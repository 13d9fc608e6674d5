#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py                 # every phase (one card)
    python3 chip_smoke.py --kernels-only  # phases 1-3: build + kernel checks
    python3 chip_smoke.py --index-profile # phases 1-2, then stage 1 profiled

Phases, in order; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the SHIMMER kernels (nvcc, sm_90a) and the native host library;
  3. each of the four kernels against its plain PyTorch version on the
     card, exactly, at the main path's shapes (B=64, L in 8192/32768/40960;
     reduce_step at L=4096), with kernel and plain times (CUDA events,
     median after warm-up);
  4. build_index of 512 simulated reads and sketch_long_np of a 200 kb
     genome slice: cuda equals cpu;
  5. the main path: `pg-tpu-torch asm` (cli.main) on a simulated
     E. coli-class set (4.6 Mb circular genome, 30x of 15 kb reads, 1%
     error, 40 kb wrap, seed 42), with stage walls, kernel launch counts
     (each must be > 0), peak device memory, and a check of the draft:
     the longest contig covers >= 0.9 of the genome and >= 0.7 of its
     21-mers occur in the genome or its reverse complement.
It then prints the kernels' JSON line and, last, the device JSON line.
There is no CPU path: without a CUDA device it exits non-zero at once.

--index-profile measures stage 1 alone on the E. coli-class set instead
of phases 3-5: build_index walls with the kernels and with their plain
versions on the card, then one kernel-route build under torch.profiler,
whose trace gives the device's busy time (the union of its kernel, copy
and memset intervals) and the device time of each kernel.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SOURCE = "peregrine_tpu_torch/csrc/shimmer_kernels.cu"
REPLACES = {
    "build_stream": "peregrine_tpu/ops/compact_pallas.py:243",
    "move_plane": "peregrine_tpu/ops/compact_pallas.py:124",
    "emit_mask": "peregrine_tpu/ops/compact_pallas.py:351",
    "reduce_step": "peregrine_tpu/ops/compact_pallas.py:464",
}
K, W, R = 16, 80, 6
GENOME, READ_LEN, COVERAGE, WRAP = 4_600_000, 15_000, 30.0, 40_000


def say(*a) -> None:
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of fn() on the card (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def max_err(pairs) -> int:
    """Max |a - b| over (kernel, plain) tensor pairs, as integers."""
    err = 0
    for a, b in pairs:
        check(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.numel():
            err = max(err, int((a.long() - b.long()).abs().max()))
    return err


def prefix_pairs(out_a, out_b, counts):
    """Per-row prefixes [:count] of two compacted planes."""
    import torch
    C = out_a.shape[1]
    valid = torch.arange(C, device=out_a.device)[None, :] < counts[:, None].long()
    return [(out_a[valid], out_b[valid])]


def phase_kernels(results: dict) -> None:
    import torch

    from peregrine_tpu_torch.ops import kernels as kn

    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    B = 64
    stats = {name: {"err": 0, "times": {}} for name in REPLACES}
    reduce_input = None
    for L in (8192, 32768, 40960):
        codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
        codes[rng.random((B, L)) < 0.01] = 4
        lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
        lens[0] = L
        lens[1] = 0
        c = torch.from_numpy(codes).to(dev)
        ln = torch.from_numpy(lens).to(dev)

        got = kn.build_stream(c, ln, k=K)
        want = kn.build_stream_plain(c, ln, K)
        e = max_err(zip(got, want))
        stats["build_stream"]["err"] = max(stats["build_stream"]["err"], e)
        H, P, dest, n = want

        sH = kn.move_plane(dest, H)
        sP = kn.move_plane(dest, P)
        sH_p = kn.move_plane_plain(dest, H)
        sP_p = kn.move_plane_plain(dest, P)
        e = max_err(prefix_pairs(sH, sH_p, n) + prefix_pairs(sP, sP_p, n))
        stats["move_plane"]["err"] = max(stats["move_plane"]["err"], e)

        got = kn.emit_mask(sH_p, sP_p, n, w=W, k=K)
        want = kn.emit_mask_plain(sH_p, sP_p, n, W, K)
        e = max_err(zip(got, want))
        stats["emit_mask"]["err"] = max(stats["emit_mask"]["err"], e)
        if L == 32768:
            oH = kn.move_plane_plain(want[0], sH_p)
            oP = kn.move_plane_plain(want[0], sP_p)
            cap = L // 8
            reduce_input = (oH[:, :cap].contiguous(), oP[:, :cap].contiguous(),
                            torch.clamp(want[1], max=cap))

        t = stats["build_stream"]["times"]
        t[L] = (cuda_ms(lambda: kn.build_stream(c, ln, k=K)),
                cuda_ms(lambda: kn.build_stream_plain(c, ln, K)))
        t = stats["move_plane"]["times"]
        t[L] = (cuda_ms(lambda: kn.move_plane(dest, H)),
                cuda_ms(lambda: kn.move_plane_plain(dest, H)))
        t = stats["emit_mask"]["times"]
        t[L] = (cuda_ms(lambda: kn.emit_mask(sH_p, sP_p, n, w=W, k=K)),
                cuda_ms(lambda: kn.emit_mask_plain(sH_p, sP_p, n, W, K)))

    Hr, Pr, nr = reduce_input
    got = kn.reduce_step(Hr, Pr, nr, r=R)
    want = kn.reduce_step_plain(Hr, Pr, nr, R)
    stats["reduce_step"]["err"] = max_err(zip(got, want))
    stats["reduce_step"]["times"][Hr.shape[1]] = (
        cuda_ms(lambda: kn.reduce_step(Hr, Pr, nr, r=R)),
        cuda_ms(lambda: kn.reduce_step_plain(Hr, Pr, nr, R)))
    torch.cuda.synchronize()

    for name, st in stats.items():
        for L, (ms, pms) in st["times"].items():
            say(f"kernel {name} B={B} L={L}: {ms:.4f} ms, plain "
                f"{pms:.4f} ms, max_abs_err {st['err']} (tolerance 0)")
        check(st["err"] == 0, f"{name} disagrees with its plain version "
              f"(max_abs_err {st['err']})")
        main_L = 4096 if name == "reduce_step" else 32768
        results[name] = {"max_abs_err": st["err"],
                         "ms": st["times"][main_L][0],
                         "plain_ms": st["times"][main_L][1]}


def phase_index(reads, genome) -> None:
    import torch

    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB, seq_to_codes
    from peregrine_tpu_torch.ops.index import build_index
    from peregrine_tpu_torch.ops.sketch import sketch_long_np

    torch.set_num_threads(os.cpu_count() or 1)
    db = SeqDB.from_reads(reads[:512])
    cfg = AsmConfig()
    t0 = time.time()
    on_card = build_index(db, cfg, "cuda")
    t1 = time.time()
    on_host = build_index(db, cfg, "cpu")
    t2 = time.time()
    for f in ("x", "y", "mc_hash", "mc_count"):
        check(np.array_equal(getattr(on_card, f), getattr(on_host, f)),
              f"build_index cuda != cpu on ShimmerIndex.{f}")
    say(f"index check: build_index of 512 reads, {len(on_card.x)} SHIMMERs, "
        f"cuda == cpu ({t1 - t0:.2f} s on the card, {t2 - t1:.2f} s cpu)")
    codes = seq_to_codes(genome[:200_000])
    xg, yg = sketch_long_np(codes, 3, W, K, "cuda")
    xc, yc = sketch_long_np(codes, 3, W, K, "cpu")
    check(np.array_equal(xg, xc) and np.array_equal(yg, yc),
          "sketch_long_np cuda != cpu")
    say(f"index check: sketch_long_np of a 200 kb slice, {len(xg)} "
        "minimizers, cuda == cpu")


def smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def plain_kernels():
    """Route the index modules' kernel calls to the plain PyTorch versions
    (on the card's tensors) for as long as the block runs."""
    from peregrine_tpu_torch.ops import index, kernels as kn, reduce, sketch
    plain = {
        "build_stream": lambda c, ln, *, k: kn.build_stream_plain(c, ln, k),
        "move_plane": kn.move_plane_plain,
        "emit_mask": lambda h, p, n, *, w, k: kn.emit_mask_plain(h, p, n, w, k),
        "reduce_step": lambda h, p, n, *, r: kn.reduce_step_plain(h, p, n, r),
    }
    saved = [(m, name, getattr(m, name)) for m in (index, reduce, sketch)
             for name in plain if hasattr(m, name)]
    for m, name, _ in saved:
        setattr(m, name, plain[name])
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)


def busy_ms(events) -> float:
    """Length of the union of [ts, ts + dur) over trace events, in ms."""
    total, end = 0.0, float("-inf")
    for ev in sorted(events, key=lambda e: e["ts"]):
        a, b = ev["ts"], ev["ts"] + ev.get("dur", 0)
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1000


def phase_index_profile(reads) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops import kernels as kn
    from peregrine_tpu_torch.ops.dbgather import upload_seqdb
    from peregrine_tpu_torch.ops.index import build_index

    torch.set_num_threads(os.cpu_count() or 1)
    db = SeqDB.from_reads(reads)
    cfg = AsmConfig()
    t0 = time.perf_counter()
    packed = upload_seqdb(db.data, "cuda")
    torch.cuda.synchronize()
    say(f"index profile: seqdb pack + upload {time.perf_counter() - t0:.4f} s")

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        idx = build_index(db, cfg, "cuda", packed=packed)
        torch.cuda.synchronize()
        return time.perf_counter() - t, idx

    walls = {"kernel": [], "plain": []}
    records = set()
    for route in ("kernel", "plain", "plain", "kernel"):
        with plain_kernels() if route == "plain" else contextlib.nullcontext():
            wall, idx = run()
        walls[route].append(wall)
        records.add(len(idx.x))
        say(f"index profile: build_index [{route}] {wall:.4f} s, "
            f"{len(idx.x)} SHIMMERs | {smi('name,power.limit,clocks.sm')}")
    check(len(records) == 1, f"routes disagree on the record count {records}")

    kn.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = run()
    launches = {fn.__name__: fn.launches for fn in kn.KERNELS}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(any(e["cat"] == "kernel" for e in dev),
          "the profiler trace holds no device kernel")
    per: dict = {}
    for e in dev:
        key = e["name"] if e["cat"] == "kernel" else e["cat"]
        per[key] = per.get(key, 0.0) + e["dur"] / 1000
    ours = {name: sum(ms for key, ms in per.items()
                      if f"{name}_kernel" in key) for name in REPLACES}
    busy = busy_ms(dev)
    copies = sum(per.get(c, 0.0) for c in ("gpu_memcpy", "gpu_memset"))
    other = sum(per.values()) - sum(ours.values()) - copies
    say(f"index profile: profiled build_index wall {wall * 1000:.1f} ms; "
        f"device busy {busy:.1f} ms (union of {len(dev)} device intervals); "
        f"idle share {1 - busy / (wall * 1000):.4f}")
    say("index profile: device ms by kernel: " + ", ".join(
        f"{name} {ms:.2f} ({launches[name]} launches)"
        for name, ms in ours.items())
        + f"; other kernels {other:.2f}; copies and memsets {copies:.2f}")
    for key, ms in sorted(per.items(), key=lambda kv: -kv[1])[:8]:
        say(f"    {ms:9.3f} ms  {key[:100]}")
    say(json.dumps({"index_profile": {
        "walls_s": walls, "records": records.pop(), "profiled_wall_ms":
        wall * 1000, "device_busy_ms": busy, "kernels_ms": ours,
        "other_kernels_ms": other, "copies_ms": copies,
        "launches": launches}}))


def kmers21(seq: bytes) -> np.ndarray:
    """All 21-mers of seq as 42-bit integers; windows with a non-ACGT base
    are dropped."""
    lut = np.full(256, 4, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
    c = lut[np.frombuffer(seq, np.uint8)]
    n = len(c) - 20
    if n <= 0:
        return np.zeros(0, np.uint64)
    km = np.zeros(n, np.uint64)
    bad = np.zeros(n, bool)
    for j in range(21):
        cj = c[j:j + n]
        bad |= cj > 3
        km = (km << np.uint64(2)) | (cj & 3).astype(np.uint64)
    return km[~bad]


def phase_main_path(reads, genome, wd: str, results: dict) -> None:
    import torch

    from peregrine_tpu_torch import cli
    from peregrine_tpu_torch.io import formats
    from peregrine_tpu_torch.io.seqdb import read_fastx, revcomp
    from peregrine_tpu_torch.ops import kernels as kn
    from peregrine_tpu_torch.simdata import write_reads

    os.makedirs(wd, exist_ok=True)
    lst = os.path.join(wd, "reads.lst")
    write_reads(reads, os.path.join(wd, "reads.fa"), lst)

    walls = {}

    class Walls(logging.Handler):
        def emit(self, record):
            if hasattr(record, "stage_wall"):
                walls[record.stage_wall[0]] = record.stage_wall[1]

    logging.getLogger("peregrine_tpu_torch").addHandler(Walls())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kn.reset_launches()
    t0 = time.time()
    rc = cli.main(["asm", lst, "--output", os.path.join(wd, "asm")])
    torch.cuda.synchronize()
    total = time.time() - t0
    launches = {fn.__name__: fn.launches for fn in kn.KERNELS}
    check(rc == 0, f"asm returned {rc}")
    say("main path: stage walls " + ", ".join(
        f"{s} {walls[s]:.2f} s" for s in ("seqdb", "index", "overlap", "layout")
        if s in walls) + f"; asm total {total:.2f} s")
    say(f"main path: kernel launches {json.dumps(launches)}")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched by the main path")
        results[name]["launches"] = n
    out = os.path.join(wd, "asm")
    x, _ = formats.read_mmlist(os.path.join(out, "1-index",
                                            "shmr-L2-01-of-01.dat"))
    with open(os.path.join(out, "2-ovlp", "preads.ovl"), "rb") as f:
        n_ovl = sum(1 for ln in f if not ln.startswith(b"-"))
    ctgs = [s for _, s in read_fastx(os.path.join(out, "3-asm", "p_ctg.fa"))]
    peak = torch.cuda.max_memory_allocated() / (1 << 30)
    say(f"main path: {len(x)} SHIMMERs, {n_ovl} overlap rows, {len(ctgs)} "
        f"contigs, peak device memory {peak:.3f} GiB")
    check(len(ctgs) > 0, "no contigs")
    longest = max(ctgs, key=len)
    cover = len(longest) / len(genome)
    g = genome + genome[:READ_LEN]  # k-mers across the circular origin
    ref = np.unique(np.concatenate([kmers21(g), kmers21(revcomp(g))]))
    km = kmers21(longest.upper())
    frac = float(np.isin(km, ref).mean()) if len(km) else 0.0
    say(f"main path: longest contig {len(longest)} b = {cover:.4f} of the "
        f"genome; {frac:.4f} of its 21-mers are in the genome")
    check(cover >= 0.9, f"longest contig covers {cover:.4f} < 0.9 of the genome")
    check(frac >= 0.7, f"21-mer agreement {frac:.4f} < 0.7")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    ap.add_argument("--index-profile", action="store_true",
                    help="phases 1-2, then stage 1 alone: kernel and plain "
                    "walls and a profiler trace (no other phase)")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import peregrine_tpu_torch  # noqa: F401  (fails outside a checkout)

    # phase 1: the card
    say(smi("name,power.limit"))
    say(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    # phase 2: build
    t0 = time.time()
    from peregrine_tpu_torch.ops import kernels as kn
    kn.library()
    t1 = time.time()
    import peregrine_tpu_torch.native  # noqa: F401  (builds on import)
    say(f"build: SHIMMER kernels {t1 - t0:.1f} s (nvcc sm_90a), native host "
        f"library {time.time() - t1:.1f} s")

    # phase 3: kernels against their plain versions
    results: dict = {}
    if not args.index_profile:
        phase_kernels(results)
        if args.kernels_only:
            return 0

    # simulated E. coli-class set (numpy, seeded)
    from peregrine_tpu_torch.simdata import random_genome, simulate_reads
    t0 = time.time()
    rng = np.random.default_rng(42)
    genome = random_genome(rng, GENOME)
    reads, _ = simulate_reads(rng, genome, read_len=READ_LEN,
                              coverage=COVERAGE, len_sd=1500, error=0.01,
                              circular_wrap=WRAP)
    say(f"simulated {len(reads)} reads, "
        f"{sum(len(s) for _, s in reads)} bases ({time.time() - t0:.1f} s)")
    if args.index_profile:
        phase_index_profile(reads)
        return 0

    # phase 4: the index on the card equals the index on the host
    phase_index(reads, genome)

    # phase 5: the main path
    wd = os.path.join(ROOT, "wd-chip-smoke")
    shutil.rmtree(wd, ignore_errors=True)
    try:
        phase_main_path(reads, genome, wd, results)
    finally:
        shutil.rmtree(wd, ignore_errors=True)

    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name],
                "launches": results[name]["launches"],
                "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"],
                "plain_ms": results[name]["plain_ms"]}
               for name in REPLACES]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
