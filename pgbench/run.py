#!/usr/bin/env python3
"""Benchmark of peregrine_tpu_torch: whole `asm` runs timed on one card.

    python3 pgbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run, in one process:
1. set-up: load the cell's files, write the reads of the seed to disk,
   and warm up with one assembly of the reads of the genome's first
   stretch (the CUDA context, the kernels' build, every pad bucket);
2. the window: whole assemblies back to back, each in a fresh output
   directory under TMPDIR, until `--seconds` have passed; the assembly
   running then finishes, and the window ends with it.  The window's
   time is that of its assemblies: the harness's own work between them
   (a finished assembly's digest and the removal of its files) is not
   counted;
3. the check: the first assembly's outputs against the plain reference
   (judge.py), and every other assembly's outputs against the first's;
   then one JSON line on standard output, last.

With --trace 1 the window runs under torch.profiler and the line carries
the cell's per-layer metrics, read by pgbench/metrics/<name>.py, in
place of its end-to-end ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import resource  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

import numpy as np  # noqa: E402

import devtrace  # noqa: E402
import gen  # noqa: E402
import judge  # noqa: E402
import refindex  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "peregrine_tpu")
OUTPUTS = ("1-index", "2-ovlp/preads.ovl", "3-asm/p_ctg.fa",
           "4-cns/p_ctg_cns.fa")
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3, NVIDIA's data sheet


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def list_cells(cells_dir: str = os.path.join(HERE, "cells")) -> list:
    return sorted(f[:-5] for f in os.listdir(cells_dir) if f.endswith(".json"))


def load_cell(name: str, root: str = HERE) -> tuple[dict, dict]:
    """(cell, configuration) by the cell's name."""
    cell = load_json(os.path.join(root, "cells", name + ".json"))
    cfg = load_json(os.path.join(root, "configs", cell["config"] + ".json"))
    return cell, cfg


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The entries of BENCHMARK.json's `kind` list that the cell reports."""
    return [m for m in bench.get(kind, [])
            if "workloads" not in m or name in m["workloads"]]


def reader(name: str, root: str = HERE):
    path = os.path.join(root, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("pgbench_metric_" + name,
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def workers_of(cfg: dict) -> int:
    w = cfg["host"]["workers"]
    return min(int(w["at_most"]), os.cpu_count() or 1) \
        if isinstance(w, dict) else int(w)


def rss_high_water() -> int:
    """The largest resident set this process has had, in bytes (the
    kernel's own high-water mark; set-up's, which stays below the
    window's, is inside it)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


class StageLog(logging.Handler):
    """Collects the program's `stage_wall` log records."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.walls: dict = {}

    def emit(self, record):
        sw = getattr(record, "stage_wall", None)
        if sw is not None:
            self.walls[sw[0]] = self.walls.get(sw[0], 0.0) + float(sw[1])


class Program:
    """The system under test, driven as `pg_run asm` drives it: the
    Assembly's stage methods in the CLI's order and arguments."""

    def __init__(self, cell: dict, cfg: dict, device: str):
        import torch
        from peregrine_tpu_torch.config import AsmConfig
        from peregrine_tpu_torch.ops import index as pg_index
        from peregrine_tpu_torch.pipeline.run import Assembly

        self.torch = torch
        self.Assembly = Assembly
        self.pg_index = pg_index
        self.device = device
        self.cell = cell
        s = dict(cfg["settings"])
        s["k"] = int(cell.get("k", s["k"]))
        self.settings = s
        self.acfg = AsmConfig(
            k=s["k"], w=s["w"], r=s["r"], levels=s["levels"],
            best_n_ovlp=s["best_n_ovlp"],
            use_device_aligner=bool(cell["device_aligner"]),
            device_pairs=bool(cell["device_pairs"]))
        self.workers = workers_of(cfg)
        self.n_chunks = int(cfg["host"]["n_chunks"])
        self.log = StageLog()
        lg = logging.getLogger("peregrine_tpu_torch")
        lg.setLevel(logging.INFO)
        lg.propagate = False
        lg.addHandler(self.log)

    def assemble(self, manifest: str, outdir: str, trace: bool) -> dict:
        """One whole assembly: {"spans": [(stage, t0, t1)], "walls":
        {stage: s}, "index_host_s": s}."""
        torch = self.torch
        self.log.walls = {}
        self.pg_index.reset_stats()
        spans = []

        def stage(name, fn, *args, **kw):
            t0 = time.perf_counter()
            if trace:
                with torch.profiler.record_function(devtrace.SPAN_PREFIX + name):
                    fn(*args, **kw)
            else:
                fn(*args, **kw)
            spans.append((name, t0, time.perf_counter()))

        asm = self.Assembly(outdir, self.acfg, device=self.device)
        stage("seqdb", asm.build_db, reads_list=manifest)
        stage("index", asm.build_shimmer_index, keep_l0=bool(self.cell["with_l0"]))
        stage("overlap", asm.build_overlaps, self.n_chunks, self.workers)
        stage("layout", asm.build_contigs)
        if self.cell["with_consensus"]:
            stage("polish", asm.build_consensus, self.workers)
        del asm
        if self.device != "cpu":
            torch.cuda.synchronize()
        return {"spans": spans, "walls": dict(self.log.walls),
                "index_host_s": float(sum(
                    self.pg_index.STATS["host_s"].values()))}


def drive(assemble, seconds: float, clock=time.perf_counter) -> list:
    """Whole assemblies back to back until `seconds` have passed since the
    first began; the one running then finishes.  assemble(i) returns the
    i-th assembly's record, whose "spans" hold (stage, start, end)."""
    runs = []
    t0 = clock()
    while True:
        runs.append(assemble(len(runs)))
        if clock() - t0 >= seconds:
            return runs


def window_s(runs: list) -> float:
    """The seconds of the window's assemblies, each from its first stage's
    start to its last stage's end."""
    return sum(r["spans"][-1][2] - r["spans"][0][1] for r in runs)


def asm_rate(bases: int, runs: list) -> float:
    """Read bases of every assembly in the window, in Mbases a second."""
    return bases * len(runs) / window_s(runs) / 1e6


def tree_bytes(path: str) -> int:
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def digest(outdir: str) -> str:
    h = hashlib.sha256()
    for rel in OUTPUTS:
        p = os.path.join(outdir, rel)
        files = ([os.path.join(p, f) for f in sorted(os.listdir(p))
                  if f.endswith(".dat")] if os.path.isdir(p)
                 else [p] if os.path.exists(p) else [])
        for fp in files:
            h.update(fp[len(outdir):].encode())
            with open(fp, "rb") as f:
                for blk in iter(lambda: f.read(1 << 22), b""):
                    h.update(blk)
    return h.hexdigest()


def check_outputs(outdir: str, cell: dict, cfg: dict, s: dict, reads: list,
                  g: np.ndarray, layout: np.ndarray, seed: int,
                  control: str = "") -> dict:
    """The numbers that decide `correct`, for one assembly's outputs, each
    that the cell has a limit for.  control puts the reference in a lower
    precision in the program's place (calibrate.py; a run uses none)."""
    lim = cell["limits"]
    out = {}
    t = time.perf_counter()
    times = {}

    def lap(name):
        nonlocal t
        times[name] = time.perf_counter() - t
        t = time.perf_counter()

    if "index_diff" in lim:
        hash_bits = (24 if s["k"] <= 16 else 32) if control == "index" else 0
        ref = refindex.build(reads, s["w"], s["k"], s["r"], s["levels"],
                             bool(cell["with_l0"]),
                             workers=min(8, os.cpu_count() or 1),
                             hash_bits=hash_bits)
        out["index_diff"] = judge.index_diff(outdir, ref, s["levels"])
        del ref
        lap("index")
    rng = gen.rng_for(seed, 3)
    if "ovl_gap" in lim:
        out["ovl_gap"] = judge.ovl_gap(outdir, reads, rng, 64)
        lap("ovl")
    circular = bool(cfg["genome"].get("wrap", 0))
    if "ovl_miss" in lim:
        out["ovl_miss"] = judge.ovl_miss(outdir, judge.true_pairs(
            layout, len(g), circular, int(cfg["reads"]["read_len"]) // 2))
        lap("pairs")
    gi = judge.GenomeIndex(g, circular)
    if "genome_miss" in lim:
        pieces = judge.contig_pieces(os.path.join(outdir, "3-asm", "p_ctg.fa"))
        out["genome_miss"], _ = judge.genome_miss(gi, pieces)
        lap("draft")
    if "cns_err" in lim:
        fa = ("3-asm/p_ctg.fa" if control == "polish"
              else "4-cns/p_ctg_cns.fa")
        pieces = judge.contig_pieces(os.path.join(outdir, fa))
        _, placed = judge.genome_miss(gi, pieces)
        out["cns_err"] = judge.piece_err(gi, placed, rng, 64)
        lap("polished")
    print("pgbench: check parts " + ", ".join(
        f"{k} {v:.3f} s" for k, v in times.items()), file=sys.stderr)
    return out


def run(args, device: str = "cuda", require_chip: bool = True,
        root: str = HERE, bench_path: str = os.path.join(ROOT, "BENCHMARK.json")
        ) -> int:
    """One run of a cell; the tests give another device, root (the folder
    of cells/, configs/ and metrics/) and BENCHMARK.json."""
    bench = load_json(bench_path)
    cell, cfg = load_cell(args.workload, root)
    import torch
    if require_chip and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < int(cell["chips"])):
        print(f"pgbench: the cell needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    on_card = device != "cpu"
    prog = Program(cell, cfg, device)
    print(f"pgbench: {args.workload}: host workers {prog.workers}, "
          f"chunks {prog.n_chunks}", file=sys.stderr)
    work = tempfile.mkdtemp(prefix="pgbench-")
    try:
        return _run(args, bench, cell, cfg, prog, work, on_card, root)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(args, bench, cell, cfg, prog, work, on_card, root) -> int:
    torch = prog.torch
    t = time.perf_counter()
    g, manifest, warm_lst, n_reads, bases, layout = gen.write_reads(
        args.seed, cfg, os.path.join(work, "reads"), int(cell["warm_span"]))
    t_gen = time.perf_counter() - t
    t = time.perf_counter()
    prog.assemble(warm_lst, os.path.join(work, "warm"), False)
    shutil.rmtree(os.path.join(work, "warm"))
    t_warm = time.perf_counter() - t
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    rss_setup = rss_high_water()
    prof = None
    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                         else [])
        prof = profile(activities=acts)
        prof.__enter__()
    setup_s = time.perf_counter() - T_START
    dirs, digests = [], []

    def one(i):
        # a window assembly's files go as soon as their digest is taken,
        # most of them before they reach the disk; the first stays for
        # the check.  This lies between the assemblies' spans, outside
        # the window's time.
        if len(dirs) > 1:
            digests.append(digest(dirs[-1]))
            shutil.rmtree(dirs[-1])
        dirs.append(os.path.join(work, f"asm{i:03d}"))
        return prog.assemble(manifest, dirs[-1], bool(args.trace))

    runs = drive(one, args.seconds)
    win = window_s(runs)
    peak_rss = rss_high_water()
    peak_dev = torch.cuda.max_memory_allocated() if on_card else 0
    trace_path = None
    if prof is not None:
        prof.__exit__(None, None, None)
        trace_path = os.path.join(work, "trace.json")
        prof.export_chrome_trace(trace_path)
        del prof
    bad = forbidden_modules()
    if bad:
        print(f"pgbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    print(f"pgbench: set-up {setup_s:.3f} s (reads {t_gen:.3f} s, warm-up "
          f"{t_warm:.3f} s); {len(runs)} assemblies of {n_reads} reads, "
          f"{bases} bases in {win:.3f} s of assemblies, "
          f"{runs[-1]['spans'][-1][2] - runs[0]['spans'][0][1]:.3f} s from "
          f"the first's start to the last's end; RSS high-water "
          f"{rss_setup} B after set-up, {peak_rss} B after the window",
          file=sys.stderr)

    ctx = {"runs": runs, "cell": cell, "config": cfg, "settings": prog.settings,
           "bases": bases, "reads": n_reads, "window_s": win,
           "outdir": dirs[0], "peak_bytes_s": PEAK_BYTES_S, "trace": None}
    metrics, device_info, breakdown = {}, {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": int(cell["chips"]), "memory_peak_bytes": int(peak_dev)}, None
    if trace_path:
        dev, spans = devtrace.load(trace_path)
        lo = min(a for a, _, _ in spans)
        hi = max(b for _, b, _ in spans)
        ctx["trace"] = {"dev": dev, "spans": spans, "lo": lo, "hi": hi}
        device_info["busy_s"] = devtrace.busy(dev, lo, hi) / 1e6
        device_info["window_s"] = (hi - lo) / 1e6
        breakdown = {"device_ops": devtrace.top_ops(dev, lo, hi),
                     "idle_gaps": devtrace.idle_gaps(dev, spans, lo, hi)}
        os.remove(trace_path)
        for m in cell_metrics(bench, args.workload, "per_layer"):
            v = reader(m["name"], root)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        own = {"setup_s": setup_s,
               "asm_rate": asm_rate(bases, runs),
               "peak_rss_GiB": peak_rss / (1 << 30),
               "peak_device_GiB": peak_dev / (1 << 30)}
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            v = (own[m["name"]] if m["name"] in own
                 else reader(m["name"], root)(ctx))
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}

    # the check, once the window's state is gone
    asm_bytes = tree_bytes(dirs[0])
    reads_bytes = tree_bytes(os.path.dirname(manifest))
    print(f"pgbench: disk: reads {reads_bytes} B, an assembly {asm_bytes} B",
          file=sys.stderr)
    print("pgbench: assembly walls " + " ".join(
        f"{r['spans'][-1][2] - r['spans'][0][1]:.3f}" for r in runs),
        file=sys.stderr)
    if len(dirs) > 1:
        digests.append(digest(dirs[-1]))
        shutil.rmtree(dirs[-1])
    first = digest(dirs[0])
    if on_card:
        torch.cuda.empty_cache()
    reads = list(gen.manifest_reads(manifest))
    t = time.perf_counter()
    numbers = {"runs_differ": sum(x != first for x in digests)}
    numbers.update(check_outputs(dirs[0], cell, cfg, prog.settings, reads, g,
                                 layout, args.seed))
    t_check = time.perf_counter() - t
    lim = cell["limits"]
    checks = {k: {"value": v, "limit": lim.get(k, 0)} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    print(f"pgbench: check {t_check:.3f} s", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    line = {"correct": bool(correct), "attempted": len(runs), "failed": 0,
            "metrics": metrics, "device": device_info}
    if breakdown:
        line["breakdown"] = breakdown
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    sys.exit(run(parse()))
