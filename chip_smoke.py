#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py                 # every phase (one card)
    python3 chip_smoke.py --kernels-only  # phases 1-3: build + kernel checks
    python3 chip_smoke.py --index-profile # phases 1-2, then stage 1 profiled
    python3 chip_smoke.py --index-profile --profile-k 28   # the same at k=28
    python3 chip_smoke.py --index-profile --abba wd-parent [--log-dir D]
                                          # parent, change, change, parent,
                                          # each in its tree; logs in D
    python3 chip_smoke.py --aligner-sass  # phases 1-2, then the aligner's
                                          # SASS loops, registers, spills
    python3 chip_smoke.py --cli-only      # phases 1-2, 5, 6 and 9

Phases, in order; any failure raises and exits non-zero:
  1. the card's name and power limit (nvidia-smi), torch and CUDA versions;
  2. build the SHIMMER kernels and the banded Myers aligner (nvcc, sm_90a)
     and the native host library, the three at once;
  3. each of the thirteen SHIMMER kernels against its plain PyTorch version
     on the card, exactly, at the main paths' shapes (B=64, L in 8192/16384/
     24576/32768/40960, 16384 being the draft's main bucket; move_plane
     moving both stream planes in one launch; reduce_step on the draft's
     two levels at L=2048, the sketch cap, and on one row of 131,072
     columns; compact_planes, whole rows with fills and counts, at the
     shapes and keep densities of each of its call sites on the k=28
     path, B=64 L=16384 keep 0.023 with planes of 8+8 bytes (the wide
     sketch's output) being the main one, on one row of 131,072 columns
     and at the former stream site's keep 0.98 with planes of 8+8+4
     bytes, each shape with its
     bytes, bound and share of it), and the chunked kernels on the
     chunk-boundary and tie-heavy rows of tests/torch_kernel_cases.py
     (build_stream and emit_mask at L = CHUNK - 1, CHUNK + 1, 16384 and
     w = 1, 5, 80, 255; reduce_step at L = REDUCE_CHUNK - 1,
     REDUCE_CHUNK + 1, 2048 and r = 2, 6, 255; compact_planes at
     L = COMPACT_CHUNK - 1, COMPACT_CHUNK, COMPACT_CHUNK + 1, 16384 with
     planes of 8+8+4, 8+8 and 4+8+4 bytes), after which the look-back
     status that the next launch will take must be zeroed; the wide
     route's three kernels at k=28, w=80, r=6, B=64, each shape with its
     bytes, bound, share and plain ms: wide_stream (the compacted
     stream, below its counts) at L = 16384 (the main shape), 24576 and
     40960, wide_emit on that stream, reduce_wide on the main shape's
     sketch capped at 2048 (read in place, as the step reads it),
     uncapped (n ~ 370; level 1 is the main shape) and both levels, and on
     one row of 131,072, reduce_wide_drain (the k > 16 step's final level
     with the drain) on level 2 uncapped (width 16384, phase 6's, the main
     shape) and capped (out_cap columns), each also against reduce_wide
     followed by drain_records and timed beside that pair, then
     tests/torch_kernel_cases.py's wide rows (wide_stream at L =
     CHUNK - 1, CHUNK + 1, 16384 and k = 17, 28; wide_emit there at
     w = 1, 2, 3, 5, 31-33, 79-81, 255 with and without ties;
     reduce_wide at L = REDUCE_WIDE_CHUNK - 1, REDUCE_WIDE_CHUNK + 1, 5000
     and r = 2, 6, 255, and reduce_wide_drain on six batches of the 5000
     rows through one cursor); stage 1's batch step's two: gather_codes
     on 64
     E. coli-class reads at L = 8192, 16384 (the main shape) and 24576,
     as the index (strand 0, fill 4) and the sharded overlap (random
     strands, fill 7) read them, and on the test windows (every residue
     mod 16, lengths 0, 1, L - 1, L) on planes cut to the data with junk
     after them; drain_records on the level-0 stream of 64 reads
     simulated as phase 5's (1% error) at L=16384, (x, y) at k=28 (phase
     6's site, the main shape) and (H, P) at k=16, on the final level of
     the same reads (cap 2048, two levels, out_cap columns),
     on random codes' level 2 three times through one cursor, and on the
     test batches at k=16 and 28 (counts 0, the width and past it;
     streams cut short); the k <= 16 step's fused pair, each also against
     the two kernels it replaces: gather_build_stream on the same reads at
     L = 16384 (the main shape) and 24576 and on the fused windows of
     tests/torch_kernel_cases.py (every residue mod 32, N runs across the
     chunk boundary) on cut planes, reduce_drain on the simulated reads'
     level 1 (the main shape and load) and on crafted rows of 5000
     columns three batches through one cursor, each timed shape with the
     time of the two launches it replaces; and
     pg_myers_align on 1,024 E. coli-class read pairs, on the crafted
     lanes of tests/torch_kernel_cases.py (windows at every word offset)
     and on its plane-end lanes (planes cut to the data and followed by
     junk, windows past the end), with its operation bound; kernel times
     are device times (many launches back to back between two CUDA
     events, divided by their number), plain times the same over a few
     calls; each kernel's byte bound at its main-path shape from this
     run's inputs (what they need: the columns below the counts, the
     kept and emitted entries);
  4. build_index of 512 simulated reads (k=16), of 256 at k=28 with and
     without the level-0 index (uncapped and capped), and of 64 at k=28,
     w=8 (cap overflow, exact retry); in fetch groups of three batches of
     four reads (tests/torch_kernel_cases.py's stage1_reads, two pad
     buckets) at k=16, at k=28 w=8 with the second batch of a group
     overflowing and retried, and at k=28 with the level-0 index, with
     the replays, group fetches and retries counted and each kernel's
     launch count held to its launches in a profiler trace of the build
     (the replays must have run what the graphs hold); sketch_long_np of
     a 200 kb genome slice at k=16 and k=28 and two reduce_flat_np levels of it (one long
     row each, as stage 4's contig index runs them): cuda equals cpu; on
     the phase-5 reads, build_index_segmented on the card in at least 9
     segments equals one build, and build_pairs_device on the card equals
     the host build_pairs and bucket_stream; SeqDBUploader on the card,
     fed the phase-5 seqdb in build_to_disk's chunks of 1 << 22 bases and
     in chunks of 4,096 with a ragged tail, gives upload_seqdb's planes
     (torch.equal), the amb plane elided (none of it copied) and zero;
  5. the draft path: `pg-tpu-torch asm` (cli.main, k=16) on a simulated
     E. coli-class set (4.6 Mb circular genome, 30x of 15 kb reads, 1%
     error, 40 kb wrap, seed 42), with stage walls, kernel launch counts
     (gather_build_stream, move_plane, emit_mask, reduce_step and
     reduce_drain must be > 0, and gather_codes, build_stream and
     drain_records 0: stage 1's step runs the fused pair; move_plane twice
     per sketch, the reduction levels moving nothing, and reduce_step and
     reduce_drain once a sketch: one batch step each), peak device
     memory, and a
     check of the draft: the longest contig covers >= 0.9 of the genome
     and >= 0.7 of its 21-mers occur in the genome or its reverse
     complement; stage 0 starts the seqdb uploader and stage 1 takes its
     planes (the stage log says so, with finish()'s wait, printed beside
     the seqdb and index walls), and 1-index/*.dat equal, byte for byte,
     an index built on the same seqdb by build_index from upload_seqdb's
     planes;
  6. the wide consensus path: `pg-tpu-torch asm --shimmer-k 28
     --with-L0-index --with-consensus` on the same set, with the stage
     walls of stages 0-4, launch counts (compact_planes, wide_stream,
     wide_emit, reduce_wide, gather_codes, reduce_wide_drain and
     drain_records must each be > 0, the fused pair 0, and
     reduce_wide_drain once a gather, drain_records at least as often:
     the level-0 stream),
     peak device memory, and a check of the polished contigs: the longest
     covers >= 0.9 of the genome, and >= 0.95 of its 21-mers, and more
     than of the phase-5 draft's, occur in the genome;
  7. stage 2 on the card: `pg-tpu-torch asm --device-aligner
     --device-pairs` on the same set, with its stage walls and aligner
     launches (> 0), each launch replayed under torch.profiler, and
     checks: the outputs of its largest launch equal the plain version's
     exactly on a seeded sample of 1,024 of its lanes, exactly one contig
     of 0.99-1.02 of the genome, a 21-mer share within 0.01 of phase 5's,
     and a Jaccard index above 0.9 between its preads.ovl read pairs and
     phase 5's;
  8. the same for `asm --hybrid-overlap` (the sample from its largest
     slice), whose device thread must have launched the aligner;
  9. the rest of the CLI and the API: `pg-tpu-torch seqdb` of the genome
     cut into 115 pieces of 40 kb; their index through the batched long
     route on the card (one sketch_batch call per 64 pieces) equal to the
     cpu's, with its wall and launches; `map` of the phase-5 reads against
     the pieces on the card (each of the four packed kernels launched;
     >= 0.95 of the mapped reads with a row on a piece overlapping their
     simulated origin); `dump-index`, `stats` and `gather-mc` on phase
     5's workdir; the API's get_shimmers_from_seq and get_cns_from_reads
     on the card equal to the cpu; Assembly(profile_dir=).run(
     with_consensus=False), whose p_ctg.fa equals phase 5's and whose
     trace names the fused pair, move_plane, emit_mask and reduce_step
     (build_stream is the long route's, launched by the reference
     index); verify_fasta of phase 6's polished
     contig against the genome, with its wall (phase 5's draft, at ~1%
     error, stalls the verifier's exact re-alignment: it is built for
     polished contigs);
 10. the multi-device paths, on an in-process mesh of four shards on
     cuda:0: build_index_mesh equal to build_index on the card at k=16
     (the four packed kernels launched) and k=28 (compact_planes and the
     three wide kernels), each
     hash shard of 256 reads equal to the same mesh's on the cpu,
     build_pairs_mesh equal to the host build_pairs and bucket_stream,
     sharded_align of a seeded 1,024-lane sample of phase 7's largest
     launch equal to myers_batch_db (the aligner launched); Assembly over
     the mesh with cfg.mesh (index, preads.ovl and p_ctg.fa equal to
     phase 5's); overlap_chunk_device with shard_overlap equal to the
     unsharded call; `asm --multihost` at world size 1 over NCCL in a
     subprocess (torchrun's environment; preads.ovl and p_ctg.fa equal
     to phase 5's); run_multihost(with_consensus=True) on two gloo ranks
     sharing the card (subprocesses of tests/torch_multihost_worker.py,
     a file:// init) equal to world size 1 in preads.ovl, p_ctg.fa and
     p_ctg_cns.fa, each rank doing >= 0.8 of its fair share of the round
     alignments and of the consensus windows;
 11. spill mode: phase 6's flags with `--mem-budget 1e6` (auto-spill into
     outdir/spill), once as the disk is (the spill filesystem holds
     0.55x the seqdb bytes, so stage 2 shares its pair map with stage
     4) and once with the free space patched to 0.4x (stage 4 rebuilds
     the map): each logs "sharing" or "not sharing" and its spill free
     space, launches compact_planes and the three wide kernels, and
     writes phase 6's p_ctg.fa,
     read_map.txt and p_ctg_cns.fa byte for byte; the stage-4 walls of
     both runs are printed;
 12. the repeat genome of tests/test_modes.py (900 kb with dispersed
     elements, a tandem array and segmental duplications; 16x of 4 kb
     reads) through Assembly(device="cuda", with_alt=True) and
     build_consensus: the fused pair, move_plane, emit_mask and
     reduce_step launched, non-empty c_path,
     a_ctg_tiling_path and a_ctg.fa, the alt polish where a_ctg.fa passes
     its gate, the polished contigs all anchored at identity >= 0.99
     (verify_contigs_multi), and stage 1's index and p_ctg.fa equal to
     the same draft on the cpu in this process.
Each path's launch counts are zeroed just before it runs and read just
after.  It then prints the JSON lines of phases 9 to 12, the digests of
every output file of phases 5-8 and 12 (the stage directories 1-index
to 4-cns-alt; scripts/torch_outputs_compare.py digests the same runs of
another checkout), the kernels' JSON line and, last, the device JSON
line.
There is no CPU path: without a CUDA device it exits non-zero at once.

--index-profile measures stage 1 alone (at --profile-k, default 16) on
the E. coli-class set instead of phases 3-6: upload_seqdb's split (its
first call, which meets the card first, and a second under
torch.profiler: the pack, the staging copies, the waits, the worker's
device set-up, where CUDA context creation lands, the planes'
allocation, and the device time of the host-to-device copies and the
memsets) beside the uploader's fed in build_to_disk's chunks (its time
from the first feed to the end of finish(), and finish()'s wait),
build_index walls on the card with the kernels and with
their plain versions (plain_kernels(): the batch step then runs eagerly;
one warm-up each, then six of each in ABBA order; median, min and max;
every build's records equal), the host's split of one build
(ops/index.py STATS: metas staging, replays, group fetches, per-read
slicing, _index_of, captures; replays and group fetches counted; the
captured graphs' pool bytes), then one build under torch.profiler,
whose trace gives the device's busy time (the union of its kernel, copy
and memset intervals), the device time of each kernel, in all and by
template instance and launch grid (which tell its shapes apart), and
the number of device intervals (fill kernels counted apart); each
kernel's launch count must equal its launches in the trace (at k=16
the fused pair and no gather_codes, drain_records or reduce_wide_drain,
at k=28 gather_codes and reduce_wide_drain and not the fused pair).
With
--abba PARENT it runs `chip_smoke.py --index-profile` of the checkout
PARENT and of this one in turns (parent, change, change, parent), each
in its own process, and prints each run's summary (walls, busy time,
device intervals, each kernel's trace us a launch).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import re
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
    "compact_planes": "peregrine_tpu/ops/compact_pallas.py:391",
    # the wide route's XLA code between and around its compactions
    "wide_stream": "peregrine_tpu/ops/sketch.py:371",
    "wide_emit": "peregrine_tpu/ops/sketch.py:425",
    "reduce_wide": "peregrine_tpu/ops/reduce.py:26",
    # stage 1's batch step around the kernels
    "gather_codes": "peregrine_tpu/ops/dbgather.py:233",
    "drain_records": "peregrine_tpu/ops/index.py:66",
    # the k <= 16 step's fused pair: gather_codes into build_stream's load
    # stage, the drain into the final reduce_step's store stage
    "gather_build_stream": "peregrine_tpu/ops/compact_pallas.py:243",
    "reduce_drain": "peregrine_tpu/ops/compact_pallas.py:464",
    # the k > 16 step's final reduce_impl level with the drain as its
    # store stage
    "reduce_wide_drain": "peregrine_tpu/ops/reduce.py:26 with "
                         "peregrine_tpu/ops/index.py:66",
}
WIDE = ("wide_stream", "wide_emit", "reduce_wide")
STAGE1 = ("gather_codes", "drain_records")
FUSED = ("gather_build_stream", "reduce_drain")
# the k > 16 step: the gather alone, the final level and the drain fused
# (drain_records stays for the level-0 stream and the retries)
WIDE_STEP = ("gather_codes", "reduce_wide_drain")
# the kernel the port adds where the JAX package used XLA: the banded
# Myers aligner's fused loop (_myers_core, as myers_batch_db_packed calls it)
ALIGN_SOURCE = "peregrine_tpu_torch/csrc/myers_align.cu"
ALIGN_REPLACES = "peregrine_tpu/ops/device_align.py:66"
K, W, R = 16, 80, 6
K_WIDE = 28
MAIN_L, CAP = 16384, 2048  # the draft's main read bucket and sketch cap
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory (NVIDIA data sheet)
# H100 SXM 32-bit integer rate: 64 INT32 lanes an SM, half the 128 FP32
# lanes behind the data sheet's 67 TFLOP/s, which counts an FMA as two
INT32_OPS_PER_S = 67e12 / 4
# The 32-bit operations the banded Myers function needs per lane and
# target column, counting a three-input logic operation, a three-input
# add and a shift with carry (funnel shift) as one each, as sm_90 issues
# them.  A block update is 13: one match-word lookup, e | hm_in, & p, the
# add, xh, ph, mh, hm_out, xv, the two shifts with carry, pv and mv.  The
# column is 11: its target base read 4 to a byte (shift, mask, ambiguity
# bit), the score (two carries out and the add), its offset, the test
# against the best, the best's two updates and the loop.  The kernel's
# own column loop executes more (`--aligner-sass` counts it).
MYERS_OPS_PER_COLUMN = 13 * 8 + 11
ALN_MAX_LEN = 1 << 15  # AsmConfig.aln_max_len: the longest lane aligned
PROFILE_PAIRS = 6  # kernel/plain stage-1 builds compared by --index-profile
GENOME, READ_LEN, COVERAGE, WRAP = 4_600_000, 15_000, 30.0, 40_000
PIECE = 40_000  # phase 9's reference: the genome cut into 115 pieces


# every phase-5/6/7/8/12 output, digested (output_digests), printed as
# one JSON line before the kernels line; scripts/torch_outputs_compare.py
# digests the same runs of another checkout
DIGESTS: dict = {}
OUTPUT_DIRS = ("1-index", "2-ovlp", "3-asm", "4-cns", "4-cns-alt")


# files whose compound rows list their '|'-joined members in an order
# that follows Python's string hash seed (tests/test_torch_repeat.py):
# digested with each token's members sorted
HASH_ORDERED = ("c_path", "utg_data")


def output_digests(out: str) -> dict:
    """sha1 (16 hex digits) of every file under the stage directories of
    the workdir `out` (stages 1-4, the alternate contigs' polish), by
    path."""
    import hashlib
    digests = {}
    for d in OUTPUT_DIRS:
        for base, _, files in sorted(os.walk(os.path.join(out, d))):
            for f in sorted(files):
                path = os.path.join(base, f)
                with open(path, "rb") as fh:
                    data = fh.read()
                if f in HASH_ORDERED:
                    data = b"\n".join(b" ".join(b"|".join(sorted(
                        tok.split(b"|"))) for tok in ln.split())
                        for ln in data.splitlines())
                digests[os.path.relpath(path, out)] = hashlib.sha1(
                    data).hexdigest()[:16]
    return digests


def say(*a) -> None:
    print(*a, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke FAILED: {what}")


def traced(name: str, event: str) -> bool:
    """Whether a trace event's kernel name is wrapper `name`'s kernel
    (name_kernel as a whole word: build_stream_kernel is not
    gather_build_stream_kernel)."""
    return re.search(rf"(?<!\w){name}_kernel(?!\w)", event) is not None


def _events():
    import torch
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def kernel_ms(fn, n: int = 50) -> float:
    """Device milliseconds per call of a kernel wrapper fn: n calls back to
    back between two CUDA events, divided by n.  A spin on the card holds
    the stream while the host queues the calls, so the events time the
    kernel on the device and not the wrapper's host path; the spin grows until the first event is still
    pending when the last call has been queued."""
    import torch
    fn()
    torch.cuda.synchronize()
    cycles = 2_000_000
    for _ in range(6):
        a, b = _events()
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        held = not a.query()
        b.synchronize()
        if held:
            return a.elapsed_time(b) / n
        cycles *= 4
    raise SystemExit("chip_smoke FAILED: the host could not queue "
                     f"{n} launches inside the hold")


def plain_ms(fn, n: int = 5) -> float:
    """Milliseconds per call of a plain version: n calls between two CUDA
    events after one warm-up call (host gaps included: several of them
    synchronise)."""
    import torch
    fn()
    a, b = _events()
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def max_err(pairs) -> int:
    """Max |a - b| over (kernel, plain) tensor pairs, as integers."""
    err = 0
    for a, b in pairs:
        check(a.shape == b.shape, f"shape {tuple(a.shape)} vs {tuple(b.shape)}")
        if a.numel() and bool((a != b).any()):
            # int64 differences may wrap: any mismatch counts at least 1
            err = max(err, 1, int((a.long() - b.long()).abs().max()))
    return err


def prefix_pairs(out_a, out_b, counts):
    """Per-row prefixes [:count] of two compacted planes."""
    import torch
    C = out_a.shape[1]
    valid = torch.arange(C, device=out_a.device)[None, :] < counts[:, None].long()
    return [(out_a[valid], out_b[valid])]


def stream_pairs(got, want):
    """(kernel, plain) pairs of wide_stream's compacted stream: each
    plane's prefixes below the counts (the kernel leaves the columns past
    them stale) and the counts."""
    return [p for a, b in zip(got[:3], want[:3])
            for p in prefix_pairs(a, b, want[3])] + [(got[3], want[3])]


def load_kernel_cases():
    """tests/torch_kernel_cases.py, the chunked kernels' edge-case rows."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_kernel_cases", os.path.join(ROOT, "tests",
                                           "torch_kernel_cases.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def phase_kernels(results: dict) -> None:
    import torch

    from peregrine_tpu_torch.ops import kernels as kn

    kernel_cases = load_kernel_cases()

    dev = torch.device("cuda")
    rng = np.random.default_rng(42)
    B = 64
    stats = {name: {"err": 0, "times": {}} for name in REPLACES}
    moved = {}  # bytes each kernel must move at its main-path shape

    def note(name, pairs):
        stats[name]["err"] = max(stats[name]["err"], max_err(pairs))

    def times(name, key, fn, plain):
        stats[name]["times"][key] = (kernel_ms(fn), plain_ms(plain))

    def on_card(*arrays):
        return [torch.from_numpy(a).to(dev) for a in arrays]

    def card_planes(rows, L, widths):
        """Random int64 (width 8) and int32 (width 4) planes on the card."""
        return tuple(on_card(*(
            rng.integers(-2**63, 2**63 - 1, (rows, L), dtype=np.int64)
            if wd == 8 else rng.integers(-2**31, 2**31, (rows, L))
            .astype(np.int32) for wd in widths)))

    reduce_input = None
    for L in (8192, MAIN_L, 24576, 32768, 40960):
        codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
        codes[rng.random((B, L)) < 0.01] = 4
        lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
        lens[0] = L
        lens[1] = 0
        c, ln = on_card(codes, lens)

        note("build_stream", zip(kn.build_stream(c, ln, k=K),
                                 kn.build_stream_plain(c, ln, K)))
        H, P, dest, n = kn.build_stream_plain(c, ln, K)

        sH, sP = kn.move_plane(dest, H, P)
        sH_p, sP_p = kn.move_plane_plain(dest, H, P)
        note("move_plane", prefix_pairs(sH, sH_p, n) + prefix_pairs(sP, sP_p, n))

        want = kn.emit_mask_plain(sH_p, sP_p, n, W, K)
        note("emit_mask", zip(kn.emit_mask(sH_p, sP_p, n, w=W, k=K), want))
        if L == MAIN_L:
            oH, oP = kn.move_plane_plain(want[0], sH_p, sP_p)
            reduce_input = (oH[:, :CAP].contiguous(), oP[:, :CAP].contiguous(),
                            torch.clamp(want[1], max=CAP))
            kept = int((dest >= 0).sum())
            moved["build_stream"] = 13 * B * L + 8 * B
            moved["move_plane"] = 4 * B * L + 16 * kept
            moved["emit_mask"] = 8 * int(n.sum()) + 4 * B * L + 8 * B

        times("build_stream", L, lambda: kn.build_stream(c, ln, k=K),
              lambda: kn.build_stream_plain(c, ln, K))
        times("move_plane", L, lambda: kn.move_plane(dest, H, P),
              lambda: kn.move_plane_plain(dest, H, P))
        times("emit_mask", L, lambda: kn.emit_mask(sH_p, sP_p, n, w=W, k=K),
              lambda: kn.emit_mask_plain(sH_p, sP_p, n, W, K))

    # rows that put lengths, counts, placeholders and final windows on the
    # chunk boundaries of build_stream and emit_mask, with and without ties
    for L in (kn.CHUNK - 1, kn.CHUNK + 1, MAIN_L):
        c, ln = on_card(*kernel_cases.stream_codes(rng, B, L, K, kn.CHUNK))
        note("build_stream", zip(kn.build_stream(c, ln, k=K),
                                 kn.build_stream_plain(c, ln, K)))
        for w in (1, 5, W, 255):
            for ties in (False, True):
                sH, sP, n = kernel_cases.emit_stream(rng, B, L, w, K,
                                                     kn.CHUNK, ties)
                sH, sP, n = on_card(sH.view(np.int32), sP.view(np.int32), n)
                note("emit_mask", zip(kn.emit_mask(sH, sP, n, w=w, k=K),
                                      kn.emit_mask_plain(sH, sP, n, w, K)))
    check(not any(bool(pair[0].any()) for pair in kn._status_pairs.values()),
          "the next chunked launch's look-back status is not zeroed")
    say(f"kernel checks: build_stream and emit_mask on the chunk-boundary "
        f"rows at L {kn.CHUNK - 1}/{kn.CHUNK + 1}/{MAIN_L}, emit_mask at w "
        f"1/5/{W}/255 with and without ties")

    # compact_planes at its call sites' shapes on the k=28 path: the wide
    # sketch's output (x, y) compaction and reduce_impl's two levels,
    # uncapped as --with-L0-index runs them, on the reads' buckets; a
    # level capped at 2,048 columns, as stage 1 runs it without the
    # level-0 index; stage 4's contig sketch (L=40,960) and a reduction
    # level of one contig row; then further shapes, among them the
    # sketch's stream (x, y, run), which wide_stream now compacts itself
    compact_shapes = []
    for site, rows, L, density, widths in (
            ("output", B, MAIN_L, 0.023, (8, 8)),  # the main shape
            ("reduce level 1", B, MAIN_L, 0.007, (8, 8)),
            ("reduce level 2", B, MAIN_L, 0.002, (8, 8)),
            ("reduce level 1, capped", B, CAP, 0.05, (8, 8)),
            ("contig output", B, 40960, 2 / (W + 1), (8, 8)),
            ("contig level", 1, 131072, 2 / (R + 1), (8, 8)),
            ("other", B, MAIN_L, 0.98, (8, 8, 4)),
            ("other", B, MAIN_L, 0.92, (8, 8, 4)),
            ("other", B, 24576, 0.92, (8, 8, 4)),
            ("other", B, 40960, 0.98, (8, 8, 4)),
            ("other", B, 8192, 0.98, (8, 8, 4)),
            ("other", B, 8192, 2 / (W + 1), (8, 8, 4)),
            ("other", B, MAIN_L, 2 / (W + 1), (8, 8, 4)),
            ("other", B, 32768, 0.98, (8, 8, 4)),
            ("other", B, 32768, 2 / (W + 1), (8, 8, 4))):
        keep = torch.from_numpy(rng.random((rows, L)) < density).to(dev)
        planes = card_planes(rows, L, widths)
        fills = (-1, -1, 0)[:len(widths)]
        got = kn.compact_planes(keep, planes, fills)
        want = kn.compact_planes_plain(keep, planes, fills)
        note("compact_planes", list(zip(got[0], want[0]))
             + [(got[1], want[1])])
        ms = kernel_ms(lambda: kn.compact_planes(keep, planes, fills))
        pms = plain_ms(lambda: kn.compact_planes_plain(keep, planes, fills))
        kept = int(keep.sum())
        nbytes = rows * L + 4 * rows + sum(wd * (kept + rows * L)
                                           for wd in widths)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        compact_shapes.append({
            "site": site, "B": rows, "L": L, "keep_density": density,
            "plane_bytes": list(widths), "bytes": nbytes, "ms": ms,
            "plain_ms": pms, "bound_ms": bound_ms,
            "share_of_bound": bound_ms / ms})
        if len(compact_shapes) == 1:  # the main shape
            stats["compact_planes"]["times"][(MAIN_L, density)] = (ms, pms)
            moved["compact_planes"] = nbytes
    # rows that put kept columns, counts and dropped chunks on the chunk
    # boundaries, for each plane layout (the generic one too)
    CC = kn.COMPACT_CHUNK
    for L in (CC - 1, CC, CC + 1, MAIN_L):
        for widths in ((8, 8, 4), (8, 8), (4, 8, 4)):
            keep, = on_card(kernel_cases.compact_rows(rng, B, L, CC))
            planes = card_planes(B, L, widths)
            fills = (-1, 7, 0xFFFFFFFF)[:len(widths)]
            got = kn.compact_planes(keep, planes, fills)
            want = kn.compact_planes_plain(keep, planes, fills)
            note("compact_planes", list(zip(got[0], want[0]))
                 + [(got[1], want[1])])
    check(not any(bool(pair[0].any()) for pair in kn._status_pairs.values()),
          "the next chunked launch's look-back status is not zeroed")
    for sh in compact_shapes:
        say(f"kernel compact_planes {sh['site']} B={sh['B']} L={sh['L']} "
            f"keep density {sh['keep_density']:.4f} planes "
            f"{'+'.join(map(str, sh['plane_bytes']))} B: {sh['bytes']} bytes,"
            f" bound {sh['bound_ms'] * 1e3:.3f} us, kernel "
            f"{sh['ms'] * 1e3:.3f} us, {sh['share_of_bound']:.4f} of the "
            f"bound, plain {sh['plain_ms']:.4f} ms")
    say(f"kernel checks: compact_planes at its call sites' shapes and on the"
        f" chunk-boundary rows at L {CC - 1}/{CC}/{CC + 1}/{MAIN_L} with "
        "planes 8+8+4, 8+8 and 4+8+4 B: whole rows, fills and counts")

    # reduce_step: the draft's two levels on the main bucket's capped
    # sketch (level 2 reads level 1's kernel output, stale tails and all),
    # the chunk-boundary and tie-heavy rows, and one long row as stage 4's
    # contig index gives it
    def level_pairs(got, want):
        return (prefix_pairs(got[0], want[0], want[2])
                + prefix_pairs(got[1], want[1], want[2]) + [(got[2], want[2])])

    Hr, Pr, nr = reduce_input
    got1, want1 = kn.reduce_step(Hr, Pr, nr, r=R), kn.reduce_step_plain(
        Hr, Pr, nr, R)
    got2 = kn.reduce_step(*got1, r=R)
    want2 = kn.reduce_step_plain(*want1, R)
    note("reduce_step", level_pairs(got1, want1) + level_pairs(got2, want2))
    times("reduce_step", CAP, lambda: kn.reduce_step(Hr, Pr, nr, r=R),
          lambda: kn.reduce_step_plain(Hr, Pr, nr, R))
    times("reduce_step", f"{CAP}, level 2", lambda: kn.reduce_step(*got1, r=R),
          lambda: kn.reduce_step_plain(*want1, R))
    moved["reduce_step"] = 8 * int(nr.clamp(0, CAP).sum()) + 8 * int(
        want1[2].sum()) + 8 * B
    for L in (kn.REDUCE_CHUNK - 1, kn.REDUCE_CHUNK + 1, CAP):
        for r in (2, R, 255):
            for ties in (False, True):
                Hc, Pc, nc = kernel_cases.reduce_rows(rng, B, L, r,
                                                      kn.REDUCE_CHUNK, ties)
                Hc, Pc, nc = on_card(Hc.view(np.int32), Pc.view(np.int32), nc)
                note("reduce_step", level_pairs(
                    kn.reduce_step(Hc, Pc, nc, r=r),
                    kn.reduce_step_plain(Hc, Pc, nc, r)))
    LONG = 131072
    Hl, Pl = on_card(*(rng.integers(0, 1 << 31, (1, LONG)).astype(np.int32)
                       for _ in range(2)))
    nl = torch.tensor([LONG], dtype=torch.int32, device=dev)
    note("reduce_step", level_pairs(kn.reduce_step(Hl, Pl, nl, r=R),
                                    kn.reduce_step_plain(Hl, Pl, nl, R)))
    times("reduce_step", f"B=1 L={LONG}",
          lambda: kn.reduce_step(Hl, Pl, nl, r=R),
          lambda: kn.reduce_step_plain(Hl, Pl, nl, R))
    check(not any(bool(pair[0].any()) for pair in kn._status_pairs.values()),
          "the next chunked launch's look-back status is not zeroed")
    say(f"kernel checks: reduce_step on two levels at L={CAP}, on the "
        f"chunk-boundary rows at L {kn.REDUCE_CHUNK - 1}/"
        f"{kn.REDUCE_CHUNK + 1}/{CAP}, r 2/{R}/255 with and without ties, "
        f"and on one row of {LONG}")
    phase_wide_kernels(rng, stats, moved, kernel_cases, note, on_card,
                       results)
    phase_stage1_kernels(rng, stats, moved, kernel_cases, note, on_card,
                         results, got2)
    torch.cuda.synchronize()

    for name, st in stats.items():
        for key, (ms, pms) in st["times"].items():
            shape = (f"B={B} L={key[0]} keep density {key[1]}"
                     if isinstance(key, tuple) else
                     key if str(key).startswith("B=") else f"B={B} L={key}")
            say(f"kernel {name} {shape}: {ms:.4f} ms, plain "
                f"{pms:.4f} ms, max_abs_err {st['err']} (tolerance 0)")
        check(st["err"] == 0, f"{name} disagrees with its plain version "
              f"(max_abs_err {st['err']})")
        main = {"reduce_step": CAP,  # level 1
                "compact_planes": (MAIN_L, 0.023),
                "reduce_wide": WIDE_LEVEL,
                "reduce_wide_drain": WIDE_DRAIN,
                "drain_records": DRAIN_MAIN,
                "reduce_drain": FUSED_DRAIN}.get(name, MAIN_L)
        ms, pms = st["times"][main]
        bound_ms = moved[name] / HBM_BYTES_PER_S * 1e3
        results[name].update(
            max_abs_err=st["err"], ms=ms, plain_ms=pms, bound_ms=bound_ms,
            bound_by="bytes", library_ms=None, bound_us=bound_ms * 1e3,
            share_of_bound=bound_ms / ms)
        if name == "compact_planes":
            results[name]["shapes"] = compact_shapes
        say(f"kernel {name} at its main-path shape ({main}): {moved[name]} "
            f"bytes, bound {bound_ms * 1e3:.3f} us, kernel {ms * 1e3:.3f} us,"
            f" {bound_ms / ms:.4f} of the bound")

WIDE_LEVEL = f"B=64 L={MAIN_L} uncapped, level 1"  # reduce_wide's main shape
# reduce_wide_drain's: phase 6's final level
WIDE_DRAIN = f"B=64 L={MAIN_L} uncapped, level 2, width {MAIN_L}"
OUT_CAP = max(64, CAP // int((R / 2) ** 2))  # the draft's final columns
# drain_records' main site is phase 6's level-0 stream
DRAIN_MAIN = (f"B=64 reads at L={MAIN_L}: (x, y) level 0 at k={K_WIDE}, "
              f"width {MAIN_L}")
DRAIN_FINAL = (f"B=64 reads at L={MAIN_L}: (H, P) level 2 of cap {CAP}, "
               f"out_cap {OUT_CAP}")
FUSED_DRAIN = (f"B=64 reads at L={MAIN_L}: (H, P) level 1 of cap {CAP} -> "
               f"level 2, out_cap {OUT_CAP}")


def phase_stage1_kernels(rng, stats, moved, kernel_cases, note, on_card,
                         results, level2) -> None:
    """Phase 3's two kernels of stage 1's batch step, each held to its
    plain version exactly: gather_codes on 64 E. coli-class reads (15 kb
    +- 1.5 kb, 1% N) at L = 8,192, 16,384 (the main shape) and 24,576,
    strand 0, fill 4, as the index reads them, and with random strands
    and fill 7 as the sharded overlap reads them; then
    tests/torch_kernel_cases.py's windows (every residue mod 16, lengths
    0, 1, L - 1, L, both strands) on planes cut to the data at a byte
    offset with junk after them.  drain_records on the final level of 64
    reads simulated as the main path's (1% error) at L=16,384
    (index_planes, cap 2,048, two levels, out_cap columns: the main shape
    and load, and the one timed), on
    random codes' level 2 three times through one cursor, and on the test
    cases' batches at k=16 and k=28 (counts 0, the width and past it).
    The fused pair of the k <= 16 step, each held to its plain version and
    to the two kernels it replaces exactly: gather_build_stream on the
    same reads at L = 16,384 (the main shape) and 24,576, and on
    tests/torch_kernel_cases.py's fused windows (every residue mod 32, N
    runs across the chunk boundary) on planes cut to the data at a byte
    offset; reduce_drain on the simulated reads' level 1 (the main shape
    and load: level 2 and the drain of out_cap columns) and on the test
    cases' level rows three batches through one cursor.  Each timed shape
    has its bytes, bound and plain ms, the fused pair's also the time of
    the two launches it replaces on the same inputs (pair_ms);
    results[name]["shapes"] lists them."""
    import torch

    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops import dbgather, index, kernels as kn, sketch
    from peregrine_tpu_torch.simdata import random_genome, simulate_reads

    B = 64
    shapes = {name: [] for name in STAGE1 + FUSED}

    def shape(name, site, fn, plain, nbytes, key=None, pair=None):
        ms, pms = kernel_ms(fn), plain_ms(plain)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        shapes[name].append({"site": site, "bytes": nbytes, "ms": ms,
                             "plain_ms": pms, "bound_ms": bound_ms,
                             "share_of_bound": bound_ms / ms})
        if pair is not None:  # the two launches the kernel replaces
            shapes[name][-1]["pair_ms"] = kernel_ms(pair)
        if key is not None:
            stats[name]["times"][key] = (ms, pms)
            moved[name] = nbytes

    lens = np.maximum(1000, rng.normal(READ_LEN, 1500, B)).astype(np.int64)
    seqs = []
    for n in lens:
        a = np.frombuffer(random_genome(rng, int(n)), np.uint8).copy()
        a[rng.random(len(a)) < 0.01] = ord("N")
        seqs.append(a.tobytes())
    db = SeqDB.from_reads([(str(i), q) for i, q in enumerate(seqs)])
    pdb = dbgather.upload_seqdb(db.data, "cuda")
    off = torch.from_numpy(db.offsets.astype(np.int64)).cuda()
    for L in (8192, MAIN_L, 24576):
        ln = torch.from_numpy(np.minimum(lens, L)).cuda()
        got = dbgather.gather_codes(pdb, off, ln, None, L, 4)
        note("gather_codes", [(got, dbgather.gather_codes_plain(
            pdb, off, ln, None, L, 4))])
        nbytes = B * L + B * L * 3 // 8 + 16 * B
        shape("gather_codes", f"index batch B={B} L={L}",
              lambda: dbgather.gather_codes(pdb, off, ln, None, L, 4),
              lambda: dbgather.gather_codes_plain(pdb, off, ln, None, L, 4),
              nbytes, L if L == MAIN_L else None)
        if L != 8192:
            # the fused gather and build on the same windows
            got = kn.gather_build_stream(pdb, off, ln, L, k=K)
            note("gather_build_stream", zip(got, kn.gather_build_stream_plain(
                pdb, off, ln, L, K)))
            ln32 = ln.to(torch.int32)
            note("gather_build_stream", zip(got, kn.build_stream(
                dbgather.gather_codes(pdb, off, ln, None, L, 4), ln32, k=K)))
            shape("gather_build_stream", f"index batch B={B} L={L}",
                  lambda: kn.gather_build_stream(pdb, off, ln, L, k=K),
                  lambda: kn.gather_build_stream_plain(pdb, off, ln, L, K),
                  B * L * 3 // 8 + 12 * B * L + 20 * B,
                  L if L == MAIN_L else None,
                  pair=lambda: kn.build_stream(dbgather.gather_codes(
                      pdb, off, ln, None, L, 4), ln32, k=K))
        st = torch.from_numpy(rng.integers(0, 2, B).astype(np.int32)).cuda()
        goff = torch.where(st == 1, off + ln - L, off)
        note("gather_codes", [(
            dbgather.gather_codes(pdb, goff, ln, st, L, 7),
            dbgather.gather_codes_plain(pdb, goff, ln, st, L, 7))])
    cases = kernel_cases.gather_seqs()
    cdb = SeqDB.from_reads([(str(i), q) for i, q in enumerate(cases)])
    fw, amb, nf, na = kernel_cases.plane_end_planes(cases, junk=64, seed=3)

    def view(a, n):
        return torch.from_numpy(np.concatenate([[0xA5], a]).astype(
            np.uint8)).cuda()[1:1 + n]
    cut = dbgather.PackedSeqDB(fw=view(fw, nf), amb=view(amb, na))
    for L in (264, 256):
        for strand in (0, 1):
            goff, ln, st = on_card(*kernel_cases.gather_windows(
                cdb.offsets, cdb.lengths, strand, L))
            for fill in (4, 7):
                note("gather_codes", [(
                    dbgather.gather_codes(cut, goff, ln, st, L, fill),
                    dbgather.gather_codes_plain(cut, goff, ln, st, L, fill))])

    # the fused windows: every residue mod 32, N runs across the chunk
    # boundary, tails past the data, on planes cut to the data at an offset
    FL = 4224
    fseqs = kernel_cases.fused_gather_seqs(FL)
    fdb = SeqDB.from_reads([(str(i), q) for i, q in enumerate(fseqs)])
    fw, amb, nf, na = kernel_cases.plane_end_planes(fseqs, junk=64, seed=5)
    fcut = dbgather.PackedSeqDB(fw=view(fw, nf), amb=view(amb, na))
    fg, fl = on_card(*kernel_cases.fused_gather_windows(
        fdb.offsets, fdb.lengths, FL, rows=B))
    for k in (5, K):
        note("gather_build_stream", zip(
            kn.gather_build_stream(fcut, fg, fl, FL, k=k),
            kn.gather_build_stream_plain(fcut, fg, fl, FL, k)))

    def streams(n_rec, slots):
        return (torch.full((n_rec, 2), 7, dtype=torch.int64, device="cuda"),
                torch.full((slots, 2, B), -5, dtype=torch.int32,
                           device="cuda"),
                torch.zeros(3, dtype=torch.int64, device="cuda"))

    # exact: the random codes' level 2 (B=64, L=2,048), three batches
    # through one cursor
    H, P, c = level2
    rids = torch.arange(B, dtype=torch.int64, device="cuda") * 7919
    c0 = c + 1000
    n = int(c.clamp(0, OUT_CAP).sum())
    got, want = streams(3 * n, 4), streams(3 * n, 4)
    for _ in range(3):
        kn.drain_records(H, P, rids, c, c0, got[2], got[0], got[1], k=K,
                         width=OUT_CAP)
        kn.drain_records_plain(H, P, rids, c, c0, want[2], want[0], want[1],
                               k=K, width=OUT_CAP)
    note("drain_records", list(zip(got, want)))
    check(got[2].tolist() == [3 * n, 3, 0], "drain_records' cursor")
    # timed at the main path's load: the final level (index_planes, cap
    # CAP, two levels) of 64 reads simulated as the main path's are (1%
    # error, no N: an N cuts the sketch's k-mers) in its L=16,384 bucket
    sim, _ = simulate_reads(rng, random_genome(rng, 1_500_000),
                            read_len=READ_LEN, coverage=1.0, len_sd=1500,
                            error=0.01)
    sim = [q for _, q in sim if MAIN_L // 2 < len(q) <= MAIN_L][:B]
    check(len(sim) == B, f"{len(sim)} simulated reads in the main bucket")
    sdb = SeqDB.from_reads([(str(i), q) for i, q in enumerate(sim)])
    ln = torch.from_numpy(sdb.lengths.astype(np.int64)).cuda()
    codes = dbgather.gather_codes(dbgather.upload_seqdb(sdb.data, "cuda"),
                                  torch.from_numpy(sdb.offsets.astype(
                                      np.int64)).cuda(), ln, None, MAIN_L, 4)
    H, P, c, c0 = index.index_planes(codes, ln.to(torch.int32), rids, w=W,
                                     k=K, r=R, levels=2, cap=CAP)
    # level 1, the fused final level's input
    H1, P1, c1, _ = index.index_planes(codes, ln.to(torch.int32), rids, w=W,
                                       k=K, r=R, levels=1, cap=CAP)
    n = int(c.clamp(0, OUT_CAP).sum())
    got, want = streams(n, 4), streams(n, 4)
    kn.drain_records(H, P, rids, c, c0, got[2], got[0], got[1], k=K,
                     width=OUT_CAP)
    kn.drain_records_plain(H, P, rids, c, c0, want[2], want[0], want[1],
                           k=K, width=OUT_CAP)
    note("drain_records", list(zip(got, want)))
    fused, fwant = streams(n, 4), streams(n, 4)
    kn.reduce_drain(H1, P1, c1, rids, c0, fused[2], fused[0], fused[1], r=R,
                    k=K, width=OUT_CAP)
    kn.reduce_drain_plain(H1, P1, c1, rids, c0, fwant[2], fwant[0],
                          fwant[1], r=R, k=K, width=OUT_CAP)
    note("reduce_drain", list(zip(fused, fwant)) + list(zip(fused, got)))
    say(f"kernel drain_records: the reads' final level holds {n} records, "
        f"{n / B:.1f} a row")
    # kernel_ms' launches (at most 301) append to one stream; the count
    # slots past 4 are not written
    timed, ptimed = streams(320 * n, 4), streams(n, 4)
    shape("drain_records", DRAIN_FINAL,
          lambda: kn.drain_records(H, P, rids, c, c0, timed[2], timed[0],
                                   timed[1], k=K, width=OUT_CAP),
          lambda: (ptimed[2].zero_(), kn.drain_records_plain(
              H, P, rids, c, c0, ptimed[2], ptimed[0], ptimed[1], k=K,
              width=OUT_CAP)),
          24 * n + 16 * B + 8 * B)
    # the level-0 stream of --with-L0-index, where the step still drains
    # alone: the same reads' sketch, (x, y) records at k=28 (phase 6, the
    # main site) and (H, P) planes at k=16, every column of the pad wide;
    # the records read and written once, the counts (and at k=16 the
    # rids) read
    for k, main in ((K_WIDE, DRAIN_MAIN), (K, None)):
        if k > 16:
            a0, b0, n0 = sketch.sketch_wide(codes, ln.to(torch.int32), rids,
                                            w=W, k=k)
        else:
            a0, b0, n0 = sketch.sketch_planes(codes, ln.to(torch.int32), w=W,
                                              k=k)
        n = int(n0.clamp(0, MAIN_L).sum())
        got, want = streams(n, 4), streams(n, 4)
        for run, fn in ((got, kn.drain_records),
                        (want, kn.drain_records_plain)):
            fn(a0, b0, rids, n0, n0, run[2], run[0], None, k=k, width=MAIN_L)
        note("drain_records", list(zip(got, want)))
        timed, ptimed = streams(320 * n, 4), streams(n, 4)
        shape("drain_records", f"B=64 reads at L={MAIN_L}: level 0 at k={k}"
              f", {n / B:.1f} records a row, width {MAIN_L}",
              lambda: kn.drain_records(a0, b0, rids, n0, n0, timed[2],
                                       timed[0], None, k=k, width=MAIN_L),
              lambda: (ptimed[2].zero_(), kn.drain_records_plain(
                  a0, b0, rids, n0, n0, ptimed[2], ptimed[0], None, k=k,
                  width=MAIN_L)),
              (32 if k > 16 else 24) * n + (4 if k > 16 else 12) * B, main)
    # the fused final level: level 2's reads (the columns below level 1's
    # counts), the records, and a row's n, c0 and rid in and count slot
    # out
    ftimed, fptimed = streams(320 * n, 4), streams(n, 4)

    def level_then_drain():
        oH, oP, cc = kn.reduce_step(H1, P1, c1, r=R)
        kn.drain_records(oH, oP, rids, cc, c0, ftimed[2], ftimed[0],
                         ftimed[1], k=K, width=OUT_CAP)
    shape("reduce_drain", FUSED_DRAIN,
          lambda: kn.reduce_drain(H1, P1, c1, rids, c0, ftimed[2], ftimed[0],
                                  ftimed[1], r=R, k=K, width=OUT_CAP),
          lambda: (fptimed[2].zero_(), kn.reduce_drain_plain(
              H1, P1, c1, rids, c0, fptimed[2], fptimed[0], fptimed[1], r=R,
              k=K, width=OUT_CAP)),
          8 * int(c1.clamp(0, CAP).sum()) + 16 * n + 24 * B, FUSED_DRAIN,
          pair=level_then_drain)
    # reduce_rows' crafted rows, three batches through one cursor
    batches = kernel_cases.reduce_drain_batches(3, B, 5000, R,
                                                kn.REDUCE_CHUNK)
    got, want = streams(3 * B * 300, 4), streams(3 * B * 300, 4)
    for Hb, Pb, nb, c0b, rb in batches:
        args = on_card(Hb.view(np.int32), Pb.view(np.int32), nb, rb, c0b)
        kn.reduce_drain(*args, got[2], got[0], got[1], r=R, k=K, width=300)
        kn.reduce_drain_plain(*args, want[2], want[0], want[1], r=R, k=K,
                              width=300)
    note("reduce_drain", list(zip(got, want)))
    for k in (K, K_WIDE):
        Cw = 300
        dt = np.int32 if k <= 16 else np.int64
        batches = kernel_cases.drain_batches(k, 3, B, Cw)
        total = sum(int(np.minimum(bt[2], Cw).sum()) for bt in batches)
        for size in (total + 40, total - 37):
            got, want = streams(size, 4), streams(size, 4)
            for a, b, cc, cc0, rd in batches:
                args = (*on_card(a.view(dt), b.view(dt), rd, cc, cc0),)
                kn.drain_records(*args, got[2], got[0], got[1], k=k,
                                 width=Cw)
                kn.drain_records_plain(*args, want[2], want[0], want[1], k=k,
                                       width=Cw)
            note("drain_records", list(zip(got, want)))
    for name in STAGE1 + FUSED:
        results[name]["shapes"] = shapes[name]
        for sh in shapes[name]:
            say(f"kernel {name} {sh['site']}: {sh['bytes']} bytes, bound "
                f"{sh['bound_ms'] * 1e3:.3f} us, kernel {sh['ms'] * 1e3:.3f}"
                f" us, {sh['share_of_bound']:.4f} of the bound, plain "
                f"{sh['plain_ms']:.4f} ms" + (
                    f", the two launches it replaces {sh['pair_ms'] * 1e3:.3f}"
                    " us" if "pair_ms" in sh else ""))
    say("kernel checks: gather_codes on E. coli-class reads at L 8192/"
        f"{MAIN_L}/24576 (strand 0 fill 4, random strands fill 7) and on "
        "the test windows on cut planes with junk after them; "
        "drain_records on the reads' final level, on random codes' level 2 "
        "three times through one cursor and on the test batches at k 16/28, "
        "streams cut short; gather_build_stream on the reads at L "
        f"{MAIN_L}/24576 and the fused windows on cut planes, reduce_drain "
        "on the reads' level 1 and on three batches of crafted rows")


def phase_wide_kernels(rng, stats, moved, kernel_cases, note, on_card,
                       results) -> None:
    """Phase 3's wide route (k=28, w=80, r=6, B=64): wide_stream on reads
    at L = 16,384 (the main shape), 24,576 and stage 4's contig batches at
    40,960, held below its counts (it leaves the columns past them stale);
    wide_emit on that stream; reduce_wide on the sketch of the main shape,
    capped at 2,048 (stage 1 without the level-0 index), uncapped with
    n ~ 370 as --with-L0-index runs both levels, and on one row of
    131,072 as stage 4's contig level; then tests/torch_kernel_cases.py's
    chunk-boundary, tie-heavy rows.  Each shape is held to the plain
    version exactly and timed, with the bytes it must move and its bound;
    results[name]["shapes"] lists them."""
    import torch

    from peregrine_tpu_torch.ops import kernels as kn

    B = 64
    shapes = {name: [] for name in WIDE + ("reduce_wide_drain",)}

    def shape(name, site, rows, L, fn, plain, nbytes, main=None,
              pairs=zip):
        got, want = fn(), plain()
        note(name, pairs(got, want))
        ms, pms = kernel_ms(fn), plain_ms(plain)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        shapes[name].append({
            "site": site, "B": rows, "L": L, "bytes": nbytes, "ms": ms,
            "plain_ms": pms, "bound_ms": bound_ms,
            "share_of_bound": bound_ms / ms})
        if main is not None:
            stats[name]["times"][main] = (ms, pms)
            moved[name] = nbytes
        return want

    level = None
    for L in (MAIN_L, 24576, 40960):
        codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
        codes[rng.random((B, L)) < 0.001] = 4
        lens = rng.integers(int(0.8 * L), L + 1, B).astype(np.int32)
        c, ln, rd = on_card(codes, lens, np.arange(B, dtype=np.int64))
        site = "contig batch" if L == 40960 else "read bucket"
        main = MAIN_L if L == MAIN_L else None
        # codes, lengths and rids in; the kept entries' 20 bytes and the
        # counts out
        kept = int(kn.wide_stream_compact_plain(c, ln, rd, K_WIDE)[3].sum())
        sx, sy, sl, n = shape(
            "wide_stream", site, B, L,
            lambda: kn.wide_stream(c, ln, rd, k=K_WIDE),
            lambda: kn.wide_stream_compact_plain(c, ln, rd, K_WIDE),
            B * L + 20 * kept + 16 * B, main, pairs=stream_pairs)
        emit, = shape(
            "wide_emit", site, B, L,
            lambda: (kn.wide_emit(sx, sl, n, w=W, k=K_WIDE),),
            lambda: (kn.wide_emit_plain(sx, sl, n, W, K_WIDE),),
            12 * int(n.sum()) + B * L + 4 * B, main)
        if L == MAIN_L:
            (ox, oy), cnt = kn.compact_planes_plain(emit, (sx, sy), (-1, -1))
            level = (ox, oy, cnt)

    def reduce_bytes(n, C):
        return 16 * int(n.clamp(0, C).sum()) + 16 * n.numel() * C + 8 * n.numel()

    ox, oy, cnt = level
    # the step's level 1 reads the capped sketch in place, its count
    # unclamped
    capped = (ox[:, :CAP], oy[:, :CAP], cnt)
    LONG = 131072
    xl = rng.integers(0, 2**64, (1, LONG), dtype=np.uint64)
    yl = np.sort(rng.integers(0, 2**31, (1, LONG)), axis=1).astype(np.uint64)
    long_row = tuple(on_card(xl.view(np.int64), (yl << np.uint64(1)).view(
        np.int64), np.array([LONG], np.int32)))
    level1 = {}
    for site, (x, y, n), main in (
            ("level 1, capped, in place", capped, None),
            ("level 1, uncapped", level, WIDE_LEVEL),
            ("contig level", long_row, None)):
        C = x.shape[1]
        want = shape("reduce_wide", site, x.shape[0], C,
                     lambda: kn.reduce_wide(x, y, n, r=R),
                     lambda: kn.reduce_wide_plain(x, y, n, R),
                     reduce_bytes(n, C), main)
        if site != "contig level":  # level 2 reads level 1's output
            level1[site] = x2, y2, n2 = want
            shape("reduce_wide", site.replace("1", "2").replace(
                ", in place", ""), B, C,
                  lambda: kn.reduce_wide(x2, y2, n2, r=R),
                  lambda: kn.reduce_wide_plain(x2, y2, n2, R),
                  reduce_bytes(n2, C))

    def streams(n_rec, rows):
        return (torch.full((n_rec, 2), 7, dtype=torch.int64, device="cuda"),
                torch.full((4, 2, rows), -5, dtype=torch.int32,
                           device="cuda"),
                torch.zeros(3, dtype=torch.int64, device="cuda"))

    # the fused final level at the step's two shapes: level 2 of the
    # uncapped level 1 (--with-L0-index, phase 6: every record kept) and
    # of the capped one (out_cap columns), each held to its plain version
    # and to reduce_wide followed by drain_records exactly and timed
    # against that pair; kernel_ms' launches (at most 301) append to one
    # stream, the count slots past 4 not written
    for site, (x, y, n), width, main in (
            ("level 2, uncapped", level1["level 1, uncapped"], MAIN_L,
             WIDE_DRAIN),
            ("level 2, capped", level1["level 1, capped, in place"],
             OUT_CAP, None)):
        rows, C = x.shape
        c0 = n + 7
        n_rec = int(kn.reduce_wide_plain(x, y, n, R)[2].clamp(
            max=width).sum())
        got, want, pair = (streams(n_rec, rows) for _ in range(3))
        kn.reduce_wide_drain(x, y, n, c0, got[2], got[0], got[1], r=R,
                             width=width)
        kn.reduce_wide_drain_plain(x, y, n, c0, want[2], want[0], want[1],
                                   r=R, width=width)
        ox, oy, oc = kn.reduce_wide(x, y, n, r=R)
        kn.drain_records(ox, oy, None, oc, c0, pair[2], pair[0], pair[1],
                         k=K_WIDE, width=width)
        note("reduce_wide_drain", list(zip(got, want)) + list(zip(got, pair)))
        timed, ptimed, qtimed = (streams(320 * n_rec, rows), streams(
            n_rec, rows), streams(320 * n_rec, rows))

        def level_then_drain():
            lx, ly, lc = kn.reduce_wide(x, y, n, r=R)
            kn.drain_records(lx, ly, None, lc, c0, qtimed[2], qtimed[0],
                             qtimed[1], k=K_WIDE, width=width)
        ms = kernel_ms(lambda: kn.reduce_wide_drain(
            x, y, n, c0, timed[2], timed[0], timed[1], r=R, width=width))
        pms = plain_ms(lambda: (ptimed[2].zero_(), kn.reduce_wide_drain_plain(
            x, y, n, c0, ptimed[2], ptimed[0], ptimed[1], r=R, width=width)))
        # x, y below n in; the records out; n and c0 in and the two count
        # words out a row; the cursor's two words in and out
        nbytes = (16 * int(n.clamp(0, C).sum()) + 16 * n_rec + 16 * rows
                  + 32)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        shapes["reduce_wide_drain"].append({
            "site": f"{site}, width {width}", "B": rows, "L": C,
            "records": n_rec, "bytes": nbytes, "ms": ms, "plain_ms": pms,
            "bound_ms": bound_ms, "share_of_bound": bound_ms / ms,
            "pair_ms": kernel_ms(level_then_drain)})
        if main is not None:
            stats["reduce_wide_drain"]["times"][main] = (ms, pms)
            moved["reduce_wide_drain"] = nbytes

    # rows that put lengths, runs, placeholders, final windows, counts and
    # window winners on the chunk boundaries
    for L in (kn.CHUNK - 1, kn.CHUNK + 1, MAIN_L):
        for k in (17, K_WIDE):
            codes, lens = kernel_cases.wide_compact_codes(rng, B, L, k,
                                                          kn.CHUNK)
            c, ln, rd = on_card(codes, lens, rng.integers(
                0, 2**40, B).astype(np.int64))
            note("wide_stream", stream_pairs(
                kn.wide_stream(c, ln, rd, k=k),
                kn.wide_stream_compact_plain(c, ln, rd, k)))
        for w in (1, 2, 3, 5, 31, 32, 33, 79, W, 81, 255):
            for ties in (False, True):
                sx, sl, n = kernel_cases.wide_emit_stream(
                    rng, B, L, w, K_WIDE, kn.CHUNK, ties)
                sx, sl, n = on_card(sx.view(np.int64), sl, n)
                note("wide_emit", [(kn.wide_emit(sx, sl, n, w=w, k=K_WIDE),
                                    kn.wide_emit_plain(sx, sl, n, w,
                                                       K_WIDE))])
    WC = kn.REDUCE_WIDE_CHUNK
    batches = []
    for L in (WC - 1, WC + 1, 5000):
        for r in (2, R, 255):
            for ties in (False, True):
                x, y, n = kernel_cases.wide_reduce_rows(rng, B, L, r, WC,
                                                        ties)
                x, y, n = on_card(x.view(np.int64), y.view(np.int64), n)
                note("reduce_wide", zip(kn.reduce_wide(x, y, n, r=r),
                                        kn.reduce_wide_plain(x, y, n, r)))
                if L == 5000:  # three batches through one cursor
                    batches.append((x, y, n))
    got, want = streams(6 * 300 * B, B), streams(6 * 300 * B, B)
    for x, y, n in batches[:6]:
        for run, fn in ((got, kn.reduce_wide_drain),
                        (want, kn.reduce_wide_drain_plain)):
            fn(x, y, n, n + 3, run[2], run[0], run[1], r=R, width=300)
    note("reduce_wide_drain", list(zip(got, want)))
    torch.cuda.synchronize()
    check(not any(bool(pair[0].any()) for pair in kn._status_pairs.values()),
          "the next chunked launch's look-back status is not zeroed")
    for name, rows in shapes.items():
        results[name]["shapes"] = rows
        for sh in rows:
            say(f"kernel {name} {sh['site']} B={sh['B']} L={sh['L']}: "
                f"{sh['bytes']} bytes, bound {sh['bound_ms'] * 1e3:.3f} us, "
                f"kernel {sh['ms'] * 1e3:.3f} us, {sh['share_of_bound']:.4f} "
                f"of the bound, plain {sh['plain_ms']:.4f} ms" + (
                    f", the two launches it replaces {sh['pair_ms'] * 1e3:.3f}"
                    " us" if "pair_ms" in sh else ""))
    say(f"kernel checks: wide_stream on the chunk-boundary rows at L "
        f"{kn.CHUNK - 1}/{kn.CHUNK + 1}/{MAIN_L}, k 17/{K_WIDE}; wide_emit "
        f"at w 1/2/3/5/31/32/33/79/{W}/81/255 with and without ties; "
        f"reduce_wide at L "
        f"{WC - 1}/{WC + 1}/5000, r 2/{R}/255 with and without ties; "
        "reduce_wide_drain on both level-2 shapes and on six batches of "
        "the L=5000 rows through one cursor")


def align_shapes(kernel_cases):
    """Phase 3's aligner inputs, as (label, packed seqdb on the card,
    request columns): the main shape (1,024 E. coli-class read pairs:
    reads of 15 kb +- 1.5 kb, both strands, 1% error); the crafted lanes
    of tests/torch_kernel_cases.py at the 15 kb read length (one lane at
    aln_max_len; windows at every word offset); and the crafted lanes at
    1.5 kb with lanes that run past the data's end, on planes cut to the
    data that start one byte past a word and are followed by junk (the
    kernel must read the clamped last byte, never the junk)."""
    import torch

    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops.dbgather import PackedSeqDB, upload_seqdb

    rng = np.random.default_rng(7)
    out = []
    for label, (seqs, cols) in (
            ("main", kernel_cases.myers_requests(rng, 1024, READ_LEN, 1500,
                                                 0.01)),
            ("crafted", kernel_cases.myers_lanes(rng, READ_LEN,
                                                 ALN_MAX_LEN))):
        db = SeqDB.from_reads([(str(i), q) for i, q in enumerate(seqs)])
        out.append((label, upload_seqdb(db.data, "cuda"),
                    torch.from_numpy(cols).cuda()))
    seqs, cols = kernel_cases.myers_lanes(rng, 1500, 4096)
    cols = np.concatenate([cols, kernel_cases.myers_past_end_lanes(seqs)])
    fw, amb, nf, na = kernel_cases.plane_end_planes(seqs, junk=4096, seed=7)

    def view(a, n):
        return torch.from_numpy(np.concatenate([[0xA5], a]).astype(
            np.uint8)).cuda()[1:1 + n]
    out.append(("plane_end", PackedSeqDB(fw=view(fw, nf), amb=view(amb, na)),
                torch.from_numpy(cols).cuda()))
    return out


def phase_align(results: dict) -> None:
    """pg_myers_align against its plain version on the card, exactly, on
    align_shapes' inputs, each with its operation bound and the plain
    time."""
    from peregrine_tpu_torch.ops import device_align as da

    shapes = []
    for label, pdb, c in align_shapes(load_kernel_cases()):
        cols = c.cpu().numpy()
        got = da.myers_batch_db(pdb, c)
        a, b = _events()
        a.record()
        want = da.myers_batch_db_plain(pdb, c)
        b.record()
        b.synchronize()
        pms = a.elapsed_time(b)
        err = max_err(zip(got, want))
        ms = kernel_ms(lambda: da.myers_batch_db(pdb, c), n=20)
        columns = int(np.clip(cols[:, 5], 0, None).sum())
        bound_ms = myers_bound_ms(cols)
        shapes.append({"site": label, "lanes": len(cols),
                       "lane_columns": columns, "max_abs_err": err,
                       "ms": ms, "plain_ms": pms, "bound_ms": bound_ms,
                       "share_of_bound": bound_ms / ms})
        say(f"kernel myers_align {label} lanes B={len(cols)}, {columns} "
            f"lane-columns: max_abs_err {err} (tolerance 0) on dist, q_end "
            f"and t_end; bound {bound_ms * 1e3:.3f} us "
            f"({MYERS_OPS_PER_COLUMN} int32 operations a lane-column at "
            f"{INT32_OPS_PER_S / 1e12:.2f} Tops/s), kernel "
            f"{ms * 1e3:.3f} us a launch, {bound_ms / ms:.4f} of the bound, "
            f"plain {pms:.1f} ms")
        check(err == 0, f"myers_align disagrees with its plain version on "
              f"the {label} lanes (max_abs_err {err})")
    main = shapes[0]
    results["myers_align"] = {
        "max_abs_err": max(sh["max_abs_err"] for sh in shapes),
        "ms": main["ms"], "plain_ms": main["plain_ms"],
        "bound_ms": main["bound_ms"], "bound_by": "operations",
        "library_ms": None, "bound_us": main["bound_ms"] * 1e3,
        "share_of_bound": main["share_of_bound"], "shapes": shapes}


def phase_index(reads, genome) -> None:
    import torch

    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB, seq_to_codes
    from peregrine_tpu_torch.ops.index import build_index
    from peregrine_tpu_torch.ops.reduce import reduce_flat_np
    from peregrine_tpu_torch.ops.sketch import sketch_long_np

    torch.set_num_threads(os.cpu_count() or 1)
    # k=28: uncapped with the level-0 index, capped (the cap/out_cap
    # slicing), and capped at w=8, whose density 2/9 overflows the cap of
    # pad/8 so that every batch takes _retry_exact
    for n, k, w, keep_l0 in ((512, K, W, False), (256, K_WIDE, W, True),
                             (256, K_WIDE, W, False), (64, K_WIDE, 8, False)):
        db = SeqDB.from_reads(reads[:n])
        cfg = AsmConfig(k=k, w=w)
        t0 = time.time()
        on_card = build_index(db, cfg, "cuda", keep_l0=keep_l0)
        t1 = time.time()
        on_host = build_index(db, cfg, "cpu", keep_l0=keep_l0)
        t2 = time.time()
        pairs = zip(on_card, on_host) if keep_l0 else [(on_card, on_host)]
        for level, (a, b) in zip(("L2", "L0"), pairs):
            for f in ("x", "y", "mc_hash", "mc_count"):
                check(np.array_equal(getattr(a, f), getattr(b, f)),
                      f"build_index k={k} w={w} cuda != cpu on {level} .{f}")
        n_rec = len((on_card[0] if keep_l0 else on_card).x)
        say(f"index check: build_index k={k} w={w} of {n} reads"
            f"{' with the level-0 index' if keep_l0 else ''}, {n_rec} "
            f"SHIMMERs, cuda == cpu ({t1 - t0:.2f} s on the card, "
            f"{t2 - t1:.2f} s cpu)")
    # fetch groups of three batches of four reads: at k=28, w=8 the
    # second batch of the first group (and both of the second bucket)
    # overflow their caps and are retried, the others are sliced from the
    # group's stream; each build's launch counts are held to its trace
    from torch.profiler import ProfilerActivity, profile

    from peregrine_tpu_torch.ops import index, kernels as kn
    small = SeqDB.from_reads(load_kernel_cases().stage1_reads())
    group = index.FETCH_GROUP
    index.FETCH_GROUP = 3
    try:
        for k, w, keep_l0 in ((K, 24, False), (K_WIDE, 8, False),
                              (K_WIDE, 24, True)):
            cfg = AsmConfig(k=k, w=w, r=4, levels=2, sketch_pad_len=8192,
                            sketch_batch=4)
            index.reset_stats()
            kn.reset_launches()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                on_card = build_index(small, cfg, "cuda", keep_l0=keep_l0)
                torch.cuda.synchronize()
            stats = dict(index.STATS)
            check_traced_launches(
                device_trace(prof),
                {fn.__name__: fn.launches for fn in kn.KERNELS},
                f"grouped build_index k={k} w={w}"
                f"{' with the level-0 index' if keep_l0 else ''}")
            on_host = build_index(small, cfg, "cpu", keep_l0=keep_l0)
            pairs = (zip(on_card, on_host) if keep_l0
                     else [(on_card, on_host)])
            for a, b in pairs:
                for f in ("x", "y", "mc_hash", "mc_count"):
                    check(np.array_equal(getattr(a, f), getattr(b, f)),
                          f"grouped build_index k={k} w={w} cuda != cpu on "
                          f".{f}")
            check(stats["replays"] == 6 and stats["group_fetches"] == 3
                  and stats["retried_batches"] == (3 if w == 8 else 0),
                  f"grouped build_index k={k} w={w}: {stats}")
            say(f"index check: build_index k={k} w={w}"
                f"{' with the level-0 index' if keep_l0 else ''} of 22 "
                f"reads in fetch groups of 3 batches of 4: {stats['replays']}"
                f" replays, {stats['group_fetches']} group fetches, "
                f"{stats['retried_batches']} batches retried, cuda == cpu")
    finally:
        index.FETCH_GROUP = group
    codes = seq_to_codes(genome[:200_000])
    for k in (K, K_WIDE):
        xg, yg = sketch_long_np(codes, 3, W, k, "cuda")
        xc, yc = sketch_long_np(codes, 3, W, k, "cpu")
        check(np.array_equal(xg, xc) and np.array_equal(yg, yc),
              f"sketch_long_np k={k} cuda != cpu")
        n0 = len(xg)
        for _ in range(2):  # the contig index's levels: one long row each
            xg, yg = reduce_flat_np(xg, yg, R, "cuda")
            xc, yc = reduce_flat_np(xc, yc, R, "cpu")
            check(np.array_equal(xg, xc) and np.array_equal(yg, yc),
                  f"reduce_flat_np k={k} cuda != cpu")
        say(f"index check: sketch_long_np k={k} of a 200 kb slice, {n0} "
            f"minimizers, and two reduce_flat_np levels, {len(xg)} "
            "SHIMMERs, cuda == cpu")


def phase_stage2_inputs(reads) -> None:
    """Phase 4, stage 2's device inputs on the E. coli-class reads: the
    segmented index build on the card, with a budget that forces at least
    9 segments, equals the one-shot build; the device pair map on the
    card equals the host pair map and bucket stream."""
    import torch

    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops.device_pairs import build_pairs_device
    from peregrine_tpu_torch.ops.index import (build_index,
                                               build_index_segmented)
    from peregrine_tpu_torch.ops.overlap import bucket_stream, build_pairs

    db = SeqDB.from_reads(reads)
    cfg = AsmConfig()
    t0 = time.time()
    one = build_index(db, cfg, "cuda")
    t1 = time.time()
    # every segment holds at most budget bytes, so there are at least 9
    budget = db.data.nbytes // 9
    seg = build_index_segmented(db, cfg, "cuda", budget)
    t2 = time.time()
    for f in ("x", "y", "mc_hash", "mc_count"):
        check(np.array_equal(getattr(seg, f), getattr(one, f)),
              f"segmented build_index != one build on .{f}")
    say(f"index check: build_index_segmented of {len(db)} reads on the card "
        f"in segments of <= {budget} bytes (of {db.data.nbytes}), "
        f"{len(seg.x)} SHIMMERs, equals one build ({t2 - t1:.2f} s against "
        f"{t1 - t0:.2f} s)")
    gates = (cfg.mc_lower, cfg.mc_upper, cfg.min_anchor_dist)
    torch.cuda.synchronize()
    t0 = time.time()
    pairs, stream = build_pairs_device(one, db.lengths, "cuda", *gates,
                                       cfg.ovlp_upper)
    t1 = time.time()
    hp = build_pairs(one, db.lengths, 1, 1, *gates)
    hs = bucket_stream(hp[0], hp[1], hp[2], hp[4], cfg.ovlp_upper)
    t2 = time.time()
    for i, (a, b) in enumerate(zip(pairs + stream, hp + hs)):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"build_pairs_device on cuda != the host build, array {i}")
    say(f"pairs check: build_pairs_device on the card equals build_pairs + "
        f"bucket_stream: {len(pairs[0])} pair records, {len(stream[0])} "
        f"stream entries ({t1 - t0:.2f} s on the card, host "
        f"{t2 - t1:.2f} s)")


def upload_split(st: dict) -> str:
    """An uploader's stats (ops/dbgather.py) as one line."""
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in st.items())


def phase_uploader(reads) -> None:
    """Phase 4, the stage-0 seqdb uploader on the card: fed the phase-5
    seqdb in build_to_disk's chunks of 1 << 22 bases, and in chunks of
    4,096 with a ragged tail, it gives upload_seqdb's planes; the reads
    hold no ambiguous base, so the amb plane is elided and zero."""
    import torch

    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops import dbgather as dg

    db = SeqDB.from_reads(reads)
    data = np.asarray(db.data)
    check(len(data) % 4096 != 0, "the seqdb has no ragged tail")
    want = dg.upload_seqdb(data, "cuda")
    torch.cuda.synchronize()
    say(f"uploader check: upload_seqdb of {len(data)} bases: "
        + upload_split(dg.LAST_STATS))
    for chunk in (1 << 22, 4096):
        t = time.perf_counter()
        up = dg.SeqDBUploader("cuda", est_bases=len(data))
        for i in range(0, len(data), chunk):
            up.feed(data[i:i + chunk])
        got = up.finish()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        amb_bytes = -(-(dg.GUARD_BASES + len(data)) // 8)
        check(torch.equal(got.fw, want.fw) and torch.equal(got.amb, want.amb),
              f"uploader in chunks of {chunk} != upload_seqdb")
        check(up.stats["elided_bytes"] == amb_bytes and not got.amb.any(),
              f"uploader in chunks of {chunk}: the amb plane was not elided "
              f"({up.stats['elided_bytes']} of {amb_bytes} bytes)")
        say(f"uploader check: fed in {up.stats['chunks']} chunks of {chunk} "
            f"bases, planes fw {tuple(got.fw.shape)} amb "
            f"{tuple(got.amb.shape)} == upload_seqdb's, amb elided and zero "
            f"({wall:.3f} s): " + upload_split(up.stats))


def smi(fields: str) -> str:
    return subprocess.run(["nvidia-smi", f"--query-gpu={fields}",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def plain_kernels():
    """Route the index modules' kernel calls to the plain PyTorch versions
    (on the card's tensors) for as long as the block runs.  Stage 1's batch
    step then runs eagerly, as it runs on the CPU: the plain versions sync
    the host, which a CUDA graph's capture forbids."""
    import torch

    from peregrine_tpu_torch.ops import index, kernels as kn, reduce, sketch
    plain = {
        "build_stream": lambda c, ln, *, k: kn.build_stream_plain(c, ln, k),
        "move_plane": kn.move_plane_plain,
        "emit_mask": lambda h, p, n, *, w, k: kn.emit_mask_plain(h, p, n, w, k),
        "reduce_step": lambda h, p, n, *, r: kn.reduce_step_plain(h, p, n, r),
        "compact_planes": kn.compact_planes_plain,
        "wide_stream": lambda c, ln, rd, *, k: kn.wide_stream_compact_plain(
            c, ln, rd, k),
        "wide_emit": lambda sx, sl, n, *, w, k: kn.wide_emit_plain(sx, sl, n,
                                                                   w, k),
        "reduce_wide": lambda x, y, c, *, r: kn.reduce_wide_plain(x, y, c, r),
        "gather_codes": kn.gather_codes_plain,
        "drain_records": kn.drain_records_plain,
        "gather_build_stream": lambda pdb, g, ln, L, *, k:
            kn.gather_build_stream_plain(pdb, g, ln, L, k),
        "reduce_drain": kn.reduce_drain_plain,
        "reduce_wide_drain": kn.reduce_wide_drain_plain,
    }
    saved = [(m, name, getattr(m, name)) for m in (index, reduce, sketch)
             for name in plain if hasattr(m, name)]
    step_run = index._Stage1Step.run

    def eager_run(step, meta, part):
        # run()'s branch for a step off the card: _body on the batch's rows
        device, step.device = step.device, torch.device("cpu")
        try:
            return step_run(step, meta, part)
        finally:
            step.device = device
    for m, name, _ in saved:
        setattr(m, name, plain[name])
    index._Stage1Step.run = eager_run
    try:
        yield
    finally:
        for m, name, fn in saved:
            setattr(m, name, fn)
        index._Stage1Step.run = step_run


def device_trace(prof) -> list:
    """The device intervals (kernels, copies, memsets) of a profiler run."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(any(e["cat"] == "kernel" for e in dev),
          "the profiler trace holds no device kernel")
    return dev


def check_traced_launches(dev, launches: dict, label: str) -> None:
    """Hold the wrappers' launch counts to the device: each SHIMMER
    kernel must appear in the trace `dev` as often as its wrapper counted.
    A captured stage-1 step adds the launches its graph holds on each
    replay, so this shows that the replays ran them."""
    traced_n = {name: sum(1 for e in dev if e["cat"] == "kernel"
                          and traced(name, e["name"]))
                for name in REPLACES}
    counted = {name: launches[name] for name in REPLACES}
    check(traced_n == counted, f"{label}: the wrappers counted {counted}, "
          f"the trace holds {traced_n}")
    # stage 1's step runs the fused pair at k=16 (no level-0 stream, so no
    # drain_records); at k > 16 the gather alone and the fused final level
    if any(traced_n[n] for n in FUSED + STAGE1 + WIDE_STEP):
        want, absent = ((FUSED, STAGE1 + WIDE_STEP) if "k=16" in label
                        else (WIDE_STEP, FUSED))
        check(all(traced_n[n] for n in want)
              and not any(traced_n[n] for n in absent),
              f"{label}: the trace holds {traced_n}, not {want} without "
              f"{absent}")
    say(f"launch check: {label}: each kernel's count equals its launches in "
        f"the trace ({sum(traced_n.values())} launches)")


def busy_ms(events) -> float:
    """Length of the union of [ts, ts + dur) over trace events, in ms."""
    total, end = 0.0, float("-inf")
    for ev in sorted(events, key=lambda e: e["ts"]):
        a, b = ev["ts"], ev["ts"] + ev.get("dur", 0)
        if b > end:
            total += b - max(a, end)
            end = b
    return total / 1000


def phase_index_profile(reads, k: int) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops import dbgather as dg, index, kernels as kn
    from peregrine_tpu_torch.ops.index import build_index

    torch.set_num_threads(os.cpu_count() or 1)
    db = SeqDB.from_reads(reads)
    cfg = AsmConfig(k=k)
    say(f"index profile: k={k}")
    # upload_seqdb's split: its first call meets the card first (CUDA
    # context creation lands in the worker's init_s), the second runs
    # under the profiler for the device time of its copies and memsets
    upload = {}
    for run_ in ("first", "profiled"):
        with (profile(activities=[ProfilerActivity.CUDA]) if run_ ==
              "profiled" else contextlib.nullcontext()) as prof:
            t = time.perf_counter()
            packed = dg.upload_seqdb(db.data, "cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
        upload[run_] = {"wall_s": wall, **dg.LAST_STATS}
        if prof is not None:  # copies, memsets and fill kernels (zeros)
            dev = device_trace(prof)
            for kind in ("gpu_memcpy", "gpu_memset", "FillFunctor"):
                ev = [e for e in dev
                      if e["cat"] == kind or kind in e["name"]]
                upload[run_][f"{kind}_ms"] = sum(e["dur"] for e in ev) / 1000
                upload[run_][f"{kind}_n"] = len(ev)
        say(f"index profile: upload_seqdb [{run_}] {wall:.4f} s: "
            + upload_split(upload[run_]))
    # the uploader as stage 0 feeds it, in build_to_disk's chunks
    t = time.perf_counter()
    up = dg.SeqDBUploader("cuda", est_bases=len(db.data))
    for i in range(0, len(db.data), 1 << 22):
        up.feed(db.data[i:i + (1 << 22)])
    t_fin = time.perf_counter()
    fed = up.finish()
    fin_s = time.perf_counter() - t_fin
    torch.cuda.synchronize()
    upload["uploader"] = {"wall_s": time.perf_counter() - t,
                          "finish_wait_s": fin_s, **up.stats}
    check(torch.equal(fed.fw, packed.fw) and torch.equal(fed.amb, packed.amb),
          "the uploader's planes != upload_seqdb's")
    del fed
    say(f"index profile: SeqDBUploader fed in chunks of 1 << 22 bases: first "
        f"feed to the end of finish() {up.stats['feed_to_finish_s']:.4f} s, "
        f"finish() waited {fin_s:.4f} s: "
        + upload_split(up.stats))
    pack_s = upload["profiled"]["pack_s"]
    upload_s = upload["profiled"]["wall_s"]

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        idx = build_index(db, cfg, "cuda", packed=packed)
        torch.cuda.synchronize()
        return time.perf_counter() - t, idx

    # one warm-up build per route, then PROFILE_PAIRS pairs in ABBA order;
    # every build's records equal the first's
    walls = {"kernel": [], "plain": []}
    first = None
    order = ["kernel", "plain"] + ["kernel", "plain", "plain", "kernel"] * (
        PROFILE_PAIRS // 2)
    for i, route in enumerate(order):
        with plain_kernels() if route == "plain" else contextlib.nullcontext():
            wall, idx = run()
        if i >= 2:
            walls[route].append(wall)
        if first is None:
            first = idx
        check(np.array_equal(idx.x, first.x) and np.array_equal(idx.y, first.y),
              f"routes disagree on the records ({len(idx.x)} [{route}], "
              f"{len(first.x)} [kernel])")
        say(f"index profile: build_index [{route}{'' if i >= 2 else ', warm-up'}]"
            f" {wall:.4f} s, {len(idx.x)} SHIMMERs | "
            f"{smi('name,power.limit,clocks.sm')}")
    for route, ws in walls.items():
        say(f"index profile: build_index [{route}] median {np.median(ws):.4f} s,"
            f" min {min(ws):.4f} s, max {max(ws):.4f} s over {len(ws)} runs")

    # the host's split of one build
    index.reset_stats()
    split_wall, _ = run()
    split = {key: (dict(v) if isinstance(v, dict) else
                   list(v) if isinstance(v, list) else v)
             for key, v in index.STATS.items()}
    host = split["host_s"]
    say(f"index profile: host split of one build ({split_wall:.4f} s): "
        + ", ".join(f"{part} {sec * 1e3:.2f} ms" for part, sec in
                    sorted(host.items(), key=lambda kv: -kv[1]))
        + f"; rest {(split_wall - sum(host.values())) * 1e3:.2f} ms; "
        f"{split['replays']} replays "
        f"({host.get('replays', 0) / max(1, split['replays']) * 1e6:.1f} us "
        f"each, metas {host.get('metas', 0) / max(1, split['replays']) * 1e6:.1f}"
        f" us), {split['group_fetches']} group fetches, "
        f"{split['retried_batches']} batches retried; graph pools "
        f"{split['graph_pool_bytes']} bytes")

    kn.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, _ = run()
    launches = {fn.__name__: fn.launches for fn in kn.KERNELS}
    dev = device_trace(prof)
    check_traced_launches(dev, launches, f"the profiled k={k} build")
    per: dict = {}
    count: dict = {}
    for e in dev:
        key = e["name"] if e["cat"] == "kernel" else e["cat"]
        per[key] = per.get(key, 0.0) + e["dur"] / 1000
        count[key] = count.get(key, 0) + 1
    fills = sum(c for key, c in count.items() if "FillFunctor" in key)
    ours = {name: sum(ms for key, ms in per.items() if traced(name, key))
            for name in REPLACES}
    busy = busy_ms(dev)
    copies = sum(per.get(c, 0.0) for c in ("gpu_memcpy", "gpu_memset"))
    other = sum(per.values()) - sum(ours.values()) - copies
    say(f"index profile: profiled build_index wall {wall * 1000:.1f} ms; "
        f"device busy {busy:.1f} ms (union of {len(dev)} device intervals); "
        f"idle share {1 - busy / (wall * 1000):.4f}")
    say("index profile: device ms by kernel: " + ", ".join(
        f"{name} {ms:.2f} ({launches[name]} launches"
        + (f", {ms / launches[name] * 1e3:.2f} us each)" if launches[name]
           else ")")
        for name, ms in ours.items())
        + f"; other kernels {other:.2f}; copies and memsets {copies:.2f}; "
        f"{sum(count.values())} device intervals, {fills} of them fill "
        "kernels")
    for key, ms in sorted(per.items(), key=lambda kv: -kv[1])[:24]:
        say(f"    {ms:9.3f} ms {count[key]:6d}x  {key[:100]}")
    # each kernel's launches by template instance and grid, which tell its
    # shapes apart (compact_planes: <8, 8, 0> the wide sketch's output and
    # the uncapped reduction levels)
    by_grid: dict = {}
    for e in dev:
        name = next((n for n in REPLACES if traced(n, e["name"])), None)
        if e["cat"] == "kernel" and name:
            inst = re.search(r"_kernel(<[^>]*>)", e["name"])
            cell = by_grid.setdefault(name, {}).setdefault(
                (inst.group(1) + " " if inst else "")
                + str(e.get("args", {}).get("grid")), [0, 0.0])
            cell[0] += 1
            cell[1] += e["dur"]
    for name, grids in by_grid.items():
        say(f"index profile: {name} by grid: " + ", ".join(
            f"{grid} {n}x {us / n:.2f} us" for grid, (n, us) in grids.items()))
    say(json.dumps({"index_profile": {
        "walls_s": walls, "records": len(first.x), "profiled_wall_ms":
        wall * 1000, "device_busy_ms": busy, "kernels_ms": ours,
        "other_kernels_ms": other, "copies_ms": copies,
        "device_intervals": sum(count.values()), "fill_launches": fills,
        "launches": launches, "by_grid": by_grid, "pack_s": pack_s,
        "upload_s": upload_s, "upload": upload, "split_wall_s": split_wall,
        "host_split_s": host, "replays": split["replays"],
        "group_fetches": split["group_fetches"],
        "graph_pool_bytes": split["graph_pool_bytes"]}}))


def index_profile_abba(parent: str, k: int, out_dir: str) -> None:
    """`--index-profile` of the checkout `parent` and of this one in
    turns, parent, change, change, parent, each in its own process from
    its own tree (each builds its kernels); each run's output goes to
    out_dir/index-profile-k{k}-{i}-{tree}.log and its summary is
    printed, then one JSON line of the four."""
    os.makedirs(out_dir, exist_ok=True)
    runs = []
    for i, (label, tree) in enumerate((("parent", parent), ("change", ROOT),
                                       ("change", ROOT),
                                       ("parent", parent))):
        t = time.time()
        r = subprocess.run([sys.executable, "chip_smoke.py",
                            "--index-profile", "--profile-k", str(k)],
                           cwd=os.path.abspath(tree), capture_output=True,
                           text=True)
        log = os.path.join(out_dir, f"index-profile-k{k}-{i}-{label}.log")
        with open(log, "w") as f:
            f.write(r.stdout + r.stderr)
        check(r.returncode == 0, f"--index-profile of {tree} returned "
              f"{r.returncode}; see {log}")
        prof = _json_line(r.stdout, "index_profile")["index_profile"]
        ws = prof["walls_s"]["kernel"]
        run = {"tree": label, "k": k, "median_s": float(np.median(ws)),
               "min_s": min(ws), "max_s": max(ws),
               "plain_median_s": float(np.median(prof["walls_s"]["plain"])),
               "device_busy_ms": prof["device_busy_ms"],
               "device_intervals": prof["device_intervals"],
               "fill_launches": prof["fill_launches"],
               "idle_share": 1 - prof["device_busy_ms"]
               / prof["profiled_wall_ms"],
               "host_split_s": prof.get("host_split_s"),
               "graph_pool_bytes": prof.get("graph_pool_bytes"),
               "launches": prof["launches"],
               "kernels_us": {name: ms * 1e3 / prof["launches"][name]
                              for name, ms in prof["kernels_ms"].items()
                              if prof["launches"].get(name)},
               "process_s": time.time() - t}
        runs.append(run)
        say(f"index profile abba k={k} [{i} {label}]: median "
            f"{run['median_s']:.4f} s (min {run['min_s']:.4f}, max "
            f"{run['max_s']:.4f}; plain {run['plain_median_s']:.4f}), device "
            f"busy {run['device_busy_ms']:.2f} "
            f"ms, {run['device_intervals']} device intervals "
            f"({run['fill_launches']} fills), idle share "
            f"{run['idle_share']:.4f}")
        for line in r.stdout.splitlines():
            if ("host split" in line or "seqdb pack" in line
                    or "launch check" in line or "by kernel" in line
                    or "by grid" in line):
                say("    " + line)
    say(json.dumps({"index_profile_abba": runs}))


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


def agreement(seq: bytes, genome: bytes) -> float:
    """Share of seq's 21-mers that occur in the circular genome or its
    reverse complement."""
    from peregrine_tpu_torch.io.seqdb import revcomp
    g = genome + genome[:READ_LEN]  # k-mers across the circular origin
    ref = np.unique(np.concatenate([kmers21(g), kmers21(revcomp(g))]))
    km = kmers21(seq.upper())
    return float(np.isin(km, ref).mean()) if len(km) else 0.0


def launch_counts() -> dict:
    """Each kernel wrapper's launch count, by kernel name."""
    from peregrine_tpu_torch.ops import device_align as da, kernels as kn
    counts = {fn.__name__: fn.launches for fn in kn.KERNELS}
    counts["myers_align"] = da.myers_batch_db.launches
    return counts


def reset_launches() -> None:
    from peregrine_tpu_torch.ops import device_align as da, kernels as kn
    kn.reset_launches()
    da.myers_batch_db.launches = 0


def ovl_pairs(path: str) -> set:
    """The read-id pairs of a preads.ovl file."""
    with open(path) as f:
        return {tuple(sorted(map(int, ln.split()[:2]))) for ln in f
                if not ln.startswith("-")}


@contextlib.contextmanager
def stage_log():
    """The package's log records for as long as the block runs: yields
    (walls, messages), the stage walls by stage name (the records'
    `stage_wall`) and every message."""
    walls, messages = {}, []

    class Records(logging.Handler):
        def emit(self, record):
            messages.append(record.getMessage())
            if hasattr(record, "stage_wall"):
                walls[record.stage_wall[0]] = record.stage_wall[1]

    handler = Records()
    logging.getLogger("peregrine_tpu_torch").addHandler(handler)
    try:
        yield walls, messages
    finally:
        logging.getLogger("peregrine_tpu_torch").removeHandler(handler)


def run_asm(lst: str, out: str, flags: list, label: str, stages: tuple):
    """`pg-tpu-torch asm` through cli.main with every launch count zeroed
    just before and read just after; returns (walls, launches, total)."""
    import torch

    from peregrine_tpu_torch import cli

    with stage_log() as (walls, _):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.time()
        rc = cli.main(["asm", lst, "--output", out] + flags)
        torch.cuda.synchronize()
        total = time.time() - t0
        launches = launch_counts()
    check(rc == 0, f"{label}: asm returned {rc}")
    say(f"{label}: `asm {' '.join(flags)}` stage walls " + ", ".join(
        f"{s} {walls[s]:.2f} s" for s in stages if s in walls)
        + f"; asm total {total:.2f} s")
    say(f"{label}: kernel launches {json.dumps(launches)}; peak device "
        f"memory {torch.cuda.max_memory_allocated() / (1 << 30):.3f} GiB")
    return walls, launches, total


def check_stage0_planes(out: str, walls: dict, messages: list,
                        label: str) -> None:
    """Stage 0 of the run into `out` started the seqdb uploader and stage
    1 built on its planes (the stage log says both), and its 1-index
    files equal, byte for byte, an index built on the same seqdb by
    build_index from upload_seqdb's planes; prints the seqdb and index
    walls and finish()'s wait."""
    import filecmp

    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops.dbgather import upload_seqdb
    from peregrine_tpu_torch.ops.index import build_index

    started = [m for m in messages if "seqdb upload to cuda" in m]
    took = [m for m in messages if "took the stage-0 seqdb planes" in m]
    check(len(started) == 1 and len(took) == 1,
          f"{label}: stage 0 did not start the uploader, or stage 1 did not "
          f"take its planes ({started}, {took})")
    note = took[0].split("seqdb planes: ")[1].split(";")[0]
    with open(os.path.join(out, "config.json")) as f:
        cfg = AsmConfig.from_json(f.read())
    db = SeqDB.open(os.path.join(out, "0-seqdb", "seq_dataset"))
    ref = os.path.join(out, "ref-index")
    build_index(db, cfg, "cuda", packed=upload_seqdb(db.data, "cuda")).save(
        ref, level=cfg.levels)
    for kind in ("", "MC-"):
        name = f"L{cfg.levels}-{kind}01-of-01.dat"
        check(filecmp.cmp(os.path.join(out, "1-index", f"shmr-{name}"),
                          f"{ref}-{name}", shallow=False),
              f"{label}: 1-index/shmr-{name} != the index built from "
              "upload_seqdb's planes")
    say(f"{label}: stage 1 took the stage-0 seqdb planes; seqdb "
        f"{walls['seqdb']:.3f} s, index {walls['index']:.3f} s; {note}; "
        "1-index/*.dat == build_index from upload_seqdb's planes")


def phase_draft(lst: str, genome, wd: str, results: dict):
    """Phase 5, the k=16 draft; returns its longest contig's agreement
    and the read pairs of its preads.ovl."""
    from peregrine_tpu_torch.io import formats
    from peregrine_tpu_torch.io.seqdb import read_fastx

    out = os.path.join(wd, "asm")
    with stage_log() as (walls, messages):
        _, launches, _ = run_asm(lst, out, [], "draft path",
                                 ("seqdb", "index", "overlap", "layout"))
    DIGESTS["phase5"] = output_digests(out)
    check_stage0_planes(out, walls, messages, "draft path")
    for name in ("gather_build_stream", "move_plane", "emit_mask",
                 "reduce_step", "reduce_drain"):
        check(launches[name] > 0,
              f"kernel {name} was not launched by the draft path")
        results[name]["launches"] = launches[name]
    # the fused pair in place of the gather, the build and the drain
    for name in STAGE1 + ("build_stream", "reduce_wide_drain"):
        check(launches[name] == 0,
              f"the draft path launched {name} {launches[name]} times")
    # one batch step a sketch: one fused gather, one level-1 reduce_step
    # and one fused final level with the drain
    check(launches["gather_build_stream"] == launches["reduce_step"]
          == launches["reduce_drain"],
          f"draft path: {launches['reduce_step']} level-1 reductions and "
          f"{launches['reduce_drain']} fused drains for "
          f"{launches['gather_build_stream']} sketches")
    # two-plane moves, two per sketch; the reduction levels move nothing
    check(launches["move_plane"] == 2 * launches["gather_build_stream"],
          f"move_plane launched {launches['move_plane']} times for "
          f"{launches['gather_build_stream']} sketches, not twice per sketch")
    x, _ = formats.read_mmlist(os.path.join(out, "1-index",
                                            "shmr-L2-01-of-01.dat"))
    with open(os.path.join(out, "2-ovlp", "preads.ovl"), "rb") as f:
        n_ovl = sum(1 for ln in f if not ln.startswith(b"-"))
    ctgs = [s for _, s in read_fastx(os.path.join(out, "3-asm", "p_ctg.fa"))]
    say(f"draft path: {len(x)} SHIMMERs, {n_ovl} overlap rows, {len(ctgs)} "
        "contigs")
    check(len(ctgs) > 0, "no contigs")
    longest = max(ctgs, key=len)
    cover = len(longest) / len(genome)
    frac = agreement(longest, genome)
    say(f"draft path: longest contig {len(longest)} b = {cover:.4f} of the "
        f"genome; {frac:.6f} of its 21-mers are in the genome")
    check(cover >= 0.9, f"longest contig covers {cover:.4f} < 0.9 of the genome")
    check(frac >= 0.7, f"21-mer agreement {frac:.4f} < 0.7")
    return frac, ovl_pairs(os.path.join(out, "2-ovlp", "preads.ovl"))


@contextlib.contextmanager
def aligner_rounds(rounds: list, calls: list):
    """Record each device alignment call of stage 2 for as long as the
    block runs: its lanes, their target columns, and its time on the card
    (CUDA events around the launch with its request upload and result
    copies) and on the host clock in `rounds`; its seqdb, requests and
    outputs in `calls`."""
    from peregrine_tpu_torch.ops import overlap as ov
    align = ov._align_lanes

    def timed(seqdb_dev, cols):
        a, b = _events()
        t = time.perf_counter()
        a.record()
        out = align(seqdb_dev, cols)
        b.record()
        b.synchronize()
        rounds.append({"lanes": len(cols), "lane_columns": int(
            np.clip(cols[:, 5], 0, None).sum()) if len(cols) else 0,
            "device_ms": a.elapsed_time(b),
            "host_ms": (time.perf_counter() - t) * 1e3})
        calls.append((seqdb_dev, cols.copy(), out))
        return out

    ov._align_lanes = timed
    try:
        yield
    finally:
        ov._align_lanes = align


def myers_bound_ms(cols) -> float:
    """pg_myers_align's operation bound for request columns: each lane
    runs its own t_len columns."""
    columns = int(np.clip(cols[:, 5], 0, None).sum())
    return columns * MYERS_OPS_PER_COLUMN / INT32_OPS_PER_S * 1e3


def trace_myers(calls) -> list:
    """Replay stage 2's device alignment calls, after the run, one launch
    each under torch.profiler: the kernel's device milliseconds from the
    trace, beside its operation bound, at the main path's shapes."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from peregrine_tpu_torch.ops import device_align as da

    out = []
    for pdb, cols, _ in calls:
        c = torch.from_numpy(cols).cuda()
        da.myers_batch_db(pdb, c)   # warm
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            da.myers_batch_db(pdb, c)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        ms = sum(e["dur"] for e in events if e.get("ph") == "X"
                 and e.get("cat") == "kernel"
                 and "myers_align_kernel" in e["name"]) / 1000
        timed_by = "trace"
        if ms == 0:
            # the profiler can drop a launch from its trace: time it back
            # to back with CUDA events instead
            say(f"the profiler trace holds no myers_align kernel at "
                f"{len(cols)} lanes; timing it with CUDA events")
            ms = kernel_ms(lambda: da.myers_batch_db(pdb, c), n=5)
            timed_by = "events"
        bound = myers_bound_ms(cols)
        out.append({"lanes": len(cols), "lane_columns": int(
            np.clip(cols[:, 5], 0, None).sum()), "trace_ms": ms,
            "timed_by": timed_by, "bound_ms": bound,
            "share_of_bound": bound / ms})
    return out


def check_launch_sample(calls, label: str, n: int = 1024) -> dict:
    """Hold the path's largest device alignment call to the plain version:
    a seeded sample of n of its lanes, whose outputs from the run's own
    launch must equal myers_batch_db_plain on the card on the same request
    rows, exactly; then a kernel launch and the plain version timed on the
    sample alone."""
    import torch

    from peregrine_tpu_torch.ops import device_align as da

    pdb, cols, got = max(calls, key=lambda call: len(call[1]))
    rng = np.random.default_rng(len(cols))
    rows = np.sort(rng.choice(len(cols), min(n, len(cols)), replace=False))
    c = torch.from_numpy(cols[rows]).cuda()
    a, b = _events()
    a.record()
    want = da.myers_batch_db_plain(pdb, c)
    b.record()
    b.synchronize()
    pms = a.elapsed_time(b)
    err = max_err(zip((torch.from_numpy(g[rows]).cuda() for g in got), want))
    ms = kernel_ms(lambda: da.myers_batch_db(pdb, c), n=20)
    bound = myers_bound_ms(cols[rows])
    say(f"{label}: {len(rows)} of the {len(cols)} lanes of its largest "
        f"launch: max_abs_err {err} (tolerance 0) on dist, q_end and t_end "
        f"against the plain version; on the sample alone kernel "
        f"{ms * 1e3:.3f} us a launch, bound {bound * 1e3:.3f} us, "
        f"{bound / ms:.4f} of the bound, plain {pms:.1f} ms")
    check(err == 0, f"{label}: myers_align's launch disagrees with its "
          f"plain version (max_abs_err {err})")
    return {"site": f"{label}, {len(rows)} of the {len(cols)} lanes of its "
            "largest launch", "lanes": len(rows), "launch_lanes": len(cols),
            "max_abs_err": err, "ms": ms, "plain_ms": pms, "bound_ms": bound,
            "share_of_bound": bound / ms}


def phase_device_overlap(lst: str, genome, wd: str, draft, label: str,
                         flags: list, trace: bool = False):
    """Phases 7 and 8: the draft with stage 2 on the card.  The largest
    launch's lanes equal the plain version's on a sample; one contig of
    0.99-1.02 of the genome whose 21-mer share is within 0.01 of the
    phase-5 draft's, and preads.ovl read pairs with a Jaccard index above
    0.9 against phase 5's (the device aligner's optimal distances differ
    from the host aligner's greedy ones, so the files are not identical);
    returns the aligner's launches, each device call's record, the
    sample's check, with `trace` each launch's profiled time, and the
    device calls (seqdb, request columns, outputs)."""
    from peregrine_tpu_torch.io.seqdb import read_fastx

    draft_frac, draft_pairs = draft
    out = os.path.join(wd, label.replace(" ", "-"))
    rounds: list = []
    calls: list = []
    with aligner_rounds(rounds, calls):
        walls, launches, _ = run_asm(lst, out, flags, label,
                                     ("seqdb", "index", "overlap", "layout"))
    check(launches["myers_align"] > 0,
          f"kernel myers_align was not launched by the {label}")
    DIGESTS["phase7" if trace else "phase8"] = output_digests(out)
    sample = check_launch_sample(calls, label)
    dev_ms = sum(r["device_ms"] for r in rounds)
    say(f"{label}: {len(rounds)} device alignment calls, lanes "
        f"{[r['lanes'] for r in rounds]}, device ms (launch, upload and "
        f"copies) {[round(r['device_ms'], 3) for r in rounds]}, host ms "
        f"{[round(r['host_ms'], 3) for r in rounds]}; {dev_ms:.1f} ms on "
        f"the card of the {walls['overlap'] * 1e3:.0f} ms overlap stage")
    traced = trace_myers(calls) if trace else []
    for t in traced:
        say(f"{label}: myers_align traced at B={t['lanes']} lanes, "
            f"{t['lane_columns']} lane-columns: {t['trace_ms']:.3f} ms, bound "
            f"{t['bound_ms']:.3f} ms, {t['share_of_bound']:.4f} of the bound")
    pairs = ovl_pairs(os.path.join(out, "2-ovlp", "preads.ovl"))
    jac = len(pairs & draft_pairs) / max(len(pairs | draft_pairs), 1)
    ctgs = [s for _, s in read_fastx(os.path.join(out, "3-asm", "p_ctg.fa"))]
    say(f"{label}: {len(pairs)} overlap read pairs, Jaccard {jac:.4f} "
        f"against the draft path's {len(draft_pairs)}; {len(ctgs)} contigs")
    check(len(ctgs) == 1, f"{label}: {len(ctgs)} contigs, not one")
    cover = len(ctgs[0]) / len(genome)
    frac = agreement(ctgs[0], genome)
    say(f"{label}: contig {len(ctgs[0])} b = {cover:.4f} of the genome; "
        f"{frac:.6f} of its 21-mers are in the genome (draft path "
        f"{draft_frac:.6f})")
    check(0.99 <= cover <= 1.02, f"{label}: the contig covers {cover:.4f} "
          "of the genome, outside 0.99-1.02")
    check(abs(frac - draft_frac) <= 0.01, f"{label}: 21-mer agreement "
          f"{frac:.6f} is more than 0.01 from the draft's {draft_frac:.6f}")
    check(jac > 0.9, f"{label}: overlap pair Jaccard {jac:.4f} <= 0.9")
    return launches["myers_align"], rounds, sample, traced, calls


def phase_consensus(lst: str, genome, wd: str, results: dict,
                    draft_frac: float) -> None:
    """Phase 6, k=28 with the level-0 index and consensus."""
    from peregrine_tpu_torch.io import formats
    from peregrine_tpu_torch.io.seqdb import read_fastx

    out = os.path.join(wd, "asm-k28-cns")
    flags = ["--shimmer-k", str(K_WIDE), "--with-L0-index",
             "--with-consensus"]
    _, launches, _ = run_asm(
        lst, out, flags, "consensus path",
        ("seqdb", "index", "overlap", "layout", "ctg_index", "mapping",
         "consensus"))
    for name in ("compact_planes",) + WIDE + STAGE1 + WIDE_STEP:
        check(launches[name] > 0,
              f"kernel {name} was not launched by the consensus path")
        results[name]["launches"] = launches[name]
    for name in FUSED:  # k=28: the gather alone, reduce_wide_drain
        check(launches[name] == 0,
              f"the consensus path launched {name} {launches[name]} times")
    # one batch step a gather: one fused final level, and a drain_records
    # of the level-0 stream (and of any retried batch)
    check(launches["gather_codes"] == launches["reduce_wide_drain"]
          <= launches["drain_records"],
          f"consensus path: {launches['reduce_wide_drain']} fused final "
          f"levels and {launches['drain_records']} level-0 drains for "
          f"{launches['gather_codes']} gathers")
    DIGESTS["phase6"] = output_digests(out)
    n = {lv: len(formats.read_mmlist(os.path.join(
        out, "1-index", f"shmr-L{lv}-01-of-01.dat"))[0]) for lv in (0, 2)}
    with open(os.path.join(out, "4-cns", "read_map.txt"), "rb") as f:
        n_map = sum(1 for _ in f)
    draft = [s for _, s in read_fastx(os.path.join(out, "3-asm", "p_ctg.fa"))]
    ctgs = [s for _, s in read_fastx(os.path.join(out, "4-cns",
                                                  "p_ctg_cns.fa"))]
    say(f"consensus path: {n[0]} level-0 minimizers, {n[2]} SHIMMERs, "
        f"{len(draft)} draft contigs, {n_map} mapping rows, {len(ctgs)} "
        "polished contigs")
    check(len(ctgs) > 0, "no polished contigs")
    longest = max(ctgs, key=len)
    cover = len(longest) / len(genome)
    frac = agreement(longest, genome)
    say(f"consensus path: longest polished contig {len(longest)} b = "
        f"{cover:.4f} of the genome; {frac:.6f} of its 21-mers are in the "
        f"genome (k=16 draft: {draft_frac:.6f})")
    check(cover >= 0.9, f"longest polished contig covers {cover:.4f} < 0.9")
    check(frac >= 0.95, f"polished 21-mer agreement {frac:.4f} < 0.95")
    check(frac > draft_frac, f"polished 21-mer agreement {frac:.4f} is not "
          f"above the draft's {draft_frac:.4f}")


@contextlib.contextmanager
def counted(module, name: str, calls: dict):
    """Count calls of module.name in calls[name] for as long as the block
    runs."""
    fn = getattr(module, name)
    calls[name] = 0

    def wrapper(*a, **kw):
        calls[name] += 1
        return fn(*a, **kw)

    setattr(module, name, wrapper)
    try:
        yield
    finally:
        setattr(module, name, fn)


def cli_out(argv: list) -> list:
    """`pg-tpu-torch` through cli.main; its stdout lines."""
    import io

    from peregrine_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    check(rc == 0, f"`{' '.join(argv[:1])}` returned {rc}")
    return buf.getvalue().splitlines()


def pieces_of(start: int, end: int, n_pieces: int) -> set:
    """The reference pieces that a read from [start, end) of the wrapped
    genome overlaps, its positions taken modulo the genome length."""
    a, b = start % GENOME // PIECE, (end - 1) % GENOME // PIECE
    return set(range(a, b + 1)) if a <= b else (
        set(range(a, n_pieces)) | set(range(b + 1)))


def phase_rest(lst: str, genome, truth, wd: str) -> dict:
    """Phase 9, the rest of the CLI and the API on the card: the genome
    cut into PIECE-long pieces as a seqdb (`seqdb`), its index through the
    batched long route on cuda and cpu, `map` of the phase-5 reads
    against it, `dump-index` and `stats` on phase 5's workdir, `gather-mc`
    on split MC files, the API's sketch and cluster consensus on cuda and
    cpu, Assembly.run under profile_dir, and verify_fasta of phase 6's
    polished contig.  Returns the phase's walls and counts."""
    import torch

    from peregrine_tpu_torch import api, verify
    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io import formats
    from peregrine_tpu_torch.io.seqdb import SeqDB, revcomp
    from peregrine_tpu_torch.ops import sketch
    from peregrine_tpu_torch.ops.index import build_index
    from peregrine_tpu_torch.pipeline.run import Assembly
    from peregrine_tpu_torch.simdata import mutate, write_reads

    out = {}
    asm = os.path.join(wd, "asm")  # phase 5's workdir
    label = "rest of the CLI"
    pieces = [(f"piece{i:03d}", genome[s:s + PIECE])
              for i, s in enumerate(range(0, len(genome), PIECE))]
    ref_lst, ref = os.path.join(wd, "ref.lst"), os.path.join(wd, "ref")
    write_reads(pieces, os.path.join(wd, "ref.fa"), ref_lst)
    t0 = time.time()
    cli_out(["seqdb", ref_lst, ref])
    ref_db = SeqDB.open(ref)
    check(len(ref_db) == len(pieces), f"seqdb holds {len(ref_db)} pieces")
    say(f"{label}: `seqdb` of {len(pieces)} pieces of {PIECE} b in "
        f"{time.time() - t0:.2f} s")

    # the reference index: every piece takes the long route
    calls: dict = {}
    cfg = AsmConfig()
    with counted(sketch, "sketch_batch", calls):
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.time()
        on_card = build_index(ref_db, cfg, "cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = launch_counts()
        on_card_calls = calls["sketch_batch"]
        t0 = time.time()
        on_host = build_index(ref_db, cfg, "cpu")
        host_wall = time.time() - t0
    for f in ("x", "y", "mc_hash", "mc_count"):
        check(np.array_equal(getattr(on_card, f), getattr(on_host, f)),
              f"the reference index on cuda != cpu on .{f}")
    want_calls = -(-len(pieces) // sketch.LONG_BATCH)
    say(f"{label}: reference index of {len(pieces)} pieces, "
        f"{len(on_card.x)} SHIMMERs, cuda == cpu: {wall:.4f} s on the card "
        f"({host_wall:.2f} s cpu), {on_card_calls} sketch_batch calls "
        f"(ceil({len(pieces)} / {sketch.LONG_BATCH}) = {want_calls}); "
        f"launches {json.dumps(launches)}")
    check(on_card_calls == want_calls, "the long route made "
          f"{on_card_calls} sketch_batch calls, not {want_calls}")
    check(launches["build_stream"] > 0, "the long route launched no "
          "build_stream")
    out["ref_index"] = {"pieces": len(pieces), "wall_s": wall,
                        "cpu_wall_s": host_wall,
                        "sketch_batch_calls": on_card_calls,
                        "launches": launches}

    # map the phase-5 reads against the pieces
    rows_path = os.path.join(wd, "map.txt")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    cli_out(["map", ref, os.path.join(asm, "0-seqdb", "seq_dataset"),
             "--device", "cuda", "--output", rows_path])
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    for name in ("build_stream", "move_plane", "emit_mask", "reduce_step"):
        check(launches[name] > 0, f"kernel {name} was not launched by map")
    rows = np.loadtxt(rows_path, dtype=np.int64, ndmin=2)
    on_piece: dict = {}
    for ref_id, read_id in rows[:, [0, 3]]:
        on_piece.setdefault(int(read_id), set()).add(int(ref_id))
    right = sum(bool(ids & pieces_of(truth[r][0], truth[r][1], len(pieces)))
                for r, ids in on_piece.items())
    share = right / max(len(on_piece), 1)
    say(f"{label}: `map` of {len(truth)} reads against the pieces: "
        f"{len(rows)} rows, {len(on_piece)} reads mapped, {share:.4f} of "
        f"them with a row on a piece overlapping their origin; {wall:.2f} s;"
        f" launches {json.dumps(launches)}")
    check(share >= 0.95, f"map: {share:.4f} < 0.95 of mapped reads land on "
          "their origin's pieces")
    out["map"] = {"rows": len(rows), "mapped_reads": len(on_piece),
                  "on_origin_share": share, "wall_s": wall,
                  "launches": launches}

    # the host verbs on phase 5's workdir
    dat = os.path.join(asm, "1-index", "shmr-L2-01-of-01.dat")
    dump = cli_out(["dump-index", dat, "--limit", "5"])
    x, y = formats.read_mmlist(dat)
    check(dump[0].split() == [str(int(x[0]) >> 8), str(int(x[0]) & 0xFF),
                              str(int(y[0]) >> 32),
                              str((int(y[0]) & 0xFFFFFFFF) >> 1),
                              str(int(y[0]) & 1)] and len(dump) == 5,
          f"dump-index printed {dump[:1]}")
    stats = cli_out(["stats", asm])
    check(len(stats) == 3 and stats[0].startswith(f"seqdb: {len(truth)} "),
          f"stats printed {stats}")
    mc = os.path.join(asm, "1-index", "shmr-L2-MC-01-of-01.dat")
    h, c = formats.read_mm_count(mc)
    parts = []
    for i in range(2):
        parts.append(os.path.join(wd, f"split-MC-{i + 1:02d}-of-02.dat"))
        formats.write_mm_count(parts[-1], h[i::2], c[i::2])
    merged = os.path.join(wd, "merged-MC-all.dat")
    gather = cli_out(["gather-mc", *parts, "--output", merged])
    with open(mc, "rb") as a, open(merged, "rb") as b:
        check(a.read() == b.read(), "gather-mc of the split MC files is not "
              "the MC file")
    say(f"{label}: `dump-index --limit 5` {dump[0]!r}; `stats`: "
        + " | ".join(stats) + f"; `gather-mc`: {gather[0]}, equal to the MC "
        "file it was split from")

    # the API on the card against the cpu
    reset_launches()
    seq = genome[:20_000]
    for levels in (0, 1, 2):
        a = api.get_shimmers_from_seq(seq, rid=3, levels=levels,
                                      device="cuda")
        b = api.get_shimmers_from_seq(seq, rid=3, levels=levels, device="cpu")
        check(all(np.array_equal(u, v) for u, v in zip(a, b)) and len(a[0]),
              f"get_shimmers_from_seq levels={levels}: cuda != cpu")
    rng = np.random.default_rng(3)
    template = genome[100_000:103_000]
    cluster = [template] + [mutate(rng, template, 0.02) for _ in range(8)]
    cluster = [s if i % 2 == 0 else revcomp(s) for i, s in enumerate(cluster)]
    t0 = time.time()
    cns = api.get_cns_from_reads(cluster, device="cuda")
    wall = time.time() - t0
    launches = launch_counts()
    check(cns == api.get_cns_from_reads(cluster, device="cpu"),
          "get_cns_from_reads: cuda != cpu")
    for name in ("build_stream", "move_plane", "emit_mask", "reduce_step"):
        check(launches[name] > 0, f"kernel {name} was not launched by api")
    say(f"{label}: api get_shimmers_from_seq (levels 0-2 of 20 kb) and "
        f"get_cns_from_reads (9 reads of 3 kb, {len(cns)} b, {wall:.2f} s)"
        f" on cuda == cpu; launches {json.dumps(launches)}")

    # Assembly.run under the profiler: the trace names the kernels
    run_wd, prof = os.path.join(wd, "asm-profiled"), os.path.join(wd, "prof")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.time()
    fa = Assembly(run_wd, cfg, device="cuda", profile_dir=prof).run(
        reads_list=lst, with_consensus=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = launch_counts()
    with open(fa, "rb") as a, open(os.path.join(asm, "3-asm", "p_ctg.fa"),
                                   "rb") as b:
        check(a.read() == b.read(), "the profiled run's p_ctg.fa differs "
              "from phase 5's")
    traces = [os.path.join(prof, f) for f in os.listdir(prof)
              if f.endswith(".pt.trace.json")]
    check(len(traces) == 1, f"{len(traces)} traces in the profile directory")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    named = {name: sum(traced(name, k) for k in kernels) for name in
             ("gather_build_stream", "move_plane", "emit_mask",
              "reduce_step", "reduce_drain")}
    say(f"{label}: Assembly(profile_dir=).run(with_consensus=False) "
        f"{wall:.2f} s, the same p_ctg.fa as phase 5; trace "
        f"{os.path.getsize(traces[0])} bytes, {len(events)} events, "
        f"{len(kernels)} device kernels, of them {json.dumps(named)}; "
        f"launches {json.dumps(launches)}")
    for name, n in named.items():
        check(n > 0, f"the trace names no {name} kernel")
    out["profiled_run"] = {"wall_s": wall, "trace_bytes": os.path.getsize(
        traces[0]), "events": len(events), "kernels": len(kernels),
        "named": named}

    # verify_fasta of phase 6's polished contig: the verifier re-aligns
    # every mismatch region exactly, which a draft at ~1% error stalls
    t0 = time.time()
    res = verify.verify_fasta(os.path.join(wd, "asm-k28-cns", "4-cns",
                                           "p_ctg_cns.fa"), genome)
    wall = time.time() - t0
    check(len(res) > 0 and all(r["anchored"] for r in res),
          "verify_fasta anchored no contig")
    best = max(res, key=lambda r: r["length"])
    say(f"{label}: verify_fasta of phase 6's {len(res)} polished "
        f"contig(s): the "
        f"longest {best['length']} b, exact edit distance "
        f"{best['distance']}, identity {best['identity']:.6f}, "
        f"{best['breaks']} breaks; {wall:.2f} s")
    check(best["identity"] >= 0.99, f"verify_fasta identity "
          f"{best['identity']:.4f} < 0.99")
    out["verify"] = {"length": best["length"], "distance": best["distance"],
                     "identity": best["identity"], "wall_s": wall}
    return out


MESH_SHARDS = 4   # phase 10's in-process mesh: four shards on cuda:0
SUBSET = 256      # reads whose shards phase 10 also builds on the cpu
MH_TIMEOUT = 300  # seconds a phase-10 subprocess may take
# one gloo rank of run_multihost, shared with the multi-process tests
WORKER = os.path.join(ROOT, "tests", "torch_multihost_worker.py")


def _same_files(a: str, b: str, rels) -> None:
    for rel in rels:
        with open(os.path.join(a, rel), "rb") as fa, \
                open(os.path.join(b, rel), "rb") as fb:
            check(fa.read() == fb.read(), f"{rel} of {b} differs from {a}'s")


def _same_index(a, b, what: str) -> None:
    for f in ("x", "y", "mc_hash", "mc_count"):
        check(np.array_equal(getattr(a, f), getattr(b, f)),
              f"{what}: {f} differs")


def _counted(label: str, fn, kernels):
    """fn() with every launch count zeroed just before and read just
    after; each named kernel must have launched.  Returns (result, wall
    s, launches)."""
    import torch
    torch.cuda.synchronize()
    reset_launches()
    t = time.time()
    out = fn()
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = launch_counts()
    for name in kernels:
        check(launches[name] > 0, f"{label}: kernel {name} was not launched")
    say(f"{label}: {wall:.3f} s; launches {json.dumps(launches)}")
    return out, wall, launches


def _run_ranks(cmds, env, label: str) -> list:
    """Start each command at once, wait for all (killing any left at the
    timeout); returns their outputs, each run having exited 0."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env,
                              cwd=ROOT) for c in cmds]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MH_TIMEOUT)[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode:
            # on stderr, whose end is what a failed run shows
            print(o[-4000:], file=sys.stderr, flush=True)
        check(p.returncode == 0, f"{label}: process {r} exited "
              f"{p.returncode}")
    return outs


def _json_line(out: str, key: str) -> dict:
    for ln in out.splitlines():
        if ln.startswith("{") and key in ln:
            return json.loads(ln)
    check(False, f"no JSON line with {key} in the output")


def phase_mesh(lst: str, wd: str, calls) -> dict:
    """Phase 10, the multi-device paths on the E. coli-class set, over an
    in-process mesh of MESH_SHARDS shards on cuda:0 (the smoke needs one
    card): build_index_mesh equal to build_index on the card (k=16 and
    k=28), each shard of SUBSET reads equal to the cpu mesh's, the pair
    map over the mesh equal to the host's, sharded_align of a seeded
    1,024-lane sample of phase 7's largest launch equal to myers_batch_db;
    then Assembly over the mesh with cfg.mesh, overlap_chunk_device with
    shard_overlap, `asm --multihost` at world size 1 over NCCL, and
    run_multihost with the consensus on two gloo ranks sharing the card
    against world size 1.  Returns the phase's walls, launches and
    shares."""
    import socket

    import torch

    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops import device_align as da
    from peregrine_tpu_torch.ops.index import ShimmerIndex, build_index
    from peregrine_tpu_torch.ops.overlap import (bucket_stream, build_pairs,
                                                 overlap_chunk_device,
                                                 ovlps_to_text)
    from peregrine_tpu_torch.parallel.mesh import Mesh
    from peregrine_tpu_torch.parallel.sharded_index import (
        build_index_mesh, sharded_index_host)
    from peregrine_tpu_torch.parallel import sharded_overlap as so
    from peregrine_tpu_torch.parallel.sharded_overlap import (shard_seqdb,
                                                             sharded_align)
    from peregrine_tpu_torch.parallel.sharded_pairs import build_pairs_mesh
    from peregrine_tpu_torch.pipeline.run import Assembly

    t_phase = time.time()
    label = "mesh paths"
    mesh = Mesh(["cuda:0"] * MESH_SHARDS)
    cpu_mesh = Mesh(["cpu"] * MESH_SHARDS)
    asm = os.path.join(wd, "asm")  # phase 5's workdir
    db = SeqDB.open(os.path.join(asm, "0-seqdb", "seq_dataset"))
    res: dict = {"shards": MESH_SHARDS, "walls_s": {}, "launches": {}}
    walls, launches = res["walls_s"], res["launches"]
    packed4 = ("build_stream", "move_plane", "emit_mask", "reduce_step")

    # 10.1: the sharded functions, k=16 then k=28
    sub = np.arange(SUBSET)
    pad = -(-int(db.lengths[sub].max()) // 8192) * 8192
    codes, lens = db.padded_code_batch(sub, pad)
    for k, kernels in ((K, packed4), (K_WIDE, ("compact_planes",) + WIDE)):
        cfg = AsmConfig(k=k)
        got, walls[f"index_mesh_k{k}"], launches[f"index_mesh_k{k}"] = \
            _counted(f"{label}: build_index_mesh k={k}",
                     lambda: build_index_mesh(db, cfg, mesh), kernels)
        t = time.time()
        one = build_index(db, cfg, "cuda")
        walls[f"index_one_k{k}"] = time.time() - t
        _same_index(got, one, f"build_index_mesh k={k}")
        step = dict(w=cfg.w, k=k, r=cfg.r, levels=cfg.levels)
        shards = sharded_index_host(mesh, codes, lens, sub, **step)
        want = sharded_index_host(cpu_mesh, codes, lens, sub, **step)
        for d, ((gx, gy), (wx, wy)) in enumerate(zip(shards, want)):
            check(np.array_equal(gx, wx) and np.array_equal(gy, wy),
                  f"k={k} shard {d} of {SUBSET} reads differs from the cpu's")
        say(f"{label}: k={k}: {len(got.x)} SHIMMERs == build_index on the "
            f"card ({walls[f'index_one_k{k}']:.3f} s); {SUBSET} reads' "
            f"shards of {[len(x) for x, _ in shards]} records == the cpu "
            "mesh's")
        if k == K:
            idx16 = one
    cfg = AsmConfig()
    gates = (cfg.mc_lower, cfg.mc_upper, cfg.min_anchor_dist)
    t = time.time()
    pairs = build_pairs_mesh(idx16, db.lengths, mesh, *gates, cfg.ovlp_upper)
    walls["pairs_mesh"] = time.time() - t
    t = time.time()
    hp = build_pairs(idx16, db.lengths, 1, 1, *gates)
    hs = bucket_stream(hp[0], hp[1], hp[2], hp[4], cfg.ovlp_upper)
    walls["pairs_host"] = time.time() - t
    for i, (a, b) in enumerate(zip(pairs[0] + pairs[1], hp + hs)):
        check(a.dtype == b.dtype and np.array_equal(a, b),
              f"build_pairs_mesh [{i}] differs from the host build")
    say(f"{label}: build_pairs_mesh {len(pairs[0][0])} records, stream "
        f"{len(pairs[1][0])} == the host build ({walls['pairs_mesh']:.3f} s "
        f"against {walls['pairs_host']:.3f} s)")
    pdb, cols, _ = max(calls, key=lambda call: len(call[1]))
    rng = np.random.default_rng(len(cols))
    c = cols[np.sort(rng.choice(len(cols), min(1024, len(cols)),
                                replace=False))]
    q_rid = np.searchsorted(db.offsets, c[:, 1])
    t_rid = np.searchsorted(db.offsets, c[:, 4])
    L = -(-int(max(c[:, 2].max(), c[:, 5].max())) // 8192) * 8192
    sdb = shard_seqdb(db.data, db.offsets, db.lengths, mesh)
    got, walls["sharded_align"], launches["sharded_align"] = _counted(
        f"{label}: sharded_align of {len(c)} phase-7 lanes",
        lambda: sharded_align(sdb, q_rid, c[:, 0], c[:, 2], c[:, 3], t_rid,
                              c[:, 4], c[:, 5], c[:, 6], L=L),
        ("myers_align",))
    want = da.myers_batch_db(pdb, torch.from_numpy(c).cuda())
    for a, b in zip(got, want):
        check(np.array_equal(a, b.cpu().numpy()),
              "sharded_align differs from myers_batch_db")
    res["align_lanes"] = len(c)

    # 10.2: Assembly over the mesh, 10.3: overlap_chunk_device sharded
    draft_fa = os.path.join(asm, "3-asm", "p_ctg.fa")
    out = os.path.join(wd, "mesh-asm")
    _, walls["asm_mesh"], launches["asm_mesh"] = _counted(
        f"{label}: Assembly(mesh=) run_draft with cfg.mesh",
        lambda: Assembly(out, AsmConfig(mesh=True), device="cuda",
                         mesh=mesh).run_draft(reads_list=lst), packed4)
    _same_files(asm, out, ("1-index/shmr-L2-01-of-01.dat",
                           "2-ovlp/preads.ovl", "3-asm/p_ctg.fa"))
    idx = ShimmerIndex.load_chunks(
        [os.path.join(asm, "1-index", "shmr-L2-01-of-01.dat")],
        [os.path.join(asm, "1-index", "shmr-L2-MC-01-of-01.dat")])
    acfg = AsmConfig(use_device_aligner=True)
    n_calls: dict = {}
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    with counted(so, "sharded_align", n_calls):
        sharded, walls["overlap_sharded"], launches["overlap_sharded"] = \
            _counted(f"{label}: overlap_chunk_device with shard_overlap",
                     lambda: ovlps_to_text(overlap_chunk_device(
                         db, idx, acfg.replace(shard_overlap=True), "cuda",
                         mesh=mesh)), ("myers_align",))
    res["overlap_sharded_calls"] = n_calls["sharded_align"]
    res["overlap_sharded_peak_gb"] = (torch.cuda.max_memory_allocated()
                                      - held) / 1e9
    say(f"{label}: {n_calls['sharded_align']} sharded_align calls, device "
        f"memory peak {res['overlap_sharded_peak_gb']:.3f} GB above the "
        f"{held / 1e9:.3f} GB held before")
    t = time.time()
    single = ovlps_to_text(overlap_chunk_device(db, idx, acfg, "cuda"))
    walls["overlap_one"] = time.time() - t
    check(sharded == single and len(single) > 0,
          "overlap_chunk_device with shard_overlap differs from unsharded")
    res["overlap_rows"] = len(single)

    # 10.4: `asm --multihost` at world size 1 over NCCL
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, RANK="0", WORLD_SIZE="1",
               LOCAL_RANK="0", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    out = os.path.join(wd, "mh-nccl")
    code = ("import json, sys; from peregrine_tpu_torch import cli; "
            "from peregrine_tpu_torch.ops import kernels as kn; "
            "rc = cli.main(sys.argv[1:]); "
            "print(json.dumps({'launches': {f.__name__: f.launches "
            "for f in kn.KERNELS}})); sys.exit(rc)")
    t = time.time()
    o = _run_ranks([[sys.executable, "-c", code, "asm", lst, "--output", out,
                     "--multihost"]], env, "asm --multihost (NCCL)")[0]
    walls["multihost_nccl_ws1"] = time.time() - t
    launches["multihost_nccl_ws1"] = _json_line(o, "launches")["launches"]
    for name in packed4:
        check(launches["multihost_nccl_ws1"][name] > 0,
              f"asm --multihost: kernel {name} was not launched")
    check(any(ln.strip() == os.path.join(out, "3-asm", "p_ctg.fa")
              for ln in o.splitlines()), "asm --multihost printed no fasta "
          "path")
    _same_files(asm, out, ("2-ovlp/preads.ovl", "3-asm/p_ctg.fa"))
    say(f"{label}: asm --multihost at world size 1 over NCCL: "
        f"{walls['multihost_nccl_ws1']:.2f} s in its process, the same "
        "preads.ovl and p_ctg.fa as phase 5")

    # 10.5: run_multihost with the consensus, two gloo ranks on cuda:0,
    # against world size 1
    one = os.path.join(wd, "mh-ws1")
    _, walls["multihost_ws1"], launches["multihost_ws1"] = _counted(
        f"{label}: run_multihost(with_consensus=True) at world size 1",
        lambda: Assembly(one, AsmConfig(mesh=True), device="cuda")
        .run_multihost(lst, with_consensus=True), packed4)
    two = os.path.join(wd, "mh-gloo")
    os.makedirs(two)
    shutil.copy(lst, os.path.join(two, "reads.lst"))
    init = "file://" + os.path.join(two, "init")
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                        "MASTER_PORT")}
    t = time.time()
    env["PYTHONPATH"] = ROOT
    outs = _run_ranks([[sys.executable, WORKER, "defaults", str(r), "2", init,
                        two, "cuda"] for r in range(2)], env,
                      "run_multihost on 2 ranks")
    walls["multihost_gloo_2"] = time.time() - t
    _same_files(one, os.path.join(two, "wd"),
                ("2-ovlp/preads.ovl", "3-asm/p_ctg.fa", "4-cns/p_ctg_cns.fa"))
    shares = []
    for r, o in enumerate(outs):
        rec = _json_line(o, "launches")
        launches[f"multihost_gloo_rank{r}"] = rec["launches"]
        for name in packed4:
            check(rec["launches"][name] > 0, f"rank {r}: kernel {name} was "
                  "not launched")
        m = re.search(r"rank share: (\d+) of (\d+) round alignments", o)
        w = re.search(r"rank \d+ computed (\d+) of (\d+) windows", o)
        check(bool(m and w), f"rank {r} printed no work share")
        share = [int(m[1]) / int(m[2]), int(w[1]) / int(w[2])]
        check(min(share) >= 0.8 / 2, f"rank {r} did {share} of the round "
              "alignments and windows, below 0.8 of its fair share")
        shares.append(share)
    res["rank_shares"] = shares
    say(f"{label}: run_multihost on 2 gloo ranks sharing cuda:0 "
        f"{walls['multihost_gloo_2']:.2f} s (world size 1: "
        f"{walls['multihost_ws1']:.2f} s): the same preads.ovl, p_ctg.fa "
        f"and p_ctg_cns.fa; shares of the round alignments and windows "
        f"{shares}")
    res["phase_s"] = time.time() - t_phase
    say(f"{label}: phase 10 took {res['phase_s']:.1f} s")
    return res


SPILL_STAGES = ("overlap", "ctg_index", "mapping", "consensus")
SPILL_SAME = ("3-asm/p_ctg.fa", "4-cns/read_map.txt", "4-cns/p_ctg_cns.fa")


def phase_spill(lst: str, wd: str, db_bytes: int) -> dict:
    """Phase 11, spill mode on the card: phase 6's flags with --mem-budget
    1e6, so auto-spill engages, twice: as the disk is (the spill
    filesystem has 0.55x the seqdb bytes free, so stage 2 shares its
    pair map with stage 4), and with the free space patched to 0.4x
    (above the 0.22x preflight, below the sharing rule, so stage 4
    rebuilds the map).  Both reproduce phase 6's unspilled bytes.
    Returns each run's walls and launches."""
    from peregrine_tpu_torch.pipeline import run as prun

    res = {"db_bytes": db_bytes}
    flags = ["--shimmer-k", str(K_WIDE), "--with-L0-index",
             "--with-consensus", "--mem-budget", "1e6"]
    unspilled = os.path.join(wd, "asm-k28-cns")  # phase 6's workdir
    budget = os.environ.get("PG_MEM_BUDGET")
    free_bytes = prun._spill_free_bytes
    t_phase = time.time()
    try:
        for name, free in (("sharing", None),
                           ("not sharing", int(0.4 * db_bytes))):
            label = f"spill path, {name}"
            out = os.path.join(wd, "asm-spill-" + name.replace(" ", "-"))
            if free is not None:
                prun._spill_free_bytes = lambda d: free
            try:
                with stage_log() as (_, messages):
                    walls, launches, total = run_asm(
                        lst, out, flags, label, ("seqdb", "index")
                        + SPILL_STAGES)
            finally:
                prun._spill_free_bytes = free_bytes
            for kernel in ("compact_planes",) + WIDE + WIDE_STEP:
                check(launches[kernel] > 0,
                      f"{label}: kernel {kernel} was not launched")
            check(os.path.isdir(os.path.join(out, "spill")),
                  f"{label}: auto-spill made no {out}/spill")
            said = [m for m in messages
                    if m.startswith("overlap spill mode: ")]
            check(len(said) == 1 and said[0].startswith(
                "overlap spill mode: " + name + " the stage-2/4 pair map"),
                f"{label}: stage 2 logged {said}")
            stage2 = [m for m in messages if m.startswith("stage 2 overlap")]
            check(len(stage2) == 1 and "spill free" in stage2[0],
                  f"{label}: the stage-2 line {stage2} has no spill free")
            rebuilt = [m for m in messages
                       if m.startswith("stage 4 contig index")
                       and "the pair map is rebuilt next" in m]
            check(len(rebuilt) == (name == "not sharing"),
                  f"{label}: stage 4 rebuilt the pair map "
                  f"{len(rebuilt)} times")
            _same_files(unspilled, out, SPILL_SAME)
            say(f"{label}: {said[0]}; {stage2[0]}")
            say(f"{label}: the same p_ctg.fa, read_map.txt and "
                "p_ctg_cns.fa as phase 6 (unspilled)")
            res[name] = {"walls": {s: walls[s] for s in SPILL_STAGES},
                         "asm_s": total,
                         "launches": {kernel: launches[kernel] for kernel
                                      in ("compact_planes",) + WIDE}}
    finally:
        if budget is None:
            os.environ.pop("PG_MEM_BUDGET", None)
        else:
            os.environ["PG_MEM_BUDGET"] = budget
    shared, rebuilt = res["sharing"]["walls"], res["not sharing"]["walls"]
    say("spill path: stage 4 ctg_index + mapping "
        f"{shared['ctg_index'] + shared['mapping']:.3f} s sharing, "
        f"{rebuilt['ctg_index'] + rebuilt['mapping']:.3f} s rebuilding")
    res["phase_s"] = time.time() - t_phase
    say(f"spill path: phase 11 took {res['phase_s']:.1f} s")
    return res


# phase 12's repeat genome: tests/test_modes.py's repeat-genome test
REPEAT_N, REPEAT_SEGDUP = 900_000, (50_000, 90_000)
REPEAT_CFG = dict(k=12, w=24, r=4, levels=2, min_len=2500,
                  sketch_pad_len=8192, sketch_batch=16)
PACKED = ("gather_build_stream", "move_plane", "emit_mask", "reduce_step",
          "reduce_drain")
VERIFY_TIMEOUT = 300  # seconds phase 12's verifier process may take
# phase 12's verifier, in a process of its own so that it runs beside the
# cpu draft (it is pure Python, ~1 min at 900 kb): argv = the polished
# contigs; it simulates the genome again from the seed and prints the
# verify_contigs_multi totals as JSON
VERIFY = """
import json, sys
import numpy as np
from peregrine_tpu_torch.io.seqdb import read_fastx
from peregrine_tpu_torch.simdata import repeat_genome
from peregrine_tpu_torch.verify import verify_contigs_multi
chroms, _ = repeat_genome(np.random.default_rng(9), %(n)d, n_chrom=1,
                          segdup_len=%(segdup)r)
ctgs = dict(read_fastx(sys.argv[1]))
agg = verify_contigs_multi(ctgs, chroms, circular=True, min_len=30000)
print(json.dumps({"contigs": len(ctgs), "identity": agg["identity"],
                  "n_unanchored": agg["n_unanchored"],
                  "breaks": agg["breaks"], "length": agg["length"]}))
"""


def phase_repeat(wd: str) -> dict:
    """Phase 12, a 900 kb repeat genome (dispersed elements, a tandem
    array, segmental duplications) at 16x of 4 kb reads through
    Assembly(device="cuda", with_alt=True) with consensus: compound paths
    and alternate contigs come out, the polished contigs pass the
    reference test's verifier bounds (checked in a process of its own
    while the cpu draft runs), and stage 1's index and p_ctg.fa equal
    the same draft on the cpu in this process.  Returns its walls,
    launches and verifier numbers."""
    import torch

    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.pipeline.run import Assembly
    from peregrine_tpu_torch.simdata import repeat_genome, simulate_reads

    label = "repeat path"
    t_phase = time.time()
    rng = np.random.default_rng(9)
    chroms, info = repeat_genome(rng, REPEAT_N, n_chrom=1,
                                 segdup_len=REPEAT_SEGDUP)
    reads, _ = simulate_reads(rng, chroms[0], read_len=4000, coverage=16.0,
                              circular_wrap=8000)
    check(bool(info["segdup"]), f"{label}: the genome has no segdups")
    say(f"{label}: {len(chroms[0])} b genome, {len(info['segdup'])} "
        f"segdups, {len(info['dispersed'])} dispersed, "
        f"{len(info['tandem'])} tandem; {len(reads)} reads")
    cfg = AsmConfig(**REPEAT_CFG)
    res = {}
    outs = {dev: os.path.join(wd, f"repeat-{dev}") for dev in ("cuda", "cpu")}
    torch.cuda.reset_peak_memory_stats()
    with stage_log() as (walls, _):
        asm = Assembly(outs["cuda"], cfg, device="cuda", with_alt=True)
        _, res["cuda_s"], launches = _counted(
            f"{label}, cuda", lambda: (asm.run_draft(reads=reads),
                                       asm.build_consensus()), PACKED)
    res["walls"] = dict(walls)
    res["launches"] = {k: launches[k] for k in PACKED + ("build_stream",)}
    DIGESTS["phase12"] = output_digests(outs["cuda"])
    say(f"{label}: stage walls " + ", ".join(
        f"{s} {w:.2f} s" for s, w in walls.items())
        + f"; peak device memory "
        f"{torch.cuda.max_memory_allocated() / (1 << 30):.3f} GiB")
    t_verify = time.time()
    verifier = subprocess.Popen(
        [sys.executable, "-c", VERIFY % dict(n=REPEAT_N,
                                             segdup=REPEAT_SEGDUP),
         os.path.join(outs["cuda"], "4-cns", "p_ctg_cns.fa")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=ROOT)
    try:
        t = time.time()
        Assembly(outs["cpu"], cfg, device="cpu", with_alt=True).run_draft(
            reads=reads)
        res["cpu_draft_s"] = time.time() - t
        _same_files(outs["cpu"], outs["cuda"], (
            "1-index/shmr-L2-01-of-01.dat",
            "1-index/shmr-L2-MC-01-of-01.dat", "3-asm/p_ctg.fa"))
        say(f"{label}: stage 1's index and p_ctg.fa on cuda equal the cpu "
            f"run's ({res['cpu_draft_s']:.1f} s on the cpu)")
        verified = verifier.communicate(timeout=VERIFY_TIMEOUT)[0]
    finally:
        verifier.kill()
        verifier.wait()
    if verifier.returncode:
        print(verified[-4000:], file=sys.stderr, flush=True)
    check(verifier.returncode == 0,
          f"{label}: the verifier exited {verifier.returncode}")
    asm_dir = os.path.join(outs["cuda"], "3-asm")
    sizes = {f: os.path.getsize(os.path.join(asm_dir, f))
             for f in ("c_path", "a_ctg_tiling_path", "a_ctg.fa")}
    for f, n in sizes.items():
        check(n > 0, f"{label}: {f} is empty")
    alt = os.path.join(outs["cuda"], "4-cns-alt", "a_ctg_cns.fa")
    gated = sizes["a_ctg.fa"] > cfg.alt_cns_min_size
    check(os.path.exists(alt) == gated and (
        not gated or os.path.getsize(alt) > 0),
        f"{label}: 4-cns-alt does not follow the {cfg.alt_cns_min_size} B "
        "gate")
    res["bytes"] = dict(sizes, a_ctg_cns=os.path.getsize(alt) if gated
                        else None)
    agg = res["verify"] = _json_line(verified, '"identity"')
    agg["wall_s"] = time.time() - t_verify
    say(f"{label}: {sizes}; 4-cns-alt "
        f"{'polished' if gated else 'below the gate'}; verifier "
        f"{json.dumps(agg)} (beside the cpu draft)")
    check(agg["n_unanchored"] == 0,
          f"{label}: {agg['n_unanchored']} contigs anchor nowhere")
    check(agg["identity"] >= 0.99,
          f"{label}: identity {agg['identity']:.5f} < 0.99")
    res["phase_s"] = time.time() - t_phase
    say(f"{label}: phase 12 took {res['phase_s']:.1f} s")
    return res


def aligner_sass(lib_path: str) -> dict:
    """Each loop of pg_myers_align's SASS (cuobjdump of the built
    library), with its instructions by opcode, and the kernel's registers
    and local (spill) bytes.  The column loops are the innermost loops
    with at least 32 LOP3s (8 block updates of several three-input logic
    operations each).  A loop body may hold several columns: the match
    word takes two LOP3s with the table 0x82 a block, 16 a column, so a
    body runs (its 0x82 LOP3s) / 16 columns, or one if it has none.
    Instructions a lane-column are the body's length over its columns;
    the least over the column loops is what an unambiguous column runs,
    beside MYERS_OPS_PER_COLUMN, what the function needs."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout
    ins = [(int(a, 16), op.strip()) for a, op in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", sass)]
    loops = []
    for a, op in ins:
        m = re.search(r"\bBRA(?:\.\w+)*\s+0x([0-9a-f]+)", op)
        if m and int(m.group(1), 16) < a:
            loops.append((int(m.group(1), 16), a))
    say(f"pg_myers_align SASS: {len(ins)} instructions, {len(loops)} loops")
    columns = []
    for lo, hi in loops:
        body = [op for a, op in ins if lo <= a <= hi]
        inner = not any(lo <= x and y <= hi and (x, y) != (lo, hi)
                        for x, y in loops)
        ops = {}
        for op in body:
            name = re.sub(r"^@!?U?P\w+\s+", "", op).split()[0].split(".")[0]
            ops[name] = ops.get(name, 0) + 1
        loads = sum(op.startswith("LDG") or " LDG" in op for op in body)
        say(f"  loop {lo:#x}-{hi:#x}{' (innermost)' if inner else ''}: "
            f"{len(body)} instructions, {loads} global loads; "
            + ", ".join(f"{k} {v}" for k, v in sorted(
                ops.items(), key=lambda kv: -kv[1])))
        if inner and ops.get("LOP3", 0) >= 32:
            per = max(1, sum("LOP3" in op and "0x82" in op for op in body)
                      // 16)
            columns.append(len(body) / per)
    res = subprocess.run([tool, "-res-usage", lib_path], capture_output=True,
                         text=True, check=True).stdout
    m = re.search(r"myers_align_kernel.*?REG:(\d+).*?STACK:(\d+).*?"
                  r"LOCAL:(\d+)", res, re.S)
    regs, stack, local = (int(g) for g in m.groups()) if m else (0, 0, 0)
    spills = sum(op.split()[0].split(".")[0] in ("STL", "LDL")
                 for _, op in ins)
    out = {"column_loops": columns,
           "instructions_per_lane_column": min(columns) if columns else None,
           "ops_per_lane_column_needed": MYERS_OPS_PER_COLUMN,
           "registers": regs, "stack_bytes": stack, "local_bytes": local,
           "local_loads_and_stores": spills}
    say(f"column loop: {out['instructions_per_lane_column']} instructions a "
        f"lane and target column (column loops {columns} a column); the "
        f"function needs {MYERS_OPS_PER_COLUMN} (MYERS_OPS_PER_COLUMN); "
        f"{regs} registers, stack {stack} B, local {local} B, {spills} "
        "local loads and stores (spills)")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after the kernel checks (phases 1-3)")
    ap.add_argument("--profile-k", type=int, default=K,
                    help="k of the --index-profile run (default %(default)s)")
    ap.add_argument("--index-profile", action="store_true",
                    help="phases 1-2, then stage 1 alone: build walls, the "
                    "host's split of a build and a profiler trace (no "
                    "other phase)")
    ap.add_argument("--abba", metavar="PARENT",
                    help="with --index-profile: profile the checkout PARENT "
                    "and this one in turns (parent, change, change, "
                    "parent), each in its own process")
    ap.add_argument("--log-dir", default=os.path.join(ROOT, "wd-profile-logs"),
                    help="where --abba writes each run's whole output "
                    "(default %(default)s)")
    ap.add_argument("--cli-only", action="store_true",
                    help="phases 1-2, the draft and the consensus path "
                    "(phases 5-6) and the rest of the CLI and the API "
                    "(phase 9)")
    ap.add_argument("--aligner-sass", action="store_true",
                    help="phases 1-2, then the instructions of each loop "
                    "of pg_myers_align's SASS (no other phase)")
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

    # phase 2: build the two kernel libraries and the native host library
    # at once (one compiler each)
    import concurrent.futures as cf
    import importlib

    from peregrine_tpu_torch.ops import device_align as da, kernels as kn

    def timed(build):
        t = time.time()
        build()
        return time.time() - t

    with cf.ThreadPoolExecutor(3) as ex:
        builds = [ex.submit(timed, fn) for fn in (
            kn.library, da.library,
            lambda: importlib.import_module("peregrine_tpu_torch.native"))]
        t_shimmer, t_align, t_native = (f.result() for f in builds)
    say(f"build, in parallel: SHIMMER kernels {t_shimmer:.1f} s and the "
        f"aligner {t_align:.1f} s (nvcc sm_90a), native host library "
        f"{t_native:.1f} s")

    if args.aligner_sass:
        say(json.dumps({"aligner_sass": aligner_sass(da.library()._name)}))
        return 0

    if args.index_profile and args.abba:
        index_profile_abba(args.abba, args.profile_k, args.log_dir)
        return 0

    # phase 3: kernels against their plain versions
    results: dict = {name: {} for name in REPLACES}
    if not (args.index_profile or args.cli_only):
        phase_kernels(results)
        phase_align(results)
        if args.kernels_only:
            return 0

    # simulated E. coli-class set (numpy, seeded)
    from peregrine_tpu_torch.simdata import random_genome, simulate_reads
    t0 = time.time()
    rng = np.random.default_rng(42)
    genome = random_genome(rng, GENOME)
    reads, truth = simulate_reads(rng, genome, read_len=READ_LEN,
                              coverage=COVERAGE, len_sd=1500, error=0.01,
                              circular_wrap=WRAP)
    say(f"simulated {len(reads)} reads, "
        f"{sum(len(s) for _, s in reads)} bases ({time.time() - t0:.1f} s)")
    if args.index_profile:
        phase_index_profile(reads, args.profile_k)
        return 0

    # phase 4: the index on the card equals the index on the host; stage
    # 2's device inputs equal the host's
    if not args.cli_only:
        phase_index(reads, genome)
        phase_stage2_inputs(reads)
        phase_uploader(reads)

    # phases 5 and 6: the draft path and the wide consensus path
    from peregrine_tpu_torch.simdata import write_reads
    wd = os.path.join(ROOT, "wd-chip-smoke")
    shutil.rmtree(wd, ignore_errors=True)
    try:
        os.makedirs(wd)
        lst = os.path.join(wd, "reads.lst")
        write_reads(reads, os.path.join(wd, "reads.fa"), lst)
        draft = phase_draft(lst, genome, wd, results)
        phase_consensus(lst, genome, wd, results, draft[0])
        if args.cli_only:
            rest = phase_rest(lst, genome, truth, wd)
            say(json.dumps({"phase9": rest}))
            return 0
        # phases 7 and 8: stage 2 on the card
        entry = results.setdefault("myers_align", {})
        entry["launches"], entry["rounds"], sample, entry["trace"], calls = \
            phase_device_overlap(lst, genome, wd, draft,
                                 "device aligner path",
                                 ["--device-aligner", "--device-pairs"],
                                 trace=True)
        (entry["launches_hybrid"], entry["rounds_hybrid"], sample_hybrid, _,
         _) = phase_device_overlap(lst, genome, wd, draft,
                                   "hybrid overlap path",
                                   ["--hybrid-overlap"])
        # phase 9: the rest of the CLI and the API; build_stream's path
        # is now the long route's (stage 1 runs the fused pair)
        rest = phase_rest(lst, genome, truth, wd)
        results["build_stream"]["launches"] = \
            rest["ref_index"]["launches"]["build_stream"]
        # phase 10: the multi-device paths
        mesh = phase_mesh(lst, wd, calls)
        # phase 11: spill mode, sharing and rebuilding the pair map
        spill = phase_spill(lst, wd, sum(len(s) for _, s in reads))
        # phase 12: the repeat genome's hard paths
        repeat = phase_repeat(wd)
    finally:
        shutil.rmtree(wd, ignore_errors=True)
    # the entry's headline is the main path's largest launch, traced, and
    # the plain version on its sample; phase 3's shapes stay in `shapes`
    entry["shapes"] += [sample, sample_hybrid]
    head = max(entry["trace"], key=lambda t: t["lanes"])
    entry.update(
        max_abs_err=max(sh["max_abs_err"] for sh in entry["shapes"]),
        ms=head["trace_ms"], lanes=head["lanes"], bound_ms=head["bound_ms"],
        bound_us=head["bound_ms"] * 1e3,
        share_of_bound=head["share_of_bound"], plain_ms=sample["plain_ms"],
        plain_lanes=sample["lanes"])

    say(json.dumps({"phase9": rest}))
    say(json.dumps({"phase10": mesh}))
    say(json.dumps({"phase11": spill}))
    say(json.dumps({"phase12": repeat}))
    say(json.dumps({"digests": DIGESTS}))
    kernels = [{"name": name, "route": "cuda", "source": SOURCE,
                "replaces": REPLACES[name], **results[name]}
               for name in REPLACES]
    kernels.append({"name": "myers_align", "route": "cuda",
                    "source": ALIGN_SOURCE, "replaces": ALIGN_REPLACES,
                    **results["myers_align"]})
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
