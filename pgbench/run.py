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

A cell may name options of the program (`asm_config`: AsmConfig fields;
`assembly`: Assembly's keyword arguments) and numbers of the check that
check_outputs does not compute (checks/<name>.py); its configuration may
name a genome model of its own (genomes/<model>.py).  A name with no
file or field is an error when the cell is loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import hashlib  # noqa: E402
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
import plugins  # noqa: E402
import refindex  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "peregrine_tpu")
OUTPUTS = ("1-index", "2-ovlp/preads.ovl", "3-asm/p_ctg.fa",
           "4-cns/p_ctg_cns.fa", "3-asm/a_ctg.fa", "4-cns-alt/a_ctg_cns.fa")
OWN = ("setup_s", "asm_rate", "peak_rss_GiB", "peak_device_GiB")
CHECKS = ("runs_differ", "index_diff", "ovl_gap", "ovl_miss", "genome_miss",
          "cns_err")
ONE_SEQUENCE = ("genome_miss", "cns_err")   # place contigs on one sequence
# AsmConfig fields that the configuration's settings and the cell's route
# flags set, or that choose a route or a path of their own; and the
# Assembly arguments that a cell may give
SET_FIELDS = ("k", "w", "r", "levels", "best_n_ovlp", "use_device_aligner",
              "device_pairs", "hybrid_overlap", "mesh", "shard_overlap",
              "spill_dir")
ASSEMBLY_ARGS = ("with_alt",)
PEAK_BYTES_S = 3.35e12   # H100 SXM HBM3, NVIDIA's data sheet


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def list_cells(cells_dir: str = os.path.join(HERE, "cells")) -> list:
    return sorted(f[:-5] for f in os.listdir(cells_dir) if f.endswith(".json"))


def load_cell(name: str, root: str = HERE) -> tuple[dict, dict]:
    """(cell, configuration) by the cell's name.  A genome model, a check
    number, an AsmConfig field or an Assembly argument that they name and
    that has no file or field is a ValueError here."""
    cell = load_json(os.path.join(root, "cells", name + ".json"))
    cfg = load_json(os.path.join(root, "configs", cell["config"] + ".json"))
    if cfg["genome"]["model"] not in gen.BUILTIN_MODELS:
        plugins.load(root, "genomes", cfg["genome"]["model"], "genome")
    for k in cell["limits"]:
        if k not in CHECKS:
            plugins.load(root, "checks", k, "check")
    if "asm_config" in cell:
        from peregrine_tpu_torch.config import AsmConfig
        fields = {f.name for f in dataclasses.fields(AsmConfig)}
        for k in cell["asm_config"]:
            if k not in fields or k in SET_FIELDS:
                raise ValueError(
                    f"pgbench: {name}: asm_config names {k!r}, " + (
                        "which the settings, the route flags or the program's "
                        "own routes set" if k in fields
                        else "which is no field of AsmConfig"))
    for k in cell.get("assembly", {}):
        if k not in ASSEMBLY_ARGS:
            raise ValueError(f"pgbench: {name}: assembly names {k!r}, which "
                             f"is no argument of Assembly that a cell may "
                             f"give ({', '.join(ASSEMBLY_ARGS)})")
    return cell, cfg


def cell_metrics(bench: dict, name: str, kind: str) -> list:
    """The entries of BENCHMARK.json's `kind` list that the cell reports."""
    return [m for m in bench.get(kind, [])
            if "workloads" not in m or name in m["workloads"]]


def readers(bench: dict, name: str, root: str = HERE) -> dict:
    """The reader of each metric the cell reports that the harness does not
    take itself; a metric with no file is a ValueError here."""
    return {m["name"]: plugins.load(root, "metrics", m["name"], "read")
            for kind in ("end_to_end", "per_layer")
            for m in cell_metrics(bench, name, kind) if m["name"] not in OWN}


def refuse_several(limits: dict, g: gen.Genome) -> None:
    """The numbers that place contigs on one sequence refuse a genome of
    several."""
    for k in ONE_SEQUENCE:
        if k in limits and len(g.seqs) > 1:
            raise ValueError(
                f"pgbench: {k} places contigs on a genome of one sequence, "
                f"and this genome has {len(g.seqs)} ({', '.join(g.names)}); "
                f"give the cell a check of its own under checks/")


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
        if "asm_config" in cell:
            self.acfg = self.acfg.replace(**cell["asm_config"])
        self.asm_args = dict(cell.get("assembly", {}))
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

        asm = self.Assembly(outdir, self.acfg, device=self.device,
                            **self.asm_args)
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
                  g: gen.Genome, layout: np.ndarray, seed: int,
                  control: str = "", root: str = HERE) -> dict:
    """The numbers that decide `correct`, for one assembly's outputs, each
    that the cell has a limit for: those of judge.py, then those of the
    cell's files checks/<name>.py under root, each called as check(ctx).
    control puts the reference in a lower precision in the program's
    place (calibrate.py; a run uses none; a check file may read it)."""
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
    if "ovl_miss" in lim:
        out["ovl_miss"] = judge.ovl_miss(outdir, judge.true_pairs_within(
            layout, [len(x) for x in g.seqs], g.circular,
            int(cfg["reads"]["read_len"]) // 2))
        lap("pairs")
    if "genome_miss" in lim or "cns_err" in lim:
        gi = judge.GenomeIndex(g.seqs[0], g.circular[0])
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
    for k in lim:
        if k not in CHECKS:
            out[k] = float(plugins.load(root, "checks", k, "check")({
                "outdir": outdir, "reads": reads, "genome": g,
                "layout": layout, "settings": s, "rng": gen.rng_for(seed, 3),
                "cell": cell, "config": cfg, "seed": seed,
                "control": control}))
            lap(k)
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
    metric_readers = readers(bench, args.workload, root)
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
        return _run(args, bench, cell, cfg, prog, work, on_card, root,
                    metric_readers)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(args, bench, cell, cfg, prog, work, on_card, root,
         metric_readers) -> int:
    torch = prog.torch
    t = time.perf_counter()
    g = gen.genome(args.seed, cfg, root=root)
    refuse_several(cell["limits"], g)
    manifest, warm_lst, n_reads, bases, layout = gen.write_reads(
        args.seed, cfg, g, os.path.join(work, "reads"), int(cell["warm_span"]))
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
            v = metric_readers[m["name"]](ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        own = {"setup_s": setup_s,
               "asm_rate": asm_rate(bases, runs),
               "peak_rss_GiB": peak_rss / (1 << 30),
               "peak_device_GiB": peak_dev / (1 << 30)}
        for m in cell_metrics(bench, args.workload, "end_to_end"):
            v = (own[m["name"]] if m["name"] in own
                 else metric_readers[m["name"]](ctx))
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
                                 layout, args.seed, root=root))
    t_check = time.perf_counter() - t
    lim = cell["limits"]
    checks = {k: {"value": v, "limit": lim.get(k, 0)} for k, v in numbers.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    print(f"pgbench: check {t_check:.3f} s", file=sys.stderr)
    # the window, the metric readers and the check files have all run
    bad = forbidden_modules()
    if bad:
        print(f"pgbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 4
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
