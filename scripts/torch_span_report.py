#!/usr/bin/env python3
"""Where a benchmark cell's assemblies spend their time inside the
stages, from the port's own spans (peregrine_tpu_torch.trace).

    python3 scripts/torch_span_report.py --workload <cell> --seed <n> \\
        [--runs 2] [--profile-dir DIR]

For one cell of pgbench/ (its configuration, flags and host workers), in
one process on the first CUDA card (or --device cpu):
1. writes the seed's reads (pgbench/gen.py) and warms up with one
   assembly of the reads of the genome's first stretch, as the benchmark
   does;
2. runs --runs whole assemblies and prints, per assembly, each stage's
   wall, the summed seconds of its direct child spans and its self share
   (wall less children, over wall), stage 2's split (pairs + stream +
   upload, rounds, final pass, write) with its counters, each round's
   attrs, stage 1's parts, stage 4's consensus windows (decode and native
   seconds summed), and the records an assembly leaves in the ring;
3. runs one more assembly under torch.profiler (the trace that
   `--profile-dir` writes) and prints the ten longest device-idle gaps
   inside it, each named by the innermost `pg.` span open on the main
   thread at its middle and broken down by the innermost spans it
   covers, and the device's busy share;
4. times a span: microseconds a span with no profiler, and under a
   profiler recording the host and the card.
The last line is one JSON object of all of it.
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import shutil
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(ROOT, "pgbench"))
sys.path.insert(1, ROOT)

import devtrace  # noqa: E402
import gen  # noqa: E402
import run as pgrun  # noqa: E402
import torch  # noqa: E402

from peregrine_tpu_torch import trace  # noqa: E402
from peregrine_tpu_torch.ops.kernels import require_device  # noqa: E402
from peregrine_tpu_torch.pipeline.run import profiled  # noqa: E402

STAGES = ("seqdb", "index", "overlap", "layout", "polish")
STAGE2 = {"pairs": ("overlap.pairs", "overlap.stream", "overlap.upload"),
          "rounds": ("overlap.round",), "final": ("overlap.final",),
          "write": ("overlap.write",)}


def stage_table(recs: list) -> dict:
    """One assembly's records: each stage's wall, children's seconds and
    self share; stage 2's split; counters."""
    kids = collections.defaultdict(list)
    for r in recs:
        kids[r.parent].append(r)
    out = {"records": len(recs), "stages": {}}
    for r in recs:
        if r.name not in STAGES or r.parent:
            continue
        child = sum(c.seconds for c in kids[r.id])
        parts = collections.Counter()
        for c in kids[r.id]:
            parts[c.name] += c.seconds
        out["stages"][r.name] = {
            "wall_s": r.seconds, "children_s": child,
            "self_share": (r.seconds - child) / r.seconds if r.seconds else 0,
            "parts_s": dict(parts)}
    ov = [r for r in recs if r.name == "overlap" and not r.parent]
    if ov:
        wall = ov[0].seconds
        split = {k: sum(r.seconds for r in recs if r.name in names)
                 for k, names in STAGE2.items()}
        out["stage2"] = {"split_s": split,
                         "covered": sum(split.values()) / wall,
                         "rounds": [dict(r.attrs, seconds=r.seconds)
                                    for r in recs
                                    if r.name == "overlap.round"],
                         "aligners": [dict(r.attrs, seconds=r.seconds)
                                      for r in recs
                                      if r.name == "overlap.aligner"],
                         "collect_s": [r.seconds for r in recs
                                       if r.name == "overlap.collect"],
                         "final": [dict(r.attrs, seconds=r.seconds)
                                   for r in recs
                                   if r.name == "overlap.final"]}
    pools = [r for r in recs if r.name == "consensus.windows"]
    if pools:
        wins = [r for r in recs if r.name == "consensus.window"]
        out["stage4"] = {
            "windows_s": sum(p.seconds for p in pools),
            "workers": pools[0].attrs["workers"], "windows": len(wins),
            "decode_s": sum(w.attrs.get("decode_s", 0) for w in wins),
            "native_s": sum(w.attrs.get("native_s", 0) for w in wins),
            "window_s": sum(w.seconds for w in wins)}
    cons = [r for r in recs if r.name == "consensus"]
    if cons:
        parts = collections.Counter()
        for c in kids[cons[0].id]:
            parts[c.name] += c.seconds
        out["consensus_parts_s"] = dict(parts)
    idx = [r for r in recs if r.name == "index" and not r.parent]
    if idx:
        parts = collections.Counter()
        n = collections.Counter()
        for c in recs:
            if (c.name.startswith("index.") and idx[0].t0 <= c.t0
                    and c.t1 <= idx[0].t1):
                parts[c.name] += c.seconds
                n[c.name] += 1
        buckets = [r for r in recs if r.name == "index.bucket"
                   and idx[0].t0 <= r.t0 and r.t1 <= idx[0].t1]
        out["index_parts"] = {k: [v, n[k]] for k, v in parts.items()}
        out["index_bucket_self_s"] = sum(
            b.seconds - sum(c.seconds for c in kids[b.id]) for b in buckets)
    return out


def idle_gaps(path: str, n: int = 10) -> dict:
    """The profiler trace's n longest device-idle gaps inside the
    assembly, each named by the innermost pg. span on the main thread at
    its middle, with the innermost spans that cover most of it (a gap
    can span several host stages); and whether every pg. span of the
    main thread lies inside a stage's span."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    dev, spans = [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        ts, dur = float(e["ts"]), float(e.get("dur", 0))
        if e.get("cat") in devtrace.DEVICE_CATS:
            dev.append((ts, ts + dur, e.get("name", ""), e["cat"]))
        elif (e.get("cat") == "user_annotation"
              and e.get("name", "").startswith("pg.")):
            spans.append((ts, ts + dur, e["name"], e.get("tid")))
    main = [s for s in spans if s[2] == "pg.seqdb"][0][3]
    spans = sorted(s for s in spans if s[3] == main)
    stages = [s for s in spans if s[2][3:] in STAGES]
    lo = min(s[0] for s in stages)
    hi = max(s[1] for s in stages)
    merged = devtrace.union(dev, lo, hi)
    gaps, t = [], lo
    for a, b in merged:
        if a > t:
            gaps.append((a - t, t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((hi - t, t, hi))
    gaps.sort(reverse=True)

    def innermost(x):
        inside = [s for s in spans if s[0] <= x < s[1]]
        return max(inside, key=lambda s: s[0])[2] if inside else "between"

    def cover(a, b):
        """Seconds of [a, b) by innermost span, the largest three."""
        cuts = sorted({a, b} | {x for s in spans for x in s[:2]
                                if a < x < b})
        tot = collections.Counter()
        for x, y in zip(cuts, cuts[1:]):
            tot[innermost((x + y) / 2)] += (y - x) / 1e6
        return [[k, v] for k, v in tot.most_common(3)]

    busy = devtrace.busy(dev, lo, hi)
    nested = all(any(st[0] <= s[0] and s[1] <= st[1] for st in stages)
                 for s in spans)
    return {"window_s": (hi - lo) / 1e6, "busy_s": busy / 1e6,
            "idle_share": 1 - busy / (hi - lo),
            "gaps": [[innermost((a + b) / 2), g / 1e6, cover(a, b)]
                     for g, a, b in gaps[:n]],
            "pg_spans_in_trace": len(spans), "nested": nested,
            "kernels": sum(1 for e in dev if e[3] == "kernel")}


def span_cost(n: int) -> float:
    """Microseconds a span (open, close, ring) in a tight loop."""
    t = time.perf_counter()
    for _ in range(n):
        with trace.span("cost"):
            pass
    return (time.perf_counter() - t) / n * 1e6


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--runs", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--profile-dir", default=None,
                   help="keep the profiled assembly's trace here")
    p.add_argument("--cells-root", default=os.path.join(ROOT, "pgbench"),
                   help="the folder of cells/ and configs/")
    p.add_argument("--trace-file", default=None,
                   help="only read this profiler trace's idle gaps")
    args = p.parse_args(argv)
    if args.trace_file:
        print(json.dumps(idle_gaps(args.trace_file)))
        return 0
    cell, cfg = pgrun.load_cell(args.workload, args.cells_root)
    prog = pgrun.Program(cell, cfg, args.device)
    work = tempfile.mkdtemp(prefix="span-report-")
    result = {"workload": args.workload, "seed": args.seed,
              "card": (torch.cuda.get_device_name(0)
                       if args.device != "cpu" else "cpu")}
    try:
        _, manifest, warm, n_reads, bases, _ = gen.write_reads(
            args.seed, cfg, os.path.join(work, "reads"),
            int(cell["warm_span"]))
        prog.assemble(warm, os.path.join(work, "warm"), False)
        result.update(reads=n_reads, bases=bases, assemblies=[])
        for i in range(args.runs):
            out = os.path.join(work, f"asm{i}")
            before = {r.id for r in trace.records()}
            rec = prog.assemble(manifest, out, False)
            recs = [r for r in trace.records() if r.id not in before]
            wall = rec["spans"][-1][2] - rec["spans"][0][1]
            table = stage_table(recs)
            table.update(wall_s=wall, walls=rec["walls"])
            result["assemblies"].append(table)
            print(json.dumps({"assembly": i, **table}), flush=True)
            shutil.rmtree(out)
        prof = args.profile_dir or os.path.join(work, "prof")
        with profiled(prof, require_device(args.device)):
            prog.assemble(manifest, os.path.join(work, "profiled"), False)
        path = max(glob.glob(os.path.join(prof, "*.json")),
                   key=os.path.getmtime)
        result["profiled"] = idle_gaps(path)
        print(json.dumps({"profiled": result["profiled"]}), flush=True)
        result["span_us"] = span_cost(200000)
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if args.device != "cpu" else [])
        with profile(activities=acts):
            result["span_us_profiled"] = span_cost(20000)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
