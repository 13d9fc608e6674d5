#!/usr/bin/env python3
"""Readings that the limits of `correct` are set from, on the card.

    python3 pgbench/calibrate.py --workload <cell> --seeds 11 12 ... \\
        [--numbers ovl_miss ...] [--faults 3] [--fault-names ...] \\
        [--fault-numbers ...] [--controls 3] \\
        [--drawn-layout] [--set key=value ...] [--gaps 20000]

In one process, for each seed: the reads of the seed, one assembly on
the timed path (after one warm-up, as a run's window does), and the
check's numbers for it, those named by --numbers or else all the cell's,
judge.py's and its check files' (checks/<name>.py) alike (the lower
readings).  For the first `--controls` seeds also the control, the
reference in a lower precision put in the program's place:
* "index": the stage-1 index recomputed with its hash cut to 24 bits
  (k <= 16) or 32 bits (k > 16), the step that would tempt a later change
  of the 32- and 64-bit kernels;
* "polish" (cells that polish): the draft in the place of the polished
  contigs, the consensus left out;
* a check file's own control, where the file declares one
  (`CONTROL = True`): its number with ctx["control"] set to the number's
  name.  A check file without it has no control here.
For the first `--faults` seeds also each stage-2 fault of faults.py (or
those named by --fault-names), planted in the program for one more
assembly, read by the same check on the stage-2 and draft numbers and
the check files' (those named by --fault-numbers, else by --numbers);
where stage 2 returns nothing the assembly stops at the draft, since the
program's stage 4 cannot run on no contigs.

--drawn-layout draws the reads' and repeats' layout from each seed in
place of the configuration's layout_seed; --set overrides a route flag of
the cell (device_aligner=1); --gaps prints each draft's uncovered
stretches of that many bases or more, and the genome's repeats.
Prints one JSON line a seed.  The benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import faults
import judge
import run


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--numbers", nargs="*", default=None)
    p.add_argument("--controls", type=int, default=0)
    p.add_argument("--faults", type=int, default=0)
    p.add_argument("--fault-names", nargs="+", default=list(faults.NAMES[1:]))
    p.add_argument("--fault-numbers", nargs="*", default=None)
    p.add_argument("--drawn-layout", action="store_true")
    p.add_argument("--set", action="append", default=[])
    p.add_argument("--gaps", type=int, default=0)
    a = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell, cfg = run.load_cell(a.workload)
    for kv in a.set:
        k, v = kv.split("=")
        cell[k] = int(v)
    if a.drawn_layout:
        cfg["genome"].pop("layout_seed", None)
        cfg["reads"].pop("layout_seed", None)
    lim = cell["limits"]
    sound_cell = dict(cell, limits={k: v for k, v in lim.items()
                                    if a.numbers is None or k in a.numbers})
    prog = run.Program(cell, cfg, "cuda")
    draft = run.Program(dict(cell, with_consensus=False), cfg, "cuda")
    work = tempfile.mkdtemp(prefix="pgbench-cal-")
    try:
        for i, seed in enumerate(a.seeds):
            t0 = time.perf_counter()
            rd = os.path.join(work, "reads")
            g = run.gen.genome(seed, cfg)
            run.refuse_several(lim, g)
            manifest, warm, n_reads, bases, layout = run.gen.write_reads(
                seed, cfg, g, rd, int(cell["warm_span"]))
            if i == 0:
                prog.assemble(warm, os.path.join(work, "warm"), False)
                shutil.rmtree(os.path.join(work, "warm"))
            out = os.path.join(work, "asm")
            t1 = time.perf_counter()
            prog.assemble(manifest, out, False)
            t_asm = time.perf_counter() - t1
            reads = list(run.gen.manifest_reads(manifest))
            s = prog.settings

            def check(outdir, limits, control=""):
                return run.check_outputs(outdir, dict(cell, limits=limits),
                                         cfg, s, reads, g, layout, seed,
                                         control=control)

            line = {"seed": seed, "asm_s": t_asm,
                    "sound": check(out, sound_cell["limits"])}
            if a.gaps and len(g.seqs) == 1:
                gi = judge.GenomeIndex(g.seqs[0], g.circular[0])
                pieces = judge.contig_pieces(
                    os.path.join(out, "3-asm", "p_ctg.fa"))
                line["genome_miss"], _ = judge.genome_miss(gi, pieces)
                line["uncovered"] = judge.uncovered(gi, pieces, a.gaps)
                line["contigs"] = sorted(
                    (len(x) for _, x in run.gen.read_fasta(
                        os.path.join(out, "3-asm", "p_ctg.fa"))), reverse=True)
                if cfg["genome"]["model"] == "repeats":
                    events = []
                    run.gen.genome(seed, cfg, events)
                    line["repeats"] = [e for e in events if e[0] != "disp"]
            ctl = {}
            if i < a.controls:
                if "index_diff" in lim:
                    ctl["index"] = check(out, {"index_diff": 0}, "index")
                if "cns_err" in lim:
                    ctl["polish"] = check(out, {"cns_err": 0}, "polish")
                for k in lim:
                    if k not in run.CHECKS and getattr(run.plugins.module(
                            run.HERE, "checks", k), "CONTROL", False):
                        ctl[k] = check(out, {k: 0}, k)
            shutil.rmtree(out)
            if i < a.faults:
                named = a.numbers if a.fault_numbers is None else a.fault_numbers
                limits = {k: v for k, v in lim.items()
                          if (k in ("ovl_gap", "ovl_miss", "genome_miss")
                              or k not in run.CHECKS)
                          and (named is None or k in named)}
                for name in a.fault_names:
                    with faults.planted(name):
                        (draft if name == "stage2_none" else prog).assemble(
                            manifest, out, False)
                    ctl[name] = check(out, limits)
                    shutil.rmtree(out)
            if ctl:
                line["controls"] = ctl
            line["seconds"] = time.perf_counter() - t0
            print(json.dumps(line), flush=True)
            shutil.rmtree(rd)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
