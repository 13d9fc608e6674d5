#!/usr/bin/env python3
"""Stage walls of `pg-tpu-torch asm` on one CUDA card, one fresh process
a run, for one or more checkouts in turns.

    python3 scripts/torch_stage_walls.py --trees wd-parent . [--rounds 2]
        [--flags "--shimmer-k 28 --with-L0-index"]

The reads are chip_smoke.py's E. coli-class set (4.6 Mb circular genome,
30x of 15 kb reads, 1% error, 40 kb wrap, seed 42), simulated once into
--wd.  Each tree first runs `asm` once unmeasured (it builds that tree's
kernels and native library into its own build directory), then the trees
run in turns, `--rounds` times: A B B A for two trees.  Every run is a
new process that imports the port from its tree, runs `cli.main(["asm",
...])` (so CUDA context creation lands where a user's would), and
reports each stage's wall from the stage log records (`stage_wall`),
the asm total, and the stage logs' notes of the seqdb uploader where
they have them (how long stage 0 took to start it; what stage 1 took).  Each run's p_ctg.fa is digested: every run must give the same
bytes.  Prints a line a run and a JSON line with all runs and the card's
name and power limit.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GENOME, READ_LEN, COVERAGE, WRAP = 4_600_000, 15_000, 30.0, 40_000


def run_one(tree: str, lst: str, out: str, flags: list) -> dict:
    """One asm in this process, the port imported from `tree`."""
    import logging
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from peregrine_tpu_torch import cli
    walls, notes = {}, []

    class Records(logging.Handler):
        def emit(self, record):
            if hasattr(record, "stage_wall"):
                walls[record.stage_wall[0]] = record.stage_wall[1]
            msg = record.getMessage()
            for key in ("seqdb upload to", "stage-0 seqdb planes: "):
                if key in msg:
                    notes.append(key + msg.split(key)[1].split(";")[0]
                                 .rstrip(")"))

    logging.getLogger("peregrine_tpu_torch").addHandler(Records())
    logging.getLogger("peregrine_tpu_torch").setLevel(logging.INFO)
    shutil.rmtree(out, ignore_errors=True)
    t = time.perf_counter()
    rc = cli.main(["asm", lst, "--output", out] + flags)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    total = time.perf_counter() - t
    with open(os.path.join(out, "3-asm", "p_ctg.fa"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()
    return {"rc": rc, "walls": walls, "total_s": total, "planes": notes,
            "p_ctg_sha256": digest}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--trees", nargs="+", default=[ROOT])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--flags", default="", help="extra asm flags")
    ap.add_argument("--wd", default=os.path.join(ROOT, "wd-stage-walls"))
    ap.add_argument("--run", nargs=3, metavar=("TREE", "LST", "OUT"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    flags = args.flags.split()
    if args.run:
        print(json.dumps(run_one(*args.run, flags)))
        return 0
    import torch
    if not torch.cuda.is_available():
        print("torch_stage_walls: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card)
    os.makedirs(args.wd, exist_ok=True)
    lst = os.path.join(args.wd, "reads.lst")
    if not os.path.exists(lst):
        import numpy as np
        sys.path.insert(0, ROOT)
        from peregrine_tpu_torch.simdata import (random_genome,
                                                 simulate_reads, write_reads)
        rng = np.random.default_rng(42)
        genome = random_genome(rng, GENOME)
        reads, _ = simulate_reads(rng, genome, read_len=READ_LEN,
                                  coverage=COVERAGE, len_sd=1500, error=0.01,
                                  circular_wrap=WRAP)
        write_reads(reads, os.path.join(args.wd, "reads.fa"), lst)

    def spawn(tree: str, i: int) -> dict:
        out = os.path.join(args.wd, f"out-{i}")
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--run", tree, lst,
             out, f"--flags={args.flags}"], capture_output=True, text=True)
        if r.returncode != 0:
            sys.stderr.write(r.stderr[-4000:])
            raise SystemExit(f"run in {tree} exited {r.returncode}")
        return json.loads(r.stdout.strip().splitlines()[-1])

    for i, tree in enumerate(args.trees):  # builds, unmeasured
        spawn(tree, i)
    order = []
    for _ in range(args.rounds):
        order += args.trees + args.trees[::-1]
    runs = []
    for i, tree in enumerate(order):
        res = spawn(tree, i)
        res["tree"] = tree
        runs.append(res)
        print(f"{tree}: asm {res['total_s']:.4f} s; " + ", ".join(
            f"{s} {w:.4f}" for s, w in res["walls"].items())
            + "".join(f"; {note}" for note in res["planes"]))
    digests = {r["p_ctg_sha256"] for r in runs}
    print(json.dumps({"stage_walls": {"card": card, "flags": args.flags,
                                      "runs": runs,
                                      "same_p_ctg": len(digests) == 1}}))
    return 0 if len(digests) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
