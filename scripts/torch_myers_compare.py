#!/usr/bin/env python3
"""pg_myers_align of one checkout on one CUDA card, at phase 3's and
phase 7's shapes of chip_smoke.py.

    python3 scripts/torch_myers_compare.py [--tree DIR]

--tree names the checkout whose peregrine_tpu_torch is imported (default:
the one holding this script); chip_smoke.py and tests/torch_kernel_cases.py
come from the checkout holding this script, so every tree gets the same
inputs.  To compare two commits in one call on one card, unpack the other
into a directory that .gitignore lists (`wd-*/`) and run the script once
per tree, in the order parent, change, change, parent.

It builds the tree's aligner and prints its SASS loops, the column loop's
instructions and the kernel's registers (chip_smoke.aligner_sass); times
phase 3's aligner shapes (chip_smoke.align_shapes: 1,024 E. coli-class
read pairs, the crafted lanes, the plane-end lanes), 20 launches back to
back between CUDA events; then runs `asm --device-aligner --device-pairs`
on chip_smoke's E. coli-class set (its reads are simulated once into
wd-myers-compare/ and reused by later runs) with every aligner call
recorded, and replays each launch under torch.profiler (phase 7's
trace).  The outputs of every shape and launch are digested, so that the
trees' results can be compared.  Prints a JSON line with the times, the
bounds, the digests, the card's name and its power limit.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _digest(arrays) -> str:
    h = hashlib.sha1()
    for a in arrays:
        h.update(a.cpu().numpy().tobytes() if hasattr(a, "cpu")
                 else a.tobytes())
    return h.hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout to import the port from")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_myers_compare: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from peregrine_tpu_torch.ops import device_align as da
    if not da.__file__.startswith(os.path.join(tree, "")):
        raise SystemExit(f"imported {da.__file__}, not from {tree}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_inputs", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    card = cs.smi("name,power.limit")
    cs.say(f"tree {tree}: {card}")
    t0 = time.time()
    da.library()
    cs.say(f"aligner built in {time.time() - t0:.1f} s")
    res = {"tree": tree, "card": card,
           "sass": cs.aligner_sass(da.library()._name), "phase3": [],
           "phase7": []}

    for label, pdb, c in cs.align_shapes(cs.load_kernel_cases()):
        cols = c.cpu().numpy()
        out = da.myers_batch_db(pdb, c)
        ms = cs.kernel_ms(lambda: da.myers_batch_db(pdb, c), n=20)
        bound = cs.myers_bound_ms(cols)
        res["phase3"].append({"site": label, "lanes": len(cols), "ms": ms,
                              "bound_ms": bound, "share_of_bound": bound / ms,
                              "digest": _digest(out)})
        cs.say(f"phase 3 {label}: {len(cols)} lanes, {ms:.4f} ms, bound "
               f"{bound:.4f} ms, {bound / ms:.4f} of it")

    from peregrine_tpu_torch.simdata import (random_genome, simulate_reads,
                                             write_reads)
    wd = os.path.join(ROOT, "wd-myers-compare")
    lst = os.path.join(wd, "reads.lst")
    if not os.path.exists(lst):
        os.makedirs(wd, exist_ok=True)
        rng = np.random.default_rng(42)
        genome = random_genome(rng, cs.GENOME)
        reads, _ = simulate_reads(rng, genome, read_len=cs.READ_LEN,
                                  coverage=cs.COVERAGE, len_sd=1500,
                                  error=0.01, circular_wrap=cs.WRAP)
        write_reads(reads, os.path.join(wd, "reads.fa"), lst)
    out_dir = os.path.join(wd, f"asm-{os.getpid()}")
    rounds, calls = [], []
    with cs.aligner_rounds(rounds, calls):
        walls, launches, total = cs.run_asm(
            lst, out_dir, ["--device-aligner", "--device-pairs"],
            "device aligner path", ("seqdb", "index", "overlap", "layout"))
    for t, (_, _, got) in zip(cs.trace_myers(calls), calls):
        t["digest"] = _digest(got)
        res["phase7"].append(t)
        cs.say(f"phase 7 launch: {t['lanes']} lanes, {t['trace_ms']:.4f} ms "
               f"({t['timed_by']}), bound {t['bound_ms']:.4f} ms, "
               f"{t['share_of_bound']:.4f} of it")
    res.update(walls=walls, asm_s=total, launches=launches["myers_align"],
               device_ms=[r["device_ms"] for r in rounds])
    with open(os.path.join(out_dir, "2-ovlp", "preads.ovl"), "rb") as f:
        res["preads_ovl"] = hashlib.sha1(f.read()).hexdigest()[:16]
    cs.say(json.dumps({"myers_compare": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
