#!/usr/bin/env python3
"""The outputs of chip_smoke.py's phases 5-8 and 12 for one checkout on
one CUDA card, digested as chip_smoke.py digests its own.

    python3 scripts/torch_outputs_compare.py [--tree DIR]

--tree names the checkout whose peregrine_tpu_torch is imported (default:
the one holding this script); chip_smoke.py comes from the checkout
holding this script, so every tree gets the same inputs.  To show that a
change keeps every output, unpack the parent into a directory that
.gitignore lists (`wd-*/`) and run the script once per tree in one call;
the final smoke's `{"digests": ...}` line holds the same keys.

It runs, through the tree's cli.main, `asm` on chip_smoke's E. coli-class
set (simulated once into wd-outputs-compare/ and reused by later runs)
with phase 5's flags (the k=16 draft), phase 6's (`--shimmer-k 28
--with-L0-index --with-consensus`), phase 7's (`--device-aligner
--device-pairs`) and phase 8's (`--hybrid-overlap`), then phase 12's
repeat genome through Assembly(device="cuda", with_alt=True) with
consensus, and digests every file of their stage directories
(chip_smoke.output_digests).  Prints a JSON line with the digests, the
stage walls, each run's launches, the card's name and its power limit.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import shutil
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout to import the port from")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_outputs_compare: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from peregrine_tpu_torch.ops import device_align as da, kernels as kn
    if not kn.__file__.startswith(os.path.join(tree, "")):
        raise SystemExit(f"imported {kn.__file__}, not from {tree}")
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_inputs", os.path.join(ROOT, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)

    card = cs.smi("name,power.limit")
    cs.say(f"tree {tree}: {card}")
    t0 = time.time()
    kn.library()
    da.library()
    importlib.import_module("peregrine_tpu_torch.native")
    cs.say(f"kernels and native library built in {time.time() - t0:.1f} s")

    wd = os.path.join(ROOT, "wd-outputs-compare")
    lst = os.path.join(wd, "reads.lst")
    if not os.path.exists(lst):
        from peregrine_tpu_torch.simdata import (random_genome,
                                                 simulate_reads, write_reads)
        rng = np.random.default_rng(42)
        genome = random_genome(rng, cs.GENOME)
        reads, _ = simulate_reads(rng, genome, read_len=cs.READ_LEN,
                                  coverage=cs.COVERAGE, len_sd=1500,
                                  error=0.01, circular_wrap=cs.WRAP)
        os.makedirs(wd, exist_ok=True)
        write_reads(reads, os.path.join(wd, "reads.fa"), lst)
    runs = {"phase5": [], "phase6": ["--shimmer-k", str(cs.K_WIDE),
                                     "--with-L0-index", "--with-consensus"],
            "phase7": ["--device-aligner", "--device-pairs"],
            "phase8": ["--hybrid-overlap"]}
    tag = hashlib.sha1(tree.encode()).hexdigest()[:8]
    digests, walls, launches = {}, {}, {}
    for phase, flags in runs.items():
        out = os.path.join(wd, f"{phase}-{tag}")
        shutil.rmtree(out, ignore_errors=True)
        walls[phase], launches[phase], _ = cs.run_asm(
            lst, out, flags, phase,
            ("seqdb", "index", "overlap", "layout", "ctg_index", "mapping",
             "consensus"))
        digests[phase] = cs.output_digests(out)
        shutil.rmtree(out, ignore_errors=True)

    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.pipeline.run import Assembly
    from peregrine_tpu_torch.simdata import repeat_genome, simulate_reads
    rng = np.random.default_rng(9)
    chroms, _ = repeat_genome(rng, cs.REPEAT_N, n_chrom=1,
                              segdup_len=cs.REPEAT_SEGDUP)
    reads, _ = simulate_reads(rng, chroms[0], read_len=4000, coverage=16.0,
                              circular_wrap=8000)
    out = os.path.join(wd, f"phase12-{tag}")
    shutil.rmtree(out, ignore_errors=True)
    cs.reset_launches()
    t = time.time()
    asm = Assembly(out, AsmConfig(**cs.REPEAT_CFG), device="cuda",
                   with_alt=True)
    asm.run_draft(reads=reads)
    asm.build_consensus()
    torch.cuda.synchronize()
    walls["phase12"] = {"total": time.time() - t}
    launches["phase12"] = cs.launch_counts()
    digests["phase12"] = cs.output_digests(out)
    shutil.rmtree(out, ignore_errors=True)
    cs.say(json.dumps({"outputs_compare": {
        "tree": tree, "card": card, "digests": digests,
        "stage_walls_s": walls, "launches": launches}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
