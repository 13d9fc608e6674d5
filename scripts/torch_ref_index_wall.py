#!/usr/bin/env python3
"""Wall of the PyTorch port's reference index on one CUDA card.

    python3 scripts/torch_ref_index_wall.py [--tree DIR] [--repeat 5]

The reference is chip_smoke.py's E. coli-class genome (4.6 Mb, seed 42)
cut into 115 pieces of 40 kb, each past the default sketch_pad_len, so
build_index (default AsmConfig, k=16) indexes every piece through the
long route, as `pg-tpu-torch map` and stage 4's contig index do.  One
warm-up build (it also builds the kernels), then --repeat builds, each
timed on the host clock up to a device synchronise.  Each build's
sketch_batch and reduce_flat_np calls and kernel launches are counted.

--tree names the checkout whose peregrine_tpu_torch is imported (default:
the one holding this script), so that two commits are compared in one
call on one card: unpack the other into a directory that .gitignore
lists and run the script once per tree, in the order parent, change,
change, parent.  Prints one line per build, then a JSON line with the
walls, the counts, the card's name and its power limit.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

GENOME, PIECE, SEED = 4_600_000, 40_000, 42


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), help="checkout to import the port from")
    ap.add_argument("--repeat", type=int, default=5)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_ref_index_wall: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops import index, kernels as kn, sketch
    from peregrine_tpu_torch.simdata import random_genome
    if not index.__file__.startswith(os.path.join(tree, "")):
        raise SystemExit(f"imported {index.__file__}, not from {tree}")

    genome = random_genome(np.random.default_rng(SEED), GENOME)
    db = SeqDB.from_reads([(f"piece{i:03d}", genome[s:s + PIECE]) for i, s
                           in enumerate(range(0, GENOME, PIECE))])
    cfg = AsmConfig()
    calls = {"sketch_batch": 0, "reduce_flat_np": 0}

    def count(module, name):
        fn = getattr(module, name)

        def wrapper(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        setattr(module, name, wrapper)

    count(sketch, "sketch_batch")
    count(index, "reduce_flat_np")
    walls, records = [], set()
    for i in range(args.repeat + 1):
        for name in calls:
            calls[name] = 0
        kn.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = index.build_index(db, cfg, "cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        records.add(len(idx.x))
        if i:
            walls.append(wall)
        launches = {fn.__name__: fn.launches for fn in kn.KERNELS}
        print(f"{tree}: build_index of {len(db)} pieces"
              f"{' (warm-up)' if not i else ''}: {wall:.4f} s, "
              f"{len(idx.x)} SHIMMERs, calls {json.dumps(calls)}, "
              f"launches {json.dumps(launches)}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()
    print(json.dumps({"ref_index_wall": {
        "tree": tree, "pieces": len(db), "walls_s": walls,
        "median_s": float(np.median(walls)), "records": sorted(records),
        "calls": calls, "launches": launches, "card": smi[:1]}}))
    return 0 if len(records) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
