#!/usr/bin/env python3
"""The wide (k = 28) route of one checkout on one CUDA card: chip_smoke.py's
phase-6 assembly and phase 10's k=28 mesh index, digested.

    python3 scripts/torch_wide_compare.py [--tree DIR]

--tree names the checkout whose peregrine_tpu_torch is imported (default:
the one holding this script); chip_smoke.py comes from the checkout
holding this script, so every tree gets the same inputs.  To compare two
commits in one call on one card, unpack the other into a directory that
.gitignore lists (`wd-*/`) and run the script once per tree, in the order
parent, change, change, parent.

It runs `asm --shimmer-k 28 --with-L0-index --with-consensus` through the
tree's cli.main on chip_smoke's E. coli-class set (its reads are
simulated once into wd-wide-compare/ and reused by later runs), with the
stage walls and every kernel's launches, then build_index_mesh at k=28
over chip_smoke's mesh of four shards on cuda:0 with the seqdb that run
wrote.  It digests p_ctg.fa, read_map.txt, p_ctg_cns.fa, every file of
1-index/ and the mesh index's arrays, so that the trees' results can be
compared, and prints a JSON line with the digests, walls, launches, the
card's name and its power limit.  Exits non-zero without a CUDA device.
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


def _digest_file(path: str) -> str:
    with open(path, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()[:16]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=ROOT,
                    help="checkout to import the port from")
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_wide_compare: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from peregrine_tpu_torch.ops import kernels as kn
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
    importlib.import_module("peregrine_tpu_torch.native")
    cs.say(f"kernels and native library built in {time.time() - t0:.1f} s")

    wd = os.path.join(ROOT, "wd-wide-compare")
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
    out = os.path.join(wd, "asm-"
                       + hashlib.sha1(tree.encode()).hexdigest()[:8])
    shutil.rmtree(out, ignore_errors=True)
    flags = ["--shimmer-k", str(cs.K_WIDE), "--with-L0-index",
             "--with-consensus"]
    walls, launches, total = cs.run_asm(
        lst, out, flags, "wide path",
        ("seqdb", "index", "overlap", "layout", "ctg_index", "mapping",
         "consensus"))
    digests = {rel: _digest_file(os.path.join(out, rel)) for rel in (
        "3-asm/p_ctg.fa", "4-cns/read_map.txt", "4-cns/p_ctg_cns.fa")}
    for name in sorted(os.listdir(os.path.join(out, "1-index"))):
        digests["1-index/" + name] = _digest_file(
            os.path.join(out, "1-index", name))

    from peregrine_tpu_torch.config import AsmConfig
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.parallel.mesh import Mesh
    from peregrine_tpu_torch.parallel.sharded_index import build_index_mesh
    db = SeqDB.open(os.path.join(out, "0-seqdb", "seq_dataset"))
    mesh = Mesh(["cuda:0"] * cs.MESH_SHARDS)
    torch.cuda.synchronize()
    cs.reset_launches()
    t = time.time()
    idx = build_index_mesh(db, AsmConfig(k=cs.K_WIDE), mesh)
    torch.cuda.synchronize()
    mesh_s = time.time() - t
    mesh_launches = cs.launch_counts()
    h = hashlib.sha1()
    for f in ("x", "y", "mc_hash", "mc_count"):
        h.update(getattr(idx, f).tobytes())
    digests["mesh index k=28"] = h.hexdigest()[:16]
    shutil.rmtree(out, ignore_errors=True)
    cs.say(json.dumps({"wide_compare": {
        "tree": tree, "card": card, "digests": digests,
        "stage_walls_s": walls, "asm_s": total, "launches": launches,
        "mesh_s": mesh_s, "mesh_launches": mesh_launches,
        "mesh_records": int(len(idx.x))}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
