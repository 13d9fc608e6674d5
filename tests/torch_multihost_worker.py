"""One rank of a torch.distributed run of the port, for the multi-process
tests (tests/test_torch_multihost.py) and chip_smoke.py's phase 10.
Imports no jax.

    python tests/torch_multihost_worker.py MODE RANK WORLD INIT OUT DEVICE \
        [BACKEND]

joins the group at INIT (a file:// address) with BACKEND (gloo unless
given), on DEVICE (cpu, or cuda: the card LOCAL_RANK names, cuda:0
without it), then:

  pipeline     Assembly.run_multihost(OUT/reads.lst, with_consensus=True)
               into OUT/wd, on the multihost test set's configuration;
  defaults     the same with AsmConfig(mesh=True), the defaults (the
               smoke's E. coli-class set);
  collectives  sharded_index_host, build_pairs_mesh and sharded_align
               over the group's mesh on the data in OUT/data.npz, each
               rank writing what it got to OUT/got-RANK.npz.

The pipeline modes print one JSON line: the rank, the fasta it returned
and each kernel's launches in the run.
"""

import datetime
import json
import logging
import os
import sys

import numpy as np
import torch

torch.set_num_threads(2)

from peregrine_tpu_torch.config import AsmConfig  # noqa: E402
from peregrine_tpu_torch.parallel import distributed  # noqa: E402

# scripts/multihost_pipeline.py's configuration: small consensus windows
# so the ~60 kb contig yields enough windows for the work-split check
PIPELINE_CFG = AsmConfig(k=12, w=24, r=4, levels=2, min_len=2500,
                         min_ovlp_aln=300, sketch_pad_len=8192,
                         sketch_batch=8, mesh=True, cns_window=6000,
                         cns_max_template=12000)


def _pipeline(out: str, device, cfg: AsmConfig = PIPELINE_CFG) -> None:
    from peregrine_tpu_torch.ops import device_align, kernels
    from peregrine_tpu_torch.pipeline.run import Assembly
    fa = Assembly(os.path.join(out, "wd"), cfg, device=device).run_multihost(
        os.path.join(out, "reads.lst"), with_consensus=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    launches = {fn.__name__: fn.launches for fn in kernels.KERNELS}
    launches["myers_align"] = device_align.myers_batch_db.launches
    print(json.dumps({"rank": distributed.rank(), "fa": fa,
                      "launches": launches}), flush=True)


def _defaults(out: str, device) -> None:
    _pipeline(out, device, AsmConfig(mesh=True))


def _collectives(out: str, device) -> None:
    from peregrine_tpu_torch.ops.index import ShimmerIndex
    from peregrine_tpu_torch.parallel.sharded_index import sharded_index_host
    from peregrine_tpu_torch.parallel.sharded_overlap import (shard_seqdb,
                                                             sharded_align)
    from peregrine_tpu_torch.parallel.sharded_pairs import build_pairs_mesh

    d = dict(np.load(os.path.join(out, "data.npz")))
    mesh = distributed.global_mesh(device)
    got = {}
    shards = sharded_index_host(mesh, d["codes"], d["lens"], d["rids"], w=24,
                                k=int(d["k"]), r=4, levels=2)
    for i, (x, y) in enumerate(shards):
        got[f"x{i}"], got[f"y{i}"] = x, y
    idx = ShimmerIndex(d["ix"], d["iy"], d["mh"], d["mc"])
    pairs, stream = build_pairs_mesh(idx, d["rlen"], mesh)
    for i, a in enumerate(pairs + stream):
        got[f"p{i}"] = a
    sdb = shard_seqdb(d["data"], d["offsets"], d["rlen"], mesh)
    q = d["requests"]
    got["align"] = np.stack(sharded_align(
        sdb, q[:, 0], q[:, 1], q[:, 2], q[:, 3], q[:, 4], q[:, 5], q[:, 6],
        q[:, 7], L=int(d["L"])), 1)
    np.savez(os.path.join(out, f"got-{distributed.rank()}.npz"), **got)


def main(argv) -> int:
    mode, rank, world, init, out, device, *backend = argv
    logging.basicConfig(level=logging.INFO)
    distributed.init_distributed(
        init_method=init, world_size=int(world), rank=int(rank),
        backend=backend[0] if backend else "gloo", device=device,
        timeout=datetime.timedelta(seconds=300))
    try:
        {"pipeline": _pipeline, "defaults": _defaults,
         "collectives": _collectives}[mode](
            out, distributed.local_device(device))
    finally:
        distributed.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
