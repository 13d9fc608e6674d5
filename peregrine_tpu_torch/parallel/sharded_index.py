"""Multi-device SHIMMER indexing: data-parallel sketch + hash-shard exchange.

The port of peregrine_tpu/parallel/sharded_index.py.  Per batch:

1. reads are split over the mesh's shards, per_dev rows each (rows of
   length 0 pad the last batch); each shard sketches and reduces its
   rows on its device (ops.index.index_step with the sketch capped at
   max(256, L/8) columns and the final level whole), and raises if any
   row's sketch overflowed the cap, as the reference does;
2. each record goes to the shard owning its hash, (x >> 8) % n: a stable
   sort by target and a scatter into a send buffer sized from the
   exchanged counts (parallel.mesh.exchange) — the reference's log-shift
   spread and one-hot counts are TPU workarounds the port leaves out;
3. each shard sorts what it received by (x, y) as unsigned 64-bit values.

build_index_mesh runs this over every batch of a seqdb and re-orders the
records by y into the rid-ordered index that build_index returns, byte
for byte.  Under a process group every rank receives every shard, as the
reference replicates them, so every rank holds the whole index.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import AsmConfig
from ..io.seqdb import SeqDB
from ..ops.device_pairs import _stable_order
from ..ops.index import (ShimmerIndex, _index_long, _length_buckets,
                         _merge_counts, index_step)
from .mesh import Mesh, exchange

_SIGN = -(1 << 63)    # x ^ _SIGN orders int64 as u64
_H56 = (1 << 56) - 1


def _index_shards(mesh: Mesh, batches: list, *, w: int, k: int, r: int,
                  levels: int) -> list:
    """batches[i] = (codes uint8 [b, L], lengths, rids) numpy rows of
    local shard i (b and L the same on every shard).  Returns per local
    shard its hash shard's records, int64 [m, 2] columns (x, y) sorted by
    (x, y) as u64, on its device."""
    recs, targets, overflow = [], [], []
    for (_, dev), (codes, lens, rids) in zip(mesh.shards(), batches):
        cap = max(256, codes.shape[1] // 8)
        x, y, c, c0 = index_step(
            torch.from_numpy(codes).to(dev),
            torch.from_numpy(lens.astype(np.int32)).to(dev),
            torch.from_numpy(rids.astype(np.int64)).to(dev),
            w=w, k=k, r=r, levels=levels, cap=cap, tight_out=False)
        overflow.append((c0 > cap).any().to(torch.int64).reshape(1))
        valid = torch.arange(x.shape[1], device=dev)[None, :] < c[:, None]
        xv, yv = x[valid], y[valid]
        recs.append(torch.stack([xv, yv], 1))
        targets.append(((xv >> 8) & _H56) % mesh.n)
    if any(int(f) for f in mesh.all_gather(overflow)):
        raise ValueError(
            "sketch cap overflowed on a mesh shard; raise the pad length "
            "(records would be silently truncated otherwise)")
    out = []
    for got in exchange(mesh, targets, recs):
        order = _stable_order(got[:, 0] ^ _SIGN, got[:, 1] ^ _SIGN)
        out.append(got[order])
    return out


def _gathered(mesh: Mesh, shards: list) -> list:
    """Every shard's records on the host: [(x, y)] u64 numpy, by shard."""
    return [(a[:, 0].numpy().view(np.uint64).copy(),
             a[:, 1].numpy().view(np.uint64).copy())
            for a in mesh.all_gather(shards)]


def sharded_index_host(mesh: Mesh, codes: np.ndarray, lengths: np.ndarray,
                       rids: np.ndarray, *, w: int, k: int, r: int,
                       levels: int) -> list:
    """One batch over the mesh: codes [B, L] (B padded to a multiple of n
    with rows of length 0) split into n contiguous row blocks, block d on
    shard d.  Returns every hash shard's (x, y) records, shard order,
    each sorted by (x, y) — on every rank under a process group."""
    n = mesh.n
    B, L = codes.shape
    pad = (-B) % n
    if pad:
        codes = np.concatenate([codes, np.full((pad, L), 4, np.uint8)])
        lengths = np.concatenate([lengths, np.zeros(pad, lengths.dtype)])
        rids = np.concatenate([rids, np.zeros(pad, rids.dtype)])
    per = len(codes) // n
    batches = [(codes[d * per:(d + 1) * per], lengths[d * per:(d + 1) * per],
                rids[d * per:(d + 1) * per]) for d in mesh.local]
    return _gathered(mesh, _index_shards(mesh, batches, w=w, k=k, r=r,
                                         levels=levels))


def build_index_mesh(db: SeqDB, cfg: AsmConfig, mesh: Mesh,
                     rid_filter: np.ndarray | None = None) -> ShimmerIndex:
    """Stage-1 SHIMMER index over a mesh; equal to ops.index.build_index.

    Reads up to 2 * sketch_pad_len long take the batch route, per_dev
    rows a shard (the reference's threshold: reads in (pad, 2 pad] are
    batched here where build_index takes them down the long route; their
    records are the same).  Longer sequences take build_index's batched
    long route (_index_long) on the first shard's device, on every rank.
    Each shard builds only its own rows' code batch."""
    n = mesh.n
    rids_all = (np.arange(len(db)) if rid_filter is None
                else np.asarray(rid_filter))
    lengths = db.lengths[rids_all].astype(np.int64)
    long_x: dict = {}
    long_y: dict = {}
    long_sel = lengths > 2 * cfg.sketch_pad_len
    if long_sel.any():
        _index_long(db, rids_all[long_sel], cfg, mesh.devices[0], long_x,
                    long_y, None)
    xs = list(long_x.values())
    ys = list(long_y.values())
    rids_all = rids_all[~long_sel]
    lengths = lengths[~long_sel]

    step = dict(w=cfg.w, k=cfg.k, r=cfg.r, levels=cfg.levels)
    bucket_unit = max(2048, cfg.sketch_pad_len // 4)
    for pad, sel in _length_buckets(lengths, bucket_unit).items():
        batch_rids = rids_all[sel]
        per_dev = max(1, min(cfg.sketch_batch,
                             (cfg.sketch_batch * cfg.sketch_pad_len) // pad))
        for i in range(0, len(batch_rids), per_dev * n):
            part = batch_rids[i:i + per_dev * n]
            batches = []
            for d in mesh.local:
                rows = part[d * per_dev:(d + 1) * per_dev]
                codes = np.full((per_dev, pad), 4, np.uint8)
                lens = np.zeros(per_dev, np.int32)
                ids = np.zeros(per_dev, np.int64)
                codes[:len(rows)], lens[:len(rows)] = db.padded_code_batch(
                    rows, pad)
                ids[:len(rows)] = rows
                batches.append((codes, lens, ids))
            for sx, sy in _gathered(mesh, _index_shards(mesh, batches,
                                                        **step)):
                xs.append(sx)
                ys.append(sy)

    x = np.concatenate(xs) if xs else np.zeros(0, np.uint64)
    y = np.concatenate(ys) if ys else np.zeros(0, np.uint64)
    # y = rid<<32|pos<<1|strand ascends within each read's records, so a
    # stable sort by y gives build_index's rid-ordered layout
    from ..native import sort_by_y
    x = np.ascontiguousarray(x, np.uint64)
    y = np.ascontiguousarray(y, np.uint64)
    sort_by_y(y, x)
    mh, mc = _merge_counts(x >> np.uint64(8), np.ones(len(x), np.uint32))
    return ShimmerIndex(x, y, mh, mc)
