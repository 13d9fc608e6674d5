"""Multi-device pair map + bucket stream (the stage-2 prologue on a mesh).

The port of peregrine_tpu/parallel/sharded_pairs.py, byte-identical to
the host build (ops.overlap.build_pairs with one chunk, then
bucket_stream) and to ops.device_pairs.build_pairs_device:

1. index entries are split into contiguous read ranges, one a shard
   (adjacent-pair candidacy never crosses a read); counts come from the
   replicated MC table, and the global first strictly-upper entry is the
   minimum over the shards;
2. each shard emits both orientation records of its candidates, tagged
   with a global candidate rank (an exclusive scan over the shards), the
   tiebreak that reproduces the host build's stable order;
3. records go to the shard owning their key0, by the order-preserving
   top bits ((hash * n) >> 56), so shard order is ascending key0 order
   (parallel.mesh.exchange sizes the exchange from the counts, so it
   cannot overflow: the reference's host rebuild on overflow is gone);
4. each shard sorts by (key0, key1, rank) and builds its bucket stream;
   a bucket never crosses shards, as equal key0 lands on one shard.

The sorts, scans and the flip are ops.device_pairs' (int64 with
x ^ 2^63 for u64 order, u32 arithmetic masked to 32 bits).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.device_pairs import _SIGN, _U28, _U32, _flip, _stable_order
from .mesh import Mesh, exchange

_H56 = (1 << 56) - 1


def _shard_bounds(y: np.ndarray, n: int) -> list:
    """Near-even cuts by entries, each advanced to the next read start."""
    N = len(y)
    rid = y >> np.uint64(32)
    bounds = [0]
    for d in range(1, n):
        c = min(N, d * N // n)
        while 0 < c < N and rid[c] == rid[c - 1]:
            c += 1
        bounds.append(max(c, bounds[-1]))
    bounds.append(N)
    return bounds


def _i64(a: np.ndarray, dev) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(dev)


def build_pairs_mesh(idx, read_lengths: np.ndarray, mesh: Mesh,
                     mc_lower: int = 2, mc_upper: int = 240,
                     min_dist: int = 100, ovlp_upper: int = 120):
    """Pair map + bucket stream of a ShimmerIndex over a mesh.  Returns
    (pairs, stream) as build_pairs_device does: pairs = (key0, key1, y0,
    y1, direction), stream = (ys, dirs, pos, bstart, bend)."""
    n = mesh.n
    x_all = np.ascontiguousarray(idx.x, np.uint64)
    y_all = np.ascontiguousarray(idx.y, np.uint64)
    if len(x_all) < 2:
        z64, zi = np.zeros(0, np.uint64), np.zeros(0, np.int64)
        return ((z64, z64, z64, z64, np.zeros(0, np.uint8)),
                (z64, np.zeros(0, np.uint8), zi, zi, zi))
    bounds = _shard_bounds(y_all, n)
    rl_np = np.asarray(read_lengths, np.int64) & _U32

    # per shard: counts, eligibility and its first strictly-upper entry
    state, firsts = [], []
    for d, dev in mesh.shards():
        lo, hi = bounds[d], bounds[d + 1]
        x, y = _i64(x_all[lo:hi], dev), _i64(y_all[lo:hi], dev)
        mch = _i64(np.asarray(idx.mc_hash, np.uint64), dev)
        mcc = torch.from_numpy(np.asarray(idx.mc_count, np.int64)).to(dev)
        h = (x >> 8) & _H56
        loc = torch.searchsorted(mch, h).clamp(max=mch.numel() - 1)
        counts = torch.where(mch[loc] == h, mcc[loc], 0)
        elig = (counts >= mc_lower) & (counts <= mc_upper)
        ok = torch.nonzero((counts >= mc_lower) & (counts < mc_upper))
        firsts.append(torch.full((1,), lo + int(ok[0, 0]) if ok.numel()
                                 else 1 << 62, dtype=torch.int64, device=dev))
        state.append((lo, x, y, elig, torch.from_numpy(rl_np).to(dev)))
    gfirst = int(torch.cat(mesh.all_gather(firsts)).min())

    # adjacent kept records on one read, at least min_dist apart
    cands, n_cand = [], []
    for (lo, x, y, elig, rl), (_, dev) in zip(state, mesh.shards()):
        iota = torch.arange(x.numel(), device=dev)
        keep = elig & (lo + iota >= gfirst)
        pk = torch.cummax(torch.where(keep, iota, -1), dim=0).values
        prev = torch.cat([pk.new_full((1,), -1), pk])[:-1]
        p = prev.clamp(min=0)
        xp, yp = x[p], y[p]
        dist = (((y >> 1) & _U28) - ((yp >> 1) & _U28)) & _U32
        cand = (keep & (prev >= 0) & ((y >> 32) == (yp >> 32))
                & (dist >= min_dist))
        cands.append((x[cand], y[cand], xp[cand], yp[cand], rl))
        n_cand.append(cand.sum().reshape(1))
    all_c = torch.cat(mesh.all_gather(n_cand))
    total = int(all_c.sum())

    # forward records (x_p, x, y_p, y), reverse ones (x, x_p, flip(y),
    # flip(y_p)); dt = global rank << 1 | direction
    targets, recs = [], []
    for (d, dev), (xc, yc, xpc, ypc, rl) in zip(mesh.shards(), cands):
        rank = int(all_c[:d].sum()) + torch.arange(xc.numel(), device=dev)
        k0 = torch.cat([xpc, xc])
        dt = torch.cat([rank << 1, ((total + rank) << 1) | 1])
        recs.append(torch.stack([
            k0, torch.cat([xc, xpc]),
            torch.cat([ypc, _flip(yc, xc, rl)]),
            torch.cat([yc, _flip(ypc, xpc, rl)]), dt], 1))
        targets.append((((k0 >> 8) & _H56) * n) >> 56)

    # each shard: (key0, key1, rank) order, then its bucket stream:
    # buckets of size in (2, ovlp_upper], bucket-major, descending
    # position inside a bucket; a column marks each bucket's first row
    pairs, stream = [], []
    for got in exchange(mesh, targets, recs):
        got = got[_stable_order(got[:, 0] ^ _SIGN, got[:, 1] ^ _SIGN,
                                got[:, 4])]
        k0, k1, y0 = got[:, 0], got[:, 1], got[:, 2]
        first = torch.ones(k0.numel(), dtype=torch.bool, device=k0.device)
        first[1:] = (k0[1:] != k0[:-1]) | (k1[1:] != k1[:-1])
        brank = torch.cumsum(first.to(torch.int64), dim=0) - 1
        bsize = torch.bincount(brank)[brank]
        sel = (bsize > 2) & (bsize <= ovlp_upper)
        sb, sp = brank[sel], (y0[sel] & _U32) >> 1
        st = torch.sort((sb << 32) | (_U32 - sp), stable=True).indices
        sb = sb[st]
        starts = torch.ones_like(sb)
        starts[1:] = (sb[1:] != sb[:-1]).to(torch.int64)
        pairs.append(got)
        stream.append(torch.stack([y0[sel][st], got[sel][st][:, 4] & 1,
                                   sp[st], starts], 1))

    got = torch.cat(mesh.all_gather(pairs))
    st = torch.cat(mesh.all_gather(stream))
    b = np.concatenate([np.flatnonzero(st[:, 3].numpy()),
                        [len(st)]]).astype(np.int64)
    bs, be = (b[:-1].copy(), b[1:].copy()) if len(st) else (b[:0], b[:0])

    def u64(t):
        return t.numpy().view(np.uint64).copy()

    return ((u64(got[:, 0]), u64(got[:, 1]), u64(got[:, 2]), u64(got[:, 3]),
             (got[:, 4] & 1).numpy().astype(np.uint8)),
            (u64(st[:, 0]), st[:, 1].numpy().astype(np.uint8),
             st[:, 2].numpy().astype(np.int64), bs, be))
