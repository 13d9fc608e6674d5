"""Stage-2 pair map and bucket stream on the device (--device-pairs).

The port of peregrine_tpu/ops/device_pairs.py: build_map semantics
(reference src/shmr_utils.c:295-404) as sorts, scans and gathers in plain
PyTorch on the given device, byte-identical to the host build
(ops.overlap.build_pairs with one chunk, then bucket_stream):

* MC counts by a sort self-join on the 56-bit index hashes;
* eligibility, the first strictly-upper entry, adjacent-kept candidates
  (the previous kept entry by a cummax scan) and the orientation flips,
  elementwise;
* the (key0, key1) pair sort and the (bucket, descending position) stream
  sort as stable torch.sort passes, least significant key first.

The 64-bit keys ride in int64: x ^ 2^63 makes signed order unsigned
order (at k > 16, x = hash << 8 | span uses all 64 bits), and the u32
arithmetic of positions and flips is masked to 32 bits.  The JAX
package's shape classes and validity lane (a compile-cache workaround)
are gone: only the valid rows are sorted.
"""

from __future__ import annotations

import numpy as np
import torch

_U28 = 0xFFFFFFF
_U32 = 0xFFFFFFFF
_SIGN = -(1 << 63)    # int64 with only bit 63 set: x ^ _SIGN orders as u64


def _stable_order(*keys: torch.Tensor) -> torch.Tensor:
    """The permutation that sorts rows stably by keys[0], then keys[1],
    ...: one stable sort per key, the least significant first."""
    order = torch.arange(keys[0].numel(), device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.sort(k[order], stable=True).indices]
    return order


def _flip(y: torch.Tensor, x: torch.Tensor, rl: torch.Tensor) -> torch.Tensor:
    """The record's coordinate on the other strand (src/shmr_utils.c:
    377-395), in the JAX kernel's u32 arithmetic: the read length is
    looked up with the rid clipped to [0, len(rl)) as an int32, as
    jnp.take(mode="clip") does."""
    span = x & 0xFF
    yl = y & _U32
    pos = (yl >> 1) + 1
    rid = (y >> 32) & _U32
    rid = torch.where(rid >= 1 << 31, 0, rid.clamp(max=rl.numel() - 1))
    rpos = (rl[rid] - pos + span - 1) & _U32
    low = ((yl & 1) | ((rpos << 1) & _U32)) ^ 1
    return (y & ~_U32) | low


def _to_u64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def build_pairs_device(idx, read_lengths: np.ndarray, device,
                       mc_lower: int = 2, mc_upper: int = 240,
                       min_dist: int = 100, ovlp_upper: int = 120):
    """Pair map + bucket stream of a ShimmerIndex on `device`.  Returns
    (pairs, stream): pairs = (key0, key1, y0, y1, direction), equal to
    ops.overlap.build_pairs(idx, read_lengths, 1, 1, ...), and stream =
    (ys, dirs, pos, bstart, bend), equal to ops.overlap.bucket_stream of
    those pairs."""
    device = torch.device(device)
    n = len(idx.x)
    z64 = np.zeros(0, np.uint64)
    zi = np.zeros(0, np.int64)
    empty = ((z64, z64, z64, z64, np.zeros(0, np.uint8)),
             (z64, np.zeros(0, np.uint8), zi, zi, zi))
    if n < 2:
        return empty

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int64)).to(
            device)

    x = put(np.asarray(idx.x, np.uint64))
    y = put(np.asarray(idx.y, np.uint64))
    rl = torch.from_numpy(np.asarray(read_lengths, np.int64) & _U32).to(device)
    iota = torch.arange(n, device=device)

    # counts: the multiplicity of each record's 56-bit hash
    _, inverse, runs = torch.unique((x >> 8) & ((1 << 56) - 1),
                                    return_inverse=True, return_counts=True)
    counts = runs[inverse]

    # eligibility from the first entry whose count lies in [lower, upper)
    elig = (counts >= mc_lower) & (counts <= mc_upper)
    first_ok = (counts >= mc_lower) & (counts < mc_upper)
    ok = torch.nonzero(first_ok)
    if ok.numel() == 0:
        return empty
    keep = elig & (iota >= ok[0, 0])

    # adjacent kept records on one read, at least min_dist apart
    pk = torch.cummax(torch.where(keep, iota, -1), dim=0).values
    prev = torch.cat([pk.new_full((1,), -1), pk[:-1]])
    p = prev.clamp(min=0)
    x_p, y_p = x[p], y[p]
    dist = (((y >> 1) & _U28) - ((y_p >> 1) & _U28)) & _U32
    cand = keep & (prev >= 0) & ((y >> 32) == (y_p >> 32)) & (dist >= min_dist)
    if not bool(cand.any()):
        return empty
    xc, yc, xpc, ypc = x[cand], y[cand], x_p[cand], y_p[cand]

    # forward records (x_p, x, y_p, y, 0), then reverse ones (x, x_p,
    # flip(y), flip(y_p), 1), stably sorted by (key0, key1) as u64
    k0 = torch.cat([xpc, xc])
    k1 = torch.cat([xc, xpc])
    y0 = torch.cat([ypc, _flip(yc, xc, rl)])
    y1 = torch.cat([yc, _flip(ypc, xpc, rl)])
    m = xc.numel()
    dirv = torch.cat([torch.zeros(m, dtype=torch.uint8, device=device),
                      torch.ones(m, dtype=torch.uint8, device=device)])
    order = _stable_order(k0 ^ _SIGN, k1 ^ _SIGN)
    k0, k1, y0, y1, dirv = (t[order] for t in (k0, k1, y0, y1, dirv))

    # bucket stream: runs of equal (key0, key1) of size in (2, ovlp_upper],
    # bucket-major, descending position inside a bucket, stable
    M = 2 * m
    first = torch.ones(M, dtype=torch.bool, device=device)
    first[1:] = (k0[1:] != k0[:-1]) | (k1[1:] != k1[:-1])
    brank = torch.cumsum(first.to(torch.int64), dim=0) - 1
    bsize = torch.bincount(brank)[brank]
    s_elig = (bsize > 2) & (bsize <= ovlp_upper)
    spos = (y0 >> 1) & _U28
    sb, sp = brank[s_elig], spos[s_elig]
    st = torch.sort((sb << 28) | (_U28 - sp), stable=True).indices
    st_y0 = y0[s_elig][st]
    st_dir = dirv[s_elig][st]
    st_b = sb[st]
    pos = sp[st]

    ns = st_b.numel()
    if ns:
        change = torch.nonzero(st_b[1:] != st_b[:-1])[:, 0] + 1
        bounds = torch.cat([change.new_zeros(1), change,
                            change.new_full((1,), ns)]).cpu().numpy()
        bs, be = bounds[:-1].copy(), bounds[1:].copy()
    else:
        bs = be = zi
    pairs = (_to_u64(k0), _to_u64(k1), _to_u64(y0), _to_u64(y1),
             dirv.cpu().numpy())
    stream = (_to_u64(st_y0), st_dir.cpu().numpy(), pos.cpu().numpy(), bs, be)
    return pairs, stream
