"""Hierarchical SHIMMER reduction of flat record lists, on packed planes.

The port of peregrine_tpu/ops/reduce.py's host entry points.  The JAX
package reduces uint64 records with reduce_impl (composite key
(x & ~0xFF) | ring slot, then the compact_planes kernel); for k <= 16,
x = hash << 8 | k, so that key orders exactly as (hash, slot) — the order
of the reduce_step kernel, which this module runs with move_plane and
never compact_planes (tests/test_reduce.py asserts the equality on the
JAX side).  The record's y word rides through as its low 32 bits
(pos << 1 | strand): within one read it is unique, which is all the
dedup compares.  Spans above 16 (the wide sketch) raise.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import move_plane, reduce_step


def reduce_flat_np(x: np.ndarray, y: np.ndarray, r: int, device
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Reduce a concatenated (rid-ordered) minimizer list by one level.

    Splits by the rid field of y into rows of planes, runs reduce_step and
    move_plane on `device`, and re-flattens; dedup never fires across rid
    boundaries because each rid is its own row.
    """
    if len(x) == 0:
        return x.copy(), y.copy()
    span = x & np.uint64(0xFF)
    k = int(span[0])
    if k > 16 or (span != span[0]).any():
        raise ValueError("reduce_flat_np: packed planes need one span "
                         f"<= 16, got {np.unique(span)[:4].tolist()} (the "
                         "wide k > 16 path is not yet ported)")
    rids = (y >> np.uint64(32)).astype(np.int64)
    starts = np.flatnonzero(np.r_[True, np.diff(rids) != 0])
    lens = np.diff(np.r_[starts, len(x)])
    B, C = len(starts), int(lens.max())
    # row b, column j <- record starts[b] + j
    row = np.repeat(np.arange(B), lens)
    colj = np.arange(len(x)) - np.repeat(starts, lens)
    H = np.full((B, C), -1, np.int32)
    P = np.full((B, C), -1, np.int32)
    H[row, colj] = (x >> np.uint64(8)).astype(np.uint32).view(np.int32)
    P[row, colj] = (y & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    Ht = torch.from_numpy(H).to(device)
    Pt = torch.from_numpy(P).to(device)
    n = torch.from_numpy(lens.astype(np.int32)).to(device)
    H2, P2, dest, count = reduce_step(Ht, Pt, n, r=r)
    oH = move_plane(dest, H2)
    oP = move_plane(dest, P2)
    valid = torch.arange(C, device=oH.device)[None, :] < count[:, None]
    oh = oH[valid].cpu().numpy().view(np.uint32).astype(np.uint64)
    op = oP[valid].cpu().numpy().view(np.uint32).astype(np.uint64)
    orid = np.repeat(rids[starts], count.cpu().numpy()).astype(np.uint64)
    return ((oh << np.uint64(8)) | np.uint64(k),
            (orid << np.uint64(32)) | op)


def end_filter_np(x: np.ndarray, y: np.ndarray, read_lengths: np.ndarray,
                  end_length: int):
    """Split minimizers into 5'-end / 3'-end subsets by proximity to the
    read ends (reference mm_end_filter, src/shmr_end_filter.c:12-36 —
    dormant there: its call site is commented out at src/shmr_index.c:173,
    kept for inventory parity).

    Returns ((x5, y5), (x3, y3)): records with pos < end_length, and
    records with rlen - pos + span < end_length (a record near both ends
    of a short read appears in both, as in the reference).
    """
    rid = (y >> np.uint64(32)).astype(np.int64)
    span = (x & np.uint64(0xFF)).astype(np.int64)
    pos = ((y & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64) + 1
    rlen = read_lengths[rid].astype(np.int64)
    r_pos = rlen - pos + span
    m5 = pos < end_length
    m3 = r_pos < end_length
    return (x[m5], y[m5]), (x[m3], y[m3])
