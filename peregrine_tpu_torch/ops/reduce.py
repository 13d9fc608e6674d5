"""Hierarchical SHIMMER reduction: records in rows, on the device.

The port of peregrine_tpu/ops/reduce.py.  reduce_impl is the general
reduction on int64 records: the window winner at column j minimizes the
composite key (x & ~0xFF) | (j % r) (hash in the high 56 bits, the ring
slot in place of the span byte) over the r trailing columns, in unsigned
order; winners are deduplicated against the previous column and
compacted, all in the one reduce_wide kernel.  The reference's ring buffer
scans slots in array order with a strict '<', so hash ties go to the
lowest slot (src/shmr_reduce.c:53-90); slots within a window are
distinct, so the key has no ties.

For k <= 16, x = hash << 8 | k, so the key orders exactly as
(hash, slot) — the order of the reduce_step kernel, which
reduce_flat_np runs on packed (H, P) planes instead, compacting its
winners in the same launch (tests/test_reduce.py asserts the equality on
the JAX side).  Its y word
rides through as its low 32 bits (pos << 1 | strand): within one read it
is unique, which is all the dedup compares.  Wider spans (k > 16) take
reduce_impl.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import reduce_step, reduce_wide


def reduce_impl(x: torch.Tensor, y: torch.Tensor, count: torch.Tensor, *,
                r: int):
    """Reduce per-read rows of records by a factor of ~r: one reduce_wide
    launch (the window winners, the dedup and the compaction).

    x, y: [B, C] int64 records compacted per row (INF padding); count: [B]
    int32 valid entries per row.  Returns (x', y', count') in the same
    layout."""
    return reduce_wide(x, y, count, r=r)


def _rows(x: np.ndarray, y: np.ndarray):
    """One row per run of equal rid in y: (rids, starts, lens, row, col)
    with record i at [row[i], col[i]]."""
    rids = (y >> np.uint64(32)).astype(np.int64)
    starts = np.flatnonzero(np.r_[True, np.diff(rids) != 0])
    lens = np.diff(np.r_[starts, len(x)])
    row = np.repeat(np.arange(len(starts)), lens)
    col = np.arange(len(x)) - np.repeat(starts, lens)
    return rids, starts, lens, row, col


def _reduce_packed(x: np.ndarray, y: np.ndarray, r: int, device):
    """reduce_flat_np on packed (H, P) planes: the fused reduce_step
    kernel, which writes the winners compacted.  Needs one span of at most
    16 (a 32-bit hash)."""
    span = x & np.uint64(0xFF)
    k = int(span[0])
    if k > 16 or (span != span[0]).any():
        raise ValueError("packed planes need one span <= 16, got "
                         f"{np.unique(span)[:4].tolist()}")
    rids, starts, lens, row, colj = _rows(x, y)
    B, C = len(starts), int(lens.max())
    H = np.full((B, C), -1, np.int32)
    P = np.full((B, C), -1, np.int32)
    H[row, colj] = (x >> np.uint64(8)).astype(np.uint32).view(np.int32)
    P[row, colj] = (y & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    n = torch.from_numpy(lens.astype(np.int32)).to(device)
    oH, oP, count = reduce_step(torch.from_numpy(H).to(device),
                                torch.from_numpy(P).to(device), n, r=r)
    valid = torch.arange(C, device=oH.device)[None, :] < count[:, None]
    oh = oH[valid].cpu().numpy().view(np.uint32).astype(np.uint64)
    op = oP[valid].cpu().numpy().view(np.uint32).astype(np.uint64)
    orid = np.repeat(rids[starts], count.cpu().numpy()).astype(np.uint64)
    return ((oh << np.uint64(8)) | np.uint64(k),
            (orid << np.uint64(32)) | op)


def _reduce_records(x: np.ndarray, y: np.ndarray, r: int, device):
    """reduce_flat_np on int64 record rows: reduce_impl."""
    _, starts, lens, row, colj = _rows(x, y)
    B, C = len(starts), int(lens.max())
    X = np.full((B, C), -1, np.int64)
    Y = np.full((B, C), -1, np.int64)
    X[row, colj] = x.view(np.int64)
    Y[row, colj] = y.view(np.int64)
    ox, oy, count = reduce_impl(
        torch.from_numpy(X).to(device), torch.from_numpy(Y).to(device),
        torch.from_numpy(lens.astype(np.int32)).to(device), r=r)
    valid = torch.arange(C, device=ox.device)[None, :] < count[:, None]
    return (ox[valid].cpu().numpy().view(np.uint64),
            oy[valid].cpu().numpy().view(np.uint64))


def reduce_flat_np(x: np.ndarray, y: np.ndarray, r: int, device
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Reduce a concatenated (rid-ordered) minimizer list by one level.

    Splits by the rid field of y into rows, reduces them on `device` and
    re-flattens; dedup never fires across rid boundaries because each rid
    is its own row.  One span of at most 16 runs the packed kernels; any
    other list runs reduce_impl.
    """
    if len(x) == 0:
        return x.copy(), y.copy()
    span = x & np.uint64(0xFF)
    if span[0] <= 16 and (span == span[0]).all():
        return _reduce_packed(x, y, r, device)
    return _reduce_records(x, y, r, device)


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
