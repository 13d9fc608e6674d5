"""(w,k)-minimizer sketch: packed (H, P) planes for k <= 16, wide records
for 17 <= k <= 28.

The port of peregrine_tpu/ops/sketch.py (see that module's docstring for
the emission-set semantics and the documented superset divergences from
the reference).  For k <= 16 one sketch is
build_stream -> move_plane -> emit_mask -> move_plane, each move taking
both planes (ops.kernels: CUDA kernels on the card, plain PyTorch on the
CPU), and
records are assembled only at the end.  For k > 16 the hash needs up to
56 bits, so sketch_wide works on the records themselves; its two stable
compactions are the compact_planes kernel and the rest is elementwise
PyTorch, as the JAX package leaves it to XLA.

    x = hash << 8 | k                       (span == k)
    y = rid << 32 | pos << 1 | strand

Records are int64 tensors holding the uint64 bits; INF (all ones) is -1.
At k > 16, x uses all 64 bits, so the wide path compares records in
unsigned order: x ^ SIGN orders as signed int64 exactly as x does as
uint64.
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import (_shift_right, build_stream, compact_planes, emit_mask,
                      hash64, move_plane)

INF = -1  # uint64 0xFFFF_FFFF_FFFF_FFFF as int64
SIGN = -(1 << 63)  # x ^ SIGN: unsigned order as signed order
MAX_K = 28  # 56-bit hashes: x = hash << 8 | span fills 64 bits


def sketch_planes(codes: torch.Tensor, lengths: torch.Tensor, *, w: int,
                  k: int):
    """[B, L] uint8 codes, [B] int32 lengths -> the emitted (H, P) planes
    and their counts (replaces peregrine_tpu's sketch_planes_tpu).
    Columns at or past a row's count are stale."""
    H, P, dest, n = build_stream(codes, lengths, k=k)
    sH, sP = move_plane(dest, H, P)
    dest2, count = emit_mask(sH, sP, n, w=w, k=k)
    return move_plane(dest2, sH, sP) + (count,)


def assemble_records(oH: torch.Tensor, oP: torch.Tensor, count: torch.Tensor,
                     rids: torch.Tensor, k: int):
    """(H, P) planes -> reference-encoded (x, y) int64 records, INF past
    the counts (peregrine_tpu/ops/sketch.py:assemble_records)."""
    L = oH.shape[1]
    valid = torch.arange(L, device=oH.device)[None, :] < count[:, None]
    h = oH.to(torch.int64) & 0xFFFFFFFF
    p = oP.to(torch.int64) & 0xFFFFFFFF
    x = torch.where(valid, (h << 8) | k, INF)
    y = torch.where(valid, (rids.to(torch.int64)[:, None] << 32)
                    | ((p >> 2) << 1) | ((p >> 1) & 1), INF)
    return x, y


def _shift_left(a: torch.Tensor, d: int, fill: int) -> torch.Tensor:
    """a[:, i + d], with fill where i + d >= L."""
    if d == 0:
        return a
    out = torch.full_like(a, fill)
    if d < a.shape[1]:
        out[:, :-d] = a[:, d:]
    return out


def _blocks(a: torch.Tensor, w: int, fill: int):
    """Pad [B, L] to whole blocks of w columns: a [B, nb, w] view."""
    B, L = a.shape
    P = -(-L // w) * w
    ap = torch.full((B, P), fill, dtype=a.dtype, device=a.device)
    ap[:, :L] = a
    return ap.view(B, P // w, w)


def _sliding_min_trailing(a: torch.Tensor, w: int, fill: int) -> torch.Tensor:
    """W[t] = min(a[t-w+1 .. t]) in unsigned order, fill out of range:
    per-block prefix and suffix minima combined by one static shift."""
    B, L = a.shape
    s, f = a ^ SIGN, fill ^ SIGN
    blocks = _blocks(s, w, f)
    pref = torch.cummin(blocks, dim=2).values.reshape(B, -1)
    suf = torch.cummin(blocks.flip(2), dim=2).values.flip(2).reshape(B, -1)
    left = _shift_right(suf, w - 1, f)[:, :L]
    return torch.minimum(left, pref[:, :L]) ^ SIGN


def _sliding_max_leading(a: torch.Tensor, w: int, fill: int) -> torch.Tensor:
    """M[t] = max(a[t .. t+w-1]) in unsigned order, fill out of range."""
    B, L = a.shape
    s, f = a ^ SIGN, fill ^ SIGN
    blocks = _blocks(s, w, f)
    pref = torch.cummax(blocks, dim=2).values.reshape(B, -1)
    suf = torch.cummax(blocks.flip(2), dim=2).values.flip(2).reshape(B, -1)
    right = _shift_left(pref, w - 1, f)[:, :L]
    return torch.maximum(suf[:, :L], right) ^ SIGN


def sketch_wide(codes: torch.Tensor, lengths: torch.Tensor,
                rids: torch.Tensor, *, w: int, k: int):
    """The wide sketch (peregrine_tpu/ops/sketch.py:_sketch_impl_wide) on
    int64 records: rolling k-mers on raw positions, the 56-bit hash, the
    stream compaction (x, y, run length) by compact_planes, window
    extrema in unsigned order, the emission set and the output
    compaction.  Returns (x, y, count) with INF past the counts."""
    B, L = codes.shape
    dev = codes.device
    if L == 0:
        empty = torch.empty((B, 0), dtype=torch.int64, device=dev)
        return empty, empty.clone(), torch.zeros(B, dtype=torch.int32,
                                                 device=dev)
    mask = (1 << (2 * k)) - 1
    pos = torch.arange(L, device=dev)[None, :]
    c = codes.to(torch.int64)
    inlen = pos < lengths.to(torch.int64)[:, None]
    valid = (c < 4) & inlen
    amb = (c >= 4) & inlen

    # rolling k-mers; zero padding mirrors the zeroed rolling registers,
    # and the complement is taken before the shift (src/mm_sketch.c:102)
    cb = c & 3
    fwd = torch.zeros_like(c)
    rev = torch.zeros_like(c)
    for d in range(k):
        fwd |= _shift_right(cb, d, 0) << (2 * d)
        rev |= _shift_right(cb ^ 3, d, 0) << (2 * (k - 1 - d))
    fwd &= mask
    sym = (fwd == rev) & valid
    strand = (fwd >= rev).to(torch.int64)
    hsh = hash64(torch.minimum(fwd, rev), mask)

    vns = valid & ~sym
    cvns = torch.cumsum(vns.to(torch.int32), dim=1, dtype=torch.int32)
    at_amb = torch.cummax(torch.where(amb, cvns, 0), dim=1).values
    run = cvns - at_amb  # valid non-symmetric entries since the last amb
    defined = vns & (run >= k)
    x = torch.where(defined, (hsh << 8) | k, INF)
    y = torch.where(defined, (rids.to(torch.int64)[:, None] << 32)
                    | ((pos << 1) & 0xFFFFFFFE) | strand, INF)

    # the buffer stream: valid non-symmetric entries and amb placeholders
    (sx, sy, sl), n = compact_planes(
        vns | amb, (x, y, torch.where(vns, run, 0)), (INF, INF, 0))

    # window minima and the emission set; Ap's sentinel 0 lies below
    # every finite x (x >= span > 0) and never equals one
    col = pos
    nn = n.to(torch.int64)[:, None]
    W = _sliding_min_trailing(sx, w, INF)
    Ap = torch.where((sl >= w + k - 1) & (col < nn), W, 0)
    M = _sliding_max_leading(Ap, w, 0)
    emit = (sx != INF) & (M == sx)

    # the final held minimum: min of the last window, the newest tie wins
    in_final = (col >= nn - w) & (col < nn)
    xm = torch.where(in_final, sx, INF)
    fmin = ((xm ^ SIGN).min(dim=1, keepdim=True).values) ^ SIGN
    t_f = torch.where((xm == fmin) & in_final, col, -1).max(
        dim=1, keepdim=True).values
    emit |= (col == t_f) & (fmin != INF) & (t_f >= 0)

    # compact_planes reads only the kept columns and fills the rest
    (ox, oy), count = compact_planes(emit, (sx, sy), (INF, INF))
    return ox, oy, count


def sketch_batch(codes: torch.Tensor, lengths: torch.Tensor,
                 rids: torch.Tensor, *, w: int, k: int):
    """Sketch a padded batch: returns (x [B, L], y [B, L], count [B])
    with the minimizers compacted to the row front.  k <= 16 runs the
    packed kernels, 17 <= k <= 28 the wide sketch."""
    if not 0 < w < 256 or not 0 < k <= MAX_K:
        raise ValueError(f"sketch_batch: w={w}, k={k} outside 1..255, "
                         f"1..{MAX_K}")
    if k > 16:
        return sketch_wide(codes, lengths, rids, w=w, k=k)
    oH, oP, count = sketch_planes(codes, lengths, w=w, k=k)
    x, y = assemble_records(oH, oP, count, rids, k)
    return x, y, count


def sketch_batch_capped(codes, lengths, rids, *, w: int, k: int, cap: int):
    """sketch_batch with the outputs sliced to `cap` entries per row; the
    full count is returned so callers can detect an overflow."""
    x, y, count = sketch_batch(codes, lengths, rids, w=w, k=k)
    return x[:, :cap], y[:, :cap], count


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def _codes_tensor(codes: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(codes, np.uint8)).to(device)


def sketch_reads_np(codes: np.ndarray, lengths: np.ndarray, rids: np.ndarray,
                    w: int, k: int, device) -> tuple[np.ndarray, np.ndarray]:
    """Host convenience: sketch_batch flattened to concatenated uint64
    (x, y) arrays in row order."""
    x, y, cnt = sketch_batch(
        _codes_tensor(codes, device),
        torch.from_numpy(np.asarray(lengths, np.int32)).to(device),
        torch.from_numpy(np.asarray(rids, np.int64)).to(device), w=w, k=k)
    valid = torch.arange(x.shape[1], device=x.device)[None, :] < cnt[:, None]
    return _u64(x[valid]), _u64(y[valid])


LONG_BATCH = 64  # segment rows per sketch_batch call on the long route


def _segments(n: int, seg: int, margin: int):
    """(lo, hi, own_lo, own_hi) of each segment of a sequence of n bases:
    the context [lo, hi) it is sketched on and the range it owns.  A
    sequence of at most seg + 2 * margin bases is one segment."""
    if n <= seg + 2 * margin:
        return [(0, n, 0, n)]
    return [(max(0, s - margin), min(n, s + seg + margin), s,
             min(n, s + seg)) for s in range(0, n, seg)]


def sketch_long_many_np(seqs, w: int, k: int, device, seg: int = 1 << 15,
                        margin: int = 1 << 12
                        ) -> list[tuple[np.ndarray, np.ndarray]]:
    """Sketch long sequences (contigs, references) via fixed-shape
    segments (peregrine_tpu/ops/sketch.py:sketch_long_np, one sequence at
    a time there): `seg`-sized ownership ranges padded with `margin`
    context on both sides, at width seg + 2 * margin, LONG_BATCH segment
    rows a sketch_batch call whichever sequences they come from.

    seqs: an iterable of (rid, codes), read once; each sequence's codes
    are held only until its last segment is sketched.  Returns each
    sequence's (x, y) in the order of seqs.  A batch's rows carry rid 0:
    each record's y is rebuilt from its segment's rid and offset, and
    emissions are kept where their global position lies in the segment's
    own range.  The first `cap` records per row are fetched to the host,
    and a batch's whole rows where any count exceeds the cap."""
    pad = seg + 2 * margin
    cap = max(256, pad // 8)  # >5x the expected 2/(w+1) minimizer density
    out: list[tuple[list, list]] = []
    rows: list[tuple] = []  # (slot, rid, lo, own_lo, own_hi, codes[lo:hi])

    def flush():
        batch = np.full((len(rows), pad), 4, np.uint8)
        lens = np.zeros(len(rows), np.int32)
        for i, row in enumerate(rows):
            batch[i, :len(row[5])] = row[5]
            lens[i] = len(row[5])
        x, y, c = sketch_batch(
            _codes_tensor(batch, device), torch.from_numpy(lens).to(device),
            torch.zeros(len(rows), dtype=torch.int64, device=device),
            w=w, k=k)
        c = c.cpu().numpy()
        width = cap if (c <= cap).all() else x.shape[1]  # exact refetch
        x, y = _u64(x[:, :width]), _u64(y[:, :width])
        for i, (slot, rid, lo, own_lo, own_hi, _) in enumerate(rows):
            xi = x[i, :c[i]]
            yi = y[i, :c[i]]
            pos = ((yi & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(
                np.int64) + lo
            keep = (pos >= own_lo) & (pos < own_hi)
            # y with global positions and the real rid
            yg = ((np.uint64(rid) << np.uint64(32))
                  | ((pos.astype(np.uint64) << np.uint64(1))
                     & np.uint64(0xFFFFFFFE)) | (yi & np.uint64(1)))
            out[slot][0].append(xi[keep])
            out[slot][1].append(yg[keep])
        rows.clear()

    for slot, (rid, codes) in enumerate(seqs):
        out.append(([], []))
        for lo, hi, own_lo, own_hi in _segments(len(codes), seg, margin):
            rows.append((slot, int(rid), lo, own_lo, own_hi, codes[lo:hi]))
            if len(rows) == LONG_BATCH:
                flush()
    if rows:
        flush()
    return [(np.concatenate(xs), np.concatenate(ys)) for xs, ys in out]


def sketch_long_np(codes: np.ndarray, rid: int, w: int, k: int, device,
                   seg: int = 1 << 15, margin: int = 1 << 12
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Sketch one long sequence: sketch_long_many_np of one."""
    return sketch_long_many_np([(rid, codes)], w, k, device, seg, margin)[0]
