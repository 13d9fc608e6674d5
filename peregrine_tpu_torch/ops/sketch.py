"""(w,k)-minimizer sketch: packed (H, P) planes for k <= 16, wide records
for 17 <= k <= 28.

The port of peregrine_tpu/ops/sketch.py (see that module's docstring for
the emission-set semantics and the documented superset divergences from
the reference).  For k <= 16 one sketch is
build_stream -> move_plane -> emit_mask -> move_plane, each move taking
both planes (ops.kernels: CUDA kernels on the card, plain PyTorch on the
CPU), and
records are assembled only at the end.  For k > 16 the hash needs up to
56 bits, so sketch_wide works on the records themselves:
wide_stream (the compacted stream) -> wide_emit -> compact_planes, where
the JAX package runs XLA fusions between its two compactions.

    x = hash << 8 | k                       (span == k)
    y = rid << 32 | pos << 1 | strand

Records are int64 tensors holding the uint64 bits; INF (all ones) is -1.
At k > 16, x uses all 64 bits, so the wide kernels compare records in
unsigned order.
"""

from __future__ import annotations

import numpy as np
import torch

# the window extrema of wide_emit's plain version, which tests read here
# assemble_records is drain_records' plain version's (ops.kernels)
from .kernels import (INF, MAX_K, _sliding_max_leading,  # noqa: F401
                      _sliding_min_trailing, assemble_records, build_stream,
                      compact_planes, emit_mask, move_plane, wide_emit,
                      wide_stream)


def sketch_planes(codes: torch.Tensor, lengths: torch.Tensor, *, w: int,
                  k: int):
    """[B, L] uint8 codes, [B] int32 lengths -> the emitted (H, P) planes
    and their counts (replaces peregrine_tpu's sketch_planes_tpu).
    Columns at or past a row's count are stale."""
    return sketch_stream(*build_stream(codes, lengths, k=k), w=w, k=k)


def sketch_stream(H: torch.Tensor, P: torch.Tensor, dest: torch.Tensor,
                  n: torch.Tensor, *, w: int, k: int):
    """The sketch after its stream build: build_stream's (H, P, dest, n)
    (or gather_build_stream's) -> the emitted (H, P) planes and their
    counts, as sketch_planes returns them."""
    sH, sP = move_plane(dest, H, P)
    dest2, count = emit_mask(sH, sP, n, w=w, k=k)
    return move_plane(dest2, sH, sP) + (count,)


def sketch_wide(codes: torch.Tensor, lengths: torch.Tensor,
                rids: torch.Tensor, *, w: int, k: int):
    """The wide sketch (peregrine_tpu/ops/sketch.py:_sketch_impl_wide) on
    int64 records: wide_stream (rolling k-mers on raw positions, the
    56-bit hash, the run length and the records, compacted to the stream
    (x, y, run length)), wide_emit (window extrema in unsigned order and
    the emission set) and the output compaction by compact_planes.
    Returns (x, y, count) with INF past the counts."""
    sx, sy, sl, n = wide_stream(codes, lengths, rids, k=k)
    emit = wide_emit(sx, sl, n, w=w, k=k)
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
