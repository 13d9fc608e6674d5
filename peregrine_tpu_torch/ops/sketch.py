"""(w,k)-minimizer sketch on the packed (H, P) stream planes, k <= 16.

The port of peregrine_tpu/ops/sketch.py's packed path (see that module's
docstring for the emission-set semantics and the documented superset
divergences from the reference).  One sketch is
build_stream -> move_plane x2 -> emit_mask -> move_plane x2
(ops.kernels: CUDA kernels on the card, plain PyTorch on the CPU), and
records are assembled only at the end:

    x = hash << 8 | k                       (span == k)
    y = rid << 32 | pos << 1 | strand

Records are int64 tensors holding the uint64 bits; INF (all ones) is -1
and only ever lies past a row's count, so no consumer sorts or compares
it.  The wide k > 16 sketch is not yet ported (ROADMAP).
"""

from __future__ import annotations

import numpy as np
import torch

from .kernels import build_stream, emit_mask, move_plane

INF = -1  # uint64 0xFFFF_FFFF_FFFF_FFFF as int64


def sketch_planes(codes: torch.Tensor, lengths: torch.Tensor, *, w: int,
                  k: int):
    """[B, L] uint8 codes, [B] int32 lengths -> the emitted (H, P) planes
    and their counts (replaces peregrine_tpu's sketch_planes_tpu).
    Columns at or past a row's count are stale."""
    H, P, dest, n = build_stream(codes, lengths, k=k)
    sH = move_plane(dest, H)
    sP = move_plane(dest, P)
    dest2, count = emit_mask(sH, sP, n, w=w, k=k)
    return move_plane(dest2, sH), move_plane(dest2, sP), count


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


def sketch_batch(codes: torch.Tensor, lengths: torch.Tensor,
                 rids: torch.Tensor, *, w: int, k: int):
    """Sketch a padded batch: returns (x [B, L], y [B, L], count [B])
    with the minimizers compacted to the row front."""
    if not 0 < w < 256 or not 0 < k <= 16:
        raise ValueError(f"sketch_batch: w={w}, k={k} (k > 16 is the wide "
                         "sketch, not yet ported)")
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


def sketch_long_np(codes: np.ndarray, rid: int, w: int, k: int, device,
                   seg: int = 1 << 15, margin: int = 1 << 12
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Sketch one long sequence via fixed-shape segments
    (peregrine_tpu/ops/sketch.py:sketch_long_np): `seg`-sized ownership
    ranges padded with `margin` context on both sides, batches of SB=64
    segments at width seg + 2 * margin, the first `cap` records per row
    fetched to the host and the whole row refetched where a count
    exceeds the cap; emissions are kept where their global position lies
    in the segment's own range."""
    n = len(codes)
    pad = seg + 2 * margin
    cap = max(256, pad // 8)  # >5x the expected 2/(w+1) minimizer density

    def run(batch: np.ndarray, lens: np.ndarray, rids: np.ndarray):
        x, y, c = sketch_batch(
            _codes_tensor(batch, device),
            torch.from_numpy(lens).to(device),
            torch.from_numpy(rids).to(device), w=w, k=k)
        c = c.cpu().numpy()
        width = cap if (c <= cap).all() else x.shape[1]  # exact refetch
        return _u64(x[:, :width]), _u64(y[:, :width]), c

    if n <= seg + 2 * margin:
        batch = np.full((1, pad), 4, np.uint8)
        batch[0, :n] = codes
        x, y, c = run(batch, np.asarray([n], np.int32),
                      np.asarray([rid], np.int64))
        return x[0, :c[0]].copy(), y[0, :c[0]].copy()

    starts = list(range(0, n, seg))
    SB = 64  # fixed batch shape, as in the JAX package
    xs, ys = [], []
    for b0 in range(0, len(starts), SB):
        part = starts[b0:b0 + SB]
        batch = np.full((SB, pad), 4, np.uint8)
        lens = np.zeros(SB, np.int32)
        for i, s in enumerate(part):
            lo = max(0, s - margin)
            hi = min(n, s + seg + margin)
            batch[i, :hi - lo] = codes[lo:hi]
            lens[i] = hi - lo
        x, y, c = run(batch, lens, np.zeros(SB, np.int64))
        for i, s in enumerate(part):
            xi = x[i, :c[i]]
            yi = y[i, :c[i]]
            pos = ((yi & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(
                np.int64) + max(0, s - margin)
            keep = (pos >= s) & (pos < min(n, s + seg))
            # y with global positions and the real rid
            yg = ((np.uint64(rid) << np.uint64(32))
                  | ((pos.astype(np.uint64) << np.uint64(1))
                     & np.uint64(0xFFFFFFFE)) | (yi & np.uint64(1)))
            xs.append(xi[keep])
            ys.append(yg[keep])
    return np.concatenate(xs), np.concatenate(ys)
