"""SHIMMER index build — batched device sketch/reduce + sorted-array counts.

The port of peregrine_tpu/ops/index.py (see its docstring).  Reads are
bucketed by padded length; per batch the code windows are gathered from
the device-resident seqdb, sketched and reduced on the packed (H, P)
planes by the four kernels of ops.kernels, assembled into records, and
the valid prefix of each row drained to the host; records concatenate in
rid order.  Sequences longer than sketch_pad_len take the segmented long
route (sketch_long_np + reduce_flat_np).

Not ported: index_step_db_meta/_scan (one-dispatch batching for a
remote device link), build_index_segmented and its worker process, and
keep_l0 (--with-L0-index).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np
import torch

from ..config import AsmConfig
from ..io import formats
from ..io.seqdb import SeqDB
from .dbgather import PackedSeqDB, gather_codes, upload_seqdb
from .kernels import move_plane, reduce_step
from .reduce import reduce_flat_np
from .sketch import assemble_records, sketch_long_np, sketch_planes


def index_step(codes: torch.Tensor, lengths: torch.Tensor, rids: torch.Tensor,
               *, w: int, k: int, r: int, levels: int, cap: int = 0):
    """Sketch -> L1 -> ... -> L_levels for one padded batch.

    cap > 0 truncates the minimizer axis after sketching (the expected
    density is 2/(w+1), so cap ~ L/8 is generous); the exact sketch
    count c0 is returned so callers detect an overflow and re-run the
    batch with cap=0.  With a cap the final level is sliced to out_cap
    columns as well.  Returns (x, y, count) of the final level + c0.
    """
    if k > 16:
        raise ValueError(f"index_step: k={k} > 16 needs the wide sketch, "
                         "which is not yet ported")
    H, P, c0 = sketch_planes(codes, lengths, w=w, k=k)
    if cap and cap < H.shape[1]:
        H, P = H[:, :cap].contiguous(), P[:, :cap].contiguous()
    c = torch.clamp(c0, max=H.shape[1])
    for _ in range(levels):
        H2, P2, dest, c = reduce_step(H, P, c, r=r)
        H = move_plane(dest, H2)
        P = move_plane(dest, P2)
    if levels > 0 and cap:
        # each level shrinks the list ~(r/2)x in practice; slice
        # conservatively (c stays exact for the overflow check)
        shrink = max(1, int((r / 2) ** levels))
        out_cap = max(64, cap // shrink)
        if out_cap < H.shape[1]:
            H, P = H[:, :out_cap], P[:, :out_cap]
    x, y = assemble_records(H, P, c, rids, k)
    return x, y, c, c0


@dataclass
class ShimmerIndex:
    """Final-level SHIMMER records (rid-ordered) + global hash counts."""

    x: np.ndarray           # uint64 [N] hash<<8|span
    y: np.ndarray           # uint64 [N] rid<<32|pos<<1|strand
    mc_hash: np.ndarray     # uint64 [M] sorted distinct hashes
    mc_count: np.ndarray    # uint32 [M] multiplicities

    def counts_for(self, hashes: np.ndarray) -> np.ndarray:
        """Vectorized multiplicity lookup (0 for unseen hashes)."""
        idx = np.searchsorted(self.mc_hash, hashes)
        idx_c = np.minimum(idx, len(self.mc_hash) - 1) if len(self.mc_hash) else idx * 0
        hit = (len(self.mc_hash) > 0) & (self.mc_hash[idx_c] == hashes)
        return np.where(hit, self.mc_count[idx_c], 0).astype(np.uint32)

    # --- reference-format io -------------------------------------------
    def save(self, prefix: str, level: int, chunk: int = 1, total: int = 1) -> None:
        os.makedirs(os.path.dirname(os.path.abspath(prefix)), exist_ok=True)
        formats.write_mmlist(f"{prefix}-L{level}-{chunk:02d}-of-{total:02d}.dat",
                             self.x, self.y)
        formats.write_mm_count(f"{prefix}-L{level}-MC-{chunk:02d}-of-{total:02d}.dat",
                               self.mc_hash, self.mc_count)

    @classmethod
    def load_chunks(cls, paths_mm: list[str], paths_mc: list[str]) -> "ShimmerIndex":
        xs, ys = zip(*(formats.read_mmlist(p) for p in paths_mm))
        x = np.concatenate(xs)
        y = np.concatenate(ys)
        hs, cs = [], []
        for p in paths_mc:
            h, c = formats.read_mm_count(p)
            hs.append(h)
            cs.append(c)
        mh, mc = _merge_counts(np.concatenate(hs), np.concatenate(cs))
        return cls(x, y, mh, mc)


def _merge_counts(hashes: np.ndarray, counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    if len(hashes) == 0:
        return hashes.astype(np.uint64), counts.astype(np.uint32)
    order = np.argsort(hashes, kind="stable")
    h = hashes[order]
    c = counts[order]
    uniq, start = np.unique(h, return_index=True)
    sums = np.add.reduceat(c.astype(np.uint64), start)
    return uniq, sums.astype(np.uint32)


def _length_buckets(lengths: np.ndarray, unit: int) -> dict[int, np.ndarray]:
    pads = np.maximum(1, -(-lengths // unit)) * unit
    out: dict[int, np.ndarray] = {}
    for p in np.unique(pads):
        out[int(p)] = np.flatnonzero(pads == p)
    return out


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint64)


def build_index(db: SeqDB, cfg: AsmConfig, device,
                packed: PackedSeqDB | None = None) -> ShimmerIndex:
    """Build the final-level SHIMMER index of a SeqDB on
    `device` (sketch -> r-reduce x levels, counts of the final level;
    src/shmr_index.c:155-233).  `packed` is the seqdb already uploaded to
    `device`; without it the seqdb is uploaded here."""
    device = torch.device(device)
    rids_all = np.arange(len(db))
    lengths = db.lengths.astype(np.int64)
    xs: dict[int, np.ndarray] = {}
    ys: dict[int, np.ndarray] = {}

    def _retry_exact(part, pad):
        """Slow path for (rare) cap overflows: recompute the batch with no
        cap and take exact per-read slices."""
        codes, lens = db.padded_code_batch(part, pad)
        xl, yl, cl, _ = index_step(
            torch.from_numpy(codes).to(device),
            torch.from_numpy(lens.astype(np.int32)).to(device),
            torch.from_numpy(part.astype(np.int64)).to(device),
            w=cfg.w, k=cfg.k, r=cfg.r, levels=cfg.levels, cap=0)
        xl, yl, cl = _to_host(xl), _to_host(yl), cl.cpu().numpy()
        for b, rid in enumerate(part):
            xs[rid] = xl[b, :cl[b]].copy()
            ys[rid] = yl[b, :cl[b]].copy()

    # long sequences (contigs/references) take the fixed-shape segmented
    # route: pad classes above sketch_pad_len are not index batch shapes
    long_sel = lengths > cfg.sketch_pad_len
    for rid in rids_all[long_sel]:
        lx, ly = sketch_long_np(db.codes(rid), int(rid), cfg.w, cfg.k, device,
                                seg=cfg.sketch_pad_len)
        for _ in range(cfg.levels):
            lx, ly = reduce_flat_np(lx, ly, cfg.r, device)
        xs[rid], ys[rid] = lx, ly
    rids_all = rids_all[~long_sel]
    lengths = lengths[~long_sel]

    if len(rids_all) and packed is None:
        packed = upload_seqdb(db.data, device)

    # bucket unit finer than the max pad: 15 kb reads at a 32k unit would
    # sketch at 2x their length; multiples of 8k keep batches tight
    bucket_unit = max(2048, cfg.sketch_pad_len // 4)
    for pad, sel in _length_buckets(lengths, bucket_unit).items():
        batch_rids = rids_all[sel]
        bsz = max(1, min(cfg.sketch_batch,
                         (cfg.sketch_batch * cfg.sketch_pad_len) // pad))
        cap = max(256, pad // 8)
        for i in range(0, len(batch_rids), bsz):
            part = batch_rids[i:i + bsz]
            offs = torch.from_numpy(db.offsets[part].astype(np.int64))
            lens = torch.from_numpy(db.lengths[part].astype(np.int32))
            codes = gather_codes(packed, offs, lens, torch.zeros_like(lens),
                                 pad, fill=4)
            xl, yl, cl, c0 = index_step(
                codes, lens.to(device),
                torch.from_numpy(part.astype(np.int64)).to(device),
                w=cfg.w, k=cfg.k, r=cfg.r, levels=cfg.levels, cap=cap)
            C = xl.shape[1]
            c0h, clh = c0.cpu().numpy(), cl.cpu().numpy()
            if (c0h > cap).any() or (clh > C).any():
                _retry_exact(part, pad)
                continue
            # drain only the valid prefix of each row, in (row, slot) order
            valid = torch.arange(C, device=xl.device)[None, :] < cl[:, None]
            xf, yf = _to_host(xl[valid]), _to_host(yl[valid])
            offs_h = np.zeros(len(part) + 1, np.int64)
            np.cumsum(clh, out=offs_h[1:])
            for b, rid in enumerate(part):
                xs[rid] = xf[offs_h[b]:offs_h[b + 1]]
                ys[rid] = yf[offs_h[b]:offs_h[b + 1]]

    order = sorted(xs)
    x = np.concatenate([xs[r] for r in order]) if order else np.zeros(0, np.uint64)
    y = np.concatenate([ys[r] for r in order]) if order else np.zeros(0, np.uint64)
    mh, mc = _merge_counts(x >> np.uint64(8), np.ones(len(x), np.uint32))
    return ShimmerIndex(x, y, mh, mc)
