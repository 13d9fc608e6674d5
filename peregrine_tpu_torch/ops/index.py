"""SHIMMER index build — batched device sketch/reduce + sorted-array counts.

The port of peregrine_tpu/ops/index.py (see its docstring).  Reads are
bucketed by padded length; per batch the code windows are gathered from
the device-resident seqdb, sketched and reduced, and the valid prefix of
each row drained to the host; records concatenate in rid order.  For
k <= 16 a batch runs on the packed (H, P) planes (the first four kernels
of ops.kernels) and records are assembled at the end; for k > 16 it runs
the wide sketch and reduce_impl on int64 records (compact_planes).
Sequences longer than sketch_pad_len take the segmented long route: the
segments of all of them share sketch batches (sketch_long_many_np), and
each reduction level runs once per length class of them
(reduce_flat_np), where the JAX package runs one sequence a thread.
keep_l0 (--with-L0-index) also returns the level-0 index.

build_index_segmented indexes a seqdb past the device budget in
contiguous read groups, each uploading only its byte window.

Not ported: index_step_db_meta/_scan (one-dispatch batching for a
remote device link) and the segmented build's worker processes.
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
from .kernels import reduce_step
from .reduce import reduce_flat_np, reduce_impl
from .sketch import (assemble_records, sketch_long_many_np, sketch_planes,
                     sketch_wide)


def _capped(a: torch.Tensor, b: torch.Tensor, cap: int):
    """The first `cap` columns of two planes (all of them for cap 0)."""
    if cap and cap < a.shape[1]:
        return a[:, :cap].contiguous(), b[:, :cap].contiguous()
    return a, b


def index_step(codes: torch.Tensor, lengths: torch.Tensor, rids: torch.Tensor,
               *, w: int, k: int, r: int, levels: int, cap: int = 0,
               keep_l0: bool = False, tight_out: bool = True):
    """Sketch -> L1 -> ... -> L_levels for one padded batch.

    cap > 0 truncates the minimizer axis after sketching (the expected
    density is 2/(w+1), so cap ~ L/8 is generous); the exact sketch
    count c0 is returned so callers detect an overflow and re-run the
    batch with cap=0.  With a cap and tight_out the final level is sliced
    to out_cap columns as well (the mesh build keeps it whole).  Returns (x, y, count) of the final level + c0, and
    with keep_l0 also the uncapped level-0 records (x0, y0), whose counts
    are c0.
    """
    out_cap = 0
    if levels > 0 and cap and tight_out:
        # each level shrinks the list ~(r/2)x in practice; slice
        # conservatively (c stays exact for the overflow check)
        out_cap = max(64, cap // max(1, int((r / 2) ** levels)))
    if k <= 16:
        H, P, c0 = sketch_planes(codes, lengths, w=w, k=k)
        l0 = assemble_records(H, P, c0, rids, k) if keep_l0 else ()
        H, P = _capped(H, P, cap)
        c = torch.clamp(c0, max=H.shape[1])
        for _ in range(levels):
            H, P, c = reduce_step(H, P, c, r=r)
        x, y = assemble_records(*_capped(H, P, out_cap), c, rids, k)
    else:
        x, y, c0 = sketch_wide(codes, lengths, rids, w=w, k=k)
        l0 = (x, y) if keep_l0 else ()
        x, y = _capped(x, y, cap)
        c = torch.clamp(c0, max=x.shape[1])
        for _ in range(levels):
            x, y, c = reduce_impl(x, y, c, r=r)
        x, y = _capped(x, y, out_cap)
    return (x, y, c, c0) + tuple(l0)


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


def _drain(x: torch.Tensor, y: torch.Tensor, c: np.ndarray,
           part: np.ndarray, xs: dict, ys: dict) -> None:
    """Per-read record slices [:c] of a batch's rows (c: the counts, on
    the host): the first max(c) columns of each plane fetched at once."""
    m = int(c.max()) if len(c) else 0
    xf, yf = _to_host(x[:, :m]), _to_host(y[:, :m])
    for b, rid in enumerate(part):
        xs[rid] = xf[b, :c[b]]
        ys[rid] = yf[b, :c[b]]


def _index_of(xs: dict, ys: dict) -> ShimmerIndex:
    order = sorted(xs)
    x = np.concatenate([xs[r] for r in order]) if order else np.zeros(0, np.uint64)
    y = np.concatenate([ys[r] for r in order]) if order else np.zeros(0, np.uint64)
    mh, mc = _merge_counts(x >> np.uint64(8), np.ones(len(x), np.uint32))
    return ShimmerIndex(x, y, mh, mc)


def _index_long(db: SeqDB, rids: np.ndarray, cfg: AsmConfig, device,
                xs: dict, ys: dict, l0: tuple | None) -> None:
    """The long route: every long sequence's segments sketched in shared
    batches (sketch_long_many_np), then each reduction level run once per
    length class on the concatenation of its sequences, one row each.  A
    class holds the sequences whose level-0 counts have one bit length,
    so a row pads to less than twice its records.  Per-rid records go to
    xs/ys, and the level-0 ones to l0 = (l0xs, l0ys) where given."""
    rids = np.sort(rids)
    sketched = sketch_long_many_np(
        ((rid, db.codes(rid)) for rid in rids), cfg.w, cfg.k, device,
        seg=cfg.sketch_pad_len)
    if l0 is not None:
        for rid, (lx, ly) in zip(rids, sketched):
            l0[0][rid], l0[1][rid] = lx, ly
    bits = np.array([len(lx).bit_length() for lx, _ in sketched])
    for b in np.unique(bits):
        members = np.flatnonzero(bits == b)
        lx = np.concatenate([sketched[i][0] for i in members])
        ly = np.concatenate([sketched[i][1] for i in members])
        for _ in range(cfg.levels):
            lx, ly = reduce_flat_np(lx, ly, cfg.r, device)
        # rows come back in row order, which is rid order here
        bounds = np.searchsorted((ly >> np.uint64(32)).astype(np.int64),
                                 rids[members])
        for rid, a, e in zip(rids[members], bounds,
                             np.r_[bounds[1:], len(lx)]):
            xs[rid], ys[rid] = lx[a:e], ly[a:e]


def build_index_segmented(db: SeqDB, cfg: AsmConfig, device,
                          budget_bytes: int,
                          keep_l0: bool = False) -> ShimmerIndex:
    """build_index in contiguous read groups whose seqdb bytes fit
    `budget_bytes`: each group uploads only its byte window, indexes, and
    frees it before the next.  Per-read records do not depend on the
    batching, so the result equals one build's.  A single read larger
    than the budget is a group of its own."""
    assert not keep_l0, "segmented build supports the production path only"
    n = len(db)
    groups: list[np.ndarray] = []
    start = 0
    while start < n:
        end = start
        base = int(db.offsets[start])
        while end < n and int(db.offsets[end] + db.lengths[end]) - base \
                <= budget_bytes:
            end += 1
        if end == start:
            end = start + 1  # single read larger than the budget
        groups.append(np.arange(start, end))
        start = end
    xs, ys = [], []
    for g in groups:
        lo = int(db.offsets[g[0]])
        hi = int(db.offsets[g[-1]] + db.lengths[g[-1]])
        part = build_index(db, cfg, device, rid_filter=g, db_window=(lo, hi))
        xs.append(part.x)
        ys.append(part.y)
    x = np.concatenate(xs) if xs else np.zeros(0, np.uint64)
    y = np.concatenate(ys) if ys else np.zeros(0, np.uint64)
    mh, mc = _merge_counts(x >> np.uint64(8), np.ones(len(x), np.uint32))
    return ShimmerIndex(x, y, mh, mc)


def build_index(db: SeqDB, cfg: AsmConfig, device,
                packed: PackedSeqDB | None = None, keep_l0: bool = False,
                rid_filter: np.ndarray | None = None,
                db_window: tuple[int, int] | None = None):
    """Build the final-level SHIMMER index of a SeqDB on `device` (sketch
    -> r-reduce x levels, counts of the final level;
    src/shmr_index.c:155-233).  `packed` is the seqdb already uploaded to
    `device`; without it the seqdb is uploaded here, or only the bytes
    [lo, hi) of db_window=(lo, hi), which must hold every read of
    rid_filter (the reads to index; all of them by default).  With keep_l0
    returns (index, level-0 index), as the JAX package does."""
    device = torch.device(device)
    rids_all = (np.arange(len(db)) if rid_filter is None
                else np.asarray(rid_filter))
    lengths = db.lengths[rids_all].astype(np.int64)
    xs: dict[int, np.ndarray] = {}
    ys: dict[int, np.ndarray] = {}
    l0xs: dict[int, np.ndarray] = {}
    l0ys: dict[int, np.ndarray] = {}
    step = dict(w=cfg.w, k=cfg.k, r=cfg.r, levels=cfg.levels)

    def _retry_exact(part, pad):
        """Slow path for (rare) cap overflows: recompute the batch with no
        cap and take exact per-read slices."""
        codes, lens = db.padded_code_batch(part, pad)
        xl, yl, cl, _ = index_step(
            torch.from_numpy(codes).to(device),
            torch.from_numpy(lens.astype(np.int32)).to(device),
            torch.from_numpy(part.astype(np.int64)).to(device), cap=0, **step)
        _drain(xl, yl, cl.cpu().numpy(), part, xs, ys)

    # long sequences (contigs/references) take the fixed-shape segmented
    # route: pad classes above sketch_pad_len are not index batch shapes
    long_sel = lengths > cfg.sketch_pad_len
    if long_sel.any():
        _index_long(db, rids_all[long_sel], cfg, device, xs, ys,
                    (l0xs, l0ys) if keep_l0 else None)
    rids_all = rids_all[~long_sel]
    lengths = lengths[~long_sel]

    win_lo = 0
    if db_window is not None:
        # gather offsets become window-relative
        win_lo = int(db_window[0])
        if len(rids_all) and packed is None:
            packed = upload_seqdb(np.asarray(db.data[win_lo:int(db_window[1])]),
                                  device)
    elif len(rids_all) and packed is None:
        packed = upload_seqdb(db.data, device)

    # bucket unit finer than the max pad: 15 kb reads at a 32k unit would
    # sketch at 2x their length; multiples of 8k keep batches tight
    bucket_unit = max(2048, cfg.sketch_pad_len // 4)
    for pad, sel in _length_buckets(lengths, bucket_unit).items():
        batch_rids = rids_all[sel]
        bsz = max(1, min(cfg.sketch_batch,
                         (cfg.sketch_batch * cfg.sketch_pad_len) // pad))
        # the level-0 records leave uncapped, as in the JAX package
        cap = 0 if keep_l0 else max(256, pad // 8)
        for i in range(0, len(batch_rids), bsz):
            part = batch_rids[i:i + bsz]
            offs = torch.from_numpy(db.offsets[part].astype(np.int64)
                                    - win_lo)
            lens = torch.from_numpy(db.lengths[part].astype(np.int32))
            codes = gather_codes(packed, offs, lens, None, pad, fill=4)
            xl, yl, cl, c0, *l0 = index_step(
                codes, lens.to(device),
                torch.from_numpy(part.astype(np.int64)).to(device),
                cap=cap, keep_l0=keep_l0, **step)
            # one fetch of the batch's counts, which the overflow check
            # and the drains read on the host
            c0h, clh = torch.stack([c0, cl]).cpu().numpy()
            if keep_l0:
                _drain(*l0, c0h, part, l0xs, l0ys)
            elif (c0h > cap).any() or (clh > xl.shape[1]).any():
                _retry_exact(part, pad)
                continue
            _drain(xl, yl, clh, part, xs, ys)

    idx = _index_of(xs, ys)
    return (idx, _index_of(l0xs, l0ys)) if keep_l0 else idx
