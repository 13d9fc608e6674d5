"""SHIMMER index build — batched device sketch/reduce + sorted-array counts.

The port of peregrine_tpu/ops/index.py (see its docstring).  Reads are
bucketed by padded length and run in batches of one shape a bucket; a
batch is one device program, as the JAX package's index_step_db_meta is
one jitted program: its (offset, length, rid) metas are copied in, the
code windows gathered from the device-resident seqdb (gather_codes),
sketched and reduced (index_planes), and the valid prefix of each row
appended to a tight record stream on the device (drain_records, which
replaces _compact_drain and assemble_records).  With one level or more
the drain is the final level's store stage (reduce_drain at k <= 16,
reduce_wide_drain above), so no final-level planes are written; at
k <= 16 the gather is also the sketch's first kernel's load stage
(gather_build_stream), so no codes plane is written, and above it the
first level reads the capped sketch in place.  On a CUDA card the
program is a CUDA graph captured once a shape (_Stage1Step), so a batch
costs the host one copy of its metas and one replay and no sync; the
counts and the records of up to FETCH_GROUP batches come back in two
copies, as the JAX package's two-phase grouped fetch does, and a batch
whose sketch overflowed its cap is recomputed exactly (_retry_exact).
On the CPU the same loop runs the step eagerly on the plain versions.
For k <= 16 a batch runs on the packed (H, P) planes (the first four
kernels of ops.kernels); for k > 16 it runs the wide sketch and
reduce_impl on int64 records.  Sequences longer than sketch_pad_len take
the segmented long route: the segments of all of them share sketch
batches (sketch_long_many_np), and each reduction level runs once per
length class of them (reduce_flat_np), where the JAX package runs one
sequence a thread.  keep_l0 (--with-L0-index) also returns the level-0
index.

build_index_segmented indexes a seqdb past the device budget in
contiguous read groups, each uploading only its byte window.

Not ported: index_step_db_scan's G batches in one dispatch (a graph
replay a batch is one launch already) and the segmented build's worker
processes.
"""

from __future__ import annotations

import contextlib
import logging
import os
from dataclasses import dataclass

import numpy as np
import torch

from .. import trace
from ..config import AsmConfig
from ..io import formats
from ..io.seqdb import SeqDB
from . import kernels as kn
from .dbgather import PackedSeqDB, gather_codes, upload_seqdb
from .kernels import (drain_records, gather_build_stream, reduce_drain,
                      reduce_step, reduce_wide_drain)
from .reduce import reduce_flat_np, reduce_impl
from .sketch import (assemble_records, sketch_long_many_np, sketch_planes,
                     sketch_stream, sketch_wide)

log = logging.getLogger(__name__)

FETCH_GROUP = 64        # batches whose counts and records one fetch brings
# A group's record streams hold its worst case (every row's count at the
# planes' width) in at most GROUP_BYTES, else the group has fewer
# batches: ~15 MB for 64 capped batches of 64 reads at L=16,384, and
# 32 batches a group with the uncapped level-0 stream of --with-L0-index.
GROUP_BYTES = 1 << 30
# stage 1's host seconds by part, and the captured graphs' pool bytes,
# summed over builds until reset_stats()
STATS: dict = {"host_s": {}, "graph_pool_bytes": [], "replays": 0,
               "group_fetches": 0, "retried_batches": 0}


def reset_stats() -> None:
    STATS.update(host_s={}, graph_pool_bytes=[], replays=0, group_fetches=0,
                 retried_batches=0)


@contextlib.contextmanager
def _timed(part: str):
    """The span index.<part>, its seconds added to STATS["host_s"][part]."""
    try:
        with trace.span("index." + part) as sp:
            yield
    finally:
        host = STATS["host_s"]
        host[part] = host.get(part, 0.0) + sp.seconds


def _capped(a: torch.Tensor, b: torch.Tensor, cap: int):
    """The first `cap` columns of two planes (all of them for cap 0)."""
    if cap and cap < a.shape[1]:
        return a[:, :cap].contiguous(), b[:, :cap].contiguous()
    return a, b


def _out_cap(cap: int, levels: int, r: int, tight_out: bool = True) -> int:
    """Columns of the final level a capped batch keeps (0: all of them).
    Each level shrinks the list ~(r/2)x in practice; the slice is
    conservative, and the exact count c stays for the overflow check."""
    if levels > 0 and cap and tight_out:
        return max(64, cap // max(1, int((r / 2) ** levels)))
    return 0


def index_planes(codes: torch.Tensor, lengths: torch.Tensor,
                 rids: torch.Tensor, *, w: int, k: int, r: int, levels: int,
                 cap: int = 0, keep_l0: bool = False):
    """index_step up to its final level's planes, whole: (a, b, c, c0),
    with keep_l0 also the level-0 planes (a0, b0), whose counts are c0.
    At k <= 16 the planes are (H, P) int32, above it (x, y) int64
    records."""
    if k <= 16:
        a, b, c0 = sketch_planes(codes, lengths, w=w, k=k)
    else:
        a, b, c0 = sketch_wide(codes, lengths, rids, w=w, k=k)
    return reduce_levels(a, b, c0, k=k, r=r, levels=levels, cap=cap,
                         keep_l0=keep_l0)


def reduce_levels(a: torch.Tensor, b: torch.Tensor, c0: torch.Tensor, *,
                  k: int, r: int, levels: int, cap: int = 0,
                  keep_l0: bool = False):
    """index_planes after its sketch (a, b, c0): the cap, then `levels`
    reduction levels; returns (a, b, c, c0), with keep_l0 also the
    sketch's planes.  At k > 16 the capped planes are views, which
    reduce_wide reads in place, and its first level clamps c0 itself; a
    count of no level is clamped to the cap."""
    l0 = (a, b) if keep_l0 else ()
    if k <= 16:
        a, b = _capped(a, b, cap)
    elif cap:
        a, b = a[:, :cap], b[:, :cap]
    c = c0 if k > 16 and levels else torch.clamp(c0, max=a.shape[1])
    for _ in range(levels):
        a, b, c = (reduce_step(a, b, c, r=r) if k <= 16
                   else reduce_impl(a, b, c, r=r))
    return (a, b, c, c0) + l0


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
    a, b, c, c0, *l0 = index_planes(codes, lengths, rids, w=w, k=k, r=r,
                                    levels=levels, cap=cap, keep_l0=keep_l0)
    a, b = _capped(a, b, _out_cap(cap, levels, r, tight_out))
    if k <= 16:
        a, b = assemble_records(a, b, c, rids, k)
        l0 = assemble_records(*l0, c0, rids, k) if keep_l0 else ()
    return (a, b, c, c0) + tuple(l0)


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


def _slices(rec: np.ndarray, n: np.ndarray, parts, xs: dict, ys: dict,
            skip=()) -> None:
    """Per-read record slices of a tight stream rec ([N, 2] uint64 (x, y)
    pairs, as drain_records writes it): the rows of parts, in order, hold
    n[i] records each; the batches whose index is in `skip` are passed
    over (their records still take their places in the stream)."""
    offs = np.zeros(len(n) + 1, np.int64)
    np.cumsum(n, out=offs[1:])
    x = np.ascontiguousarray(rec[:, 0])
    y = np.ascontiguousarray(rec[:, 1])
    i = 0
    for j, part in enumerate(parts):
        if j not in skip:
            for b, rid in enumerate(part):
                xs[rid] = x[offs[i + b]:offs[i + b + 1]]
                ys[rid] = y[offs[i + b]:offs[i + b + 1]]
        i += len(part)


def _fetch(rec: torch.Tensor, total: int) -> np.ndarray:
    """The first `total` (x, y) pairs of a record stream, on the host."""
    return rec[:total].cpu().numpy().view(np.uint64)


class _Stage1Step:
    """One stage-1 batch shape (pad L, rows B, cap, k, w, r, levels,
    keep_l0) on one device, and the fetch group of its batches.

    The step is the counterpart of the JAX package's index_step_db_meta:
    the metas [3, B] (offset, length, rid) go in, gather_codes,
    index_planes and drain_records run, and the records leave in a tight
    stream with their counts in one slot a batch.  Where there is a level,
    the final level and the drain are one launch, reduce_drain at k <= 16
    and reduce_wide_drain above (the level-0 stream of keep_l0 still
    drains alone); at k <= 16 the gather and build_stream are one
    gather_build_stream launch, and above it level 1 reads the capped
    sketch in place.  On a CUDA
    card it is captured once as a CUDA graph (after an eager warm-up on
    its first
    batch, whose output the first replay writes again), with its own
    look-back status zeroed at its start, so a
    batch is one metas copy from pinned memory and one replay, with no
    host sync; a capture or replay error raises.  On the CPU the step runs
    eagerly on its batch's rows alone.  fetch() brings the group's counts
    and then its records back, one copy each (and one more for the
    level-0 stream of keep_l0), slices them per read, and sends the
    batches that overflowed the cap to `retry`."""

    def __init__(self, packed: PackedSeqDB, device: torch.device, pad: int,
                 rows: int, cap: int, keep_l0: bool, step: dict,
                 batches: int):
        self.packed, self.device, self.pad, self.rows = packed, device, pad, rows
        self.cap, self.keep_l0, self.step = cap, keep_l0, step
        width = min(cap, pad) if cap else pad
        self.out_w = min(_out_cap(cap, step["levels"], step["r"]) or width,
                         width)
        batch_bytes = 16 * rows * (self.out_w + (pad if keep_l0 else 0))
        self.group = max(1, min(FETCH_GROUP, batches,
                                GROUP_BYTES // batch_bytes))

        def empty(*shape, dtype=torch.int64):
            return torch.empty(shape, dtype=dtype, device=device)
        self.metas = torch.zeros((3, rows), dtype=torch.int64, device=device)
        self.stage = torch.empty((self.group, 3, rows), dtype=torch.int64,
                                 pin_memory=device.type == "cuda")
        self.rec = empty(self.group * rows * self.out_w, 2)
        self.counts = empty(self.group, 2, rows, dtype=torch.int32)
        self.cursor = torch.zeros(3, dtype=torch.int64, device=device)
        if keep_l0:
            self.rec0 = empty(self.group * rows * pad, 2)
            self.cursor0 = torch.zeros_like(self.cursor)
        self.parts: list = []
        self.graph = None
        self.per_replay: dict = {}

    def _body(self, rows: int) -> None:
        goff, lens, rids = self.metas[:, :rows]
        w, k, r, levels = (self.step[key] for key in ("w", "k", "r", "levels"))
        # the drain is the final level's store stage; at k <= 16 the
        # gather is build_stream's load stage too
        fused = levels > 0
        if k <= 16:
            a, b, c0 = sketch_stream(*gather_build_stream(
                self.packed, goff, lens, self.pad, k=k), w=w, k=k)
        else:
            codes = gather_codes(self.packed, goff, lens, None, self.pad,
                                 fill=4)
            a, b, c0 = sketch_wide(codes, lens.to(torch.int32), rids, w=w,
                                   k=k)
        a, b, c, c0, *l0 = reduce_levels(a, b, c0, k=k, r=r,
                                         levels=levels - fused, cap=self.cap,
                                         keep_l0=self.keep_l0)
        if not fused:
            drain_records(a, b, rids, c, c0, self.cursor, self.rec,
                          self.counts, k=k, width=self.out_w)
        elif k <= 16:
            reduce_drain(a, b, c, rids, c0, self.cursor, self.rec,
                         self.counts, r=r, k=k, width=self.out_w)
        else:
            reduce_wide_drain(a, b, c, c0, self.cursor, self.rec,
                              self.counts, r=r, width=self.out_w)
        if self.keep_l0:
            drain_records(*l0, rids, c0, c0, self.cursor0, self.rec0, None,
                          k=k, width=self.pad)

    def _capture(self) -> None:
        dev = self.device
        kn.library()
        # two halves, each for any chunked launch of the step: the final
        # level's fused drain takes a ticket and a slot a tile even where
        # a row fits one chunk, reduce_wide_drain also a slot a row
        # (status_words counts the smallest chunk and the row slots)
        self.status = torch.zeros(2 * kn.status_words(self.rows, self.pad),
                                  dtype=torch.int32, device=dev)
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            with kn.status_scope(self.status):
                self._body(self.rows)  # the warm-up, on the first batch
            self.cursor.zero_()
            if self.keep_l0:
                self.cursor0.zero_()
            before = {fn: fn.launches for fn in kn.KERNELS}
            reserved = torch.cuda.memory_reserved(dev)
            graph = torch.cuda.CUDAGraph()
            graph.capture_begin()
            try:
                with kn.status_scope(self.status):
                    self._body(self.rows)
            finally:
                graph.capture_end()
        torch.cuda.current_stream(dev).wait_stream(stream)
        # a capture launches nothing: each replay counts its launches
        self.per_replay = {fn: fn.launches - n for fn, n in before.items()
                           if fn.launches > n}
        for fn, n in before.items():
            fn.launches = n
        pool = torch.cuda.memory_reserved(dev) - reserved
        STATS["graph_pool_bytes"].append(pool)
        log.debug("stage 1: captured L=%d B=%d cap=%d keep_l0=%s, graph pool "
                  "%d bytes", self.pad, self.rows, self.cap, self.keep_l0,
                  pool)
        self.graph = graph

    def run(self, meta: np.ndarray, part: np.ndarray) -> bool:
        """Queue one batch (meta: its [3, len(part)] metas); True when the
        group is full and must be fetched."""
        with _timed("metas"):
            slot = self.stage[len(self.parts)]
            slot.zero_()
            slot[:, :len(part)] = torch.from_numpy(meta)
            self.metas.copy_(slot, non_blocking=True)
        self.parts.append(part)
        if self.device.type != "cuda":
            with _timed("eager"):
                self._body(len(part))
        else:
            if self.graph is None:
                with _timed("capture"):
                    self._capture()
            with _timed("replays"):
                self.graph.replay()
            for fn, n in self.per_replay.items():
                fn.launches += n
            STATS["replays"] += 1
        return len(self.parts) == self.group

    def fetch(self, xs: dict, ys: dict, l0xs: dict, l0ys: dict,
              retry) -> None:
        """The group's counts (the one sync), then its records; per-read
        slices, the overflowed batches retried; both cursors reset."""
        if not self.parts:
            return
        parts, m = self.parts, len(self.parts)
        with _timed("fetches"):
            counts = self.counts[:m].cpu().numpy()
            c0 = [counts[i, 0, :len(p)] for i, p in enumerate(parts)]
            c = [counts[i, 1, :len(p)] for i, p in enumerate(parts)]
            n = np.minimum(np.concatenate(c), self.out_w)
            rec = _fetch(self.rec, int(n.sum()))
            if self.keep_l0:
                n0 = np.minimum(np.concatenate(c0), self.pad)
                rec0 = _fetch(self.rec0, int(n0.sum()))
        STATS["group_fetches"] += 1
        over = set()
        if self.cap:
            over = {i for i in range(m) if (c0[i] > self.cap).any()
                    or (c[i] > self.out_w).any()}
        with _timed("slicing"):
            _slices(rec, n, parts, xs, ys, over)
            if self.keep_l0:
                _slices(rec0, n0, parts, l0xs, l0ys)
        for i in sorted(over):
            with _timed("retries"):
                retry(parts[i], self.pad)
            STATS["retried_batches"] += 1
        self.cursor.zero_()
        if self.keep_l0:
            self.cursor0.zero_()
        self.parts = []


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
    device = kn.require_device(device)
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
        cap and drain it whole."""
        codes, lens = db.padded_code_batch(part, pad)
        rids = torch.from_numpy(part.astype(np.int64)).to(device)
        a, b, c, c0 = index_planes(
            torch.from_numpy(codes).to(device),
            torch.from_numpy(lens.astype(np.int32)).to(device), rids, cap=0,
            **step)
        rec = torch.empty((len(part) * a.shape[1], 2), dtype=torch.int64,
                          device=device)
        counts = torch.empty((1, 2, len(part)), dtype=torch.int32,
                             device=device)
        drain_records(a, b, rids, c, c0,
                      torch.zeros(3, dtype=torch.int64, device=device), rec,
                      counts, k=cfg.k, width=a.shape[1])
        n = np.minimum(counts[0, 1].cpu().numpy(), a.shape[1])
        _slices(_fetch(rec, int(n.sum())), n, [part], xs, ys)

    # long sequences (contigs/references) take the fixed-shape segmented
    # route: pad classes above sketch_pad_len are not index batch shapes
    long_sel = lengths > cfg.sketch_pad_len
    if long_sel.any():
        _index_long(db, rids_all[long_sel], cfg, device, xs, ys,
                    (l0xs, l0ys) if keep_l0 else None)
    rids_all = rids_all[~long_sel]
    lengths = lengths[~long_sel]

    win_lo = 0
    with _timed("upload_seqdb"):
        if db_window is not None:
            # gather offsets become window-relative
            win_lo = int(db_window[0])
            if len(rids_all) and packed is None:
                packed = upload_seqdb(
                    np.asarray(db.data[win_lo:int(db_window[1])]), device)
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
        rows = min(bsz, len(batch_rids))
        n_batches = -(-len(batch_rids) // bsz)
        # a bucket's batches under one span: its own seconds are the
        # host work outside the parts (the step's buffers made and freed,
        # each batch's metas built)
        with trace.span("index.bucket", pad=pad, batches=n_batches):
            batch = _Stage1Step(packed, device, pad, rows, cap, keep_l0,
                                step, n_batches)
            for i in range(0, len(batch_rids), bsz):
                part = batch_rids[i:i + bsz]
                meta = np.stack([db.offsets[part].astype(np.int64) - win_lo,
                                 db.lengths[part].astype(np.int64),
                                 part.astype(np.int64)])
                if batch.run(meta, part):
                    batch.fetch(xs, ys, l0xs, l0ys, _retry_exact)
            batch.fetch(xs, ys, l0xs, l0ys, _retry_exact)
            del batch  # its streams and graph, before the next bucket's

    with _timed("index_of"):
        idx = _index_of(xs, ys)
        return (idx, _index_of(l0xs, l0ys)) if keep_l0 else idx
