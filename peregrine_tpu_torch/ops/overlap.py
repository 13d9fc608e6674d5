"""Overlap detection: SHIMMER pair map + bucketed alignment confirmation.

The port of peregrine_tpu/ops/overlap.py: the host half copied with its
imports changed (pair map, bucket stream, overlap_all, overlap_all_spec's
host backend, the preads.ovl writer) and the device aligner backends
(overlap_all_spec's "device" and "hybrid", overlap_all_hybrid,
overlap_chunk_device) on ops.device_align.myers_batch_db, on the device
the caller gives.  A device error propagates: unlike the JAX package no
lane falls back to the host aligner for it; only lanes longer than
cfg.aln_max_len stay off the device and go to the final native pass.

TPU-first reformulation of the reference overlapper (src/shmr_overlap.c,
src/shmr_utils.c:295-404):

* The two-level khash MMER0->MMER1->hits becomes **sorted arrays**: oriented
  (key0, key1, y0, y1, dir) records are generated vectorized and sorted by
  the composite bucket key; buckets are contiguous runs.  Hash-sharding is
  the same `hash % total_chunk` filter, applied as a mask.
* Bucket processing keeps the reference's *sequential accept semantics*
  (bestn extension cap, containment kill, global rid-pair dedup,
  src/shmr_overlap.c:52-180) on the host, but buckets are visited in
  canonical sorted order rather than khash iteration order — the reference
  output is itself hash-order dependent, so parity is validated at the
  dnadiff/contig level (SURVEY.md §7.3).
* Alignment confirmation calls the native banded O(ND) kernel; a batched
  device path can be substituted transparently.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .. import trace
from ..config import AsmConfig
from ..io.seqdb import SeqDB
from .index import ShimmerIndex

_U28 = np.uint64(0xFFFFFFF)
_U32 = np.uint64(0xFFFFFFFF)

OVLP_DTYPE = np.dtype([
    ("y0", "<u8"), ("y1", "<u8"), ("rl0", "<u4"), ("rl1", "<u4"),
    ("strand0", "u1"), ("strand1", "u1"), ("ovlp_type", "u1"),
    ("m_size", "<i4"), ("dist", "<i4"),
    ("q_bgn", "<i4"), ("q_end", "<i4"), ("t_bgn", "<i4"), ("t_end", "<i4"),
    ("t_m_end", "<i4"), ("q_m_end", "<i4"),
])


def pair_candidates(idx: ShimmerIndex, mc_lower: int = 2,
                    mc_upper: int = 240, min_dist: int = 100):
    """The shard-independent prefix of build_pairs: all adjacent eligible
    SHIMMER pairs (src/shmr_utils.c:295-340).  Computed once and shared
    across hash chunks — each chunk only filters, flips, and sorts its
    shard (re-deriving this per chunk re-scanned the whole index)."""
    x, y = idx.x, idx.y
    if len(x) < 2:
        z = np.zeros(0, np.uint64)
        return z, z, z, z
    counts = idx.counts_for(x >> np.uint64(8))

    # the reference scans to the first entry with count in [lower, upper)
    # then filters subsequent entries with count in [lower, upper]
    elig = (counts >= mc_lower) & (counts <= mc_upper)
    first_ok = (counts >= mc_lower) & (counts < mc_upper)
    s_candidates = np.flatnonzero(first_ok)
    if len(s_candidates) == 0:
        z = np.zeros(0, np.uint64)
        return z, z, z, z
    s = s_candidates[0]
    keep = elig.copy()
    keep[:s] = False
    keep[s] = True
    sel = np.flatnonzero(keep)

    fx, fy = x[sel], y[sel]
    a0, a1 = fx[:-1], fx[1:]
    b0, b1 = fy[:-1], fy[1:]
    same_read = (b0 >> np.uint64(32)) == (b1 >> np.uint64(32))
    dist = ((b1 >> np.uint64(1)) & _U28) - ((b0 >> np.uint64(1)) & _U28)
    far = dist.astype(np.uint32) >= np.uint32(min_dist)
    pair = same_read & far
    return a0[pair], a1[pair], b0[pair], b1[pair]


def build_pairs(idx: ShimmerIndex, read_lengths: np.ndarray,
                chunk: int = 1, total_chunk: int = 1,
                mc_lower: int = 2, mc_upper: int = 240,
                min_dist: int = 100, cand=None,
                spill_dir: str | None = None):
    """Oriented adjacent-SHIMMER pair records (build_map semantics,
    src/shmr_utils.c:295-404).

    Dispatches to the fused threaded native build (native/build_pairs.cpp,
    ~12 s vs ~35 s numpy at 250 Mb scale) unless `cand` passes a
    precomputed pair_candidates result (the legacy hash-chunk path shares
    one scan across chunks); build_pairs_np below is the semantic oracle
    and the two are asserted byte-identical in tests/test_overlap.py.

    Returns (key0, key1, y0, y1, direction) arrays sorted by (key0, key1).
    """
    if cand is None:
        from ..native import build_pairs_fused
        return build_pairs_fused(
            np.ascontiguousarray(idx.x, np.uint64),
            np.ascontiguousarray(idx.y, np.uint64),
            np.ascontiguousarray(idx.mc_hash, np.uint64),
            np.ascontiguousarray(idx.mc_count, np.uint32),
            read_lengths, mc_lower, mc_upper, min_dist, chunk, total_chunk,
            spill_dir=spill_dir)
    return build_pairs_np(idx, read_lengths, chunk, total_chunk,
                          mc_lower, mc_upper, min_dist, cand)


def build_pairs_np(idx: ShimmerIndex, read_lengths: np.ndarray,
                   chunk: int = 1, total_chunk: int = 1,
                   mc_lower: int = 2, mc_upper: int = 240,
                   min_dist: int = 100, cand=None):
    """Vectorized numpy pair-map build (semantic oracle for the native
    fused path; also the production path when a shared `cand` amortizes
    the eligibility scan across legacy hash chunks)."""
    if cand is None:
        cand = pair_candidates(idx, mc_lower, mc_upper, min_dist)
    p0x, p1x, p0y, p1y = cand
    if len(p0x) == 0:
        z = np.zeros(0, np.uint64)
        return z, z, z, z, np.zeros(0, np.uint8)
    tc = np.uint64(total_chunk)
    ck = np.uint64(chunk % total_chunk)

    # forward orientation, sharded by the leading hash
    fsel = ((p0x >> np.uint64(8)) % tc) == ck
    k0f, k1f = p0x[fsel], p1x[fsel]
    y0f, y1f = p0y[fsel], p1y[fsel]

    # reverse orientation: keys swapped, coordinates flipped to the other
    # strand (rpos = rlen - pos - 1 + span - 1 with pos already +1'd;
    # src/shmr_utils.c:377-395)
    rsel = ((p1x >> np.uint64(8)) % tc) == ck
    k0r, k1r = p1x[rsel], p0x[rsel]

    rl = read_lengths.astype(np.uint64)

    def _flip(yv: np.ndarray, xv: np.ndarray) -> np.ndarray:
        span = xv & np.uint64(0xFF)
        rid = yv >> np.uint64(32)
        pos = ((yv & _U32) >> np.uint64(1)) + np.uint64(1)
        rpos = rl[rid.astype(np.int64)] - pos + span - np.uint64(1)
        return ((yv & np.uint64(0xFFFFFFFF00000001))
                | ((rpos << np.uint64(1)) & _U32)) ^ np.uint64(1)

    y0r = _flip(p1y[rsel], p1x[rsel])
    y1r = _flip(p0y[rsel], p0x[rsel])

    key0 = np.concatenate([k0f, k0r])
    key1 = np.concatenate([k1f, k1r])
    y0 = np.concatenate([y0f, y0r])
    y1 = np.concatenate([y1f, y1r])
    direction = np.concatenate([np.zeros(len(k0f), np.uint8),
                                np.ones(len(k0r), np.uint8)])

    # stable (key0, key1) sort — threaded native pass (sort_pairs.cpp);
    # order identical to np.lexsort((key1, key0)), ~4x faster at 14.9M
    # rows on 2 cores
    from ..native import sort_pairs
    sort_pairs(key0, key1, y0, y1, direction)
    return key0, key1, y0, y1, direction


def bucket_stream(key0, key1, y0a, dira, ovlp_upper: int,
                  spill_dir: str | None = None):
    """Fused native bucket-stream build (build_pairs.cpp): eligible
    buckets (2 < size <= ovlp_upper) flattened into one replay-ordered
    stream, bucket-major with descending position inside a bucket, as
    two threaded linear passes.  Returns (ys, dirs, pos, bstart, bend).
    The JAX package keeps the numpy oracle (_bucket_stream)."""
    from ..native import bucket_stream_fused
    return bucket_stream_fused(
        np.ascontiguousarray(key0, np.uint64),
        np.ascontiguousarray(key1, np.uint64),
        np.ascontiguousarray(y0a, np.uint64),
        np.ascontiguousarray(dira, np.uint8), ovlp_upper,
        spill_dir=spill_dir)


def overlap_chunk_native(db: SeqDB, idx: ShimmerIndex, cfg: AsmConfig,
                         chunk: int = 1, total_chunk: int = 1,
                         pairs=None, cache=None, stream=None, cand=None):
    """Overlaps of one hash shard, with the sequential accept loop of
    src/shmr_overlap.c:52-180 in C++ (native/overlap_replay.cpp); alignments come from the optional
    speculative cache (unordered keys, CacheMap hash lookup, duplicate
    keys first-wins) with the native O(ND) kernel as
    miss fallback.  Returns (records, n_cache_misses, n_rejecter_misses),
    the last the misses whose rid pair had a failing cached alignment
    earlier in the pass.  stream may pass a
    precomputed bucket_stream to avoid rebuilding it; cand a shared
    pair_candidates result."""
    from ..native import overlap_replay
    assert OVLP_DTYPE.itemsize == 59
    if stream is None:
        key0, key1, y0a, y1a, dira = (pairs if pairs is not None
                                      else build_pairs(
            idx, db.lengths, chunk, total_chunk,
            cfg.mc_lower, cfg.mc_upper, cfg.min_anchor_dist, cand=cand))
        ys, dirs, pos, bs, be = bucket_stream(key0, key1, y0a, dira,
                                              cfg.ovlp_upper)
    else:
        ys, dirs, pos, bs, be = stream
    if cache is None:
        z64 = np.zeros(0, np.uint64)
        cache = (z64, z64, np.zeros((0, 8), np.int32))
    raw, n, miss, rejecters = overlap_replay(
        ys, dirs, pos, bs, be, db.data, db.offsets, db.lengths,
        cfg.best_n_ovlp, cfg.read_end_fuzz, cfg.min_ovlp_aln, cfg.aln_bw,
        *cache)
    recs = (np.frombuffer(raw, dtype=OVLP_DTYPE).copy() if n
            else np.zeros(0, OVLP_DTYPE))
    return recs, miss, rejecters


class _CacheArena:
    """Append-only (ka, kb, res) alignment-result cache with 2x growth.

    With spill_dir the buffers are unlinked-file-backed (native._alloc),
    so the cache — the anonymous-RSS bulk of the overlap stage at scale
    (24 B + 32 B per alignment; ~0.6 GB at 250 Mb, ~sixfold at human) —
    stays under page-cache control in bounded-RSS mode.  Growth also
    replaces the per-round full-cache np.concatenate copies."""

    def __init__(self, spill_dir: str | None = None):
        from ..native import _alloc
        self._mk = lambda shape, dt, tag: _alloc(shape, dt, spill_dir, tag)
        self.n = 0
        cap = 1 << 16
        self.ka = self._mk(cap, np.uint64, "cache-ka")
        self.kb = self._mk(cap, np.uint64, "cache-kb")
        self.res = self._mk((cap, 8), np.int32, "cache-res")

    def _grow(self, need: int) -> None:
        cap = len(self.ka)
        if self.n + need <= cap:
            return
        new_cap = max(cap * 2, self.n + need)
        for name, shape, dt in (("ka", new_cap, np.uint64),
                                ("kb", new_cap, np.uint64),
                                ("res", (new_cap, 8), np.int32)):
            old = getattr(self, name)
            new = self._mk(shape, dt, f"cache-{name}")
            new[:self.n] = old[:self.n]
            setattr(self, name, new)

    def append(self, mka, mkb, rres) -> None:
        m = len(mka)
        if not m:
            return
        self._grow(m)
        self.ka[self.n:self.n + m] = mka
        self.kb[self.n:self.n + m] = mkb
        self.res[self.n:self.n + m] = rres
        self.n += m

    def view(self):
        """Contiguous (ka, kb, res) views of the filled prefix — re-take
        after every append (growth reallocates)."""
        return self.ka[:self.n], self.kb[:self.n], self.res[:self.n]


def _req_keys(reqs: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    ka = ((reqs["rid0"].astype(np.uint64) << np.uint64(33))
          | (reqs["pos0"].astype(np.uint64) << np.uint64(1))
          | reqs["strand0"].astype(np.uint64))
    kb = ((reqs["rid1"].astype(np.uint64) << np.uint64(33))
          | (reqs["pos1"].astype(np.uint64) << np.uint64(1))
          | reqs["strand1"].astype(np.uint64))
    return ka, kb


def _align_parallel(reqs: np.ndarray, db: SeqDB, db_data: np.ndarray,
                    band: int, n_workers: int,
                    slices=None) -> np.ndarray:
    """Align one request array on all host cores (native align_spec over
    disjoint slices; ctypes releases the GIL)."""
    import concurrent.futures as cf

    from ..native import align_spec

    n = len(reqs)
    res = np.zeros((max(n, 1), 8), np.int32)
    if not n:
        return res[:n]
    if slices is None:
        # fine-grained slices smooth the variable per-alignment cost
        step = max(1024, n // (8 * n_workers) + 1)
        slices = [(lo, min(lo + step, n)) for lo in range(0, n, step)]
    if n_workers > 1 and len(slices) > 1:
        with cf.ThreadPoolExecutor(max_workers=n_workers) as ex:
            futs = [ex.submit(align_spec, reqs, lo, hi, db_data,
                              db.offsets, db.lengths, band, res)
                    for lo, hi in slices]
            for f in futs:
                f.result()
    else:
        for lo, hi in slices:
            align_spec(reqs, lo, hi, db_data, db.offsets, db.lengths,
                       band, res)
    return res[:n]


def _device_fill(res: np.ndarray, part: np.ndarray, d, qe, te) -> None:
    """Expand the device kernel's (dist, q_end, t_end) into the 8
    OvlpMatch fields the replay cache carries (same derivation the
    3-field cache hit used to compute inline)."""
    d64 = np.asarray(d, np.int64)
    qe64 = np.asarray(qe, np.int64)
    te64 = np.asarray(te, np.int64)
    res[part, 0] = ((qe64 + te64 + 2 * d64) // 2).astype(np.int32)
    res[part, 1] = d64.astype(np.int32)
    res[part, 3] = qe64.astype(np.int32)   # q_bgn/t_bgn stay 0
    res[part, 5] = te64.astype(np.int32)
    res[part, 6] = te64.astype(np.int32)
    res[part, 7] = qe64.astype(np.int32)


def _request_columns(db: SeqDB, r0, r1, p0, p1, s0, s1):
    """The aligner's seven int64 request columns (q_off, q_rstart, q_len,
    q_strand, t_off, t_len, t_strand) and each lane's max(q, t, 1024)
    length, which cfg.aln_max_len caps."""
    shift = p0.astype(np.int64) - p1.astype(np.int64)
    qr = db.offsets[r0.astype(np.int64)]
    tl = db.lengths[r1.astype(np.int64)]
    cols = np.stack([qr + shift, qr, db.lengths[r0.astype(np.int64)] - shift,
                     s0.astype(np.int64), db.offsets[r1.astype(np.int64)], tl,
                     s1.astype(np.int64)], axis=1)
    mlen = np.maximum(np.maximum(cols[:, 2], tl), 1024)
    return cols, mlen


def _align_lanes(seqdb_dev, cols: np.ndarray):
    """(dist, q_end, t_end) numpy int32 arrays of request columns aligned
    on seqdb_dev's device: one myers_batch_db call for all lanes (the JAX
    package's pad classes and fixed batches are compile-cache shapes; the
    kernel's result does not depend on them, and a GPU wants every lane
    of a round in one launch).  The copy back synchronises the device."""
    from .device_align import myers_batch_db
    if not len(cols):
        z = np.zeros(0, np.int32)
        return z, z, z
    dev = seqdb_dev.fw.device
    out = myers_batch_db(seqdb_dev, torch.from_numpy(cols).to(dev))
    return tuple(o.cpu().numpy() for o in out)


def _launches() -> int:
    """The device aligner's launches so far (myers_batch_db.launches; 0
    where the aligner in its place counts none)."""
    from . import device_align
    return getattr(device_align.myers_batch_db, "launches", 0)


def _on_device(seqdb_dev):
    """A context that makes seqdb_dev's device the current one, for a
    worker thread that launches there (nothing on the CPU)."""
    dev = seqdb_dev.fw.device
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _align_device(reqs: np.ndarray, db: SeqDB, cfg: AsmConfig,
                  seqdb_dev) -> tuple[np.ndarray, np.ndarray]:
    """Align one request array with the device Myers kernel against the
    device-resident seqdb; returns (res [n,8], have mask).  Requests
    longer than aln_max_len stay un-cached and fall to the final pass's
    native aligner."""
    n = len(reqs)
    res = np.zeros((max(n, 1), 8), np.int32)
    have = np.zeros(max(n, 1), bool)
    if not n:
        return res[:n], have[:n]
    cols, mlen = _request_columns(db, reqs["rid0"], reqs["rid1"],
                                  reqs["pos0"], reqs["pos1"],
                                  reqs["strand0"], reqs["strand1"])
    part = np.flatnonzero(mlen <= cfg.aln_max_len)
    _device_fill(res, part, *_align_lanes(seqdb_dev, cols[part]))
    have[part] = True
    return res[:n], have[:n]


def _align_hybrid(reqs: np.ndarray, db: SeqDB, db_data: np.ndarray,
                  cfg: AsmConfig, seqdb_dev, batch: int,
                  n_host: int) -> tuple[np.ndarray, np.ndarray]:
    """Host threads and a device thread pull slices of ONE request array
    from a shared queue — the chunk-free hybrid (the old chunked hybrid
    needed extra chunks whose work was duplicated, BENCH.md).  The device
    thread makes seqdb_dev's device its current one; each of its slices
    is one launch whose results it copies back, synchronising, before it
    takes the next."""
    import concurrent.futures as cf
    import queue

    n = len(reqs)
    res = np.zeros((max(n, 1), 8), np.int32)
    have = np.zeros(max(n, 1), bool)
    if not n:
        return res[:n], have[:n]
    step = max(batch, n // 16 + 1)
    work: queue.SimpleQueue = queue.SimpleQueue()
    for lo in range(0, n, step):
        work.put((lo, min(lo + step, n)))

    from ..native import align_spec

    def host_drain():
        while True:
            try:
                lo, hi = work.get_nowait()
            except queue.Empty:
                return
            align_spec(reqs, lo, hi, db_data, db.offsets, db.lengths,
                       cfg.aln_bw, res)
            have[lo:hi] = True

    def dev_drain():
        with _on_device(seqdb_dev):
            while True:
                try:
                    lo, hi = work.get_nowait()
                except queue.Empty:
                    return
                r, h = _align_device(reqs[lo:hi], db, cfg, seqdb_dev)
                res[lo:hi][h] = r[h]
                have[lo:hi] = h

    with cf.ThreadPoolExecutor(max_workers=n_host + 1) as ex:
        futs = [ex.submit(dev_drain)]
        futs += [ex.submit(host_drain) for _ in range(n_host)]
        for f in futs:
            f.result()
    return res[:n], have[:n]


def overlap_all_spec(db: SeqDB, idx: ShimmerIndex, cfg: AsmConfig,
                     n_workers: int | None = None, window: int = 0,
                     per_pair: int = 1, pairs=None,
                     max_rounds: int = 8, backend: str = "host",
                     shard: tuple[int, int] | None = None,
                     exchange=None, run_final: bool = True,
                     device=None) -> np.ndarray:
    """Globally-deduplicated parallel overlap detection.

    The scaling scheme that replaces hash chunking: discover the accept
    loop's alignment points by ITERATION — a collect-mode replay walks the
    exact sequential accept semantics but, on a cache miss, records the
    request and optimistically assumes an accepted OVERLAP (the majority
    outcome), except, on the host backend, where the pair's cached
    alignment already failed in this pass: that miss is collected as a
    rejection, so one round collects the rest of such a pair's anchors
    (the device backends keep the optimistic rule everywhere: their
    aligner's results differ from the final pass's inline aligner, so
    which keys a round harvests decides their records); the collected
    requests are aligned on all host cores (native
    align_spec, GIL-releasing threads over slices of one request array)
    and the replay re-runs with the widened full-fidelity cache until it
    converges.  The final pass runs exact (misses align inline), so
    correctness never depends on the iteration: the output is
    **byte-identical to the 1-chunk run at any worker count** — unlike
    the reference, where every shmr_overlap process keeps a private RPAIR
    table (src/shmr_overlap.c:101-107) and 55-80% of each added chunk's
    alignment work is duplicated (BENCH.md).

    Measured at yeast scale (BENCH.md): 517k total alignments vs 550k for
    the sequential 1-chunk run and 691k/1.66M for 2/8 legacy hash chunks;
    a window>0 pre-seeds the cache with spec_enum requests, measured
    strictly worse (689k at window=8) — kept for experimentation.

    backend selects who aligns the harvested requests: "host" (native
    O(ND) threads), "device" (batched Myers against the HBM-resident
    seqdb; dist/endpoint semantics per ops.device_align), or "hybrid"
    (host threads + a device thread pulling slices of one request array —
    no extra chunks, so no duplicated work, fixing the old hybrid's
    measured flaw).  Whatever the backend cannot align falls to the final
    exact pass's native aligner.  The device backends upload the seqdb to
    `device` and align there.

    Multi-host sharding (VERDICT r4 item 1; reference analog: N
    independent shmr_overlap processes over a shared filesystem,
    py/scripts/pg_run.py:320-342): with shard=(rank, nranks) every rank
    runs the IDENTICAL deterministic collect loop, but rank r aligns
    only the request-buffer blocks it owns (block-cyclic: streamed block
    b of 4096 iff b % nranks == r, overflow block of 1024 likewise).
    After each round `exchange(rnd, reqs, res, mine)` must return the
    full result array (peers' rows filled — shared-FS files or
    collectives); every rank then merges the identical full set, so
    cache state — and therefore the next round's collected request
    set — stays byte-equal across ranks.  The final exact pass runs
    only where run_final=True (rank 0); other ranks return None.
    Requires backend="host" and window=0.
    """
    import logging
    import os as _os

    from ..native import spec_enum

    log2 = logging.getLogger("peregrine_tpu_torch")
    if shard is not None and (backend != "host" or window > 0):
        raise ValueError("shard=(rank, nranks) requires backend='host' "
                         "and window=0")
    if n_workers is None:
        n_workers = _os.cpu_count() or 1
    t_pairs = 0.0
    if pairs is None:
        with trace.span("overlap.pairs") as sp:
            key0, key1, y0a, y1a, dira = build_pairs(
                idx, db.lengths, 1, 1,
                cfg.mc_lower, cfg.mc_upper, cfg.min_anchor_dist,
                spill_dir=cfg.spill_dir)
            sp.attrs["entries"] = len(key0)
        t_pairs = sp.seconds
    else:
        key0, key1, y0a, y1a, dira = pairs
    with trace.span("overlap.stream") as sp:
        stream = bucket_stream(key0, key1, y0a, dira, cfg.ovlp_upper,
                               spill_dir=cfg.spill_dir)
    log2.info("overlap dedup: pair map %.1fs (%d entries)%s + stream %.1fs",
              t_pairs, len(key0), " [shared]" if pairs is not None else "",
              sp.seconds)
    if pairs is None:
        # the replay stream fully replaces the pair map from here on;
        # freeing the five columns now (not at function exit) drops
        # ~33 B/entry of anonymous-or-spill footprint (~11 GB at the
        # human-class rung) before the alignment rounds allocate theirs
        del key0, key1, y0a, y1a, dira
    sys_, sdirs, spos, sbs, sbe = stream
    db_data = np.ascontiguousarray(db.data, np.uint8) \
        if not db.data.flags.c_contiguous else db.data

    seqdb_dev = None
    if backend in ("device", "hybrid"):
        from .dbgather import upload_seqdb
        with trace.span("overlap.upload"):
            seqdb_dev = upload_seqdb(db.data, torch.device(device))

    def align_round(rr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The round's alignments under the span overlap.align (attrs:
        the device's lanes and the aligner's launches)."""
        with trace.span("overlap.align") as sp:
            launches = _launches()
            if backend == "device":
                rres, rhave = _align_device(rr, db, cfg, seqdb_dev)
                sp.attrs["lanes"] = int(rhave.sum())
            elif backend == "hybrid":
                rres, rhave = _align_hybrid(rr, db, db_data, cfg, seqdb_dev,
                                            cfg.aln_batch, n_workers)
            else:
                rres, rhave = (_align_parallel(rr, db, db_data, cfg.aln_bw,
                                               n_workers),
                               np.ones(len(rr), bool))
            sp.attrs["launches"] = _launches() - launches
        return rres, rhave

    arena = _CacheArena(cfg.spill_dir)

    def merge(rr, rres, rhave):
        # append-only: the replay's cache is a hash map (CacheMap in
        # overlap_replay.cpp) that neither needs sorted keys nor cares
        # which duplicate wins — a request key fully determines the
        # alignment inputs, so duplicate keys carry identical results.
        # (The per-round lexsort+dedup this replaced cost ~4 s/round at
        # 140 Mb scale.)
        mka, mkb = _req_keys(rr)
        arena.append(mka[rhave], mkb[rhave], rres[rhave])
    # a collected miss is by definition not in the cache, so the only keys
    # that could be re-collected forever are ones the backend FAILED to
    # align (ultra-long lanes, failed batches) — track just those
    failed: set[tuple[int, int]] = set()
    total_aligned = 0
    if window > 0:  # optional spec_enum pre-seed (measured worse; kept)
        with trace.span("overlap.round", round=0) as rsp:
            reqs = spec_enum(sys_, sdirs, spos, sbs, sbe, window, per_pair)
            rres, rhave = align_round(reqs)
            with trace.span("overlap.merge"):
                merge(reqs, rres, rhave)
            if not rhave.all():
                pka, pkb = _req_keys(reqs)
                failed.update(zip(pka[~rhave].tolist(),
                                  pkb[~rhave].tolist()))
            rsp.attrs.update(misses=len(reqs), aligned=int(rhave.sum()))
        total_aligned += int(rhave.sum())

    # iterative miss harvest: collect -> parallel align -> merge -> re-run
    # (host backend: collect and align run CONCURRENTLY — the replay
    # streams misses to aligner threads as it walks, so its single-core
    # wall hides under the parallel alignment work)
    cap0 = min(64 << 20, max(1 << 22,
                             4 * cfg.best_n_ovlp * len(db.lengths)))
    prev_miss = cap0
    my_aligned = 0
    for rnd in range(max_rounds):
        # a round's span: attrs round, misses, rejecters (the misses of
        # pairs whose cached alignment failed earlier in the pass),
        # aligned; on the host backend also workers and the aligner
        # threads' summed busy_s and wait_s (set by
        # _collect_align_streaming)
        if backend == "host":
            with trace.span("overlap.round", round=rnd + 1, misses=0,
                            aligned=0, workers=n_workers) as rsp:
                cap = int(min(cap0, max(prev_miss, 1 << 16)))
                miss, rej, missreqs, rres, mine = _collect_align_streaming(
                    db, cfg, stream, arena.view(), db_data, n_workers, cap,
                    shard=shard, parent=rsp)
                rsp.attrs.update(misses=miss, rejecters=rej)
                if miss == 0:
                    break
                my_aligned += int(mine.sum())
                with trace.span("overlap.merge") as msp:
                    if exchange is not None:
                        rres = exchange(rnd, missreqs, rres, mine)
                    rhave = np.ones(len(missreqs), bool)
                    merge(missreqs, rres, rhave)
                rsp.attrs["aligned"] = len(missreqs)
            total_aligned += len(missreqs)
            prev_miss = miss
            log2.info("overlap dedup round %d: %d misses harvested "
                      "(streamed, %.1fs + merge %.1fs)", rnd + 1, miss,
                      msp.t0 - rsp.t0, msp.seconds)
            if miss < max(5000, total_aligned // 50):
                # stop iterating: the final pass aligns the misses left
                # inline, on one thread — mostly those of pairs the last
                # round met first and assumed overlaps, with what their
                # results change (the rest of a failing pair's anchors is
                # collected by the round after its first failure aligns)
                break
            continue
        with trace.span("overlap.round", round=rnd + 1, misses=0,
                        aligned=0) as rsp:
            with trace.span("overlap.collect"):
                _, _, miss, rej, missreqs = _replay(
                    db, cfg, stream, arena.view(), db_data, collect=True)
            rsp.attrs.update(misses=miss, rejecters=rej)
            if miss == 0:
                break
            if rnd > 0 and miss < max(5000, total_aligned // 50):
                # stop iterating: the final pass aligns the misses left
                # inline, on one thread (the device backends keep the
                # optimistic rule, so a failing pair's chain of anchors
                # still gives up one anchor a round here)
                log2.info("overlap dedup: %d residual misses left to the "
                          "final pass", miss)
                break
            if failed:
                mka, mkb = _req_keys(missreqs)
                new = np.fromiter((k not in failed for k in
                                   zip(mka.tolist(), mkb.tolist())),
                                  bool, len(missreqs))
                if not new.any():
                    break  # only backend-unalignable requests remain
                missreqs = missreqs[new]
            rres, rhave = align_round(missreqs)
            with trace.span("overlap.merge"):
                merge(missreqs, rres, rhave)
            if not rhave.all():
                mka, mkb = _req_keys(missreqs)
                failed.update(zip(mka[~rhave].tolist(),
                                  mkb[~rhave].tolist()))
            rsp.attrs["aligned"] = int(rhave.sum())
        total_aligned += int(rhave.sum())
        log2.info("overlap dedup round %d: %d misses harvested", rnd + 1,
                  len(missreqs))

    if shard is not None:
        log2.info("overlap dedup rank share: %d of %d round alignments",
                  my_aligned, total_aligned)
    if not run_final:
        return None
    with trace.span("overlap.final") as sp:
        recs, miss, rej = overlap_chunk_native(
            db, idx, cfg, stream=stream[:5], cache=arena.view())
        sp.attrs.update(inline=miss, rejecter_inline=rej)
    total_aligned += miss
    log2.info("overlap dedup [%s]: %d alignments total on %d workers "
              "(%d inline in the final pass, %.1fs)", backend,
              total_aligned, n_workers, miss, sp.seconds)
    return recs


def _collect_align_streaming(db: SeqDB, cfg: AsmConfig, stream, cache,
                             db_data, n_workers: int, cap: int,
                             shard: tuple[int, int] | None = None,
                             parent: trace.Span | None = None):
    """One collect-mode replay pass with CONCURRENT alignment of the
    streamed misses: the single-core replay writes requests into a shared
    buffer behind an atomic progress counter while n_workers aligner
    threads consume [cursor, progress) slices (GIL-free native calls on
    both sides).  Oversubscribing the cores by one replay thread is fine —
    wall converges to total_work / n_cores instead of
    replay_wall + align_work / n_cores.  The collected request SET is
    identical to the non-streamed pass (streaming changes who aligns,
    never what is collected), so output bytes are unchanged.

    With shard=(rank, nranks) this rank aligns only its block-cyclic
    share of the buffer — streamed block b (4096 rows) iff
    b % nranks == rank, overflow block (1024 rows) likewise — leaving
    peers' rows zeroed for the caller's exchange to fill.  Ownership is
    a pure function of row index, so every rank can reconstruct every
    other rank's mask from the (deterministic) collected order.

    The replay thread's span is overlap.collect, each aligner thread's
    overlap.aligner (attrs: busy_s in align_spec, wait_s in its 2 ms
    polls), all under `parent`, whose attrs take the threads' summed
    busy_s and wait_s when they join.

    The pass collects under the rejecter rule (overlap_replay's
    collect_rejecters), a function of the stream and the cache alone, so
    every rank collects the same requests.

    Returns (n_miss, n_rejecters, requests, results[n, 8], mine) where
    `mine` marks the rows this rank aligned (all True without shard)."""
    import threading
    import time as _time

    from ..native import SPEC_REQ_DTYPE, align_spec, overlap_replay

    rank, nranks = shard if shard is not None else (0, 1)
    sys_, sdirs, spos, sbs, sbe = stream[:5]
    buf = np.zeros(cap, SPEC_REQ_DTYPE)
    prog = np.zeros(1, np.int64)
    res = np.zeros((cap, 8), np.int32)
    done = threading.Event()
    out: dict = {}

    def run_replay():
        try:
            with trace.span("overlap.collect", parent=parent):
                out["r"] = overlap_replay(
                    sys_, sdirs, spos, sbs, sbe, db_data, db.offsets,
                    db.lengths, cfg.best_n_ovlp, cfg.read_end_fuzz,
                    cfg.min_ovlp_aln, cfg.aln_bw, *cache,
                    collect_misses=True, stream_buf=buf,
                    stream_progress=prog, collect_rejecters=True)
        except BaseException as e:  # surfaced after join
            out["err"] = e
        finally:
            done.set()

    lock = threading.Lock()
    cursor = [0]
    # block size scales with the EXPECTED round workload (a pure
    # function of inputs identical on every rank, so ownership stays
    # deterministic) — sizing from the buffer capacity would leave a
    # toy-scale round entirely inside block 0 of one rank
    est = 4 * cfg.best_n_ovlp * len(db.lengths)
    chunk = int(min(4096, max(256, est // (16 * nranks))))

    spent = []

    def aligner():
        busy = wait = 0.0
        with trace.span("overlap.aligner", parent=parent) as sp:
            while True:
                with lock:
                    # read the progress counter under the lock: the mutex
                    # acquire is the acquire barrier pairing the C++
                    # side's release store on weakly-ordered CPUs (plain
                    # loads are only safe on x86-TSO)
                    avail = int(prog[0])
                    fin = done.is_set()
                    lo = cursor[0]
                    if nranks > 1:
                        # skip blocks owned by other ranks; never let one
                        # align call cross a block boundary
                        while (lo // chunk) % nranks != rank:
                            lo = (lo // chunk + 1) * chunk
                        hi = min(avail, (lo // chunk + 1) * chunk)
                    else:
                        hi = min(avail, lo + chunk)
                    cursor[0] = hi if hi > lo else lo
                t = _time.perf_counter()
                if hi > lo:
                    align_spec(buf, lo, hi, db_data, db.offsets, db.lengths,
                               cfg.aln_bw, res)
                    busy += _time.perf_counter() - t
                    continue
                if fin and lo >= int(prog[0]):
                    break
                _time.sleep(0.002)
                wait += _time.perf_counter() - t
            sp.attrs.update(busy_s=busy, wait_s=wait)
        spent.append((busy, wait))

    threads = [threading.Thread(target=run_replay)]
    threads += [threading.Thread(target=aligner) for _ in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if parent is not None:
        parent.attrs.update(busy_s=sum(b for b, _ in spent),
                            wait_s=sum(w for _, w in spent))
    if "err" in out:
        raise out["err"]
    _, _, n_miss, n_rej, overflow = out["r"]
    streamed = int(prog[0])
    reqs = buf[:streamed]
    rres = res[:streamed]
    mine = np.ones(streamed + len(overflow), bool)
    if nranks > 1:
        mine[:streamed] = \
            (np.arange(streamed) // chunk) % nranks == rank
    if len(overflow):
        oslices = None
        if nranks > 1:
            ob = max(256, chunk // 4)
            oslices = [(lo, min(lo + ob, len(overflow)))
                       for lo in range(0, len(overflow), ob)
                       if (lo // ob) % nranks == rank]
            mine[streamed:] = \
                (np.arange(len(overflow)) // ob) % nranks == rank
        with trace.span("overlap.overflow", rows=len(overflow)):
            ores = _align_parallel(overflow, db, db_data, cfg.aln_bw,
                                   n_workers, slices=oslices)
        reqs = np.concatenate([reqs, overflow])
        rres = np.concatenate([rres, ores])
    return n_miss, n_rej, reqs, rres, mine


def _replay(db: SeqDB, cfg: AsmConfig, stream, cache, db_data,
            collect: bool):
    """Raw replay invocation (collect or exact) against a prepared
    stream + cache."""
    from ..native import overlap_replay
    sys_, sdirs, spos, sbs, sbe = stream[:5]
    return overlap_replay(
        sys_, sdirs, spos, sbs, sbe, db_data, db.offsets, db.lengths,
        cfg.best_n_ovlp, cfg.read_end_fuzz, cfg.min_ovlp_aln, cfg.aln_bw,
        *cache, collect_misses=collect)


def overlap_all(db: SeqDB, idx: ShimmerIndex, cfg: AsmConfig,
                n_chunks: int = 1, n_workers: int = 1,
                seqdb_prefix: str | None = None,
                mm_paths: list[str] | None = None,
                mc_paths: list[str] | None = None,
                dedup: bool | None = None,
                pairs=None) -> np.ndarray:
    """All overlaps, parallelized across worker threads.

    Default (cfg.dedup_overlap): the globally-deduplicated speculative
    path (overlap_all_spec) — work is sharded by alignment request, not
    by bucket hash, and the record output is identical to a single-chunk
    run at any worker count.

    Legacy mode (dedup=False): hash-chunked workers, each chunk keeping
    its own rid-pair table (as each reference shmr_overlap process does);
    cross-chunk duplicates are removed by the text-emission dedup
    (shmr_dedup semantics in ovlps_to_text) but their alignment work is
    not.  Chunk workers are THREADS sharing db + idx: the accept loop is
    one ctypes call (native/overlap_replay.cpp) that releases the GIL.
    (seqdb_prefix/mm/mc paths are kept for API compatibility; they are no
    longer needed.)
    """
    if dedup is None:
        dedup = cfg.dedup_overlap
    if dedup:
        if n_workers <= 1:
            return overlap_chunk_native(db, idx, cfg)[0]
        return overlap_all_spec(db, idx, cfg, n_workers, pairs=pairs)
    if n_chunks <= 1:
        return overlap_chunk_native(db, idx, cfg)[0]
    cand = pair_candidates(idx, cfg.mc_lower, cfg.mc_upper,
                           cfg.min_anchor_dist)
    if n_workers <= 1:
        parts = [overlap_chunk_native(db, idx, cfg, c + 1, n_chunks,
                                      cand=cand)[0]
                 for c in range(n_chunks)]
        parts = [p for p in parts if len(p)]
        return np.concatenate(parts) if parts else np.zeros(0, OVLP_DTYPE)

    import concurrent.futures as cf

    results: list[np.ndarray | None] = [None] * n_chunks
    with cf.ThreadPoolExecutor(max_workers=max(1, n_workers)) as ex:
        futs = {ex.submit(overlap_chunk_native, db, idx, cfg,
                          c + 1, n_chunks, cand=cand): c
                for c in range(n_chunks)}
        for f in cf.as_completed(futs):
            results[futs[f]] = f.result()[0]
    parts = [r for r in results if r is not None and len(r)]
    return np.concatenate(parts) if parts else np.zeros(0, OVLP_DTYPE)


def overlap_all_hybrid(db: SeqDB, idx: ShimmerIndex, cfg: AsmConfig,
                       device, n_chunks: int = 8,
                       n_host_workers: int | None = None) -> np.ndarray:
    """Hash chunks pulled from one queue by a device thread (speculative
    device batches, overlap_chunk_device) and host threads (native O(ND)
    replay, overlap_chunk_native) running concurrently; per-chunk accept
    semantics are unchanged (each path is the tested per-chunk code) and
    the packed seqdb is uploaded to `device` once.

    MEASURED CAVEAT (BENCH.md, on the JAX package): per-chunk rid-pair
    dedup — the reference's own share-nothing tradeoff
    (src/shmr_overlap.c:101-107) — makes total alignment work GROW with
    chunk count, so the extra chunks this mode needs eat its concurrency
    gain on hosts with few cores.  Off by default."""
    import concurrent.futures as cf
    import os as _os
    import queue

    if n_host_workers is None:
        n_host_workers = _os.cpu_count() or 1
    cand = pair_candidates(idx, cfg.mc_lower, cfg.mc_upper,
                           cfg.min_anchor_dist)
    from .dbgather import upload_seqdb
    seqdb_dev = upload_seqdb(db.data, torch.device(device))

    work: queue.SimpleQueue = queue.SimpleQueue()
    for c in range(1, n_chunks + 1):
        work.put(c)
    results: dict[int, np.ndarray] = {}

    def drain(fn):
        while True:
            try:
                c = work.get_nowait()
            except queue.Empty:
                return
            results[c] = fn(c)

    def dev_chunk(c):
        return overlap_chunk_device(db, idx, cfg, seqdb_dev.fw.device, c,
                                    n_chunks, cand=cand, seqdb_dev=seqdb_dev)

    def host_chunk(c):
        return overlap_chunk_native(db, idx, cfg, c, n_chunks,
                                    cand=cand)[0]

    def dev_drain():
        with _on_device(seqdb_dev):
            drain(dev_chunk)

    with cf.ThreadPoolExecutor(max_workers=n_host_workers + 1) as ex:
        futs = [ex.submit(dev_drain)]
        futs += [ex.submit(drain, host_chunk) for _ in range(n_host_workers)]
        for f in futs:
            f.result()
    parts = [results[c] for c in sorted(results) if len(results[c])]
    return np.concatenate(parts) if parts else np.zeros(0, OVLP_DTYPE)


def _ovl_columns(ovlps: np.ndarray, seen: set | None = None):
    """Vectorized shmr_dedup column computation (coordinate flips +
    first-occurrence rid-pair dedup); shared by the Python text
    formatter (oracle) and the native file writer."""
    y0 = ovlps["y0"]
    y1 = ovlps["y1"]
    rid0 = (y0 >> np.uint64(32)).astype(np.int64)
    rid1 = (y1 >> np.uint64(32)).astype(np.int64)
    ridp = np.where(rid0 < rid1, (rid0 << 32) | rid1, (rid1 << 32) | rid0)
    # keep the FIRST record of each rid pair, in input order
    _, first = np.unique(ridp, return_index=True)
    keep = np.zeros(len(ovlps), bool)
    keep[first] = True
    if seen is not None:
        kept_idx = np.flatnonzero(keep)
        for i in kept_idx:
            p = int(ridp[i])
            if p in seen:
                keep[i] = False
            else:
                seen.add(p)

    o = ovlps[keep]
    rid0, rid1 = rid0[keep], rid1[keep]
    pos0 = ((o["y0"] & _U32) >> np.uint64(1)).astype(np.int64) + 1
    pos1 = ((o["y1"] & _U32) >> np.uint64(1)).astype(np.int64) + 1
    rlen0 = o["rl0"].astype(np.int64)
    rlen1 = o["rl1"].astype(np.int64)
    strand0 = o["strand0"].astype(np.int64)
    strand1 = o["strand1"].astype(np.int64)
    q_bgn = o["q_bgn"].astype(np.int64) - o["t_bgn"].astype(np.int64)
    q_end = o["q_end"].astype(np.int64)
    t_end = o["t_end"].astype(np.int64)
    d = pos0 - pos1
    a_bgn = np.where(strand0 == 0, d + q_bgn, rlen0 - d - q_end)
    a_end = np.where(strand0 == 0, d + q_end, rlen0 - d - q_bgn)
    a_bgn = np.clip(a_bgn, 0, None)
    a_end = np.minimum(a_end, rlen0)
    # after the q_bgn shift the aligner t_bgn is 0, so the strand-1 flip's
    # b_end = rlen1 - t_bgn = rlen1 (src/shmr_dedup.c:59-90)
    b_bgn = np.clip(np.where(strand1 == 0, 0, rlen1 - t_end), 0, None)
    b_end = np.minimum(np.where(strand1 == 0, t_end, rlen1), rlen1)
    m_size = o["m_size"].astype(np.int64)
    dist = o["dist"].astype(np.int64)
    err_est = 100.0 - 100.0 * dist / m_size
    out_strand = np.where(strand0 == 0, strand1, 1 - strand1)
    return (rid0, rid1, -m_size, err_est, a_bgn, a_end, rlen0, out_strand,
            b_bgn, b_end, rlen1, np.ascontiguousarray(o["ovlp_type"]))


def ovlps_to_text(ovlps: np.ndarray, seen: set | None = None) -> list[str]:
    """Convert OVLP records to preads.ovl text rows with per-read forward-
    strand coordinates (shmr_dedup semantics, src/shmr_dedup.c:32-101).

    The coordinate flips and the first-occurrence rid-pair dedup are
    vectorized (the per-record Python loop cost ~16 us/record — ~11 s of
    the yeast-scale overlap stage).  This Python formatter remains the
    oracle; the pipeline writes the file natively via write_ovl_file
    (~30-44 s of f-string formatting + per-line writes at 250 Mb scale).
    """
    if len(ovlps) == 0:
        return []
    c = _ovl_columns(ovlps, seen)
    tnames = ("overlap", "contains", "contained")
    cols = tuple(a.tolist() for a in c)
    return [f"{r0:09d} {r1:09d} {nm} {e:0.1f} 0 {ab} {ae} {l0} {st} "
            f"{bb} {be} {l1} {tnames[tt]}"
            for r0, r1, nm, e, ab, ae, l0, st, bb, be, l1, tt in zip(*cols)]


def write_ovl_file(path: str, ovlps: np.ndarray, seen: set | None = None,
                   terminator: bool = True) -> int:
    """Write preads.ovl directly (native/write_ovl.cpp; byte-identical to
    '\\n'.join(ovlps_to_text(...)) + the '-' terminator).  Atomic
    (tmp + rename).  Returns the number of rows written."""
    import os

    from ..native import write_ovl_rows

    tmp = path + ".tmp"
    if len(ovlps) == 0:
        with open(tmp, "w") as f:
            if terminator:
                f.write("-\n")
        os.replace(tmp, path)
        return 0
    c = _ovl_columns(ovlps, seen)
    n = write_ovl_rows(tmp, *c, terminator=terminator)
    os.replace(tmp, path)
    return n


def overlap_chunk_device(db: SeqDB, idx: ShimmerIndex, cfg: AsmConfig,
                         device, chunk: int = 1, total_chunk: int = 1,
                         spec_window: int = 8, spec_per_pair: int = 1,
                         cand=None, seqdb_dev=None,
                         mesh=None) -> np.ndarray:
    """Overlap detection with device-batched alignment.

    Speculatively aligns, for every anchor, its next `spec_window`
    candidates on the device (ops.device_align.myers_batch_db, every
    in-cap request in one call), then replays the reference's sequential
    accept logic against the result cache; cache misses (rare: long skip
    runs) and requests longer than cfg.aln_max_len align natively in the
    replay.  The seqdb is uploaded to `device` unless seqdb_dev holds it.
    With cfg.shard_overlap and a mesh of several shards (--shard-overlap)
    the seqdb is split over the mesh instead and the requests go to their
    target read's shard (parallel.sharded_overlap), in calls sized by a
    device-memory budget per 8 kb length class; the result is the same.  A failed launch or exchange raises: there is no host fallback.
    """
    import logging

    from ..native import spec_enum

    log = logging.getLogger("peregrine_tpu_torch")
    with trace.span("overlap.pairs") as pairs_sp:
        key0, key1, y0a, y1a, dira = build_pairs(
            idx, db.lengths, chunk, total_chunk,
            cfg.mc_lower, cfg.mc_upper, cfg.min_anchor_dist, cand=cand)
        pairs_sp.attrs["entries"] = len(key0)

    # One request per RID PAIR at its first occurrence in replay order
    # (buckets in canonical order; anchors walk the descending-position
    # array tail-up, candidates forward) — mirroring the global rid-pair
    # dedup that lets the reference align each pair once
    # (src/shmr_overlap.c:101-107).  Self-read runs longer than the
    # window's slack make the replay miss the cache and align natively.
    with trace.span("overlap.stream") as enum_sp:
        sys_, sdirs, spos, sbs, sbe = bucket_stream(
            key0, key1, y0a, dira, cfg.ovlp_upper)
        reqs = spec_enum(sys_, sdirs, spos, sbs, sbe,
                         spec_window + 4, spec_per_pair)
        key_a, key_b = _req_keys(reqs)
        cols, mlen = _request_columns(db, reqs["rid0"], reqs["rid1"],
                                      reqs["pos0"], reqs["pos1"],
                                      reqs["strand0"], reqs["strand1"])
        got = np.flatnonzero(mlen <= cfg.aln_max_len)  # longer: native
    if cfg.shard_overlap and mesh is not None and mesh.n > 1:
        with trace.span("overlap.align", lanes=len(got)) as dev_sp:
            d, qe, te = _align_sharded(db, mesh, reqs["rid0"][got],
                                       reqs["rid1"][got], cols[got],
                                       mlen[got])
    else:
        if seqdb_dev is None:
            from .dbgather import upload_seqdb
            with trace.span("overlap.upload"):
                seqdb_dev = upload_seqdb(db.data, torch.device(device))
        with trace.span("overlap.align", lanes=len(got)) as dev_sp:
            launches = _launches()
            d, qe, te = _align_lanes(seqdb_dev, cols[got])
            dev_sp.attrs["launches"] = _launches() - launches

    # replay in C++ against the result cache; the device kernel reports
    # (dist, q_end, t_end) and _device_fill derives the other fields
    with trace.span("overlap.final") as final_sp:
        cvals = np.zeros((len(got), 8), np.int32)
        _device_fill(cvals, np.arange(len(got)), d, qe, te)
        order = np.lexsort((key_b[got], key_a[got]))
        result, misses, _ = overlap_chunk_native(
            db, idx, cfg, chunk, total_chunk,
            stream=(sys_, sdirs, spos, sbs, sbe),
            cache=(key_a[got][order], key_b[got][order], cvals[order]))
        final_sp.attrs["inline"] = misses
    log.info(
        "device overlap: %d cached alignments, %d native fallbacks "
        "(pairs %.1fs, enum %.1fs, device %.1fs, replay %.1fs)",
        len(got), misses, pairs_sp.seconds, enum_sp.seconds,
        dev_sp.seconds, final_sp.seconds)
    return result


# device bytes a sharded_align call may hold in packed windows, and its
# bytes a lane and window base: each lane's two windows at 3/8 of a byte
# a base, sent, received, gathered and laid out for the aligner
SHARDED_ALIGN_BYTES = 4 << 30
SHARDED_ALIGN_BYTES_PER_BASE = 4


def _align_sharded(db: SeqDB, mesh, rid0, rid1, cols: np.ndarray,
                   mlen: np.ndarray):
    """(dist, q_end, t_end) of request columns aligned over a mesh whose
    shards each hold a slice of the seqdb (parallel.sharded_overlap):
    windows of 8 kb length classes, as many lanes a call as
    SHARDED_ALIGN_BYTES holds (65,536 at L = 16 kb)."""
    from ..parallel.sharded_overlap import shard_seqdb, sharded_align
    sdb = shard_seqdb(db.data, db.offsets, db.lengths, mesh)
    pad_class = -(-mlen // 8192) * 8192
    out = np.zeros((len(cols), 3), np.int32)
    for pad in np.unique(pad_class):
        idxs = np.flatnonzero(pad_class == pad)
        lanes = max(mesh.n, SHARDED_ALIGN_BYTES
                    // (SHARDED_ALIGN_BYTES_PER_BASE * int(pad)))
        for i in range(0, len(idxs), lanes):
            part = idxs[i:i + lanes]
            c = cols[part]
            out[part] = np.stack(sharded_align(
                sdb, rid0[part], c[:, 0], c[:, 2], c[:, 3], rid1[part],
                c[:, 4], c[:, 5], c[:, 6], L=int(pad)), 1)
    return out[:, 0], out[:, 1], out[:, 2]
