"""Overlap detection: SHIMMER pair map + bucketed alignment confirmation.

The host half of peregrine_tpu/ops/overlap.py, copied with its imports
changed: pair map, bucket stream, overlap_all, overlap_all_spec with the
host backend, and the preads.ovl writer.  The device aligner backends
raise NotImplementedError until they are ported (ROADMAP queue 1).

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

import numpy as np

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
    miss fallback.  Returns (records, n_cache_misses).  stream may pass a
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
    raw, n, miss = overlap_replay(
        ys, dirs, pos, bs, be, db.data, db.offsets, db.lengths,
        cfg.best_n_ovlp, cfg.read_end_fuzz, cfg.min_ovlp_aln, cfg.aln_bw,
        *cache)
    recs = (np.frombuffer(raw, dtype=OVLP_DTYPE).copy() if n
            else np.zeros(0, OVLP_DTYPE))
    return recs, miss


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


_DEVICE_ALIGNER = ("the device aligner is not yet ported to peregrine_tpu_torch "
                   "(ROADMAP queue 1, flag paths: --device-aligner, "
                   "--hybrid-overlap, --shard-overlap)")


def overlap_all_spec(db: SeqDB, idx: ShimmerIndex, cfg: AsmConfig,
                     n_workers: int | None = None, window: int = 0,
                     per_pair: int = 1, pairs=None,
                     max_rounds: int = 8, backend: str = "host",
                     seqdb_dev=None, shard: tuple[int, int] | None = None,
                     exchange=None, run_final: bool = True) -> np.ndarray:
    """Globally-deduplicated parallel overlap detection.

    The scaling scheme that replaces hash chunking: discover the accept
    loop's alignment points by ITERATION — a collect-mode replay walks the
    exact sequential accept semantics but, on a cache miss, records the
    request and optimistically assumes an accepted OVERLAP (the majority
    outcome); the collected requests are aligned on all host cores (native
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
    exact pass's native aligner.

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
    import time as _t

    from ..native import spec_enum

    log2 = logging.getLogger("peregrine_tpu_torch")
    if backend != "host":
        raise NotImplementedError(_DEVICE_ALIGNER)
    if shard is not None and window > 0:
        raise ValueError("shard=(rank, nranks) requires backend='host' "
                         "and window=0")
    if n_workers is None:
        n_workers = _os.cpu_count() or 1
    _t0 = _t.time()
    key0, key1, y0a, y1a, dira = pairs if pairs is not None else build_pairs(
        idx, db.lengths, 1, 1,
        cfg.mc_lower, cfg.mc_upper, cfg.min_anchor_dist,
        spill_dir=cfg.spill_dir)
    _t1 = _t.time()
    stream = bucket_stream(key0, key1, y0a, dira, cfg.ovlp_upper,
                           spill_dir=cfg.spill_dir)
    log2.info("overlap dedup: pair map %.1fs (%d entries)%s + stream %.1fs",
              _t1 - _t0, len(key0), " [shared]" if pairs is not None else "",
              _t.time() - _t1)
    if pairs is None:
        # the replay stream fully replaces the pair map from here on;
        # freeing the five columns now (not at function exit) drops
        # ~33 B/entry of anonymous-or-spill footprint (~11 GB at the
        # human-class rung) before the alignment rounds allocate theirs
        del key0, key1, y0a, y1a, dira
    sys_, sdirs, spos, sbs, sbe = stream
    db_data = np.ascontiguousarray(db.data, np.uint8) \
        if not db.data.flags.c_contiguous else db.data

    def align_round(rr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        return (_align_parallel(rr, db, db_data, cfg.aln_bw, n_workers),
                np.ones(len(rr), bool))

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
        reqs = spec_enum(sys_, sdirs, spos, sbs, sbe, window, per_pair)
        rres, rhave = align_round(reqs)
        merge(reqs, rres, rhave)
        if not rhave.all():
            pka, pkb = _req_keys(reqs)
            failed.update(zip(pka[~rhave].tolist(), pkb[~rhave].tolist()))
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
        if backend == "host":
            _tr = _t.time()
            cap = int(min(cap0, max(prev_miss, 1 << 16)))
            miss, missreqs, rres, mine = _collect_align_streaming(
                db, cfg, stream, arena.view(), db_data, n_workers, cap,
                shard=shard)
            if miss == 0:
                break
            _ta = _t.time()
            my_aligned += int(mine.sum())
            if exchange is not None:
                rres = exchange(rnd, missreqs, rres, mine)
            rhave = np.ones(len(missreqs), bool)
            merge(missreqs, rres, rhave)
            total_aligned += len(missreqs)
            prev_miss = miss
            log2.info("overlap dedup round %d: %d misses harvested "
                      "(streamed, %.1fs + merge %.1fs)", rnd + 1, miss,
                      _ta - _tr, _t.time() - _ta)
            if miss < max(5000, total_aligned // 50):
                # the next collect pass would cost a full replay wall
                # (~13 s at Drosophila scale) to find a yet-smaller tail
                # the final pass can align inline — stop iterating
                break
            continue
        _, _, miss, missreqs = _replay(db, cfg, stream, arena.view(),
                                       db_data, collect=True)
        if miss == 0:
            break
        if rnd > 0 and miss < max(5000, total_aligned // 50):
            # tail harvests cost a full replay pass each (~13 s at
            # Drosophila scale) to collect work the final pass can align
            # inline in a fraction of that — stop iterating
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
        merge(missreqs, rres, rhave)
        if not rhave.all():
            mka, mkb = _req_keys(missreqs)
            failed.update(zip(mka[~rhave].tolist(), mkb[~rhave].tolist()))
        total_aligned += int(rhave.sum())
        log2.info("overlap dedup round %d: %d misses harvested", rnd + 1,
                  len(missreqs))

    if shard is not None:
        log2.info("overlap dedup rank share: %d of %d round alignments",
                  my_aligned, total_aligned)
    if not run_final:
        return None
    _tf = _t.time()
    recs, miss = overlap_chunk_native(db, idx, cfg, stream=stream[:5],
                                      cache=arena.view())
    total_aligned += miss
    log2.info("overlap dedup [%s]: %d alignments total on %d workers "
              "(%d inline in the final pass, %.1fs)", backend,
              total_aligned, n_workers, miss, _t.time() - _tf)
    return recs


def _collect_align_streaming(db: SeqDB, cfg: AsmConfig, stream, cache,
                             db_data, n_workers: int, cap: int,
                             shard: tuple[int, int] | None = None):
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

    Returns (n_miss, requests, results[n, 8], mine) where `mine` marks
    the rows this rank aligned (all True without shard)."""
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
            out["r"] = overlap_replay(
                sys_, sdirs, spos, sbs, sbe, db_data, db.offsets,
                db.lengths, cfg.best_n_ovlp, cfg.read_end_fuzz,
                cfg.min_ovlp_aln, cfg.aln_bw, *cache, collect_misses=True,
                stream_buf=buf, stream_progress=prog)
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

    def aligner():
        while True:
            with lock:
                # read the progress counter under the lock: the mutex
                # acquire is the acquire barrier pairing the C++ side's
                # release store on weakly-ordered CPUs (plain loads are
                # only safe on x86-TSO)
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
            if hi > lo:
                align_spec(buf, lo, hi, db_data, db.offsets, db.lengths,
                           cfg.aln_bw, res)
                continue
            if fin and lo >= int(prog[0]):
                break
            _time.sleep(0.002)

    threads = [threading.Thread(target=run_replay)]
    threads += [threading.Thread(target=aligner) for _ in range(n_workers)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if "err" in out:
        raise out["err"]
    _, _, n_miss, overflow = out["r"]
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
        ores = _align_parallel(overflow, db, db_data, cfg.aln_bw,
                               n_workers, slices=oslices)
        reqs = np.concatenate([reqs, overflow])
        rres = np.concatenate([rres, ores])
    return n_miss, reqs, rres, mine


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


def overlap_all_hybrid(*args, **kwargs):
    raise NotImplementedError(_DEVICE_ALIGNER)


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


def overlap_chunk_device(*args, **kwargs):
    raise NotImplementedError(_DEVICE_ALIGNER)
