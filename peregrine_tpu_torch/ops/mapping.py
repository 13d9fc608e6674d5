"""Read-to-reference SHIMMER mapping (reference src/shmr_map.c).

A copy of peregrine_tpu/ops/mapping.py (host numpy); the changes: the
logger's name, and the pair map's rebuild runs under the span
mapping.pairs (peregrine_tpu_torch.trace; attr entries), whose seconds
its log line gives.

Builds the oriented pair map over the *read* index (sorted arrays, see
ops/overlap.py), then walks the *reference* SHIMMER list: every adjacent
eligible reference pair present in the map emits its stored read-pair hits
as mapping records ``(ref_id, ref_bgn, ref_end, read_id, read_bgn,
read_end, direction, mc0, mc1)`` — the input of the consensus stage.

The reference walks the list one SHIMMER at a time with khash probes
(src/shmr_map.c:93-157).  Here the walk is fully vectorized: the anchor
pointer only ever advances at positions whose minimizer count passes the
gates, so the candidate anchor pairs are exactly consecutive elements of
``[first_hit] + [i : count_valid(i)]``; bucket membership is one
searchsorted over a composite (mmer0, mmer1) key instead of a dict probe
per step (VERDICT r1 weak #3 — the last scalar hot loop in the pipeline).
"""

from __future__ import annotations

import numpy as np

from .. import trace
from ..config import AsmConfig
from .index import ShimmerIndex
from .overlap import build_pairs

_U32 = np.uint64(0xFFFFFFFF)


def _empty() -> np.ndarray:
    return np.zeros((0, 9), np.int64)


def map_reads_to_ref(read_idx: ShimmerIndex, read_lengths: np.ndarray,
                     ref_idx: ShimmerIndex, cfg: AsmConfig,
                     chunk: int = 1, total_chunk: int = 1,
                     pairs=None) -> np.ndarray:
    """Returns an int64 array [n, 9] of mapping rows (printf order,
    src/shmr_map.c:153).

    pairs: an unchunked build_pairs result to reuse (the overlap stage
    computes the identical pair map — ~41 s at Drosophila scale); only
    honored for chunk == total_chunk == 1."""
    m = _matched_buckets(read_idx, read_lengths, ref_idx, cfg,
                         chunk, total_chunk, pairs)
    if m is None:
        return _empty()
    km0, ki, kb, bstart, bend, ry_rid, ry_pos, c_int, y0a, y1a, dira = m

    # emit every stored read-pair hit of each matched bucket
    sizes = bend[kb] - bstart[kb]
    total = int(sizes.sum())
    rep = np.repeat(np.arange(len(kb)), sizes)
    within = np.arange(total) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    j = bstart[kb][rep] + within
    rows = np.empty((total, 9), np.int64)
    _fill_rows(rows, rep, j, km0, ki, ry_rid, ry_pos, y0a, y1a, dira, c_int)
    return rows


def map_reads_to_ref_grouped(read_idx: ShimmerIndex,
                             read_lengths: np.ndarray,
                             ref_idx: ShimmerIndex, cfg: AsmConfig,
                             path: str, n_ctg: int, pairs=None,
                             chunk_rows: int = 1 << 22):
    """External (disk-backed) mapping emission, GROUPED by contig.

    The reference bounds this stage's memory with a disk sort of the
    text dump (`sort -T tmp -S 8g` over reads2ref,
    py/scripts/pg_run.py:491-496).  This equivalent skips the
    text round-trip: matched buckets already carry their contig rid, so
    per-contig destinations are computed analytically (bincount +
    groupwise cumsum over BUCKETS, which are ~100x fewer than rows) and
    rows are emitted in O(chunk_rows) anonymous slabs straight into
    their final grouped position in a [total, 9] int64 .npy memmap.
    One sequential write pass, no merge pass, page-cache-governed.

    Per-contig row ORDER equals the in-memory path's boolean-mask
    grouping (walk order within each contig), so consensus output is
    byte-identical (tests/test_mapping.py).

    Returns (memmap[total, 9], offsets[n_ctg + 1]): contig r's rows are
    mm[offsets[r]:offsets[r + 1]]."""
    m = _matched_buckets(read_idx, read_lengths, ref_idx, cfg, 1, 1, pairs)
    if m is None:
        mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.int64,
                                       shape=(0, 9))
        return mm, np.zeros(n_ctg + 1, np.int64)
    km0, ki, kb, bstart, bend, ry_rid, ry_pos, c_int, y0a, y1a, dira = m

    sizes = (bend[kb] - bstart[kb]).astype(np.int64)
    total = int(sizes.sum())
    r_b = ry_rid[km0]                       # contig rid per matched bucket
    counts = np.zeros(n_ctg, np.int64)
    np.add.at(counts, r_b, sizes)
    offsets = np.zeros(n_ctg + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])

    # destination start of each bucket's row run: contig base + exclusive
    # cumsum of sizes within its contig group (stable sort keeps walk
    # order inside each group)
    order = np.argsort(r_b, kind="stable")
    so = sizes[order]
    cso = np.cumsum(so) - so
    rb_o = r_b[order]
    grp_first = np.empty(len(rb_o), bool)
    grp_first[0] = True
    np.not_equal(rb_o[1:], rb_o[:-1], out=grp_first[1:])
    base = cso[grp_first][np.cumsum(grp_first) - 1]
    dest_start = np.empty(len(kb), np.int64)
    dest_start[order] = offsets[rb_o] + (cso - base)

    mm = np.lib.format.open_memmap(path, mode="w+", dtype=np.int64,
                                   shape=(total, 9))
    csizes = np.cumsum(sizes)
    start_b = 0
    while start_b < len(kb):
        lo = int(csizes[start_b] - sizes[start_b])
        end_b = int(np.searchsorted(csizes, lo + chunk_rows)) + 1
        end_b = min(end_b, len(kb))
        sl = slice(start_b, end_b)
        ssl = sizes[sl]
        ctotal = int(ssl.sum())
        rep = np.repeat(np.arange(end_b - start_b), ssl)
        within = np.arange(ctotal) - np.repeat(np.cumsum(ssl) - ssl, ssl)
        j = bstart[kb[sl]][rep] + within
        tmp = np.empty((ctotal, 9), np.int64)
        _fill_rows(tmp, rep, j, km0[sl], ki[sl], ry_rid, ry_pos,
                   y0a, y1a, dira, c_int)
        mm[dest_start[sl][rep] + within] = tmp
        start_b = end_b
    return mm, offsets


def _matched_buckets(read_idx: ShimmerIndex, read_lengths: np.ndarray,
                     ref_idx: ShimmerIndex, cfg: AsmConfig,
                     chunk: int = 1, total_chunk: int = 1,
                     pairs=None):
    """Shared matching phase: pair-map bucket table + vectorized
    reference-SHIMMER walk.  Returns None when nothing matches, else
    (km0, ki, kb, bstart, bend, ry_rid, ry_pos, c_int, y0a, y1a, dira)
    where (km0, ki, kb) index the matched anchor pairs / buckets."""
    if pairs is not None and chunk == 1 and total_chunk == 1:
        key0, key1, y0a, y1a, dira = pairs
    else:
        # Low-memory mode (run.py frees the stage-2 map before this stage
        # rebuilds it) must not reintroduce the ~33 B/entry map as anon RSS:
        # spill the rebuild exactly like the stage-2 build does.
        import logging
        with trace.span("mapping.pairs") as sp:
            key0, key1, y0a, y1a, dira = build_pairs(
                read_idx, read_lengths, chunk, total_chunk,
                cfg.mc_lower, cfg.mc_upper, cfg.min_anchor_dist,
                spill_dir=cfg.spill_dir)
            sp.attrs["entries"] = len(key0)
        logging.getLogger("peregrine_tpu_torch").info(
            "mapping: pair map rebuilt (%.1fs, %d entries%s)",
            sp.seconds, len(key0),
            ", spilled" if cfg.spill_dir else "")

    rx, ry = ref_idx.x, ref_idx.y
    n = len(rx)
    if n == 0 or len(key0) == 0:
        return None

    # bucket table: (key0, key1) is lex-sorted, so buckets are runs
    change = np.flatnonzero((key0[1:] != key0[:-1])
                            | (key1[1:] != key1[:-1])) + 1
    bstart = np.concatenate([[0], change]).astype(np.int64)
    bend = np.concatenate([change, [len(key0)]]).astype(np.int64)
    bk0, bk1 = key0[bstart], key1[bstart]

    # dense ids -> one sortable composite key per bucket (dict replacement)
    uniq0 = np.unique(bk0)
    uniq1 = np.unique(bk1)
    K = np.int64(len(uniq1) + 1)
    # bk0 nondecreasing and bk1 strictly increasing within equal bk0 in lex
    # order, so the composite is strictly increasing (searchsorted-ready)
    bcomp = (np.searchsorted(uniq0, bk0).astype(np.int64) * K
             + np.searchsorted(uniq1, bk1).astype(np.int64))

    # first reference SHIMMER whose x leads any bucket (the reference skips
    # until the first kh_get(MMER0) hit regardless of count bounds)
    p0 = np.searchsorted(uniq0, rx)
    present0 = (p0 < len(uniq0)) & (uniq0[np.minimum(p0, len(uniq0) - 1)] == rx)
    if not present0.any():
        return None
    s = int(np.argmax(present0))

    counts = read_idx.counts_for(rx >> np.uint64(8))
    c_int = counts.astype(np.int64)
    # c == 0 means the hash is absent from the read index (the reference
    # skips on kh_get miss regardless of the bounds)
    valid = (c_int != 0) & (c_int >= cfg.mc_lower) & (c_int <= cfg.mc_upper)
    vi = np.flatnonzero(valid[s + 1:]) + s + 1
    if len(vi) == 0:
        return None
    # the anchor pointer m0 advances exactly at valid positions (and starts
    # at s), so candidate pairs are consecutive elements of [s] + vi
    m0s = np.concatenate([[s], vi[:-1]])
    iis = vi

    ry_rid = (ry >> np.uint64(32)).astype(np.int64)
    ry_pos = ((ry & _U32) >> np.uint64(1)).astype(np.int64)

    same_rid = ry_rid[m0s] == ry_rid[iis]
    dist_ok = (((ry_pos[iis] & 0xFFFFFFF) - (ry_pos[m0s] & 0xFFFFFFF))
               % (1 << 28)) >= cfg.min_anchor_dist

    # vectorized bucket probe on the composite key
    i0 = np.searchsorted(uniq0, rx[m0s])
    ok0 = (i0 < len(uniq0)) & (uniq0[np.minimum(i0, len(uniq0) - 1)] == rx[m0s])
    i1 = np.searchsorted(uniq1, rx[iis])
    ok1 = (i1 < len(uniq1)) & (uniq1[np.minimum(i1, len(uniq1) - 1)] == rx[iis])
    qcomp = i0.astype(np.int64) * K + i1.astype(np.int64)
    bpos = np.searchsorted(bcomp, qcomp)
    bposc = np.minimum(bpos, len(bcomp) - 1)
    hit = ok0 & ok1 & (bcomp[bposc] == qcomp)

    keep = same_rid & dist_ok & hit
    if not keep.any():
        return None
    km0, ki, kb = m0s[keep], iis[keep], bposc[keep]
    return km0, ki, kb, bstart, bend, ry_rid, ry_pos, c_int, y0a, y1a, dira


def _fill_rows(rows, rep, j, km0, ki, ry_rid, ry_pos, y0a, y1a, dira,
               c_int) -> None:
    """Emit mapping rows (printf column order, src/shmr_map.c:153) for
    the bucket-expanded (rep, j) selection into a preallocated [n, 9]
    target (an anonymous array or a slice of a grouped memmap)."""
    rows[:, 0] = ry_rid[km0][rep]
    rows[:, 1] = ry_pos[km0][rep]
    rows[:, 2] = ry_pos[ki][rep]
    rows[:, 3] = (y0a[j] >> np.uint64(32)).astype(np.int64)
    rows[:, 4] = ((y0a[j] & _U32) >> np.uint64(1)).astype(np.int64)
    rows[:, 5] = ((y1a[j] & _U32) >> np.uint64(1)).astype(np.int64)
    rows[:, 6] = dira[j].astype(np.int64)
    rows[:, 7] = c_int[km0][rep]
    rows[:, 8] = c_int[ki][rep]
