"""FALCON-style alignment-tag-pileup consensus.

A copy of peregrine_tpu/ops/consensus.py (host numpy and the native
window core); the one change: consensus_windows runs each window under a
span (peregrine_tpu_torch.trace), whose attrs window_consensus's `times`
fills.

Re-implementation of the reference consensus core (falcon/falcon.c) and its
driver (py/scripts/pg_asm_cns.py): reads mapped to a draft contig are
aligned to ≤100 kb template windows; each alignment contributes per-column
tags (t_pos, delta, base) with predecessor links; the consensus is the
max-weight path through the implied partial-order graph, scored
count − 0.5·(coverage−1) per edge (falcon/falcon.c:143-209).

The pileup is dict-based on host for correctness; the batched dense-tensor
device version (scatter-add + scan DP) plugs in behind the same interface.
"""

from __future__ import annotations

import time

import numpy as np

from .. import trace
from ..config import AsmConfig
from ..io.seqdb import SeqDB, decode_biseq
from ..native import dw_align

_SENTINEL = (-1, 0, ord("."))


def get_align_tags(q_aln: bytes, t_aln: bytes, s1: int, s2: int,
                   t_offset: int = 0):
    """Alignment strings -> per-column tag list
    [(t_pos, delta, q_base, p_t_pos, p_delta, p_q_base)]
    (reference falcon/falcon.c:67-122)."""
    tags = []
    i = s1 - 1
    j = s2 - 1
    jj = 0
    p_j, p_jj, p_q = -1, 0, ord(".")
    dash = ord("-")
    for qb, tb in zip(q_aln, t_aln):
        if qb != dash:
            i += 1
            jj += 1
        if tb != dash:
            j += 1
            jj = 0
        if j + t_offset >= 0 and jj < 255 and p_jj < 255:
            tags.append((j + t_offset, jj, qb, p_j + t_offset, p_jj, p_q))
            p_j, p_jj, p_q = j, jj, qb
        else:
            break
    return tags


def cns_from_tags(tag_lists, t_len: int, min_cov: int) -> bytes:
    """Tag pileup -> consensus sequence (reference falcon/falcon.c:277-397).

    Edge counts accumulate per (ctag -> ptag); the DP walks ctags in
    ascending (t_pos, delta, base) key order so predecessors are final.
    """
    coverage = np.zeros(t_len + 1, np.int32)
    edge_count: dict[tuple, dict[tuple, int]] = {}

    for tags in tag_lists:
        started = False
        for t_pos, delta, q_base, p_t_pos, p_delta, p_q_base in tags:
            # skip leading deletion columns (reference falcon.c:304-310)
            if not started and p_q_base == ord("-"):
                continue
            started = True
            ctag = (t_pos, delta, q_base)
            ptag = (p_t_pos, p_delta, p_q_base)
            d = edge_count.setdefault(ctag, {})
            d[ptag] = d.get(ptag, 0) + 1
            if delta == 0:
                coverage[t_pos] += 1

    best_score: dict[tuple, float] = {}
    best_edge: dict[tuple, tuple] = {}
    global_best = 0.0
    global_best_node = None

    # predecessor order mirrors the reference's uint64 key sort, where the
    # sentinel (t_pos = -1) wraps to 0xFFFFFFFF and sorts last
    def _pkey(p):
        return (p[0] & 0xFFFFFFFF, p[1], p[2])

    for ctag in sorted(edge_count):
        t_pos = ctag[0]
        for ptag in sorted(edge_count[ctag], key=_pkey):
            count = edge_count[ctag][ptag]
            score = count - 0.5 * (coverage[t_pos] - 1)
            if ctag not in best_score:
                best_score[ctag] = score
                best_edge[ctag] = ptag
            if ptag[2] == ord("."):
                continue
            if ptag not in best_score:
                continue
            new_score = score + best_score[ptag]
            if new_score > best_score[ctag]:
                best_score[ctag] = new_score
                best_edge[ctag] = ptag
                if new_score > global_best:
                    global_best = new_score
                    global_best_node = ctag

    if global_best_node is None:
        return b""

    out = bytearray()
    node = global_best_node
    while True:
        t_pos, _, q_base = node
        if q_base != ord("-"):
            if coverage[t_pos] > min_cov:
                out.append(q_base)
            else:
                out.append(ord(chr(q_base).lower()))
        ptag = best_edge.get(node)
        if ptag is None or ptag[2] == ord("."):
            break
        node = ptag
    out.reverse()
    return bytes(out)


def _window_groups(mapped_rows: np.ndarray, ref_len: int,
                   grow: int = 50000, cap: int = 100000):
    """Split a contig's sorted mapping rows into consensus windows
    (reference pg_asm_cns.py:68-98).

    Returns [[left, right, ranges]] where ranges is a list of (start, end)
    index ranges into mapped_rows (the boundary row that closes a window
    belongs to no window — a reference quirk preserved here).  The row
    loop is replaced by searchsorted jumps over the sorted positions: a
    window boundary is the first row with p1 >= left + grow, exactly the
    loop's close condition; per-row Python iteration cost ~16 s at 3M
    rows."""
    p1s = mapped_rows[:, 1] if len(mapped_rows) else np.zeros(0, np.int64)
    groups = []
    left = 1000
    start = 0
    n = len(p1s)
    while start < n:
        b = int(np.searchsorted(p1s, left + grow, side="left"))
        if b >= n:
            break
        p1 = int(p1s[b])
        groups.append([left, p1, [(start, b)]] if p1 - left < cap
                      else [left, p1, []])
        left = p1
        start = b + 1
    tail = [(start, n)] if start < n else []
    if ref_len - left < cap:
        if ref_len - left > 1000:
            groups.append([left, ref_len, tail])
        elif groups:
            groups[-1][1] = ref_len
            groups[-1][2].extend(tail)
        else:
            groups.append([left, ref_len, tail])
    else:
        groups.append([left, ref_len, []])
    return groups


def plan_windows(ref_len_total: int, mapped_rows: np.ndarray,
                 grow: int = 50000, cap: int = 100000):
    """Contig mappings -> [(left, right, reads)] window specs with per-read
    (read_id, strand, shift) entries (reference pg_asm_cns.py:68-139)."""
    order = np.argsort(mapped_rows[:, 1], kind="stable")
    rows = mapped_rows[order]
    # column lists once (per-row numpy indexing dominated this planner)
    rid_l = rows[:, 3].tolist() if len(rows) else []
    off_l = (rows[:, 1] - rows[:, 4]).tolist() if len(rows) else []
    dir_l = rows[:, 6].tolist() if len(rows) else []
    specs = []
    for left, right, ranges in _window_groups(rows, ref_len_total, grow, cap):
        left = left - 1000
        assert left >= 0
        # multiple anchor offsets per (read, strand): keep distinct shifts
        rmap: dict[tuple[int, int], list[int]] = {}
        for s, e in ranges:
            for i in range(s, e):
                rmap.setdefault((rid_l[i], dir_l[i]), []).append(off_l[i])
        reads = []
        for (read_id, strand), offs in rmap.items():
            offs.sort()
            cur = offs[0]
            reads.append((read_id, strand, cur - left))
            for v in offs:
                if v > cur + 50:
                    cur = v
                    reads.append((read_id, strand, cur - left))
        reads.sort(key=lambda x: x[2])
        specs.append((left, right, reads))
    return specs


def window_consensus(read_db: SeqDB, ref_db: SeqDB, ctg_rid: int,
                     left: int, right: int, reads, cfg: AsmConfig,
                     use_native: bool = True, times: dict | None = None
                     ) -> bytes:
    """Consensus of one template window (reference pg_asm_cns.py:109-249).

    use_native routes the whole window (alignments + pileup + DP) through
    the C++ core (native/consensus.cpp); the Python path below is the
    semantic reference used for cross-checking.  With use_native, `times`
    takes the seconds of the Python decode (decode_s) and of the native
    call (native_s)."""
    t0 = time.perf_counter()
    ref_len = right - left
    ref_seq = decode_biseq(ref_db.packed(ctg_rid)[left:left + ref_len], 0)

    if use_native:
        from ..native import window_cns
        read_seqs = [decode_biseq(read_db.packed(rid), strand)
                     for rid, strand, _ in reads]
        shifts = [shift for _, _, shift in reads]
        t1 = time.perf_counter()
        out = window_cns(ref_seq, read_seqs, shifts,
                         cfg.cns_aln_band, cfg.cns_min_cov)
        if times is not None:
            times.update(decode_s=t1 - t0,
                         native_s=time.perf_counter() - t1)
        return out

    # backbone self-alignment anchors the template
    # (reference pg_asm_cns.py:152-166)
    aln = dw_align(ref_seq, ref_seq, 50)
    tag_lists = [get_align_tags(aln.q_aln_str, aln.t_aln_str,
                                aln.aln_q_s, aln.aln_t_s, 0)]
    aln_base = 0
    for read_id, strand, shift in reads:
        read_seq = decode_biseq(read_db.packed(read_id), strand)
        read_len = len(read_seq)
        if shift < 0:
            aln = dw_align(read_seq[-shift:], ref_seq, cfg.cns_aln_band)
            if abs(abs(aln.aln_q_e - aln.aln_q_s) - (read_len + shift)) < 48:
                tag_lists.append(get_align_tags(
                    aln.q_aln_str, aln.t_aln_str,
                    aln.aln_q_s, aln.aln_t_s, 0))
                aln_base += abs(aln.aln_t_e - aln.aln_t_s)
        else:
            aln = dw_align(read_seq, ref_seq[shift:], cfg.cns_aln_band)
            if (abs(abs(aln.aln_q_e - aln.aln_q_s) - read_len) < 48
                    or abs(ref_len - shift - abs(aln.aln_q_e - aln.aln_q_s)) < 48):
                tag_lists.append(get_align_tags(
                    aln.q_aln_str, aln.t_aln_str,
                    aln.aln_q_s, aln.aln_t_s, shift))
                aln_base += abs(aln.aln_t_e - aln.aln_t_s)

    if aln_base / max(ref_len, 1) < 3:
        return ref_seq.lower()
    return cns_from_tags(tag_lists, len(ref_seq), cfg.cns_min_cov)


def stitch_segments(segments: list[bytes]) -> bytes:
    """Splice window segments by aligning tail/head overhangs
    (reference pg_asm_cns.py:251-271)."""
    s0 = segments[0]
    stitched = [s0]
    for s1 in segments[1:]:
        aln = dw_align(s0[-1000:], s1[:1050], 400, get_aln_str=False)
        if aln.aln_q_e < 1000:
            stitched[-1] = stitched[-1][:-(1000 - aln.aln_q_e)]
        stitched.append(s1[aln.aln_t_e:])
        s0 = s1
    return b"".join(stitched)


_worker_dbs: dict[str, SeqDB] = {}


def _window_worker(read_prefix: str, ref_prefix: str, ctg_rid: int,
                   left: int, right: int, reads, cfg_json: str) -> bytes:
    """Worker computing one window (dbs cached per process/module)."""
    for p in (read_prefix, ref_prefix):
        if p not in _worker_dbs:
            _worker_dbs[p] = SeqDB.open(p)
    return window_consensus(_worker_dbs[read_prefix], _worker_dbs[ref_prefix],
                            ctg_rid, left, right, reads,
                            AsmConfig.from_json(cfg_json))


def consensus_for_contig(read_db: SeqDB, ref_db: SeqDB, ctg_rid: int,
                         mapped_rows: np.ndarray, cfg: AsmConfig) -> bytes:
    """Polish one contig from its read mappings
    (reference pg_asm_cns.py:68-273)."""
    specs = plan_windows(int(ref_db.lengths[ctg_rid]), mapped_rows,
                         cfg.cns_window, cfg.cns_max_template)
    segments = [window_consensus(read_db, ref_db, ctg_rid, l, r, reads, cfg)
                for l, r, reads in specs]
    return stitch_segments(segments)


def plan_all(contig_rows: dict[int, np.ndarray], ref_lengths: np.ndarray,
             cfg: AsmConfig) -> dict[int, list]:
    """Window plans for every contig — a pure function of the mapping
    rows, so every multi-host rank derives the identical plan (and
    therefore the identical deterministic job order) independently."""
    return {rid: plan_windows(int(ref_lengths[rid]), rows,
                              cfg.cns_window, cfg.cns_max_template)
            for rid, rows in contig_rows.items()}


def consensus_windows(read_db: SeqDB, ref_db: SeqDB, plans: dict[int, list],
                      cfg: AsmConfig, n_workers: int,
                      shard: tuple[int, int] | None = None
                      ) -> dict[tuple[int, int], bytes]:
    """Compute window consensus segments for (a shard of) the planned
    windows; returns {(ctg_rid, window_i): segment}.

    With shard=(rank, nranks) only jobs with job_index % nranks == rank
    are computed — the reference's own distribution scheme one grain
    finer (pg_asm_cns.py:59 shards whole contigs by ctg_id %
    total_chunks; windows balance better when contig sizes skew).

    Spans: consensus.windows (attrs windows, workers) over the pool, and
    one consensus.window under it a window, in its worker thread (attrs
    reads, decode_s, native_s)."""
    import concurrent.futures as cf

    jobs = [(rid, i, spec) for rid, specs in plans.items()
            for i, spec in enumerate(specs)]
    if shard is not None:
        rank, nranks = shard
        jobs = jobs[rank::nranks]
    results: dict[tuple[int, int], bytes] = {}
    n_workers = max(1, n_workers)

    def window(parent, rid, spec):
        with trace.span("consensus.window", parent=parent,
                        reads=len(spec[2])) as sp:
            return window_consensus(read_db, ref_db, rid, spec[0], spec[1],
                                    spec[2], cfg, times=sp.attrs)

    with trace.span("consensus.windows", windows=len(jobs),
                    workers=n_workers) as sp, \
            cf.ThreadPoolExecutor(max_workers=n_workers) as ex:
        futs = {ex.submit(window, sp, rid, spec): (rid, i)
                for rid, i, spec in jobs}
        for f in cf.as_completed(futs):
            results[futs[f]] = f.result()
    return results


def stitch_all(plans: dict[int, list],
               results: dict[tuple[int, int], bytes]) -> dict[int, bytes]:
    """Stitch per-window segments into final per-contig sequences
    (serial per contig, same as the reference's in-chunk stitch)."""
    out = {}
    for rid, specs in plans.items():
        segs = [results[(rid, i)] for i in range(len(specs))]
        out[rid] = stitch_segments(segs) if segs else b""
    return out


def consensus_parallel(read_prefix: str, ref_prefix: str,
                       contig_rows: dict[int, np.ndarray],
                       ref_lengths: np.ndarray, cfg: AsmConfig,
                       n_workers: int) -> dict[int, bytes]:
    """Window-parallel consensus over all contigs: windows are independent
    (the reference runs whole contigs per process; windows are the finer
    grain), stitching is serial per contig.

    Workers are THREADS sharing the mmap'd dbs: the window core is one
    ctypes call into native/consensus.cpp, which releases the GIL for the
    whole alignment+pileup+DP, so threads scale like processes without
    the ~2 s/worker spawn+preload tax or per-window pickling."""
    read_db = SeqDB.open(read_prefix)
    ref_db = SeqDB.open(ref_prefix)
    plans = plan_all(contig_rows, ref_lengths, cfg)
    results = consensus_windows(read_db, ref_db, plans, cfg, n_workers)
    return stitch_all(plans, results)
