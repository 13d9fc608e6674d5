"""Native host runtime: ctypes bindings to the C++ alignment kernels.

A copy of peregrine_tpu/native/__init__.py with one change: the C++
sources are read by path from the JAX package (they are compiled, never
imported), and the shared object is built on first use into
peregrine_tpu_torch/build/ (see _build.build_shared), so this package
neither imports the JAX package nor writes into it.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .._build import build_shared

_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "peregrine_tpu", "native")
_SRC = [os.path.join(_DIR, "dw_align.cpp"),
        os.path.join(_DIR, "consensus.cpp"),
        os.path.join(_DIR, "overlap_replay.cpp"),
        os.path.join(_DIR, "spec_enum.cpp"),
        os.path.join(_DIR, "pack2.cpp"),
        os.path.join(_DIR, "parse_ovl.cpp"),
        os.path.join(_DIR, "encode.cpp"),
        os.path.join(_DIR, "sort_pairs.cpp"),
        os.path.join(_DIR, "build_pairs.cpp"),
        os.path.join(_DIR, "sg_passes.cpp"),
        os.path.join(_DIR, "write_ovl.cpp"),
        os.path.join(_DIR, "fastx.cpp")]


def _bytes_at(ptr: int | None, nbytes: int) -> bytes:
    """64-bit-safe ctypes.string_at.

    The stdlib helper's size parameter is a C *int*: any native payload
    >= 2 GiB wraps negative and raises SystemError (first hit at the
    human-class 3 Gb rung, where one replay pass returns a ~6.5 GB
    record block; the 1 Gb rung passed 2.1 GB — under the wrap by 2%).
    A c_char-array view carries a Py_ssize_t length instead."""
    if not ptr or nbytes <= 0:
        return b""
    return bytes((ctypes.c_char * nbytes).from_address(ptr))


def _load() -> ctypes.CDLL:
    so = build_shared("pgnative", _SRC,
                      ["g++", "-O3", "-march=native", "-shared", "-fPIC"],
                      libs=["-lz"])
    return ctypes.CDLL(so)


class OvlpMatch(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int32) for n in
                ("m_size", "dist", "q_bgn", "q_end", "t_bgn", "t_end",
                 "t_m_end", "q_m_end")]


class _Alignment(ctypes.Structure):
    _fields_ = [("aln_str_size", ctypes.c_int32), ("dist", ctypes.c_int32),
                ("aln_q_s", ctypes.c_int32), ("aln_q_e", ctypes.c_int32),
                ("aln_t_s", ctypes.c_int32), ("aln_t_e", ctypes.c_int32),
                ("q_aln_str", ctypes.c_void_p), ("t_aln_str", ctypes.c_void_p)]


_lib = _load()
_lib.ovlp_match_c.argtypes = [
    ctypes.c_char_p, ctypes.c_int32, ctypes.c_uint8,
    ctypes.c_char_p, ctypes.c_int32, ctypes.c_uint8,
    ctypes.c_int32, ctypes.POINTER(OvlpMatch)]
_lib.dw_align_c.argtypes = [
    ctypes.c_char_p, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int32,
    ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(_Alignment)]
_lib.free_alignment_c.argtypes = [ctypes.POINTER(_Alignment)]


def ovlp_match(query: bytes | np.ndarray, q_strand: int,
               target: bytes | np.ndarray, t_strand: int,
               band_tolerance: int) -> OvlpMatch:
    """Overlap-confirm alignment on 4-bit packed sequences.

    Semantics mirror the reference overlap aligner (src/DWmatch.c:66-204);
    strand selects the nibble (0 = forward low nibble, 1 = complement high).
    """
    qb = bytes(query) if not isinstance(query, bytes) else query
    tb = bytes(target) if not isinstance(target, bytes) else target
    out = OvlpMatch()
    _lib.ovlp_match_c(qb, len(qb), q_strand, tb, len(tb), t_strand,
                      band_tolerance, ctypes.byref(out))
    return out


class DwAlignment:
    """Gapped alignment result with explicit alignment strings."""

    __slots__ = ("aln_str_size", "dist", "aln_q_s", "aln_q_e", "aln_t_s",
                 "aln_t_e", "q_aln_str", "t_aln_str")

    def __init__(self, a: _Alignment):
        self.aln_str_size = a.aln_str_size
        self.dist = a.dist
        self.aln_q_s = a.aln_q_s
        self.aln_q_e = a.aln_q_e
        self.aln_t_s = a.aln_t_s
        self.aln_t_e = a.aln_t_e
        n = a.aln_str_size
        self.q_aln_str = ctypes.string_at(a.q_aln_str, n) if a.q_aln_str else b""
        self.t_aln_str = ctypes.string_at(a.t_aln_str, n) if a.t_aln_str else b""


class _CnsResult(ctypes.Structure):
    _fields_ = [("seq", ctypes.c_void_p), ("len", ctypes.c_int32)]


_lib.window_cns_c.argtypes = [
    ctypes.c_char_p, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int32),
    ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
    ctypes.c_int32, ctypes.c_int32, ctypes.POINTER(_CnsResult)]
_lib.free_cns_c.argtypes = [ctypes.POINTER(_CnsResult)]


def window_cns(ref_seq: bytes, read_seqs: list[bytes], shifts: list[int],
               band: int, min_cov: int) -> bytes:
    """Native consensus of one template window (backbone + read alignments
    + tag pileup + max-weight path; semantics of falcon/falcon.c via
    ops/consensus.py)."""
    n = len(read_seqs)
    arr = (ctypes.c_char_p * n)(*read_seqs)
    lens = (ctypes.c_int32 * n)(*[len(s) for s in read_seqs])
    sh = (ctypes.c_int32 * n)(*shifts)
    out = _CnsResult()
    _lib.window_cns_c(ref_seq, len(ref_seq), arr, lens, sh, n,
                      band, min_cov, ctypes.byref(out))
    try:
        return ctypes.string_at(out.seq, out.len) if out.seq else b""
    finally:
        _lib.free_cns_c(ctypes.byref(out))


_REC_SIZE = 59  # sizeof(OvlpRec) packed == OVLP_DTYPE.itemsize

_i64p = ctypes.POINTER(ctypes.c_int64)
_lib.overlap_replay_c.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # ys, dirs, pos
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,    # bstart, bend, nb
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # db, offsets, lens
    ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # ck_a, ck_b, cvals
    ctypes.c_int64,                                      # n_cache
    ctypes.POINTER(ctypes.c_void_p), _i64p, _i64p,
    ctypes.POINTER(ctypes.c_void_p),                     # miss_reqs|NULL
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]    # stream buf/cap/prog
_lib.free_ovlp_recs_c.argtypes = [ctypes.POINTER(ctypes.c_void_p)]
_lib.free_spec_reqs2_c.argtypes = [ctypes.POINTER(ctypes.c_void_p)]


def overlap_replay(ys: np.ndarray, dirs: np.ndarray, pos: np.ndarray,
                   bstart: np.ndarray, bend: np.ndarray,
                   db_data: np.ndarray, offsets: np.ndarray,
                   lengths: np.ndarray, bestn: int, fuzz: int, min_aln: int,
                   band: int, ck_a: np.ndarray, ck_b: np.ndarray,
                   cvals: np.ndarray, collect_misses: bool = False,
                   stream_buf: np.ndarray | None = None,
                   stream_progress: np.ndarray | None = None):
    """Native sequential overlap accept loop (overlap_replay.cpp); returns
    (raw record bytes, n_records, n_cache_misses[, miss_requests]).
    cvals is an int32 [n, 8] matrix of cached alignment results in
    OvlpMatch field order (m_size, dist, q_bgn, q_end, t_bgn, t_end,
    t_m_end, q_m_end), sorted with (ck_a, ck_b).  With collect_misses,
    cache misses are returned as a SPEC_REQ_DTYPE array (treated as
    rejects in THIS pass) instead of aligning inline — the iterative
    driver in ops.overlap.overlap_all_spec.  The caller parses the record
    bytes with ops.overlap.OVLP_DTYPE (kept out of here to avoid a
    circular import).

    stream_buf (SPEC_REQ_DTYPE, C-contiguous) + stream_progress (int64[1])
    enable streaming collect: misses land in stream_buf as found, with
    stream_progress[0] advanced behind them (release-store; safe to poll
    from other Python threads while this call runs GIL-free).  The
    returned miss_requests array then holds only the OVERFLOW beyond
    len(stream_buf); n_cache_misses stays the total."""
    def p(a, dtype):
        a = np.ascontiguousarray(a, dtype)
        return a, a.ctypes.data_as(ctypes.c_void_p)

    ys, ysp = p(ys, np.uint64)
    dirs, dirsp = p(dirs, np.uint8)
    pos, posp = p(pos, np.int64)
    bstart, bsp = p(bstart, np.int64)
    bend, bep = p(bend, np.int64)
    db_data, dbp = p(db_data, np.uint8)
    offsets, offp = p(offsets, np.int64)
    lengths, lenp = p(lengths, np.int64)
    ck_a, kap = p(ck_a, np.uint64)
    ck_b, kbp = p(ck_b, np.uint64)
    cvals, cvp = p(cvals, np.int32)
    out = ctypes.c_void_p()
    n_out = ctypes.c_int64()
    n_miss = ctypes.c_int64()
    mreqs = ctypes.c_void_p()
    if stream_buf is not None:
        assert collect_misses
        assert stream_buf.dtype == SPEC_REQ_DTYPE \
            and stream_buf.flags.c_contiguous
        assert stream_progress is not None \
            and stream_progress.dtype == np.int64
        sbp = stream_buf.ctypes.data_as(ctypes.c_void_p)
        scap = len(stream_buf)
        spp = stream_progress.ctypes.data_as(ctypes.c_void_p)
    else:
        sbp, scap, spp = None, 0, None
    _lib.overlap_replay_c(ysp, dirsp, posp, bsp, bep, len(bstart),
                          dbp, offp, lenp, bestn, fuzz, min_aln, band,
                          kap, kbp, cvp, len(ck_a),
                          ctypes.byref(out), ctypes.byref(n_out),
                          ctypes.byref(n_miss),
                          ctypes.byref(mreqs) if collect_misses else None,
                          sbp, scap, spp)
    try:
        raw = _bytes_at(out.value, n_out.value * _REC_SIZE)
        if collect_misses:
            n_over = n_miss.value - (int(stream_progress[0])
                                     if stream_buf is not None else 0)
            mraw = _bytes_at(mreqs.value,
                             n_over * SPEC_REQ_DTYPE.itemsize)
    finally:
        _lib.free_ovlp_recs_c(ctypes.byref(out))
        if collect_misses:
            _lib.free_spec_reqs2_c(ctypes.byref(mreqs))
    if collect_misses:
        miss_arr = (np.frombuffer(mraw, SPEC_REQ_DTYPE).copy() if mraw
                    else np.zeros(0, SPEC_REQ_DTYPE))
        return raw, int(n_out.value), int(n_miss.value), miss_arr
    return raw, int(n_out.value), int(n_miss.value)


_lib.align_spec_c.argtypes = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,     # reqs, lo, hi
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # db, offsets, lens
    ctypes.c_int32, ctypes.c_void_p]                     # band, out


def align_spec(reqs: np.ndarray, lo: int, hi: int, db_data: np.ndarray,
               offsets: np.ndarray, lengths: np.ndarray, band: int,
               out: np.ndarray) -> None:
    """Align speculative requests [lo, hi) into out[i, :8] (OvlpMatch field
    order).  GIL-releasing: call from threads on disjoint slices.  All
    arrays must be contiguous with the documented dtypes (reqs:
    SPEC_REQ_DTYPE, offsets/lengths: int64, out: int32 [n, 8])."""
    assert reqs.dtype == SPEC_REQ_DTYPE and reqs.flags.c_contiguous
    assert out.dtype == np.int32 and out.flags.c_contiguous
    assert offsets.dtype == np.int64 and offsets.flags.c_contiguous
    assert lengths.dtype == np.int64 and lengths.flags.c_contiguous
    _lib.align_spec_c(reqs.ctypes.data_as(ctypes.c_void_p), lo, hi,
                      db_data.ctypes.data_as(ctypes.c_void_p),
                      offsets.ctypes.data_as(ctypes.c_void_p),
                      lengths.ctypes.data_as(ctypes.c_void_p),
                      band, out.ctypes.data_as(ctypes.c_void_p))


_lib.sort_pairs_c.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64]


def sort_pairs(key0: np.ndarray, key1: np.ndarray, y0: np.ndarray,
               y1: np.ndarray, direction: np.ndarray) -> None:
    """In-place stable lexicographic sort of the five pair-map arrays by
    (key0, key1) — sort_pairs.cpp, two threads; order identical to
    np.lexsort((key1, key0))."""
    for a, dt in ((key0, np.uint64), (key1, np.uint64), (y0, np.uint64),
                  (y1, np.uint64), (direction, np.uint8)):
        # real exceptions, not asserts: these guard native in-place memory
        # access and must survive python -O
        if a.dtype != dt:
            raise TypeError(f"sort_pairs: expected {dt}, got {a.dtype}")
        if not a.flags.c_contiguous:
            raise ValueError("sort_pairs: arrays must be C-contiguous")
        if len(a) != len(key0):
            raise ValueError("sort_pairs: length mismatch")
    _lib.sort_pairs_c(key0.ctypes.data_as(ctypes.c_void_p),
                      key1.ctypes.data_as(ctypes.c_void_p),
                      y0.ctypes.data_as(ctypes.c_void_p),
                      y1.ctypes.data_as(ctypes.c_void_p),
                      direction.ctypes.data_as(ctypes.c_void_p),
                      len(key0))


_lib.pack_db_c.argtypes = [
    ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_void_p]


_lib.encode_biseq_c.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                ctypes.c_void_p]


def encode_biseq_into(seq: bytes | np.ndarray, out: np.ndarray) -> None:
    """Encode one ASCII read into a preallocated 4-bit codec slice
    (encode.cpp; semantics of io/seqdb.encode_biseq)."""
    if isinstance(seq, np.ndarray):
        src = np.ascontiguousarray(seq, np.uint8)
        _lib.encode_biseq_c(src.ctypes.data_as(ctypes.c_char_p), len(src),
                            out.ctypes.data_as(ctypes.c_void_p))
    else:
        _lib.encode_biseq_c(seq, len(seq),
                            out.ctypes.data_as(ctypes.c_void_p))


_lib.write_rows_c.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                              ctypes.c_int64, ctypes.c_char_p]
_lib.write_rows_c.restype = ctypes.c_int64


def write_rows(rows: np.ndarray, path: str) -> None:
    """Write an int64 [n, m] array as space-separated text rows
    (encode.cpp; the np.savetxt formatting loop cost ~8 s at 3M rows)."""
    rows = np.ascontiguousarray(rows, np.int64)
    n, m = rows.shape if rows.ndim == 2 else (len(rows), 1)
    rc = _lib.write_rows_c(rows.ctypes.data_as(ctypes.c_void_p), n, m,
                           path.encode())
    if rc != n:
        raise OSError(f"write_rows failed for {path}")


def pack_db(data: np.ndarray, guard_bases: int) -> tuple[np.ndarray, np.ndarray]:
    """One-pass packing of 4-bit codec bytes into the device planes
    (pack2.cpp); returns (fw 2-bit codes 4/byte, amb flags 8/byte) with
    `guard_bases` zero bases prepended."""
    assert guard_bases % 8 == 0
    data = np.ascontiguousarray(data, np.uint8)
    n = guard_bases + len(data)
    fw = np.zeros(-(-n // 4), np.uint8)
    amb = np.zeros(-(-n // 8), np.uint8)
    _lib.pack_db_c(data.ctypes.data_as(ctypes.c_void_p), len(data),
                   guard_bases, fw.ctypes.data_as(ctypes.c_void_p),
                   amb.ctypes.data_as(ctypes.c_void_p))
    return fw, amb


OVL_ROW_DTYPE = np.dtype([
    ("f_id", "<i4"), ("g_id", "<i4"), ("score", "<i4"), ("idt", "<f4"),
    ("f_b", "<i4"), ("f_e", "<i4"), ("f_l", "<i4"),
    ("g_s", "<i4"), ("g_b", "<i4"), ("g_e", "<i4"), ("g_l", "<i4"),
])

_lib.parse_ovl_c.argtypes = [
    ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_double,
    ctypes.POINTER(ctypes.c_void_p), _i64p,
    ctypes.POINTER(ctypes.c_void_p), _i64p]
_lib.free_ovl_rows_c.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                 ctypes.POINTER(ctypes.c_void_p)]


def parse_ovl(buf: bytes, min_len: int, min_idt: float):
    """Parse preads.ovl text (parse_ovl.cpp; semantics of the Python loop
    in graph.string_graph.generate_string_graph).  Returns
    (rows OVL_ROW_DTYPE array, contained rid int32 array)."""
    rows = ctypes.c_void_p()
    n_rows = ctypes.c_int64()
    cont = ctypes.c_void_p()
    n_cont = ctypes.c_int64()
    _lib.parse_ovl_c(buf, len(buf), min_len, min_idt,
                     ctypes.byref(rows), ctypes.byref(n_rows),
                     ctypes.byref(cont), ctypes.byref(n_cont))
    try:
        raw = _bytes_at(rows.value,
                        n_rows.value * OVL_ROW_DTYPE.itemsize)
        craw = _bytes_at(cont.value, n_cont.value * 4)
    finally:
        _lib.free_ovl_rows_c(ctypes.byref(rows), ctypes.byref(cont))
    return (np.frombuffer(raw, OVL_ROW_DTYPE).copy() if raw
            else np.zeros(0, OVL_ROW_DTYPE),
            np.frombuffer(craw, np.int32).copy() if craw
            else np.zeros(0, np.int32))


SPEC_REQ_DTYPE = np.dtype([
    ("rid0", "<u4"), ("rid1", "<u4"), ("pos0", "<i4"), ("pos1", "<i4"),
    ("strand0", "u1"), ("strand1", "u1"), ("_pad", "<u2"),
])

_lib.spec_enum_c.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # ys, dirs, pos
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,    # bstart, bend, nb
    ctypes.c_int32, ctypes.c_int32,                      # window, per_pair
    ctypes.POINTER(ctypes.c_void_p), _i64p]
_lib.free_spec_reqs_c.argtypes = [ctypes.POINTER(ctypes.c_void_p)]


def spec_enum(ys: np.ndarray, dirs: np.ndarray, pos: np.ndarray,
              bstart: np.ndarray, bend: np.ndarray,
              window: int, per_pair: int) -> np.ndarray:
    """Enumerate speculative alignment requests in exact replay order
    (spec_enum.cpp): for each rid pair its first `per_pair` candidate
    occurrences, exact-duplicate requests removed.  Returns a structured
    SPEC_REQ_DTYPE array."""
    def p(a, dtype):
        a = np.ascontiguousarray(a, dtype)
        return a, a.ctypes.data_as(ctypes.c_void_p)

    ys, ysp = p(ys, np.uint64)
    dirs, dirsp = p(dirs, np.uint8)
    pos, posp = p(pos, np.int64)
    bstart, bsp = p(bstart, np.int64)
    bend, bep = p(bend, np.int64)
    out = ctypes.c_void_p()
    n_out = ctypes.c_int64()
    _lib.spec_enum_c(ysp, dirsp, posp, bsp, bep, len(bstart),
                     window, per_pair, ctypes.byref(out), ctypes.byref(n_out))
    try:
        raw = _bytes_at(out.value,
                        n_out.value * SPEC_REQ_DTYPE.itemsize)
    finally:
        _lib.free_spec_reqs_c(ctypes.byref(out))
    return (np.frombuffer(raw, dtype=SPEC_REQ_DTYPE).copy() if raw
            else np.zeros(0, SPEC_REQ_DTYPE))


_lib.pair_scan_c.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,    # x, y, n
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,    # mc_hash/count, m
    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,   # lower, upper, dist
    ctypes.c_void_p]                                     # keep scratch
_lib.pair_scan_c.restype = ctypes.c_int64
_lib.pair_fill_c.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,    # x, y, n
    ctypes.c_void_p, ctypes.c_void_p,                    # keep, rl
    ctypes.c_uint32, ctypes.c_uint64, ctypes.c_uint64,   # dist, tc, ck
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # key0, key1, y0
    ctypes.c_void_p, ctypes.c_void_p]                    # y1, dir
_lib.pair_fill_c.restype = ctypes.c_int64
_lib.bucket_stream_scan_c.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p]
_lib.bucket_stream_fill_c.argtypes = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_int64, ctypes.c_int64,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # ys, dirs, pos
    ctypes.c_void_p, ctypes.c_void_p]                    # bstart, bend


def _cptr(a: np.ndarray, dt, name: str):
    if a.dtype != dt:
        raise TypeError(f"{name}: expected {dt}, got {a.dtype}")
    if not a.flags.c_contiguous:
        raise ValueError(f"{name}: must be C-contiguous")
    return a.ctypes.data_as(ctypes.c_void_p)


def _alloc(shape, dtype, spill_dir, tag):
    """np.empty, or a delete-on-close file-backed memmap when spill_dir is
    set — the pair map's anonymous footprint (~0.9 GB at 250 Mb, ~14 GB
    at human-30x) then lives under page-cache control instead of RSS."""
    if spill_dir is None or int(np.prod(shape)) == 0:
        return np.empty(shape, dtype)
    import tempfile
    f = tempfile.NamedTemporaryFile(dir=spill_dir, prefix=f"pg-{tag}-")
    n = int(np.prod(shape)) * np.dtype(dtype).itemsize
    f.truncate(max(n, 1))
    a = np.memmap(f, dtype=dtype, mode="w+", shape=shape)
    a._pg_spill_file = f  # keep the fd alive; file is already unlinked
    return a


def build_pairs_fused(x: np.ndarray, y: np.ndarray, mc_hash: np.ndarray,
                      mc_count: np.ndarray, read_lengths: np.ndarray,
                      mc_lower: int, mc_upper: int, min_dist: int,
                      chunk: int = 1, total_chunk: int = 1,
                      spill_dir: str | None = None):
    """Fused threaded pair-map build (build_pairs.cpp): MC gates +
    adjacency + orientation flips + stable (key0, key1) sort in three
    linear passes.  Byte-identical to ops.overlap.build_pairs (asserted
    in tests/test_overlap.py).  Returns (key0, key1, y0, y1, dir).
    spill_dir: back the output arrays with unlinked files there instead
    of anonymous memory (bounded-RSS mode)."""
    n = len(x)
    xp = _cptr(x, np.uint64, "x")
    yp = _cptr(y, np.uint64, "y")
    mhp = _cptr(mc_hash, np.uint64, "mc_hash")
    mcp = _cptr(mc_count, np.uint32, "mc_count")
    rl = np.ascontiguousarray(read_lengths, np.int64)
    keep = np.empty(max(n, 1), np.uint8)
    n_cand = _lib.pair_scan_c(xp, yp, n, mhp, mcp, len(mc_hash),
                              mc_lower, mc_upper, min_dist,
                              keep.ctypes.data_as(ctypes.c_void_p))
    z64 = np.zeros(0, np.uint64)
    if n_cand == 0:
        return z64, z64, z64, z64, np.zeros(0, np.uint8)
    cap = 2 * n_cand  # exact when total_chunk == 1; upper bound otherwise
    key0 = _alloc(cap, np.uint64, spill_dir, "key0")
    key1 = _alloc(cap, np.uint64, spill_dir, "key1")
    y0 = _alloc(cap, np.uint64, spill_dir, "y0")
    y1 = _alloc(cap, np.uint64, spill_dir, "y1")
    direction = _alloc(cap, np.uint8, spill_dir, "dir")
    total = _lib.pair_fill_c(
        xp, yp, n, keep.ctypes.data_as(ctypes.c_void_p),
        rl.ctypes.data_as(ctypes.c_void_p), min_dist,
        total_chunk, chunk % total_chunk,
        key0.ctypes.data_as(ctypes.c_void_p),
        key1.ctypes.data_as(ctypes.c_void_p),
        y0.ctypes.data_as(ctypes.c_void_p),
        y1.ctypes.data_as(ctypes.c_void_p),
        direction.ctypes.data_as(ctypes.c_void_p))
    del keep
    if total < cap:
        if spill_dir is None:
            key0, key1 = key0[:total].copy(), key1[:total].copy()
            y0, y1 = y0[:total].copy(), y1[:total].copy()
            direction = direction[:total].copy()
        else:  # keep the file backing; views stay contiguous
            key0, key1 = key0[:total], key1[:total]
            y0, y1 = y0[:total], y1[:total]
            direction = direction[:total]
    sort_pairs(key0, key1, y0, y1, direction)
    return key0, key1, y0, y1, direction


_lib.sort_by_y_c.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int64]


def sort_by_y(y: np.ndarray, x: np.ndarray) -> None:
    """In-place threaded stable sort of the (x, y) index arrays by y
    (build_pairs.cpp); order identical to np.argsort(y, kind='stable')."""
    for a, name in ((y, "y"), (x, "x")):
        if a.dtype != np.uint64:
            raise TypeError(f"sort_by_y: {name} must be uint64")
        if not a.flags.c_contiguous:
            raise ValueError(f"sort_by_y: {name} must be C-contiguous")
    if len(x) != len(y):
        raise ValueError("sort_by_y: length mismatch")
    _lib.sort_by_y_c(y.ctypes.data_as(ctypes.c_void_p),
                     x.ctypes.data_as(ctypes.c_void_p), len(y))


def bucket_stream_fused(key0: np.ndarray, key1: np.ndarray, y0: np.ndarray,
                        direction: np.ndarray, ovlp_upper: int,
                        spill_dir: str | None = None):
    """Threaded bucket-stream build over the sorted pair map
    (build_pairs.cpp): run-length buckets, size gate, stable
    descending-position order within each bucket — identical to the
    numpy lexsort((-pos, bid)) stream.  Returns (ys, dirs, pos, bstart,
    bend)."""
    n = len(key0)
    k0p = _cptr(key0, np.uint64, "key0")
    k1p = _cptr(key1, np.uint64, "key1")
    y0p = _cptr(y0, np.uint64, "y0")
    dp = _cptr(direction, np.uint8, "direction")
    out2 = np.zeros(2, np.int64)
    _lib.bucket_stream_scan_c(k0p, k1p, n, ovlp_upper,
                              out2.ctypes.data_as(ctypes.c_void_p))
    n_stream, n_buckets = int(out2[0]), int(out2[1])
    ys = _alloc(n_stream, np.uint64, spill_dir, "sys")
    dirs = _alloc(n_stream, np.uint8, spill_dir, "sdir")
    pos = _alloc(n_stream, np.int64, spill_dir, "spos")
    bstart = np.empty(n_buckets, np.int64)
    bend = np.empty(n_buckets, np.int64)
    if n_stream:
        _lib.bucket_stream_fill_c(
            k0p, k1p, y0p, dp, n, ovlp_upper,
            ys.ctypes.data_as(ctypes.c_void_p),
            dirs.ctypes.data_as(ctypes.c_void_p),
            pos.ctypes.data_as(ctypes.c_void_p),
            bstart.ctypes.data_as(ctypes.c_void_p),
            bend.ctypes.data_as(ctypes.c_void_p))
    return ys, dirs, pos, bstart, bend


_pp = ctypes.POINTER(ctypes.c_void_p)
_lib.sg_build_c.argtypes = (
    [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
     ctypes.c_int32, ctypes.c_int32, ctypes.c_int64]
    + [_pp] * 8 + [_i64p]          # edge arrays + n_edges
    + [_pp, _i64p]                 # chimer nodes
    + [_pp, _i64p]                 # best_in nodes
    + [_pp, _i64p])                # lines buffer
_lib.sg_build_c.restype = ctypes.c_int32
_lib.sg_free_c.argtypes = [ctypes.c_void_p] * 11


def sg_build(rows: np.ndarray, cont: np.ndarray, lfc: bool,
             disable_chimer: bool, fuzz: int = 500):
    """String-graph construction + classification passes (sg_passes.cpp;
    semantics of graph.string_graph, the Python oracle — byte-equal
    sg_edges_list asserted in tests/test_graph.py).

    Returns a dict with edge arrays (ev/ew node codes rid*2+end, label
    rid/s/t, score int64, idt float32, cls uint8 0=G 1=C 2=R 3=S 4=TR),
    chimer node codes (append order), best_in node codes (membership),
    and the formatted sg_edges_list file bytes."""
    rows = np.ascontiguousarray(rows)
    if rows.dtype != OVL_ROW_DTYPE:
        raise TypeError(f"sg_build: rows must be OVL_ROW_DTYPE, got {rows.dtype}")
    cont = np.ascontiguousarray(cont, np.int32)
    outs = [ctypes.c_void_p() for _ in range(11)]
    n_edges = ctypes.c_int64()
    n_chimer = ctypes.c_int64()
    n_best = ctypes.c_int64()
    lines_len = ctypes.c_int64()
    rc = _lib.sg_build_c(
        rows.ctypes.data_as(ctypes.c_void_p), len(rows),
        cont.ctypes.data_as(ctypes.c_void_p), len(cont),
        1 if lfc else 0, 1 if disable_chimer else 0, fuzz,
        ctypes.byref(outs[0]), ctypes.byref(outs[1]), ctypes.byref(outs[2]),
        ctypes.byref(outs[3]), ctypes.byref(outs[4]), ctypes.byref(outs[5]),
        ctypes.byref(outs[6]), ctypes.byref(outs[7]), ctypes.byref(n_edges),
        ctypes.byref(outs[8]), ctypes.byref(n_chimer),
        ctypes.byref(outs[9]), ctypes.byref(n_best),
        ctypes.byref(outs[10]), ctypes.byref(lines_len))
    if rc != 0:
        raise RuntimeError("sg_build_c failed")
    ne = n_edges.value

    def arr(p, dtype, count):
        size = count * np.dtype(dtype).itemsize
        if not count:
            return np.zeros(0, dtype)
        return np.frombuffer(_bytes_at(p.value, size), dtype).copy()

    try:
        res = {
            "ev": arr(outs[0], np.int64, ne),
            "ew": arr(outs[1], np.int64, ne),
            "lrid": arr(outs[2], np.int64, ne),
            "ls": arr(outs[3], np.int64, ne),
            "lt": arr(outs[4], np.int64, ne),
            "score": arr(outs[5], np.int64, ne),
            "idt": arr(outs[6], np.float32, ne),
            "cls": arr(outs[7], np.uint8, ne),
            "chimer": arr(outs[8], np.int64, n_chimer.value),
            "best_in": arr(outs[9], np.int64, n_best.value),
            "lines": (_bytes_at(outs[10].value, lines_len.value)
                      if lines_len.value else b""),
        }
    finally:
        _lib.sg_free_c(*outs)
    return res


_lib.write_ovl_c.argtypes = [ctypes.c_void_p] * 12 + [
    ctypes.c_int64, ctypes.c_int32, ctypes.c_char_p]
_lib.write_ovl_c.restype = ctypes.c_int64


def write_ovl_rows(path: str, rid0, rid1, neg_m, err, a_bgn, a_end, rlen0,
                   strand, b_bgn, b_end, rlen1, type_,
                   terminator: bool = True) -> int:
    """Stream preads.ovl rows to `path` (write_ovl.cpp); columns in
    ovlps_to_text order.  Byte-identical to the Python formatter."""
    n = len(rid0)
    arrs = []
    for a, dt, name in ((rid0, np.int64, "rid0"), (rid1, np.int64, "rid1"),
                        (neg_m, np.int64, "neg_m"), (err, np.float64, "err"),
                        (a_bgn, np.int64, "a_bgn"), (a_end, np.int64, "a_end"),
                        (rlen0, np.int64, "rlen0"), (strand, np.int64, "strand"),
                        (b_bgn, np.int64, "b_bgn"), (b_end, np.int64, "b_end"),
                        (rlen1, np.int64, "rlen1"), (type_, np.uint8, "type")):
        a = np.ascontiguousarray(a, dt)
        if len(a) != n:
            raise ValueError(f"write_ovl_rows: {name} length mismatch")
        arrs.append(a)
    rc = _lib.write_ovl_c(*[a.ctypes.data_as(ctypes.c_void_p) for a in arrs],
                          n, 1 if terminator else 0, path.encode())
    if rc != n:
        raise OSError(f"write_ovl_rows failed for {path} (rc={rc})")
    return int(rc)


_lib.fastx_encode_c.argtypes = [
    ctypes.c_char_p, ctypes.c_char_p,
    ctypes.POINTER(ctypes.c_void_p), _i64p,
    ctypes.POINTER(ctypes.c_void_p), _i64p]
_lib.fastx_encode_c.restype = ctypes.c_int64
_lib.free_fastx_c.argtypes = [ctypes.c_void_p, ctypes.c_void_p]


def fastx_encode_append(in_path: str, out_path: str):
    """Parse one FASTA/FASTQ(.gz) file and append its encoded 4-bit
    bytes to out_path (fastx.cpp; kseq semantics of io.seqdb.read_fastx,
    which remains the oracle).  Returns (names list, lengths int64
    array, total bytes appended)."""
    names_p = ctypes.c_void_p()
    names_len = ctypes.c_int64()
    lens_p = ctypes.c_void_p()
    count = ctypes.c_int64()
    total = _lib.fastx_encode_c(in_path.encode(), out_path.encode(),
                                ctypes.byref(names_p),
                                ctypes.byref(names_len),
                                ctypes.byref(lens_p), ctypes.byref(count))
    if total < 0:
        raise OSError(f"fastx_encode failed for {in_path}")
    try:
        raw = _bytes_at(names_p.value, names_len.value) \
            if names_len.value else b""
        lens = (np.frombuffer(_bytes_at(lens_p.value,
                                        count.value * 8),
                              np.int64).copy()
                if count.value else np.zeros(0, np.int64))
    finally:
        _lib.free_fastx_c(names_p, lens_p)
    names = raw.decode().split("\n")[:-1] if raw else []
    return names, lens, int(total)


def dw_align(query: bytes, target: bytes, band_tolerance: int,
             get_aln_str: bool = True) -> DwAlignment:
    """Banded O(ND) alignment with traceback on ASCII sequences
    (semantics: reference falcon/DW_banded.c:104-315)."""
    a = _Alignment()
    _lib.dw_align_c(query, len(query), target, len(target),
                    band_tolerance, 1 if get_aln_str else 0, ctypes.byref(a))
    try:
        return DwAlignment(a)
    finally:
        _lib.free_alignment_c(ctypes.byref(a))
