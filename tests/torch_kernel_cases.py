"""Seeded edge-case inputs for the port's CUDA kernels (numpy, and the
port's numpy read simulator for the aligner's requests).

build_stream, emit_mask, reduce_step and compact_planes split each row
into chunks of `chunk` columns (ops.kernels.CHUNK, REDUCE_CHUNK for
reduce_step and COMPACT_CHUNK for compact_planes, on the card) and carry
row prefixes from chunk to chunk, so their inputs here put the features
that the prefixes and the window halos carry right at chunk boundaries.
The card tests, phase 3
of chip_smoke.py (which loads this file by its path) and the CPU tests
against the Pallas kernels (with a small `chunk`, where the boundaries
only place the features) use them.
Rows 0-7 (0-9 for reduce_step, 0-13 for compact_planes) are the crafted
ones; any further rows are random.  The wide route's kernels
(wide_stream, wide_emit, reduce_wide: wide_stream_codes and
wide_compact_codes, wide_emit_stream, wide_reduce_rows) take int64
records whose hashes reach 2^55 and more, so records at and above 2^63
are ordered as unsigned.  The banded Myers aligner's requests
(myers_lanes, myers_requests) come with the sequences they read.
"""

from __future__ import annotations

import numpy as np

from peregrine_tpu_torch.io.seqdb import revcomp
from peregrine_tpu_torch.simdata import mutate, random_genome

_U32 = np.uint32(0xFFFFFFFF)


def _boundaries(L: int, chunk: int) -> range:
    """The chunk boundaries inside a row, or its middle if it has none."""
    return range(chunk, L, chunk) if chunk < L else range(L // 2, L // 2 + 1)


def stream_codes(rng: np.random.Generator, B: int, L: int, k: int,
                 chunk: int):
    """[B, L] uint8 codes (4 = ambiguous) and [B] int32 lengths for
    build_stream: 1% ambiguous bases and random lengths, and rows of
    length 0 (row 0) and L (row 1); all ambiguous (row 2); one ambiguous
    base at column 0 followed by (AT)* — every k-mer strand-symmetric for
    even k — up to a chunk and a half, so the count since the last
    ambiguous base stays 0 across a boundary (row 3); lengths on a
    boundary and one either side of it (rows 4, 6, 7); ambiguous bases at
    the k + 1 columns that end at each boundary (row 5)."""
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.01] = 4
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    rows = dict(zip(range(8), (0, L, L, L, min(L, chunk), L,
                               min(L, chunk + 1), min(L, chunk - 1))))
    for b, n in rows.items():
        if b < B:
            lens[b] = n
    if B > 2:
        codes[2] = 4
    if B > 3:
        end = min(L, chunk + chunk // 2)
        codes[3, :end] = np.resize(np.array([0, 3], np.uint8), end)
        codes[3, 0] = 4
    if B > 5:
        for b in _boundaries(L, chunk):
            codes[5, max(0, b - k):b + 1] = 4
    return codes, lens


def emit_stream(rng: np.random.Generator, B: int, L: int, w: int, k: int,
                chunk: int, ties: bool):
    """(sH, sP, n) for emit_mask: [B, L] uint32 hashes (INF at ambiguous
    placeholders and 5% warm-up holes; values below 50 when `ties`), [B, L]
    uint32 P = pos << 2 | strand << 1 | amb, [B] int32 counts; columns at
    or past n hold stale values.  n = 0 (row 0) and L (row 1); a
    placeholder at column 0 (row 2); the least hash, 0, at each boundary
    with the only placeholder within w + k columns before it exactly
    w + k - 3, w + k - 2 or w + k - 1 columns before (rows 3, 4, 5); n on
    a boundary (row 6); a final window across a boundary (row 7)."""
    hi = 50 if ties else 1 << 32
    sH = rng.integers(0, hi, (B, L), dtype=np.int64).astype(np.uint32)
    amb = rng.random((B, L)) < 0.01
    sH[amb | (rng.random((B, L)) < 0.05)] = _U32
    n = rng.integers(0, L + 1, B).astype(np.int32)
    rows = dict(zip(range(8), (0, L, L, L, L, L, min(L, chunk),
                               min(L, chunk + w // 2))))
    for b, v in rows.items():
        if b < B:
            n[b] = v
    if B > 2:
        amb[2, 0] = True
        sH[2, 0] = _U32
    for b in range(3, min(B, 6)):
        d = w + k - 3 + (b - 3)
        for c in _boundaries(L, chunk):
            if c - d < 0:
                continue
            lo = max(0, c - w - k)
            amb[b, lo:c + 1] = False
            sH[b, lo:c + 1] = rng.integers(1, hi, c + 1 - lo,
                                           dtype=np.int64).astype(np.uint32)
            amb[b, c - d] = True
            sH[b, c - d] = _U32
            sH[b, c] = 0
    sP = ((rng.integers(0, 1 << 29, (B, L)).astype(np.uint32) << np.uint32(2))
          | (rng.integers(0, 2, (B, L)).astype(np.uint32) << np.uint32(1))
          | amb.astype(np.uint32))
    return sH, sP, n


def reduce_rows(rng: np.random.Generator, B: int, L: int, r: int,
                chunk: int, ties: bool):
    """(H, P, n) for reduce_step: [B, L] uint32 hashes (below 50 when
    `ties`), [B, L] uint32 P = pos << 2 | strand << 1, [B] int32 counts;
    columns at or past n hold random values that nothing may use.  n = 0
    (row 0) and L (row 1); n = r - 2, short of the first whole window
    (columns 0..r-1), and n = r, which holds exactly that one (rows 2, 3);
    n on a boundary and one either side (rows
    4-6); the least hash, 0, on the column before each boundary, so that
    the first columns of the next chunk keep its winner and must not emit
    it again (row 7); every hash equal, so that the least ring slot
    decides (row 8); every P equal, so that only column r - 1 is emitted
    (row 9)."""
    hi = 50 if ties else 1 << 32
    H = rng.integers(0, hi, (B, L), dtype=np.int64).astype(np.uint32)
    P = ((rng.integers(0, 1 << 29, (B, L)).astype(np.uint32) << np.uint32(2))
         | (rng.integers(0, 2, (B, L)).astype(np.uint32) << np.uint32(1)))
    n = rng.integers(0, L + 1, B).astype(np.int32)
    rows = dict(zip(range(10), (0, L, min(L, max(0, r - 2)), min(L, r),
                                min(L, chunk), min(L, chunk + 1),
                                min(L, chunk - 1), L, L, L)))
    for b, v in rows.items():
        if b < B:
            n[b] = v
    if B > 7:
        for c in _boundaries(L, chunk):
            lo, hi_c = max(0, c - r), min(L, c + r)
            H[7, lo:hi_c] = rng.integers(1, hi, hi_c - lo,
                                         dtype=np.int64).astype(np.uint32)
            H[7, c - 1] = 0
    if B > 8:
        H[8] = H[8, 0]
    if B > 9:
        P[9] = P[9, 0]
    return H, P, n


def compact_rows(rng: np.random.Generator, B: int, L: int, chunk: int):
    """[B, L] bool keep masks for compact_planes, whose fills land on
    [count, L) by each dropped column's rank, so a fill placed one column
    off overwrites a kept entry or leaves a column unset.  Keeps nothing
    (row 0) and everything (row 1); only column c - 1, c or c + 1 of the
    first boundary c, the row's single kept column (rows 2-4); one kept
    column at c - 1, c or c + 1 of every boundary (rows 5-7); the first
    `chunk` columns, so the count lies on the boundary (row 8); `chunk`
    columns at random, the same count elsewhere (row 9); every other
    chunk dropped whole (row 10); only the first and the last chunk with
    kept columns (row 11); only the last column (row 12) and only the
    first (row 13).  Further rows are random at a density of their own."""
    keep = rng.random((B, L)) < rng.random((B, 1))
    crafted = np.zeros((14, L), bool)
    crafted[1] = True
    bounds = list(_boundaries(L, chunk))
    for i, d in enumerate((-1, 0, 1)):
        for b, cols in ((2 + i, bounds[:1]), (5 + i, bounds)):
            for c in cols:
                if 0 <= c + d < L:
                    crafted[b, c + d] = True
    crafted[8, :chunk] = True
    crafted[9, rng.permutation(L)[:chunk]] = True
    col = np.arange(L)
    crafted[10] = ((col // chunk) % 2 == 0) & (rng.random(L) < 0.5)
    last = (L - 1) // chunk
    crafted[11] = ((col // chunk == 0) | (col // chunk == last)) & (
        rng.random(L) < 0.5)
    crafted[12, L - 1] = True
    crafted[13, 0] = True
    keep[:min(B, 14)] = crafted[:B]
    return keep


# --- the wide route (wide_stream, wide_emit, reduce_wide) -----------------

_INF64 = np.uint64(2**64 - 1)


def wide_stream_codes(rng: np.random.Generator, B: int, L: int, k: int,
                      chunk: int):
    """[B, L] uint8 codes and [B] int32 lengths for wide_stream:
    stream_codes' rows 0-7 (empty and full rows, all ambiguous, an (AT)*
    run after an ambiguous base, lengths on and beside a boundary,
    ambiguous runs ending at every boundary), then a row shorter than k
    (row 8), a row of one base (row 9), an (AT)* run with no ambiguous base
    from column 0 to the end, every k-mer from column k - 1 on
    strand-symmetric at even k, so the run length stays at the k - 1 of
    the row's start across every boundary (row 10), and a random prefix up
    to k columns before the first boundary followed by (AT)* to the end
    (row 11).  Ambiguous codes are 4 to 7 (their low two bits
    enter the k-mers)."""
    codes, lens = stream_codes(rng, B, L, k, chunk)
    codes[codes == 4] += rng.integers(0, 4, int((codes == 4).sum()),
                                      dtype=np.uint8)
    at = np.resize(np.array([0, 3], np.uint8), L)
    rows = {8: max(0, k - 1), 9: min(L, 1), 10: L, 11: L}
    for b, n in rows.items():
        if b < B:
            lens[b] = min(n, L)
    if B > 10:
        codes[10] = at
    if B > 11:
        start = max(0, _boundaries(L, chunk)[0] - k)
        codes[11, start:] = at[:L - start]
    return codes, lens


def wide_compact_codes(rng: np.random.Generator, B: int, L: int, k: int,
                       chunk: int):
    """wide_stream_codes' rows 0-11, then rows whose kept ranks the
    compacting wide_stream carries across boundaries: ambiguous runs of
    seven bases centred on each boundary (row 12); no ambiguous base, so
    every column of the read is kept (row 13); (AT)* over the whole
    second chunk, which keeps nothing there at even k, and the read's end
    a column after the next boundary (row 14); the read's end a column
    before the first boundary, on an ambiguous base (row 15)."""
    codes, lens = wide_stream_codes(rng, B, L, k, chunk)
    bounds = list(_boundaries(L, chunk))
    if B > 12:
        lens[12] = L
        for c in bounds:
            codes[12, max(0, c - 3):c + 4] = 4 + rng.integers(
                0, 4, len(range(max(0, c - 3), min(L, c + 4))),
                dtype=np.uint8)
    if B > 13:
        codes[13] = rng.integers(0, 4, L)
        lens[13] = L
    if B > 14:
        lo = min(L, chunk)
        hi = min(L, 2 * chunk)
        codes[14, lo:hi] = np.resize(np.array([0, 3], np.uint8), hi - lo)
        lens[14] = min(L, hi + 1)
    if B > 15:
        lens[15] = max(0, bounds[0] - 1)
        if lens[15]:
            codes[15, lens[15] - 1] = 5
    return codes, lens


def _wide_records(rng, shape, k: int, ties: bool):
    """uint64 records hash << 8 | k with hashes of 56 bits (about half of
    them >= 2^55, so records >= 2^63), or from a pool of 8 hashes, half of
    them >= 2^55, when `ties`."""
    if ties:
        pool = np.concatenate([rng.integers(1, 2**20, 4, dtype=np.uint64),
                               rng.integers(2**55, 2**56, 4,
                                            dtype=np.uint64)])
        h = pool[rng.integers(0, len(pool), shape)]
    else:
        h = rng.integers(0, 2**56, shape, dtype=np.uint64)
    return (h << np.uint64(8)) | np.uint64(k)


def wide_emit_stream(rng: np.random.Generator, B: int, L: int, w: int,
                     k: int, chunk: int, ties: bool):
    """(sx, sl, n) for wide_emit, as compact_planes leaves the wide
    stream: [B, L] uint64 records (all ones at ambiguous placeholders and
    while the run is shorter than k), [B, L] int32 run lengths (0 at the
    placeholders, which come at 1%), [B] int32 counts, and the fills past
    n (all ones, 0).  n = 0 (row 0) and L (row 1); n on a boundary (row
    2); a final window across a boundary (row 3); one repeated record in
    the whole final window, so its newest column must win (row 4); a run
    length of w + k - 2, then w + k - 1, at each boundary, the least
    record there (rows 5, 6); a placeholder on each boundary (row 7)."""
    sx = _wide_records(rng, (B, L), k, ties)
    n = rng.integers(0, L + 1, B).astype(np.int32)
    crafted = (0, L, min(L, chunk), min(L, chunk + w // 2), L, L, L, L)
    for b, v in enumerate(crafted[:B]):
        n[b] = v
    amb = rng.random((B, L)) < 0.01
    if B > 7:
        amb[7, list(_boundaries(L, chunk))] = True
    sl = np.zeros((B, L), np.int32)
    for b in range(B):
        run = int(rng.integers(0, 3 * (w + k)))
        for t in range(L):
            run = 0 if amb[b, t] else run + 1
            sl[b, t] = run
    for b in (5, 6):
        if b < B:
            for c in _boundaries(L, chunk):
                lo = max(0, c - (w + k - 2 + (b - 5)) + 1)
                sl[b, lo:c + 1] = np.arange(c + 1 - lo) + (w + k - 2 + (b - 5)
                                                           - (c - lo))
                sx[b, c] = np.uint64(k)  # hash 0: the least record
    sx[(sl < k) | amb] = _INF64
    sl[amb] = 0
    if B > 4 and L:
        lo = max(0, L - w)
        sx[4, lo:] = _wide_records(rng, (1,), k, ties)[0]
        sl[4, lo:] = k + np.arange(L - lo)
    past = np.arange(L)[None, :] >= n[:, None]
    sx[past] = _INF64
    sl[past] = 0
    return sx, sl, n


def wide_reduce_rows(rng: np.random.Generator, B: int, L: int, r: int,
                     chunk: int, ties: bool):
    """(x, y, count) for reduce_wide: [B, L] uint64 records (hashes of 56
    bits, or from a pool of 8 when `ties`, so the ring slot decides),
    y = rid << 32 | pos << 1 | strand with increasing positions, [B]
    int32 counts; columns at or past the count hold random values that
    nothing may read.  count = 0 (row 0) and L (row 1); r - 2, short of
    the first whole window, and r - 1, which holds exactly one (rows 2,
    3); on a boundary and one either side (rows 4-6); the least hash on
    the column before each boundary, so the first columns of the next
    chunk keep its winner and must not emit it again (row 7); every
    record equal, so the least ring slot decides (row 8); every y equal,
    so only column r - 1 is emitted (row 9)."""
    x = _wide_records(rng, (B, L), 28, ties)
    pos = np.sort(rng.integers(0, 2**30, (B, L)), axis=1).astype(np.uint64)
    y = ((np.arange(B, dtype=np.uint64)[:, None] << np.uint64(32))
         | (pos << np.uint64(1)) | rng.integers(0, 2, (B, L), dtype=np.uint64))
    count = rng.integers(0, L + 1, B).astype(np.int32)
    crafted = (0, L, max(0, r - 2), max(0, r - 1), chunk, chunk + 1,
               chunk - 1, L, L, L)
    for b, v in enumerate(crafted[:B]):
        count[b] = min(L, v)
    if B > 7:
        for c in _boundaries(L, chunk):
            x[7, c - 1] = np.uint64(28)  # hash 0
    if B > 8:
        x[8] = x[8, 0]
    if B > 9:
        y[9] = y[9, 0]
    return x, y, count


# --- the banded Myers aligner (pg_myers_align) ----------------------------

class _Requests:
    """A growing list of stored sequences and the request columns
    (q_off, q_rstart, q_len, q_strand, t_off, t_len, t_strand) that make
    the aligner see a given query and target on given strands: a strand-1
    request reads the complement of its sequence backwards, so the stored
    read is the reverse complement of the view."""

    def __init__(self):
        self.seqs: list[bytes] = []
        self.cols: list[list[int]] = []
        self.off = 0

    def _store(self, seq: bytes) -> int:
        off = self.off
        self.seqs.append(seq)
        self.off += len(seq)
        return off

    def pad_to(self, residue: int, mod: int = 16):
        """Store a spacer so that the next sequence starts at `residue`
        mod `mod` (a 32-bit fw word holds 16 bases, an amb word 32)."""
        if (self.off - residue) % mod:
            self._store(b"A" * ((residue - self.off) % mod))

    def add(self, q: bytes, t: bytes, qs: int, ts: int, prefix: bytes = b"",
            residues: tuple[int, int] | None = None):
        """Query view q (behind `prefix` in its read on strand 0, so that
        q_off lies inside the read) against target view t; `residues`
        places the query's and the target's stored reads at those
        residues mod 16."""
        if residues:
            self.pad_to(residues[0])
        if qs == 0:
            rs = self._store(prefix + q)
            q_off = rs + len(prefix)
        else:
            rs = self._store(revcomp(q) + prefix)
            q_off = rs
        if residues:
            self.pad_to(residues[1])
        t_off = self._store(t if ts == 0 else revcomp(t))
        self.lane(q_off, rs, len(q), qs, t_off, len(t), ts)

    def lane(self, q_off: int, rs: int, q_len: int, qs: int, t_off: int,
             t_len: int, ts: int):
        """A request on sequences already stored."""
        self.cols.append([q_off, rs, q_len, qs, t_off, t_len, ts])

    def offset(self, seq: bytes) -> int:
        """Where the first stored copy of seq starts."""
        i = self.seqs.index(seq)
        return sum(len(s) for s in self.seqs[:i])

    def result(self):
        return self.seqs, np.array(self.cols, np.int64).reshape(-1, 7)


def myers_lanes(rng: np.random.Generator, read_len: int, cap: int):
    """Crafted alignment requests and their seqdb sequences (ASCII, in
    storage order): identical sequences; a query shorter than its target
    and the reverse; q_len < 32; a t_len that is not a multiple of 32;
    10% error; tandem repeats at both ends (ties in the readouts);
    ambiguous bases; a lane whose max(q_len, t_len) is `cap` (the
    aln_max_len that still goes to the device); 1% error with the query
    window inside its read; a target of one base and a query of none;
    query and target reads starting at every residue mod 16 (windows
    that straddle the kernel's 32-bit words at every offset) with t_len
    of 16m +- 1 and 32m +- 1; strand-1 windows that read down to the
    first base after the guard; and, last, targets and queries that end
    on the last base of the data, whose length is a multiple of 8, so
    that with planes cut to the data they end on the planes' last base
    (plane_end_planes).  Each kind on all four strand pairs.  Returns
    (seqs, cols [B, 7])."""
    a = random_genome(rng, read_len)
    n2 = read_len // 2
    rep = b"AC" * 60
    amb = bytearray(a)
    for i in rng.integers(0, read_len, max(1, read_len // 50)):
        amb[i] = ord("N")
    long_a = random_genome(rng, cap)
    kinds = [
        (a, a, b""),
        (a[:n2], a, b""),
        (a, a[:n2], b""),
        (a[:21], a[:300], b""),
        (a[:1000], mutate(rng, a[:1037], 0.01), b""),
        (a, mutate(rng, a, 0.10), b""),
        (rep + a[:n2] + rep, rep + mutate(rng, a[:n2], 0.01) + rep + rep, b""),
        (bytes(amb), mutate(rng, a, 0.01)[:read_len - 7] + b"NNNNNNN", b""),
        (long_a[:cap - 100], mutate(rng, long_a, 0.01)[:cap], b""),
        (a[300:], mutate(rng, a[300:], 0.01) + random_genome(rng, 200),
         a[:300]),
        (b"", a[:1], b""),
    ]
    pairs = ((0, 0), (1, 1), (0, 1), (1, 0))
    req = _Requests()
    for q, t, prefix in kinds:
        for qs, ts in pairs:
            req.add(q, t, qs, ts, prefix)
    # word boundaries
    g = random_genome(rng, 700)
    for r in range(16):
        m = 5 + r // 2
        tl = (32 * m - 1, 32 * m + 1, 32 * m + 15, 32 * m + 17)[r % 4]
        q = mutate(rng, g[:tl + 7 * (r % 3 - 1)], 0.02)
        for qs, ts in pairs:
            req.add(q, g[:tl], qs, ts, residues=(r, (5 * r + 3) % 16))
    # strand 1 down to the first base: the first stored read is `a`, so
    # its reverse complement is the view of strand 1 at offset 0
    ra, n = req.offset(revcomp(a)), len(a)
    for qs, ts in pairs:
        req.lane(ra + n - n2 if qs == 0 else 0, ra if qs == 0 else 0, n2, qs,
                 ra if ts == 0 else 0, n, ts)
    # the end of the data: revcomp(e) then e, the last read
    e = random_genome(rng, 1013)
    req.pad_to(-2 * len(e) % 8, 8)
    off_r = req._store(revcomp(e))
    off_e = req._store(e)
    n = len(e) - 100
    for qs, ts in pairs:   # views e[100:] and e
        req.lane(off_e + 100 if qs == 0 else off_r,
                 off_e if qs == 0 else off_r, n, qs,
                 off_e if ts == 0 else off_r, len(e), ts)
    for qs, ts in pairs:   # views revcomp(e)[:n] and revcomp(e)
        req.lane(off_r if qs == 0 else off_e + 100,
                 off_r if qs == 0 else off_e + 100, n, qs,
                 off_r if ts == 0 else off_e, len(e), ts)
    assert req.off % 8 == 0
    return req.result()


def plane_end_planes(seqs: list[bytes], junk: int = 0, seed: int = 0):
    """The packed (fw, amb) planes of the concatenated seqs cut to the
    data (no padding rows after its last base), each followed by `junk`
    random bytes that are not part of the plane: a kernel that reads past
    a plane's end, where gather_codes clamps, sees them.  Returns numpy
    (fw, amb, fw_bytes, amb_bytes)."""
    from peregrine_tpu_torch.io.seqdb import SeqDB
    from peregrine_tpu_torch.ops.dbgather import pack_db_np

    data = SeqDB.from_reads([(str(i), s) for i, s in enumerate(seqs)]).data
    fw, amb = pack_db_np(data)
    rng = np.random.default_rng(seed)
    return (np.concatenate([fw, rng.integers(0, 256, junk, np.uint8)]),
            np.concatenate([amb, rng.integers(0, 256, junk, np.uint8)]),
            len(fw), len(amb))


def myers_requests(rng: np.random.Generator, B: int, read_len: int,
                   len_sd: int, error: float):
    """B overlap requests as the overlap stage makes them: two reads of
    length ~N(read_len, len_sd) from one random genome, the second
    starting `shift` bases into the first; the query is the first read
    from its shift on, the target the whole second read; both with
    `error`, each on a random strand.  Returns (seqs, cols [B, 7])."""
    req = _Requests()
    for _ in range(B):
        la, lb = (max(read_len // 3, int(read_len + rng.normal(0, len_sd)))
                  for _ in range(2))
        shift = int(rng.integers(0, la // 2))
        g = random_genome(rng, shift + max(la - shift, lb))
        q = mutate(rng, g[shift:la], error)
        t = mutate(rng, g[shift:shift + lb], error)
        prefix = mutate(rng, g[:shift], error)
        req.add(q, t, int(rng.integers(0, 2)), int(rng.integers(0, 2)),
                prefix)
    return req.result()


def myers_past_end_lanes(seqs: list[bytes]) -> np.ndarray:
    """Requests whose windows run 1, 17 and 300 bases past the end of the
    concatenated seqs, on all four strand pairs: with planes cut to the
    data (plane_end_planes), gather_codes clamps those bases to the
    plane's last byte, so the junk after a plane changes a result if a
    kernel reads it.  Returns cols [24, 7]."""
    n = sum(len(s) for s in seqs)
    return np.array([[n - 200, n - 200, 200 + over, qs, n - 250, 250 + over, ts]
                     for qs, ts in ((0, 0), (1, 1), (0, 1), (1, 0))
                     for over in (1, 17, 300)], np.int64)


# --- stage 1's batch step: gather_codes, drain_records, build_index --------

def gather_seqs() -> list[bytes]:
    """Twelve reads of 300-700 bases, one with N runs."""
    rng = np.random.default_rng(5)
    seqs = [random_genome(rng, int(n)) for n in rng.integers(300, 700, 12)]
    seqs[4] = seqs[4][:50] + b"NNNN" + seqs[4][54:200] + b"N" + seqs[4][201:]
    return seqs


def gather_windows(offsets: np.ndarray, lengths: np.ndarray, strand: int,
                   L: int):
    """gather_codes windows inside the reads at (offsets, lengths): for
    each residue of the gather start mod 16, lengths 0, 1, L - 1, L and
    min(L, the read's rest); then the last read's tails of 1, 17 and 200
    bases, which end on the data's last base (strand 0 reads on past it).
    Reads must be longer than L + 31.  Returns (goff int64, lens int32,
    strands int32)."""
    rng = np.random.default_rng(strand)
    off, lens = [], []
    for res in range(16):
        for want in (0, 1, L - 1, L, L + 1):
            rid = int(rng.integers(0, len(offsets)))
            ro, rl = int(offsets[rid]), int(lengths[rid])
            ln = min(want, L)
            # goff = o (strand 0) or o + ln - L (strand 1) at residue res
            base = ro + 16 if strand == 0 else ro + 16 + ln - L
            off.append(ro + 16 + (res - base) % 16)
            lens.append(ln)
    end = int(offsets[-1] + lengths[-1])
    for ln in (1, 17, 200):
        off.append(end - ln)
        lens.append(ln)
    off, lens = np.array(off, np.int64), np.array(lens, np.int32)
    goff = np.where(strand == 0, off, off + lens - L)
    return goff, lens, np.full(len(off), strand, np.int32)


def drain_batches(k: int, G: int, B: int, C: int):
    """G batches of drain_records input: [B, C + 3] planes (the step's
    planes are wider than what it drains), uint32 (H, P) at k <= 16 and
    uint64 (x, y) records with hashes >= 2^55 (x >= 2^63) above; counts
    0, exactly C, past C and random; sketch counts c0 >= counts; rids."""
    rng = np.random.default_rng(k)
    out = []
    for g in range(G):
        c = rng.integers(0, C, B).astype(np.int32)
        c[0], c[1], c[2] = 0, C, C + 7 + g
        c0 = c + rng.integers(0, 50, B).astype(np.int32)
        rids = rng.integers(0, 1 << 20, B).astype(np.int64)
        if k <= 16:
            a = rng.integers(0, 1 << 32, (B, C + 3),
                             dtype=np.uint64).astype(np.uint32)
            b = rng.integers(0, 1 << 31, (B, C + 3)).astype(np.uint32)
        else:
            a = ((rng.integers(1 << 55, 1 << 56, (B, C + 3), dtype=np.uint64)
                  << np.uint64(8)) | np.uint64(k))
            b = rng.integers(0, 1 << 63, (B, C + 3), dtype=np.uint64)
        out.append((a, b, c, c0, rids))
    return out


def stage1_reads() -> list[tuple[str, bytes]]:
    """22 reads in two pad buckets of a sketch_pad_len of 8192 (units of
    2048): reads of ~800 bases, four of ~2000 as rids 4-7 (the second
    batch of four; at k=28, w=8 a sketch of ~440 past the cap of 256),
    and six of ~3000 (the 4096 bucket; rid 18 holds an N run)."""
    rng = np.random.default_rng(13)
    genome = random_genome(rng, 60000)
    reads = []
    for i, n in enumerate([800] * 4 + [2000] * 4 + [800] * 8 + [3000] * 6):
        n = n + int(rng.integers(-40, 40))
        s = int(rng.integers(0, len(genome) - n))
        reads.append((f"r{i}", genome[s:s + n]))
    s = reads[18][1]
    reads[18] = ("r18", s[:700] + b"N" * 30 + s[730:])
    return reads


# --- the fused stage-1 kernels: gather_build_stream, reduce_drain ----------

def fused_gather_seqs(L: int) -> list[bytes]:
    """Six reads of L + 300 to L + 600 bases for gather_build_stream's
    windows of L columns; reads 0, 2 and 4 hold N runs at read offsets
    30-33, 1000 and c + 4 to c + 63 for each multiple c of 4,096 below L,
    the last across column c (a chunk boundary) of every window
    fused_gather_windows starts in them."""
    rng = np.random.default_rng(17)
    seqs = [bytearray(random_genome(rng, L + int(n)))
            for n in rng.integers(300, 600, 6)]
    for s in seqs[::2]:
        s[30:34] = b"NNNN"
        s[1000:1001] = b"N"
        for c in range(4096, L, 4096):
            s[c + 4:c + 64] = b"N" * 60
    return [bytes(s) for s in seqs]


def fused_gather_windows(offsets: np.ndarray, lengths: np.ndarray, L: int,
                         rows: int = 40):
    """Strand-0 windows of L columns (as stage 1 gathers them) in the reads
    at (offsets, lengths): one for each residue of the gather start mod
    32, read 16 + (0..31) bases in, with lengths 0, 1, 15, CHUNK - 1,
    CHUNK, CHUNK + 1, L - 1 and L in turn; the last read's tails of 1, 17
    and 200 bases, which end on the data's last base (the windows read on
    past the planes' data); then, up to `rows`, windows of length L read
    16 to 47 bases into reads 0, 2 and 4 (across their N runs at the
    chunk boundary).  Reads must be longer than L + 47.  Returns (goff,
    lens), both int64."""
    rng = np.random.default_rng(L)
    cycle = (0, 1, 15, 4095, 4096, 4097, L - 1, L)
    goff, lens = [], []
    for res in range(32):
        rid = res % len(offsets)
        base = int(offsets[rid]) + 16
        goff.append(base + (res - base) % 32)
        lens.append(cycle[res % len(cycle)])
    end = int(offsets[-1] + lengths[-1])
    for ln in (1, 17, 200):
        goff.append(end - ln)
        lens.append(ln)
    while len(goff) < rows:
        rid = 2 * int(rng.integers(0, 3))
        goff.append(int(offsets[rid]) + int(rng.integers(16, 48)))
        lens.append(L)
    return np.array(goff, np.int64), np.array(lens, np.int64)


def reduce_drain_batches(G: int, B: int, L: int, r: int, chunk: int):
    """G batches of reduce_drain input: reduce_rows' (H, P, n) (n = 0, L,
    short of a window, on a chunk boundary, ...; ties in the second
    batch), sketch counts c0 >= n and rids below 2^20."""
    rng = np.random.default_rng(r + L)
    out = []
    for g in range(G):
        H, P, n = reduce_rows(rng, B, L, r, chunk, ties=g == 1)
        c0 = (n + rng.integers(0, 50, B)).astype(np.int32)
        rids = rng.integers(0, 1 << 20, B).astype(np.int64)
        out.append((H, P, n, c0, rids))
    return out
