"""Seeded edge-case inputs for the chunked SHIMMER kernels (numpy only).

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
ones; any further rows are random.
"""

from __future__ import annotations

import numpy as np

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
