"""Plain NumPy reference of stage 1: the SHIMMER index of a read set.

The semantics of Peregrine's src/mm_sketch.c and src/shmr_reduce.c in
the set form the repository states for them (its sketch's docstring),
written here without any code of the program under test.  The set form
departs from upstream's ring buffer only where equal hashes meet at a
read's first complete window: upstream may emit a tied entry once less
or once more.

* k-mers are rolled base by base from 2-bit codes (A=0, C=1, G=2, T=3);
  a position whose forward k-mer equals its reverse complement is
  strand-symmetric and skipped (it takes no stream slot); the canonical
  k-mer is hashed with the invertible 64-bit mix, masked to 2k bits;
* a stream entry is valid once k entries have been taken
  (x = hash << 8 | k, y = rid << 32 | pos << 1 | strand);
* an entry is a minimizer iff it is a minimum of some complete window of
  w stream entries (all ties kept), or, in a read with no complete
  window, the newest minimum of its last w entries;
* a reduction level slides a window of r consecutive minimizers of a
  read and keeps the smallest (hash, offset mod r), each kept entry once;
* the count file holds, for each distinct hash of the final level, the
  number of its records.

Reads are ACGT only (the generator makes no other letter).  Everything
is vectorised over a block of whole reads; blocks run on a thread pool,
since NumPy releases the interpreter lock inside its loops.
"""

from __future__ import annotations

import concurrent.futures as cf

import numpy as np

INF = np.uint64(0xFFFFFFFFFFFFFFFF)
_CODE = np.full(256, 255, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i


def codes_of(seq: np.ndarray) -> np.ndarray:
    """2-bit codes of an ACGT byte array; raises on any other letter."""
    c = _CODE[seq]
    if (c > 3).any():
        raise ValueError("the reference takes ACGT reads only")
    return c


def hash64(key: np.ndarray, mask: int) -> np.ndarray:
    """Thomas Wang's invertible 64-bit mix, every step modulo 2**(2k): in
    the keys' own unsigned type, whose width must be a multiple of 2k's
    power of two (uint32 serves k <= 16)."""
    u = key.dtype.type
    m = u(mask)
    key = (~key + (key << u(21))) & m
    key = key ^ (key >> u(24))
    key = (key + (key << u(3)) + (key << u(8))) & m
    key = key ^ (key >> u(14))
    key = (key + (key << u(2)) + (key << u(4))) & m
    key = key ^ (key >> u(28))
    key = (key + (key << u(31))) & m
    return key


def _shift(a: np.ndarray, n: int, fill) -> np.ndarray:
    """a[i - n], fill where i < n."""
    out = np.empty_like(a)
    out[:n] = fill
    out[n:] = a[:len(a) - n]
    return out


def _roll(codes: np.ndarray, k: int, newest_high: bool,
          dtype=np.uint64) -> np.ndarray:
    """The k-mer register at each position of a zero-padded code array:
    newest code in the low bits (forward) or in the high bits (reverse
    complement register fed complemented codes)."""
    u = np.dtype(dtype).type
    acc = None   # register of the last `have` codes
    have = 0
    blk = codes.astype(dtype)   # register of the last `width` codes
    width = 1
    kk = k
    while kk:
        if kk & 1:
            if acc is None:
                acc, have = blk, width
            elif newest_high:
                # acc holds the newest `have` codes; blk's block is older
                acc = (acc << u(2 * width)) | _shift(blk, have, 0)
                have += width
            else:
                acc = (_shift(blk, have, 0) << u(2 * have)) | acc
                have += width
        kk >>= 1
        if kk:
            if newest_high:
                blk = (blk << u(2 * width)) | _shift(blk, width, 0)
            else:
                blk = (_shift(blk, width, 0) << u(2 * width)) | blk
            width *= 2
    return acc


def _sliding_min(a: np.ndarray, w: int) -> np.ndarray:
    """out[t] = min(a[t-w+1 .. t]) (van Herk / Gil-Werman); out[t] for
    t < w-1 covers a[0 .. t]."""
    n = len(a)
    nb = -(-n // w)
    p = np.full(nb * w, INF, np.uint64)
    p[:n] = a
    blocks = p.reshape(nb, w)
    pref = np.minimum.accumulate(blocks, axis=1).reshape(-1)[:n]
    suf = np.minimum.accumulate(blocks[:, ::-1], axis=1)[:, ::-1]
    suf = suf.reshape(-1)[:n]
    return np.minimum(_shift(suf, w - 1, INF), pref)


def _sliding_max_ahead(a: np.ndarray, w: int) -> np.ndarray:
    """out[e] = max(a[e .. e+w-1]), past the end counting as 0."""
    n = len(a)
    nb = -(-n // w) + 1
    p = np.zeros(nb * w, np.uint64)
    p[:n] = a
    blocks = p.reshape(nb, w)
    pref = np.maximum.accumulate(blocks, axis=1).reshape(-1)
    suf = np.maximum.accumulate(blocks[:, ::-1], axis=1)[:, ::-1].reshape(-1)
    return np.maximum(suf[:n], pref[w - 1:w - 1 + n])


def _seg_index(lengths: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(segment id, offset within the segment) of each element of the
    concatenation of segments of the given lengths."""
    lengths = np.asarray(lengths, np.int64)
    total = int(lengths.sum())
    seg = np.repeat(np.arange(len(lengths)), lengths)
    starts = np.zeros(len(lengths), np.int64)
    np.cumsum(lengths[:-1], out=starts[1:])
    return seg, np.arange(total, dtype=np.int64) - starts[seg]


def sketch_block(seqs: list[np.ndarray], rids: np.ndarray, w: int,
                 k: int, hash_bits: int = 0):
    """Level-0 minimizers of whole reads: (x, y, per-read counts).
    hash_bits > 0 keeps only the hash's low bits (the control's lower
    precision)."""
    pad = k - 1
    lens = np.array([len(s) for s in seqs], np.int64)
    n = len(seqs)
    # each read behind k-1 zero codes: the registers restart per read
    seg_len = lens + pad
    total = int(seg_len.sum())
    codes = np.zeros(total, np.uint8)
    comp = np.zeros(total, np.uint8)
    starts = np.zeros(n, np.int64)
    np.cumsum(seg_len[:-1], out=starts[1:])
    for s, st in zip(seqs, starts):
        c = codes_of(s)
        codes[st + pad:st + pad + len(c)] = c
        comp[st + pad:st + pad + len(c)] = 3 - c
    mask = (1 << (2 * k)) - 1
    dt = np.uint32 if k <= 16 else np.uint64
    fwd = _roll(codes, k, newest_high=False, dtype=dt) & dt(mask)
    rev = _roll(comp, k, newest_high=True, dtype=dt) & dt(mask)
    del codes, comp
    seg, off = _seg_index(seg_len)
    keep = np.flatnonzero((off >= pad) & (fwd != rev))
    fwd, rev, seg = fwd[keep], rev[keep], seg[keep]
    h = hash64(np.minimum(fwd, rev), mask).astype(np.uint64)
    if hash_bits:
        h &= np.uint64((1 << hash_bits) - 1)
    x = (h << np.uint64(8)) | np.uint64(k)
    del h
    # stream index within the read; entries before the k-th are invalid
    nstream = np.bincount(seg, minlength=n).astype(np.int64)
    _, j = _seg_index(nstream)
    valid = j >= k - 1
    xv = np.where(valid, x, INF)
    mins = _sliding_min(xv, w)
    complete = j >= w + k - 2
    mmax = _sliding_max_ahead(np.where(complete, mins, np.uint64(0)), w)
    emit = valid & (xv == mmax)
    # a read with no complete window: the newest minimum of its last w
    short = np.flatnonzero((nstream >= k) & (nstream < w + k - 1))
    if len(short):
        ends = np.cumsum(nstream)
        for r in short:
            lo = max(ends[r] - nstream[r] + k - 1, ends[r] - w)
            win = xv[lo:ends[r]]
            last = lo + len(win) - 1 - int(np.argmin(win[::-1]))
            emit[last] = True
    sel = np.flatnonzero(emit)
    pos = (off[keep[sel]] - pad).astype(np.uint64)
    strand = (fwd[sel] > rev[sel]).astype(np.uint64)
    y = ((rids[seg[sel]].astype(np.uint64) << np.uint64(32))
         | (pos << np.uint64(1)) | strand)
    counts = np.bincount(seg[sel], minlength=n)
    return x[sel], y, counts


def reduce_level(x: np.ndarray, y: np.ndarray, counts: np.ndarray, r: int):
    """One reduction level over per-read runs of records."""
    n_all = len(x)
    if n_all == 0:
        return x, y, counts
    seg, off = _seg_index(counts)
    key = ((x >> np.uint64(8)) << np.uint64(8)) | (off % r).astype(np.uint64)
    best = key.copy()
    arg = np.arange(n_all, dtype=np.int64)
    for d in range(1, r):
        cand = _shift(key, d, INF)
        better = cand < best
        best = np.where(better, cand, best)
        arg = np.where(better, np.arange(n_all, dtype=np.int64) - d, arg)
    full = off >= r - 1
    t = np.flatnonzero(full)
    chosen = arg[t]
    first = np.ones(len(t), bool)
    first[1:] = (chosen[1:] != chosen[:-1]) | (seg[t[1:]] != seg[t[:-1]])
    pick = chosen[first]
    return x[pick], y[pick], np.bincount(seg[pick], minlength=len(counts))


def index_block(seqs, rids, w, k, r, levels, keep_l0, hash_bits=0):
    x0, y0, c0 = sketch_block(seqs, rids, w, k, hash_bits)
    x, y, c = x0, y0, c0
    for _ in range(levels):
        x, y, c = reduce_level(x, y, c, r)
    return (x, y), ((x0, y0) if keep_l0 else None)


def counts_of(x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Distinct hashes of records, ascending, and their multiplicities."""
    h, c = np.unique(x >> np.uint64(8), return_counts=True)
    return h, c.astype(np.uint32)


BLOCK_BASES = 8_000_000   # bases a block of whole reads, on one thread


def build(reads_iter, w: int, k: int, r: int, levels: int, keep_l0: bool,
          workers: int = 4, hash_bits: int = 0):
    """The index of reads given in rid order as ACGT uint8 arrays:
    {"L": (x, y, mer, count), "L0": (...) or None}."""
    blocks, cur, cur_b, rid = [], [], 0, 0
    for s in reads_iter:
        cur.append(s)
        cur_b += len(s)
        if cur_b >= BLOCK_BASES:
            blocks.append((cur, np.arange(rid, rid + len(cur))))
            rid += len(cur)
            cur, cur_b = [], 0
    if cur:
        blocks.append((cur, np.arange(rid, rid + len(cur))))
    with cf.ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        futs = [ex.submit(index_block, s, ids, w, k, r, levels, keep_l0,
                          hash_bits) for s, ids in blocks]
        parts = [f.result() for f in futs]
    out = {}
    for name, i in (("L", 0), ("L0", 1)):
        if name == "L0" and not keep_l0:
            out[name] = None
            continue
        x = np.concatenate([p[i][0] for p in parts]) if parts else \
            np.zeros(0, np.uint64)
        y = np.concatenate([p[i][1] for p in parts]) if parts else \
            np.zeros(0, np.uint64)
        out[name] = (x, y) + counts_of(x)
    return out
