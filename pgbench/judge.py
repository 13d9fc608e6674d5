"""The comparison that decides `correct`: an assembly's outputs against
the plain reference, from the reads and the seeded genome alone.

It reads the output files of one assembly (the index, preads.ovl, the
draft and the polished contigs) only to judge them, and imports nothing
of the program.  Numbers, each with a limit ("worse" is higher):

* index_diff   records and count entries of stage 1 (the final level, and
               level 0 where kept) that differ from refindex's;
* ovl_gap      over a seeded sample of preads.ovl rows, the largest amount
               (percentage points) by which a row's identity exceeds the
               identity of an optimal alignment of the spans it names;
* ovl_miss     the share (%) of the true neighbour pairs that preads.ovl
               lacks: reads next to each other along one sequence of the
               genome, neither inside another read, that overlap by half
               a read or more;
* genome_miss  the share (%) of the genome that no placed 2 kb piece of
               the draft contigs covers (a genome of one sequence);
* cns_err      where the cell polishes: edit distance per 100 bases of a
               seeded sample of polished pieces against the genome (a
               genome of one sequence).
"""

from __future__ import annotations

import os

import numpy as np

from gen import read_fasta, revcomp
import refindex

_MM128 = np.dtype([("x", "<u8"), ("y", "<u8")])
_MMCOUNT = np.dtype({"names": ["mer", "count"], "formats": ["<u8", "<u4"],
                     "offsets": [0, 8], "itemsize": 16})
_UPPER = np.arange(256, dtype=np.uint8)
_UPPER[np.frombuffer(b"acgtn", np.uint8)] = np.frombuffer(b"ACGTN", np.uint8)
PIECE = 2000
PLACE_K = 24
BIG = np.int32(1 << 29)


# --- reading the program's files ------------------------------------------
def read_mmlist(path: str):
    with open(path, "rb") as f:
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        rec = np.fromfile(f, _MM128, count=n)
    return rec["x"].copy(), rec["y"].copy()


def count_records(path: str) -> int:
    """The record count in an index file's header."""
    with open(path, "rb") as f:
        return int(np.frombuffer(f.read(8), "<u8")[0])


def read_mm_count(path: str):
    with open(path, "rb") as f:
        n = int(np.frombuffer(f.read(8), "<u8")[0])
        rec = np.fromfile(f, _MMCOUNT, count=n)
    return rec["mer"].copy(), rec["count"].copy()


def read_ovl(path: str) -> np.ndarray:
    """preads.ovl rows as an int64 array of (a, b, -m, idt*10, 0, a_bgn,
    a_end, a_len, strand, b_bgn, b_end, b_len)."""
    rows = []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"-"):
                break
            v = line.split()
            rows.append((int(v[0]), int(v[1]), int(v[2]),
                         round(float(v[3]) * 10), 0, int(v[5]), int(v[6]),
                         int(v[7]), int(v[8]), int(v[9]), int(v[10]),
                         int(v[11])))
    return np.array(rows, np.int64).reshape(-1, 12)


# --- stage 1 -----------------------------------------------------------------
def _diff_records(px, py, rx, ry) -> int:
    """Records in one list and not the other, plus one if the order of the
    shared ones differs."""
    if len(px) == len(rx) and (px == rx).all() and (py == ry).all():
        return 0
    a = np.stack([px, py], 1)
    b = np.stack([rx, ry], 1)
    ua = np.unique(a, axis=0)
    ub = np.unique(b, axis=0)
    both = np.concatenate([ua, ub])
    _, cnt = np.unique(both, axis=0, return_counts=True)
    only = int((cnt == 1).sum()) + (len(a) - len(ua)) + (len(b) - len(ub))
    return max(only, 1)


def _diff_counts(ph, pc, rh, rc) -> int:
    if len(ph) == len(rh) and (ph == rh).all() and (pc == rc).all():
        return 0
    keys = np.union1d(ph, rh)
    a = np.zeros(len(keys), np.int64)
    b = np.zeros(len(keys), np.int64)
    a[np.searchsorted(keys, ph)] = pc
    b[np.searchsorted(keys, rh)] = rc
    return max(int((a != b).sum()), 1)


def index_diff(outdir: str, ref: dict, levels: int) -> int:
    d = os.path.join(outdir, "1-index")
    total = 0
    for name, lev in (("L", levels), ("L0", 0)):
        if ref.get(name) is None:
            continue
        rx, ry, rh, rc = ref[name]
        px, py = read_mmlist(os.path.join(d, f"shmr-L{lev}-01-of-01.dat"))
        ph, pc = read_mm_count(os.path.join(d, f"shmr-L{lev}-MC-01-of-01.dat"))
        total += _diff_records(px, py, rx, ry) + _diff_counts(ph, pc, rh, rc)
    return total


# --- banded dynamic programming --------------------------------------------
def band_dp(qs: list, ts: list, half: int, free_ends: bool) -> np.ndarray:
    """Edit distances of each query to its target, in a band of `half`
    cells either side of the diagonal: global (the target's ends fixed)
    or, with free_ends, the query anywhere in the target, whose first and
    last `half` bases are margin.  All pairs advance row by row at once."""
    n = len(qs)
    if n == 0:
        return np.zeros(0, np.int64)
    W = 2 * half + 1
    lq = np.array([len(q) for q in qs], np.int64)
    lt = np.array([len(t) for t in ts], np.int64)
    R = int(lq.max())
    Q = np.zeros((n, R + 1), np.uint8)
    for i, q in enumerate(qs):
        Q[i, 1:len(q) + 1] = q
    C = int(lt.max()) + 2 * W + 2
    T = np.full((n, C), 255, np.uint8)
    for i, t in enumerate(ts):
        T[i, W + 1:W + 1 + len(t)] = t

    def centre(i):
        if free_ends:
            return np.minimum(i, lq) + half
        return (np.minimum(i, lq) * lt) // np.maximum(lq, 1)

    ks = np.arange(W, dtype=np.int64)[None, :]
    c_prev = centre(0)
    j = c_prev[:, None] - half + ks
    if free_ends:
        D = np.where((j >= 0) & (j <= lt[:, None]), 0, BIG).astype(np.int32)
    else:
        D = np.where((j >= 0) & (j <= lt[:, None]), j, BIG).astype(np.int32)
    rows = np.arange(n)[:, None]
    kk = np.arange(W, dtype=np.int32)[None, :]
    done = np.zeros(n, np.int64)
    result = np.zeros(n, np.int64)
    for i in range(1, R + 1):
        c = centre(i)
        s = (c - c_prev)[:, None]
        Dp = np.concatenate([np.full((n, 1), BIG, np.int32), D,
                             np.full((n, W + 2), BIG, np.int32)], 1)
        up = Dp[rows, 1 + ks + s]
        diag = Dp[rows, ks + s]
        j = c[:, None] - half + ks
        tj = T[rows, np.clip(j + W, 0, C - 1)]  # t[j-1]
        cost = (tj != Q[:, i:i + 1]).astype(np.int32)
        new = np.minimum(diag + cost, up + 1)
        ok = (j >= 0) & (j <= lt[:, None])
        new = np.where(ok, new, BIG)
        # a gap along the row: D[k] = min over k' <= k of D[k'] + (k - k')
        new = np.minimum.accumulate(new - kk, axis=1) + kk
        new = np.where(ok, np.minimum(new, BIG), BIG)
        live = i <= lq
        D = np.where(live[:, None], new, D)
        c_prev = np.where(live, c, c_prev)
        fin = live & (i == lq) & (done == 0)
        if fin.any():
            if free_ends:
                result[fin] = D[fin].min(1)
            else:
                kend = (lt - c_prev + half)[fin]
                result[fin] = np.where((kend >= 0) & (kend < W),
                                       D[fin, np.clip(kend, 0, W - 1)], BIG)
            done[fin] = 1
    return result


# --- stage 2 -----------------------------------------------------------------
def ovl_gap(outdir: str, reads: list, rng: np.random.Generator,
            sample: int, half: int = 64, alter: bool = False) -> float:
    """The largest gap over `sample` rows drawn by rng (infinite where
    preads.ovl has no row).  alter=True is the planted fault of a wrong
    answer: each sampled row names the next read as its b read."""
    rows = read_ovl(os.path.join(outdir, "2-ovlp", "preads.ovl"))
    if len(rows) == 0:
        return float("inf")
    pick = rng.choice(len(rows), min(sample, len(rows)), replace=False)
    qs, ts, idt = [], [], []
    for r in rows[pick]:
        a, b = int(r[0]), int(r[1])
        if alter:
            b = (b + 1) % len(reads)
        qa = reads[a][r[5]:r[6]]
        tb = reads[b][r[9]:r[10]]
        qs.append(qa)
        ts.append(revcomp(tb) if r[8] else tb)
        idt.append(r[3] / 10.0)
    d = band_dp(qs, ts, half, free_ends=False)
    la = np.array([len(q) for q in qs])
    lb = np.array([len(t) for t in ts])
    ref_idt = 100.0 - 100.0 * d / np.maximum(1, (la + lb + 2 * d) / 2)
    return float(np.max(np.array(idt) - ref_idt))


def ovl_pairs(path: str) -> np.ndarray:
    """The read pairs of preads.ovl's rows as keys min << 32 | max."""
    a, b = [], []
    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"-"):
                break
            v = line.split(None, 2)
            a.append(int(v[0]))
            b.append(int(v[1]))
    a, b = np.array(a, np.int64), np.array(b, np.int64)
    return np.unique(np.minimum(a, b) << 32 | np.maximum(a, b))


def true_pairs(layout: np.ndarray, g_len: int, circular: bool,
               min_ovl: int) -> np.ndarray:
    """Keys (min << 32 | max) of the pairs of reads that lie next to each
    other along the genome, once the reads inside another read are left
    out, and overlap by min_ovl bases or more.  layout holds each read's
    (start in the source, length before the errors, strand); on a
    circular genome the reads at its origin also meet those at its end."""
    start = layout[:, 0] % g_len if circular else layout[:, 0].copy()
    end = start + layout[:, 1]
    rid = np.arange(len(layout), dtype=np.int64)
    if circular:
        again = start < int(layout[:, 1].max())   # a turn on, past the end
        start = np.r_[start, start[again] + g_len]
        end = np.r_[end, end[again] + g_len]
        rid = np.r_[rid, rid[again]]
    order = np.lexsort((-end, start))   # by start, the longest first
    start, end, rid = start[order], end[order], rid[order]
    reach = np.maximum.accumulate(np.r_[np.int64(-1), end[:-1]])
    inside = np.zeros(len(layout), bool)
    inside[rid[end <= reach]] = True
    keep = ~inside[rid]
    start, end, rid = start[keep], end[keep], rid[keep]
    ok = (end[:-1] - start[1:] >= min_ovl) & (rid[:-1] != rid[1:])
    a, b = rid[:-1][ok], rid[1:][ok]
    return np.unique(np.minimum(a, b) << 32 | np.maximum(a, b))


def true_pairs_within(layout: np.ndarray, lens: list, circular: list,
                      min_ovl: int) -> np.ndarray:
    """true_pairs of the reads of each sequence of a genome (lens and
    circular, each a sequence's), by the sequence in layout's fourth
    column: no pair crosses from one sequence to another."""
    keys = []
    for s, (n, c) in enumerate(zip(lens, circular)):
        rid = np.flatnonzero(layout[:, 3] == s)
        if len(rid) > 1:
            k = true_pairs(layout[rid], n, c, min_ovl)
            a, b = rid[k >> 32], rid[k & 0xFFFFFFFF]
            keys.append(np.minimum(a, b) << 32 | np.maximum(a, b))
    return np.unique(np.concatenate(keys)) if keys else np.zeros(0, np.int64)


def ovl_miss(outdir: str, truth: np.ndarray) -> float:
    """% of the true neighbour pairs that preads.ovl has no row for."""
    have = ovl_pairs(os.path.join(outdir, "2-ovlp", "preads.ovl"))
    if len(truth) == 0:
        return 0.0
    return 100.0 * float((~np.isin(truth, have)).sum()) / len(truth)


# --- contigs against the genome ----------------------------------------------
class GenomeIndex:
    """Unique 24-mers of a genome and its reverse complement, for placing
    pieces of contigs (a circular genome's k-mers across its origin
    included)."""

    def __init__(self, g: np.ndarray, circular: bool):
        self.g = g
        self.circular = circular
        ksrc = np.concatenate([g, g[:PLACE_K - 1]]) if circular else g
        self.klen = len(ksrc)
        # forward bases to cut targets from, past the origin if circular
        self.src = np.concatenate([g, g[:4 * PIECE]]) if circular else g
        keys = np.concatenate([_kmers(ksrc), _kmers(revcomp(ksrc))])
        order = np.argsort(keys)
        keys = keys[order]
        uniq = np.ones(len(keys), bool)
        same = keys[1:] == keys[:-1]
        uniq[1:] &= ~same
        uniq[:-1] &= ~same
        self.keys, self.pos = keys[uniq], order[uniq]
        self.nf = self.klen - PLACE_K + 1

    def place_all(self, pieces: list) -> list:
        """(strand, forward start) of each piece, or None where fewer than
        8 of its k-mers (every 4th) agree on one diagonal."""
        if not pieces:
            return []
        lens = np.array([len(p) for p in pieces], np.int64)
        km, at, pid = [], [], []
        for i, p in enumerate(pieces):
            k = _kmers(p)[::4]
            km.append(k)
            at.append(np.arange(len(k), dtype=np.int64) * 4)
            pid.append(np.full(len(k), i, np.int64))
        km, at, pid = np.concatenate(km), np.concatenate(at), np.concatenate(pid)
        i = np.minimum(np.searchsorted(self.keys, km), len(self.keys) - 1)
        hit = self.keys[i] == km
        p = self.pos[i[hit]]
        at, pid = at[hit], pid[hit]
        strand = (p >= self.nf).astype(np.int64)
        diag = np.where(strand == 1, p - self.nf, p) - at
        # votes by (piece, strand, 32-base band of diagonals)
        key = (pid << 42) | (strand << 41) | ((diag + (1 << 30)) // 32)
        vals, first, cnt = np.unique(key, return_index=True,
                                     return_counts=True)
        owner = vals >> 42
        best = np.full(len(pieces), -1, np.int64)
        best_n = np.zeros(len(pieces), np.int64)
        order = np.lexsort((cnt, owner))   # each piece's largest vote last
        last = np.r_[owner[order][1:] != owner[order][:-1], True]
        top = order[last]
        best[owner[top]] = top
        best_n[owner[top]] = cnt[top]
        out = []
        keysort = np.argsort(key, kind="stable")
        ks = key[keysort]
        for i in range(len(pieces)):
            if best_n[i] < 8:
                out.append(None)
                continue
            v = vals[best[i]]
            a, e = np.searchsorted(ks, v), np.searchsorted(ks, v, "right")
            sel = keysort[a:e]
            s_, d = int(strand[sel][0]), int(np.median(diag[sel]))
            fs = self.klen - d - int(lens[i]) if s_ else d
            if self.circular:
                fs %= len(self.g)
            out.append((s_, fs))
        return out

    def target(self, strand: int, fs: int, n: int, half: int) -> np.ndarray:
        """The genome under a placed piece with `half` bases either side,
        on the piece's strand; margin past a linear genome's ends is a
        letter that matches nothing."""
        if self.circular and fs < half:
            fs += len(self.g)
        lo, hi = fs - half, fs + n + half
        t = self.src[max(0, lo):min(len(self.src), hi)]
        t = np.concatenate([np.full(max(0, -lo), 254, np.uint8), t,
                            np.full(max(0, hi - len(self.src)), 254, np.uint8)])
        return revcomp(t) if strand else t


def _kmers(s: np.ndarray) -> np.ndarray:
    """The 2-bit 24-mer ending at each position from the 24th on (any
    letter but ACGT counts as A)."""
    c = refindex._CODE[_UPPER[s]]
    c[c > 3] = 0
    if len(s) < PLACE_K:
        return np.zeros(0, np.uint64)
    return refindex._roll(c, PLACE_K, newest_high=False)[PLACE_K - 1:]


def contig_pieces(path: str) -> list:
    out = []
    for _, s in read_fasta(path):
        s = _UPPER[s]
        for a in range(0, len(s) - PIECE // 4 + 1, PIECE):
            out.append(s[a:a + PIECE])
    return out


def genome_miss(gi: GenomeIndex, pieces: list) -> tuple:
    """(% of the genome no placed piece covers, placed pieces)."""
    covered, placed = _cover(gi, pieces)
    return 100.0 * (1 - int(covered.sum()) / len(gi.g)), placed


def uncovered(gi: GenomeIndex, pieces: list, min_len: int) -> list:
    """The stretches of min_len bases or more that no placed piece covers,
    as (start, end) on the genome."""
    covered, _ = _cover(gi, pieces)
    edge = np.flatnonzero(np.diff(np.r_[1, covered.astype(np.int8), 1]))
    return [(int(a), int(e)) for a, e in zip(edge[::2], edge[1::2])
            if e - a >= min_len]


def _cover(gi: GenomeIndex, pieces: list) -> tuple:
    g_len = len(gi.g)
    cover = np.zeros(g_len + 1, np.int64)
    placed = []
    for p, at in zip(pieces, gi.place_all(pieces)):
        if at is None:
            continue
        placed.append((p, at))
        a = max(0, at[1])
        e = min(at[1] + len(p), len(gi.src))
        for lo, hi in ((a, min(e, g_len)), (max(a - g_len, 0), e - g_len)):
            if hi > lo:
                cover[lo] += 1
                cover[hi] -= 1
    return np.cumsum(cover[:g_len]) > 0, placed


def piece_err(gi: GenomeIndex, placed: list, rng: np.random.Generator,
              sample: int, half: int = 48) -> float:
    """Edit distance per 100 bases of a seeded sample of placed pieces,
    each aligned anywhere within its voted window of the genome."""
    if not placed:
        return float("inf")
    pick = rng.choice(len(placed), min(sample, len(placed)), replace=False)
    qs = [placed[i][0] for i in pick]
    ts = [gi.target(*placed[i][1], len(placed[i][0]), half) for i in pick]
    d = band_dp(qs, ts, half, free_ends=True)
    return float(100.0 * d.sum() / sum(len(q) for q in qs))
