"""The port's wide (k > 16) path against the JAX package's, on the CPU:
compact_planes (plain version), hash64 under a 56-bit mask, the wide
sketch, reduce_impl, the long-sequence route and build_index (with and
without the level-0 index).

Same numpy inputs from a seed go to both packages.  Every value is an
integer, so the tolerance is exact equality, of whole rows where the
function defines them past the counts (compact_planes' fills).  At k=28
a record x = hash << 8 | span fills all 64 bits, so the tests put hashes
at and above 2^55 (records at and above 2^63) where minima are taken.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from peregrine_tpu.config import AsmConfig as JaxConfig
from peregrine_tpu.io.seqdb import SeqDB as JaxSeqDB
from peregrine_tpu.io.seqdb import seq_to_codes
from peregrine_tpu.ops import compact_pallas as pl
from peregrine_tpu.ops import index as jindex
from peregrine_tpu.ops import reduce as jreduce
from peregrine_tpu.ops import sketch as jsketch
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io.seqdb import SeqDB
from peregrine_tpu_torch.ops import index, kernels as kn, reduce, sketch
from tests import oracles
from tests.conftest import random_seq
from tests.simdata import random_genome, simulate_reads
import torch_kernel_cases as kernel_cases

torch.set_num_threads(2)

CPU = "cpu"
B = 8
BIG = 1 << 63  # records at or above it hold a hash >= 2^55


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _pairs(x, y):
    return list(zip(x.tolist(), y.tolist()))


# --- compact_planes ------------------------------------------------------

@pytest.mark.parametrize("p", [0.9, 0.05, 0.0, 1.0])
def test_compact_planes_plain_matches_pallas(rng, p):
    """u32 planes (int32 bits in torch) with two fills, whole rows."""
    L = 512
    keep = rng.random((B, L)) < p
    a = rng.integers(0, 2**32, (B, L)).astype(np.uint32)
    b = rng.integers(0, 2**32, (B, L)).astype(np.uint32)
    (ja, jb), jc = pl.compact_planes(jnp.asarray(keep.astype(np.int32)),
                                     (jnp.asarray(a), jnp.asarray(b)),
                                     (0xFFFFFFFF, 7), interpret=True)
    (ta, tb), tc = kn.compact_planes(_t(keep), (_t(a.view(np.int32)),
                                                _t(b.view(np.int32))),
                                     (0xFFFFFFFF, 7))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(ta.numpy().view(np.uint32), np.asarray(ja))
    np.testing.assert_array_equal(tb.numpy().view(np.uint32), np.asarray(jb))


@pytest.mark.parametrize("p", [0.98, 0.03, 0.0, 1.0])
def test_compact_planes_plain_matches_shift_compact(rng, p):
    """Two int64 planes and one int32 plane, as the wide sketch moves
    them, against the JAX package's XLA compaction: whole rows."""
    L = 640
    keep = rng.random((B, L)) < p
    x = rng.integers(0, 2**64, (B, L), dtype=np.uint64)
    y = rng.integers(0, 2**64, (B, L), dtype=np.uint64)
    li = rng.integers(-2**31, 2**31, (B, L)).astype(np.int32)
    (jx, jy, jl), jc = jsketch._shift_compact(
        jnp.asarray(keep), [jnp.asarray(x), jnp.asarray(y), jnp.asarray(li)],
        fills=[jsketch.INF, jsketch.INF, jnp.int32(0)])
    (tx, ty, tl), tc = kn.compact_planes(
        _t(keep), (_t(x.view(np.int64)), _t(y.view(np.int64)), _t(li)),
        (sketch.INF, sketch.INF, 0))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(_u64(tx), np.asarray(jx))
    np.testing.assert_array_equal(_u64(ty), np.asarray(jy))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("L,chunk", [(255, 256), (256, 256), (257, 256),
                                     (640, 256),
                                     (kn.COMPACT_CHUNK + 1, kn.COMPACT_CHUNK)])
def test_compact_planes_plain_on_chunk_boundary_rows(rng, L, chunk):
    """kernel_cases.compact_rows (nothing or everything kept, a single kept
    column beside a boundary, counts on a boundary, whole chunks dropped;
    L = chunk - 1, chunk, chunk + 1), whole rows: the wide sketch's planes
    against the JAX package's XLA compaction at any L, and u32 planes
    against the Pallas kernel in interpret mode where its tiling allows
    (B % 8 == 0, L % 128 == 0)."""
    Bc = 16
    keep = kernel_cases.compact_rows(rng, Bc, L, chunk)
    x = rng.integers(0, 2**64, (Bc, L), dtype=np.uint64)
    y = rng.integers(0, 2**64, (Bc, L), dtype=np.uint64)
    li = rng.integers(-2**31, 2**31, (Bc, L)).astype(np.int32)
    (jx, jy, jl), jc = jsketch._shift_compact(
        jnp.asarray(keep), [jnp.asarray(x), jnp.asarray(y), jnp.asarray(li)],
        fills=[jsketch.INF, jsketch.INF, jnp.int32(0)])
    (tx, ty, tl), tc = kn.compact_planes(
        _t(keep), (_t(x.view(np.int64)), _t(y.view(np.int64)), _t(li)),
        (sketch.INF, sketch.INF, 0))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(tc.numpy(), keep.sum(1))
    np.testing.assert_array_equal(_u64(tx), np.asarray(jx))
    np.testing.assert_array_equal(_u64(ty), np.asarray(jy))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    if Bc % 8 == 0 and L % 128 == 0:
        a = x.astype(np.uint32)
        (ja,), jc = pl.compact_planes(jnp.asarray(keep.astype(np.int32)),
                                      (jnp.asarray(a),), (0xFFFFFFFF,),
                                      interpret=True)
        (ta,), tc = kn.compact_planes(_t(keep), (_t(a.view(np.int32)),),
                                      (0xFFFFFFFF,))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ta.numpy().view(np.uint32),
                                      np.asarray(ja))


def test_compact_planes_rejects_bad_planes():
    keep = torch.zeros((2, 8), dtype=torch.bool)
    x = torch.zeros((2, 8), dtype=torch.int64)
    with pytest.raises(ValueError):
        kn.compact_planes(keep, (x,) * 4, (0,) * 4)
    with pytest.raises(ValueError):
        kn.compact_planes(keep, (x.float(),), (0,))
    with pytest.raises(ValueError):
        kn.compact_planes(keep.int(), (x,), (0,))


# --- hash64 and the wide sketch --------------------------------------------

@pytest.mark.parametrize("k", [17, 24, 28])
def test_hash64_56bit_matches_jax(rng, k):
    """Keys near the top of the 2k-bit space, where every step wraps."""
    mask = (1 << (2 * k)) - 1
    keys = np.concatenate([
        rng.integers(0, mask + 1, 500, dtype=np.uint64),
        mask - rng.integers(0, 1000, 500, dtype=np.uint64),
        np.asarray([0, 1, mask, mask >> 1, (mask >> 1) + 1], np.uint64)])
    want = np.asarray(jsketch.hash64(jnp.asarray(keys), jnp.uint64(mask)))
    got = kn.hash64(_t(keys.view(np.int64)), mask).numpy().view(np.uint64)
    np.testing.assert_array_equal(got, want)
    assert (want > mask >> 1).any()
    assert [oracles.hash64(int(v), mask) for v in keys[:50]] == \
        want[:50].tolist()


def _batch(seqs, pad):
    codes = np.full((len(seqs), pad), 4, np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = seq_to_codes(s)
        lens[i] = len(s)
    return codes, lens


def _sketch_both(codes, lens, w, k):
    rids = np.arange(len(lens), dtype=np.uint32)
    x, y, c = sketch.sketch_batch(_t(codes), _t(lens),
                                  _t(rids.astype(np.int64)), w=w, k=k)
    jx, jy, jc = jax.device_get(jsketch.sketch_batch(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(rids), w=w, k=k))
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_array_equal(_u64(x), jx)
    np.testing.assert_array_equal(_u64(y), jy)
    return _u64(x), _u64(y), c.numpy()


@pytest.mark.parametrize("w,k", [(80, 17), (24, 24), (80, 28), (3, 28),
                                 (1, 28)])
def test_sketch_wide_matches_jax_and_oracle(rng, w, k):
    """Whole rows against the JAX sketch, tie-heavy rows included;
    emission lists of the random rows against the transliterated
    reference (on ties at a read's first complete window the emission
    set is a documented superset).  At w <= 3 minima are often large:
    the emitted records include hashes >= 2^55."""
    seqs = [random_seq(rng, 700 + 131 * i) for i in range(3)]
    seqs += [random_seq(rng, 40), b"A" * 300, (b"AC" * 200)]
    codes, lens = _batch(seqs, 1280)
    x, y, c = _sketch_both(codes, lens, w, k)
    for b, s in enumerate(seqs[:4]):
        assert _pairs(x[b, :c[b]], y[b, :c[b]]) == \
            oracles.mm_sketch(s, w, k, b), f"row {b}"
    if w <= 3:
        emitted = np.concatenate([x[b, :c[b]] for b in range(len(seqs))])
        assert (emitted >= BIG).any()


@pytest.mark.parametrize("k", [17, 28])
def test_sketch_wide_with_ambiguous_bases_matches_jax(rng, k):
    seqs = [random_seq(rng, 900 + 77 * i, with_n=True) for i in range(6)]
    codes, lens = _batch(seqs, 1408)
    lens[1] = 0
    _sketch_both(codes, lens, 24, k)


def test_sketch_batch_k_range():
    codes = torch.full((1, 64), 4, dtype=torch.uint8)
    lens = torch.tensor([64], dtype=torch.int32)
    with pytest.raises(ValueError):
        sketch.sketch_batch(codes, lens, torch.tensor([0]), w=10, k=29)
    x, y, c = sketch.sketch_batch(codes, lens, torch.tensor([0]), w=10, k=28)
    assert c.tolist() == [0] and (x == sketch.INF).all()


@pytest.mark.parametrize("w", [5, 80])
def test_final_window_newest_tie_wins(w):
    """Reads of one repeated k-mer (poly-A): every window entry ties, and
    the held minimum of the final window is its newest entry, the read's
    last position."""
    seqs = [b"A" * 300, b"A" * 60, b"A" * 29]
    codes, lens = _batch(seqs, 384)
    x, y, c = _sketch_both(codes, lens, w, 28)
    for b, s in enumerate(seqs):
        assert c[b] > 0
        assert int(y[b, c[b] - 1] & np.uint64(0xFFFFFFFF)) >> 1 == len(s) - 1


def test_unsigned_window_extrema(rng):
    """_sliding_min_trailing / _sliding_max_leading order records as
    uint64: values on both sides of 2^63, against numpy's uint64."""
    L, w = 300, 7
    a = rng.integers(0, 2**64, (4, L), dtype=np.uint64)
    a[0, ::3] = np.uint64(2**64 - 1)
    a[1] = rng.integers(2**63 - 5, 2**63 + 5, L, dtype=np.uint64)
    t = _t(a.view(np.int64))
    mn = _u64(sketch._sliding_min_trailing(t, w, sketch.INF))
    mx = _u64(sketch._sliding_max_leading(t, w, 0))
    for j in range(L):
        np.testing.assert_array_equal(mn[:, j], a[:, max(0, j - w + 1):j + 1]
                                      .min(axis=1))
        np.testing.assert_array_equal(mx[:, j], a[:, j:j + w].max(axis=1))


# --- reduce_impl -----------------------------------------------------------

def _records(rng, k, C, ties):
    count = rng.integers(0, C, B).astype(np.int32)
    count[0], count[1] = 0, C
    if ties:  # few distinct hashes, half of them >= 2^55
        pool = np.concatenate([rng.integers(1, 2**20, 4, dtype=np.uint64),
                               rng.integers(2**55, 2**56, 4, dtype=np.uint64)])
        h = pool[rng.integers(0, len(pool), (B, C))]
    else:
        h = rng.integers(0, 2**56, (B, C), dtype=np.uint64)
    x = (h << np.uint64(8)) | np.uint64(k)
    pos = np.sort(rng.choice(2**20, (B, C)), axis=1).astype(np.uint64)
    y = ((np.arange(B, dtype=np.uint64)[:, None] << np.uint64(32))
         | (pos << np.uint64(1)) | rng.integers(0, 2, (B, C), dtype=np.uint64))
    hole = np.arange(C)[None, :] >= count[:, None]
    inf = np.uint64(2**64 - 1)
    return np.where(hole, inf, x), np.where(hole, inf, y), count


@pytest.mark.parametrize("k,r", [(17, 6), (24, 4), (28, 6), (28, 2)])
@pytest.mark.parametrize("ties", [False, True])
def test_reduce_impl_matches_jax_and_oracle(rng, k, r, ties):
    C = 384
    x, y, count = _records(rng, k, C, ties)
    jx, jy, jc = jax.device_get(jreduce.reduce_batch(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(count), r=r))
    tx, ty, tc = reduce.reduce_impl(_t(x.view(np.int64)), _t(y.view(np.int64)),
                                    _t(count), r=r)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(_u64(tx), jx)
    np.testing.assert_array_equal(_u64(ty), jy)
    for b in (1, 2):
        rec = _pairs(x[b, :count[b]], y[b, :count[b]])
        assert _pairs(_u64(tx)[b, :tc[b]], _u64(ty)[b, :tc[b]]) == \
            oracles.mm_reduce(rec, r)
    assert (_u64(tx)[tx.numpy() != -1] >= BIG).any()


def test_reduce_flat_k28_matches_jax(rng):
    seqs = [random_seq(rng, 2500 + 13 * i) for i in range(5)]
    seqs.append(random_seq(rng, 70))   # fewer than r minimizers
    codes, lens = _batch(seqs, 2560)
    x, y = sketch.sketch_reads_np(codes, lens, np.arange(len(seqs)), 5, 28,
                                  CPU)
    for _ in range(2):
        gx, gy = reduce.reduce_flat_np(x, y, 4, CPU)
        jx, jy = jreduce.reduce_flat_np(x, y, 4)
        np.testing.assert_array_equal(gx, jx)
        np.testing.assert_array_equal(gy, jy)
        assert _pairs(gx, gy) == oracles.mm_reduce(_pairs(x, y), 4)
        x, y = gx, gy


def test_sketch_long_k28_matches_jax(rng):
    """The segmented long route at k=28, with a w that overflows the
    capped fetch (the exact refetch), and at the default w."""
    codes = seq_to_codes(random_seq(rng, 30_000))
    for w in (80, 3):
        gx, gy = sketch.sketch_long_np(codes, 7, w, 28, CPU, seg=1 << 12,
                                       margin=1 << 10)
        jx, jy = jsketch.sketch_long_np(codes, 7, w, 28, seg=1 << 12,
                                        margin=1 << 10)
        np.testing.assert_array_equal(gx, jx)
        np.testing.assert_array_equal(gy, jy)


# --- build_index -----------------------------------------------------------

def _assert_same(jidx, tidx):
    for f in ("x", "y", "mc_hash", "mc_count"):
        np.testing.assert_array_equal(getattr(tidx, f), getattr(jidx, f),
                                      err_msg=f)


@pytest.mark.parametrize("k,keep_l0", [(28, False), (28, True), (12, True)])
def test_build_index_matches_jax(rng, k, keep_l0):
    """Reads in two pad buckets and one read past sketch_pad_len (the
    long route), with and without the level-0 index."""
    genome = random_genome(rng, 30000)
    reads, _ = simulate_reads(rng, genome, read_len=2500, coverage=5.0)
    reads.insert(3, ("long", genome[:12000]))
    cfg = dict(k=k, w=24, r=4, levels=2, sketch_pad_len=8192,
               sketch_batch=16)
    jout = jindex.build_index(JaxSeqDB.from_reads(reads), JaxConfig(**cfg),
                              keep_l0=keep_l0)
    tout = index.build_index(SeqDB.from_reads(reads), AsmConfig(**cfg), CPU,
                             keep_l0=keep_l0)
    if keep_l0:
        assert len(tout) == 2
        for j, t in zip(jout, tout):
            _assert_same(j, t)
    else:
        _assert_same(jout, tout)


def test_build_index_k24_cap_overflow_retry(rng):
    """w=3 at k=24 overflows the per-batch cap: the exact retry fires."""
    genome = random_genome(rng, 20000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=6.0)
    cfg = dict(k=24, w=3, r=4, levels=1, sketch_pad_len=4096,
               sketch_batch=16)
    _assert_same(jindex.build_index(JaxSeqDB.from_reads(reads),
                                    JaxConfig(**cfg)),
                 index.build_index(SeqDB.from_reads(reads), AsmConfig(**cfg),
                                   CPU))
    codes, lens = SeqDB.from_reads(reads).padded_code_batch(range(16), 4096)
    *_, c0 = index.index_step(_t(codes), _t(lens), torch.arange(16), w=3,
                              k=24, r=4, levels=1, cap=512)
    assert (c0 > 512).any()
