"""The port's ops against the JAX package's on the CPU: the seqdb gather,
the sketch (batch and long), the flat reduction and the index build.

Same inputs from a seed go to both packages; all values are integers and
the tolerance is exact equality (and identical .dat bytes for the index).
"""

import filecmp

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from peregrine_tpu.config import AsmConfig as JaxConfig
from peregrine_tpu.io.seqdb import SeqDB as JaxSeqDB
from peregrine_tpu.io.seqdb import seq_to_codes
from peregrine_tpu.ops import dbgather as jdb
from peregrine_tpu.ops import index as jindex
from peregrine_tpu.ops import reduce as jreduce
from peregrine_tpu.ops import sketch as jsketch
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io.seqdb import SeqDB
from peregrine_tpu_torch.ops import dbgather, index, reduce, sketch
from tests import oracles
from tests.conftest import random_seq
from tests.simdata import random_genome, simulate_reads
from tests.test_dbgather import _oracle, _random_db

torch.set_num_threads(2)

CPU = "cpu"


def _pairs(x, y):
    return list(zip(x.tolist(), y.tolist()))


# --- gather_codes ------------------------------------------------------

@pytest.mark.parametrize("fill", [4, 7])
def test_gather_codes_matches_jax(rng, fill):
    data, offsets, lengths = _random_db(rng)
    pdb = dbgather.upload_seqdb(data, CPU)
    jpdb = jdb.upload_seqdb(data)
    np.testing.assert_array_equal(pdb.fw.numpy(), np.asarray(jpdb.fw))
    np.testing.assert_array_equal(pdb.amb.numpy(), np.asarray(jpdb.amb))

    Bq, L = 64, 4096
    rid = rng.integers(0, len(offsets), Bq)
    shift = np.minimum(rng.integers(0, 300, Bq), lengths[rid] - 1)
    off = offsets[rid] + shift
    ln = (lengths[rid] - shift).astype(np.int32)
    strand = rng.integers(0, 2, Bq).astype(np.int32)
    goff = dbgather.gather_offsets(off, ln, strand, offsets[rid], L)
    got = dbgather.gather_codes(pdb, torch.from_numpy(goff),
                                torch.from_numpy(ln),
                                torch.from_numpy(strand), L, fill).numpy()
    want = np.asarray(jdb.gather_codes(jpdb, jnp.asarray(goff),
                                       jnp.asarray(ln), jnp.asarray(strand),
                                       L, fill=fill))
    np.testing.assert_array_equal(got, want)
    for b in range(0, Bq, 7):
        np.testing.assert_array_equal(
            got[b], _oracle(data, int(off[b]), int(ln[b]), int(strand[b]),
                            L, fill))


def test_gather_negative_mirror_start_from_jax_planes(rng):
    """A short strand-1 read at the very start of the db gathers from the
    guard region; the planes come from the JAX package's upload."""
    data, offsets, lengths = _random_db(rng, n_reads=3, min_len=100,
                                        max_len=200)
    jpdb = jdb.upload_seqdb(data)
    pdb = dbgather.packed_from_numpy(np.asarray(jpdb.fw),
                                     np.asarray(jpdb.amb), CPU)
    L = 1024
    ln = np.asarray([lengths[0]], np.int32)
    strand = np.ones(1, np.int32)
    goff = dbgather.gather_offsets(offsets[:1], ln, strand, offsets[:1], L)
    assert goff[0] < 0
    got = dbgather.gather_codes(pdb, torch.from_numpy(goff),
                                torch.from_numpy(ln),
                                torch.from_numpy(strand), L, 7).numpy()
    want = np.asarray(jdb.gather_codes(jpdb, jnp.asarray(goff),
                                       jnp.asarray(ln), jnp.asarray(strand),
                                       L, fill=7))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], _oracle(data, int(offsets[0]),
                                                  int(ln[0]), 1, L, 7))


# --- sketch ------------------------------------------------------------

def _batch(seqs, pad=None):
    pad = pad or max(len(s) for s in seqs)
    codes = np.full((len(seqs), pad), 4, np.uint8)
    lens = np.zeros(len(seqs), np.int32)
    for i, s in enumerate(seqs):
        codes[i, :len(s)] = seq_to_codes(s)
        lens[i] = len(s)
    return codes, lens


@pytest.mark.parametrize("w,k,n,with_n", [(80, 16, 2000, False),
                                          (12, 8, 777, False),
                                          (24, 12, 1200, False),
                                          (12, 8, 1500, True),
                                          (80, 16, 40, False)])
def test_sketch_batch_matches_jax_and_oracle(rng, w, k, n, with_n):
    seqs = [random_seq(rng, n + 17 * i, with_n=with_n) for i in range(4)]
    codes, lens = _batch(seqs, pad=-(-max(len(s) for s in seqs) // 128) * 128)
    rids = np.arange(len(seqs), dtype=np.uint32)
    x, y, c = sketch.sketch_batch(torch.from_numpy(codes),
                                  torch.from_numpy(lens),
                                  torch.from_numpy(rids.astype(np.int64)),
                                  w=w, k=k)
    jx, jy, jc = jax.device_get(jsketch.sketch_batch(
        jnp.asarray(codes), jnp.asarray(lens), jnp.asarray(rids), w=w, k=k))
    np.testing.assert_array_equal(c.numpy(), jc)
    for b in range(len(seqs)):
        np.testing.assert_array_equal(x[b, :c[b]].numpy().view(np.uint64),
                                      jx[b, :jc[b]])
        np.testing.assert_array_equal(y[b, :c[b]].numpy().view(np.uint64),
                                      jy[b, :jc[b]])
    cx, cy, cc = sketch.sketch_batch_capped(
        torch.from_numpy(codes), torch.from_numpy(lens),
        torch.from_numpy(rids.astype(np.int64)), w=w, k=k, cap=64)
    assert torch.equal(cx, x[:, :64]) and torch.equal(cy, y[:, :64])
    assert torch.equal(cc, c)
    gx, gy = sketch.sketch_reads_np(codes, lens, rids, w, k, CPU)
    if not with_n:  # with N's the sketch is a documented superset
        want = []
        for rid, s in enumerate(seqs):
            want.extend(oracles.mm_sketch(s, w, k, rid))
        assert _pairs(gx, gy) == want


def test_sketch_long_matches_jax(rng):
    codes = seq_to_codes(random_seq(rng, 100_000))
    seg, margin = 1 << 12, 1 << 10
    gx, gy = sketch.sketch_long_np(codes, 7, 80, 16, CPU, seg=seg,
                                   margin=margin)
    jx, jy = jsketch.sketch_long_np(codes, 7, 80, 16, seg=seg, margin=margin)
    np.testing.assert_array_equal(gx, jx)
    np.testing.assert_array_equal(gy, jy)
    # and the single-shot sketch of the whole sequence
    x, y, c = sketch.sketch_batch(
        torch.from_numpy(np.pad(codes, (0, 2048), constant_values=4)[None]),
        torch.tensor([len(codes)], dtype=torch.int32),
        torch.tensor([7]), w=80, k=16)
    assert _pairs(gx, gy) == _pairs(x[0, :c[0]].numpy().view(np.uint64),
                                    y[0, :c[0]].numpy().view(np.uint64))


def test_sketch_long_cap_overflow_refetch(rng):
    """w=3 makes every segment overflow the capped fetch; the exact
    refetch must still return the single-shot emission set."""
    codes = seq_to_codes(random_seq(rng, 30_000))
    gx, gy = sketch.sketch_long_np(codes, 3, 3, 12, CPU, seg=1 << 12,
                                   margin=1 << 10)
    batch = np.full((1, 1 << 15), 4, np.uint8)
    batch[0, :len(codes)] = codes
    jx, jy, jc = jax.device_get(jsketch.sketch_batch(
        jnp.asarray(batch), jnp.asarray([len(codes)], np.int32),
        jnp.asarray([3], np.uint32), w=3, k=12))
    # a segment row (6144 wide, cap 768) holds ~3000 minimizers: overflow
    assert jc[0] / len(codes) * (6 << 10) > 2 * max(256, (6 << 10) // 8)
    assert _pairs(gx, gy) == _pairs(jx[0, :jc[0]], jy[0, :jc[0]])


# --- reduce ------------------------------------------------------------

@pytest.mark.parametrize("w,k,r", [(12, 8, 6), (12, 8, 3), (5, 4, 6),
                                   (80, 16, 6)])
def test_reduce_flat_matches_jax(rng, w, k, r):
    seqs = [random_seq(rng, 3000 + 11 * i) for i in range(5)]
    seqs.append(random_seq(rng, 60))   # fewer than r minimizers
    codes, lens = _batch(seqs)
    x, y = sketch.sketch_reads_np(codes, lens, np.arange(len(seqs)), w, k, CPU)
    for _ in range(2):  # L1, then L2
        gx, gy = reduce.reduce_flat_np(x, y, r, CPU)
        jx, jy = jreduce.reduce_flat_np(x, y, r)
        np.testing.assert_array_equal(gx, jx)
        np.testing.assert_array_equal(gy, jy)
        assert _pairs(gx, gy) == oracles.mm_reduce(_pairs(x, y), r)
        x, y = gx, gy


def test_reduce_flat_tie_slot_break():
    x = np.array([(5 << 8) | 16, (5 << 8) | 16, (7 << 8) | 16,
                  (5 << 8) | 16, (9 << 8) | 16], dtype=np.uint64)
    y = np.array([(1 << 32) | (p << 1) for p in (10, 20, 30, 40, 50)],
                 dtype=np.uint64)
    gx, gy = reduce.reduce_flat_np(x, y, 3, CPU)
    jx, jy = jreduce.reduce_flat_np(x, y, 3)
    np.testing.assert_array_equal(gx, jx)
    np.testing.assert_array_equal(gy, jy)
    assert _pairs(gx, gy) == oracles.mm_reduce(_pairs(x, y), 3)


def test_reduce_flat_rejects_wide_spans():
    """The packed planes hold 32-bit hashes: their route rejects spans
    above 16, and reduce_flat_np sends such lists to reduce_impl."""
    x = np.array([(5 << 8) | 20, (9 << 8) | 20, (5 << 8) | 20,
                  (2 << 8) | 20, (7 << 8) | 20, (5 << 8) | 20,
                  (1 << 8) | 20, (8 << 8) | 20], dtype=np.uint64)
    y = np.arange(8, dtype=np.uint64) << np.uint64(1)
    with pytest.raises(ValueError):
        reduce._reduce_packed(x, y, 3, CPU)
    gx, gy = reduce.reduce_flat_np(x, y, 3, CPU)
    jx, jy = jreduce.reduce_flat_np(x, y, 3)
    np.testing.assert_array_equal(gx, jx)
    np.testing.assert_array_equal(gy, jy)
    assert _pairs(gx, gy) == oracles.mm_reduce(_pairs(x, y), 3)


# --- build_index -------------------------------------------------------

def _both_indexes(reads, **cfg):
    jidx = jindex.build_index(JaxSeqDB.from_reads(reads), JaxConfig(**cfg))
    tidx = index.build_index(SeqDB.from_reads(reads), AsmConfig(**cfg), CPU)
    for f in ("x", "y", "mc_hash", "mc_count"):
        np.testing.assert_array_equal(getattr(tidx, f), getattr(jidx, f),
                                      err_msg=f)
    return jidx, tidx


def _assert_same_files(jidx, tidx, tmp_path, level):
    jidx.save(str(tmp_path / "jax" / "shmr"), level=level)
    tidx.save(str(tmp_path / "torch" / "shmr"), level=level)
    for name in (f"shmr-L{level}-01-of-01.dat", f"shmr-L{level}-MC-01-of-01.dat"):
        assert filecmp.cmp(tmp_path / "jax" / name, tmp_path / "torch" / name,
                           shallow=False), name


def test_build_index_matches_jax_and_oracle(rng, tmp_path):
    """Most reads are longer than sketch_pad_len here: the long route."""
    reads = [(f"r{i}", random_seq(rng, int(rng.integers(800, 3000))))
             for i in range(12)]
    cfg = dict(k=8, w=12, r=4, levels=2, sketch_pad_len=1024, sketch_batch=8)
    jidx, tidx = _both_indexes(reads, **cfg)
    want = []
    for rid, (_, s) in enumerate(reads):
        l1 = oracles.mm_reduce(oracles.mm_sketch(s, 12, 8, rid), 4)
        want.extend(oracles.mm_reduce(l1, 4))
    assert _pairs(tidx.x, tidx.y) == want
    _assert_same_files(jidx, tidx, tmp_path, 2)


def test_build_index_cap_overflow_retry(rng, tmp_path):
    """w=3 overflows the per-batch cap: the exact retry must fire."""
    genome = random_genome(rng, 20000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=6.0)
    jidx, tidx = _both_indexes(reads, k=12, w=3, r=4, levels=1,
                               sketch_pad_len=4096, sketch_batch=16)
    _assert_same_files(jidx, tidx, tmp_path, 1)
    # the batches really overflow their cap (max(256, pad // 8) = 512)
    codes, lens = SeqDB.from_reads(reads).padded_code_batch(range(16), 4096)
    *_, c0 = index.index_step(torch.from_numpy(codes), torch.from_numpy(lens),
                              torch.arange(16), w=3, k=12, r=4, levels=1,
                              cap=512)
    assert (c0 > 512).any()


def test_build_index_reads_and_one_long_read(rng, tmp_path):
    genome = random_genome(rng, 30000)
    reads, _ = simulate_reads(rng, genome, read_len=2500, coverage=8.0)
    reads.insert(5, ("long", genome[:20000]))   # > sketch_pad_len
    jidx, tidx = _both_indexes(reads, k=12, w=24, r=4, levels=2,
                               sketch_pad_len=8192, sketch_batch=16)
    _assert_same_files(jidx, tidx, tmp_path, 2)
    # the JAX package's packed planes give the same index
    db = SeqDB.from_reads(reads)
    jp = jdb.upload_seqdb(np.asarray(db.data))
    again = index.build_index(
        db, AsmConfig(k=12, w=24, r=4, levels=2, sketch_pad_len=8192,
                      sketch_batch=16), CPU,
        packed=dbgather.packed_from_numpy(np.asarray(jp.fw),
                                          np.asarray(jp.amb), CPU))
    np.testing.assert_array_equal(again.x, tidx.x)
    np.testing.assert_array_equal(again.y, tidx.y)


def test_index_files_load_across_packages(rng, tmp_path):
    """Index files written by either package load in the other with the
    same records and counts; counts_for gives 0 for unseen hashes."""
    reads = [(f"r{i}", random_seq(rng, 1500)) for i in range(8)]
    jidx, tidx = _both_indexes(reads, k=12, w=24, r=4, levels=2,
                               sketch_pad_len=2048, sketch_batch=8)
    _assert_same_files(jidx, tidx, tmp_path, 2)
    for pkg, load in (("jax", index.ShimmerIndex.load_chunks),
                      ("torch", jindex.ShimmerIndex.load_chunks)):
        got = load([str(tmp_path / pkg / "shmr-L2-01-of-01.dat")],
                   [str(tmp_path / pkg / "shmr-L2-MC-01-of-01.dat")])
        for f in ("x", "y", "mc_hash", "mc_count"):
            np.testing.assert_array_equal(getattr(got, f), getattr(tidx, f),
                                          err_msg=f"{pkg} {f}")
    h, c = np.unique(tidx.x >> np.uint64(8), return_counts=True)
    np.testing.assert_array_equal(tidx.counts_for(h), c)
    unseen = np.setdiff1d(np.arange(1, 64, dtype=np.uint64), h)
    assert (tidx.counts_for(unseen) == 0).all()
