"""The port's device pair map (--device-pairs), run on the CPU, against the
host pair map and bucket stream of the port and against the JAX
package's build_pairs_device: every array equal, dtypes included.

Shapes of the reference's tests/test_device_pairs.py (30 kb genome, 3 kb
reads, 12x, k=12 w=24 r=4), default and tight gates, plus k=28 with
hashes rewritten to lie at or above 2^55, where x = hash << 8 | span
sets bit 63 and only an unsigned order sorts the records right.
"""

import numpy as np
import pytest
import torch

from peregrine_tpu.ops.device_pairs import build_pairs_device as jax_pairs
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io.seqdb import SeqDB
from peregrine_tpu_torch.ops.device_pairs import build_pairs_device
from peregrine_tpu_torch.ops.index import ShimmerIndex, _merge_counts, build_index
from peregrine_tpu_torch.ops.overlap import bucket_stream, build_pairs
from peregrine_tpu_torch.simdata import random_genome, simulate_reads

torch.set_num_threads(2)

GATES = {"default": (2, 240, 100), "tight": (3, 6, 50)}
OVLP_UPPER = 120


def _high(idx: ShimmerIndex) -> ShimmerIndex:
    """The same records with every hash moved to [2^55, 2^56) by a
    bijection (xor with a 56-bit constant whose top bit is set), so the
    multiplicities and the pairs stay, and x uses all 64 bits."""
    h = (idx.x >> np.uint64(8)) ^ np.uint64((1 << 55) | 0x5A5A5A5A5A5A)
    x = (h << np.uint64(8)) | (idx.x & np.uint64(0xFF))
    assert (x >> np.uint64(63)).all()
    mh, mc = _merge_counts(x >> np.uint64(8), np.ones(len(x), np.uint32))
    return ShimmerIndex(x, idx.y.copy(), mh, mc)


@pytest.fixture(scope="module")
def indexes():
    rng = np.random.default_rng(42)
    genome = random_genome(rng, 30000)
    reads, _ = simulate_reads(rng, genome, read_len=3000, coverage=12.0)
    db = SeqDB.from_reads(reads)
    out = {}
    for k in (12, 28):
        cfg = AsmConfig(k=k, w=24, r=4, levels=2, sketch_pad_len=8192,
                        sketch_batch=16)
        out[k] = build_index(db, cfg, "cpu")
    out["28-high"] = _high(out[28])
    return db, out


def _host(idx, lengths, lo, up, md):
    pairs = build_pairs(idx, lengths, 1, 1, lo, up, md)
    return pairs, bucket_stream(pairs[0], pairs[1], pairs[2], pairs[4],
                                OVLP_UPPER)


def _assert_same(a, b, what):
    assert len(a) == len(b)
    for i, (x, y) in enumerate(zip(a, b)):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype, f"{what}[{i}] dtype {x.dtype} {y.dtype}"
        np.testing.assert_array_equal(x, y, err_msg=f"{what}[{i}]")


@pytest.mark.parametrize("gates", sorted(GATES))
@pytest.mark.parametrize("k", [12, 28, "28-high"])
def test_device_pairs_match_host_and_jax(indexes, k, gates):
    db, idx = indexes
    idx = idx[k]
    lo, up, md = GATES[gates]
    pairs, stream = build_pairs_device(idx, db.lengths, "cpu", lo, up, md,
                                       OVLP_UPPER)
    hp, hs = _host(idx, db.lengths, lo, up, md)
    assert len(hp[0]) > 0 and len(hs[0]) > 0
    _assert_same(pairs, hp, "pairs")
    _assert_same(stream, hs, "stream")
    jp, js = jax_pairs(idx, db.lengths, lo, up, md, OVLP_UPPER)
    for i, (a, b) in enumerate(zip(pairs + stream, jp + js)):
        np.testing.assert_array_equal(a, b, err_msg=f"vs JAX [{i}]")


@pytest.mark.parametrize("n", [0, 1])
def test_fewer_than_two_records(indexes, n):
    db, idx = indexes
    idx = idx[12]
    small = ShimmerIndex(idx.x[:n], idx.y[:n], *_merge_counts(
        idx.x[:n] >> np.uint64(8), np.ones(n, np.uint32)))
    pairs, stream = build_pairs_device(small, db.lengths, "cpu")
    _assert_same(pairs, _host(small, db.lengths, 2, 240, 100)[0], "pairs")
    assert all(len(a) == 0 for a in pairs + stream)
    assert [a.dtype for a in stream] == [np.uint64, np.uint8, np.int64,
                                         np.int64, np.int64]


@pytest.mark.parametrize("gates", [(500, 600, 100), (2, 240, 1 << 30)])
def test_no_candidates(indexes, gates):
    """No count in the gate, or no pair far enough apart: empty outputs
    of the host build's dtypes."""
    db, idx = indexes
    pairs, stream = build_pairs_device(idx[12], db.lengths, "cpu", *gates)
    hp, hs = _host(idx[12], db.lengths, *gates)
    _assert_same(pairs, hp, "pairs")
    _assert_same(stream, hs, "stream")
    assert len(pairs[0]) == 0
