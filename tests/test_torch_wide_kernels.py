"""The wide route's three kernels on the CPU: wide_stream, wide_emit and
reduce_wide, whose plain versions are what the CPU runs and what the card
compares the CUDA kernels against.

The three plain versions, composed with compact_planes' as sketch_wide
and reduce_impl compose the wrappers, equal the JAX package's
sketch_batch and reduce_impl (XLA on the CPU) on the edge-case rows of
tests/torch_kernel_cases.py, and build_index with the level-0 index
equals the JAX package's at k = 17 and 24 (k = 28 is in
test_torch_wide.py).  wide_emit's plain version is also held to a numpy
transliteration of the emission rule.  Every value is an integer, so
the tolerance is exact equality, of whole rows where the function defines
them past the counts (the fills).  The wrappers' CUDA branch is checked
with the kernel library stubbed out: one launch each, with the arguments
of its C prototype, and none for an empty shape.
"""

import re
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from peregrine_tpu.config import AsmConfig as JaxConfig
from peregrine_tpu.io.seqdb import SeqDB as JaxSeqDB
from peregrine_tpu.ops import index as jindex
from peregrine_tpu.ops import reduce as jreduce
from peregrine_tpu.ops import sketch as jsketch
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io.seqdb import SeqDB
from peregrine_tpu_torch.ops import index, kernels as kn, reduce, sketch
from tests.simdata import random_genome, simulate_reads
import torch_kernel_cases as kernel_cases

torch.set_num_threads(2)

B, L = 16, 640
CHUNK = 256  # where kernel_cases puts its features at these small shapes
INF = kn.INF


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _i64(a: np.ndarray) -> torch.Tensor:
    return _t(a.view(np.int64))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


# --- the sketch: wide_stream -> compact_planes -> wide_emit -> compact ----

def _sketch_plain(codes, lens, rids, w, k):
    """The three plain versions composed as sketch_wide composes them."""
    x, y, li, keep = kn.wide_stream_plain(codes, lens, rids, k)
    (sx, sy, sl), n = kn.compact_planes_plain(keep, (x, y, li),
                                              (INF, INF, 0))
    emit = kn.wide_emit_plain(sx, sl, n, w, k)
    (ox, oy), count = kn.compact_planes_plain(emit, (sx, sy), (INF, INF))
    return ox, oy, count


@pytest.mark.parametrize("k,w", [(17, 80), (24, 24), (28, 80), (28, 5)])
def test_plain_versions_compose_to_the_jax_sketch(k, w):
    """kernel_cases.wide_stream_codes (empty rows, a row shorter than k,
    ambiguous runs at the boundaries, (AT)* runs whose k-mers are all
    strand-symmetric at even k, lengths on and beside a boundary): whole
    rows equal the JAX sketch, and the wrappers' CPU route is the same."""
    rng = np.random.default_rng(k * 1000 + w)
    codes, lens = kernel_cases.wide_stream_codes(rng, B, L, k, CHUNK)
    rids = rng.integers(0, 2**31, B).astype(np.int64)
    got = _sketch_plain(_t(codes), _t(lens), _t(rids), w, k)
    jx, jy, jc = jax.device_get(jsketch.sketch_batch(
        jnp.asarray(codes), jnp.asarray(lens),
        jnp.asarray(rids.astype(np.uint32)), w=w, k=k))
    np.testing.assert_array_equal(got[2].numpy(), jc)
    np.testing.assert_array_equal(_u64(got[0]), jx)
    np.testing.assert_array_equal(_u64(got[1]), jy)
    wrapped = sketch.sketch_batch(_t(codes), _t(lens), _t(rids), w=w, k=k)
    for a, b in zip(wrapped, got):
        assert torch.equal(a, b)
    assert (jc > 0).any() and (jc == 0).any()


def test_wide_stream_plain_outputs(rng):
    """wide_stream's planes on crafted rows: nothing kept past a row's
    length, the placeholders kept with run length 0 and no record, an
    (AT)* run at even k all symmetric (nothing kept, run 0 after it), and
    y carrying the rid, the position and the strand where x is defined."""
    k = 24
    codes, lens = kernel_cases.wide_stream_codes(rng, B, L, k, CHUNK)
    rids = np.arange(B, dtype=np.int64) + 2**31
    x, y, li, keep = (a.numpy() for a in kn.wide_stream_plain(
        _t(codes), _t(lens), _t(rids), k))
    col = np.arange(L)[None, :]
    inlen = col < lens[:, None]
    amb = (codes >= 4) & inlen
    assert not keep[~inlen].any() and (keep[amb]).all()
    assert not li[amb].any() and (x[amb] == INF).all()
    # row 10, (AT)* from column 0: only the first k - 1 k-mers, which
    # reach before the row's start, are not strand-symmetric
    assert keep[10, :k - 1].all() and not keep[10, k - 1:].any()
    assert (li[10, :k - 1] == np.arange(1, k)).all()
    defined = x != INF
    assert (li[defined] >= k).all() and (keep[defined]).all()
    yu = y.view(np.uint64)[defined]
    assert ((yu >> np.uint64(32)) == np.repeat(
        rids.astype(np.uint64), defined.sum(1))).all()
    assert (((yu & np.uint64(0xFFFFFFFF)) >> np.uint64(1)).astype(np.int64)
            == np.broadcast_to(col, (B, L))[defined]).all()
    assert ((x.view(np.uint64)[defined] & np.uint64(0xFF)) == k).all()


def _emit_oracle(sx: np.ndarray, sl: np.ndarray, n: np.ndarray, w: int,
                 k: int) -> np.ndarray:
    """The emission rule transliterated row by row in numpy uint64."""
    Bq, Lq = sx.shape
    out = np.zeros((Bq, Lq), bool)
    inf = np.uint64(2**64 - 1)
    for b in range(Bq):
        nb = int(n[b])
        s = sx[b]
        W = np.array([s[max(0, t - w + 1):t + 1].min() for t in range(Lq)])
        Ap = np.where((sl[b] >= w + k - 1) & (np.arange(Lq) < nb), W,
                      np.uint64(0))
        M = np.array([Ap[t:t + w].max() for t in range(Lq)])
        out[b, :nb] = ((s != inf) & (M == s))[:nb]
        if nb:
            lo = max(0, nb - w)
            m = s[lo:nb].min()
            if m != inf:
                out[b, lo + np.flatnonzero(s[lo:nb] == m)[-1]] = True
    return out


@pytest.mark.parametrize("w", [1, 5, 80, 255])
@pytest.mark.parametrize("ties", [False, True])
def test_wide_emit_plain_matches_the_rule(w, ties):
    """kernel_cases.wide_emit_stream (n 0, L and on a boundary, a final
    window across a boundary and one of a single repeated record, run
    lengths of w + k - 2 and w + k - 1 at the boundaries, placeholders on
    them; records at and above 2^63) at w = 1, 5, 80, 255."""
    k = 28
    rng = np.random.default_rng(w + 300 * ties)
    sx, sl, n = kernel_cases.wide_emit_stream(rng, B, L, w, k, CHUNK, ties)
    got = kn.wide_emit(_i64(sx), _t(sl), _t(n), w=w, k=k).numpy()
    want = _emit_oracle(sx, sl, n, w, k)
    np.testing.assert_array_equal(got, want)
    assert got[4].any() and (sx[sx != np.uint64(2**64 - 1)]
                             >= np.uint64(2**63)).any()


@pytest.mark.parametrize("r", [2, 6, 255])
@pytest.mark.parametrize("ties", [False, True])
def test_reduce_wide_plain_matches_jax(r, ties):
    """kernel_cases.wide_reduce_rows (counts 0, r - 2, r - 1, on and
    beside a boundary, L; the least hash before each boundary; equal
    records; equal y; junk past the counts): whole rows, fills included,
    equal the JAX reduce_impl, and reduce_impl is reduce_wide."""
    rng = np.random.default_rng(r + 500 * ties)
    x, y, count = kernel_cases.wide_reduce_rows(rng, B, L, r, CHUNK, ties)
    got = kn.reduce_wide_plain(_i64(x), _i64(y), _t(count), r)
    jx, jy, jc = jax.device_get(jreduce.reduce_batch(
        jnp.asarray(x), jnp.asarray(y), jnp.asarray(count), r=r))
    np.testing.assert_array_equal(got[2].numpy(), jc)
    np.testing.assert_array_equal(_u64(got[0]), jx)
    np.testing.assert_array_equal(_u64(got[1]), jy)
    for a, b in zip(reduce.reduce_impl(_i64(x), _i64(y), _t(count), r=r),
                    got):
        assert torch.equal(a, b)
    assert got[2][9] == (1 if count[9] >= r else 0)


@pytest.mark.parametrize("k", [17, 24])
def test_build_index_with_l0_matches_jax(rng, k):
    """build_index with the level-0 index at k = 17 and 24 (the wide
    route's three kernels in both levels and the long route), as
    test_torch_wide.py runs it at k = 28."""
    genome = random_genome(rng, 30000)
    reads, _ = simulate_reads(rng, genome, read_len=2500, coverage=5.0)
    reads.insert(3, ("long", genome[:12000]))
    cfg = dict(k=k, w=24, r=4, levels=2, sketch_pad_len=8192,
               sketch_batch=16)
    jout = jindex.build_index(JaxSeqDB.from_reads(reads), JaxConfig(**cfg),
                              keep_l0=True)
    tout = index.build_index(SeqDB.from_reads(reads), AsmConfig(**cfg), "cpu",
                             keep_l0=True)
    assert len(tout) == 2
    for j, t in zip(jout, tout):
        for f in ("x", "y", "mc_hash", "mc_count"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                          err_msg=f)


# --- the wrappers ----------------------------------------------------------

def test_wrappers_refuse_bad_dtypes_and_shapes():
    codes = torch.zeros((2, 8), dtype=torch.uint8)
    lens = torch.zeros(2, dtype=torch.int32)
    rids = torch.zeros(2, dtype=torch.int64)
    x = torch.zeros((2, 8), dtype=torch.int64)
    sl = torch.zeros((2, 8), dtype=torch.int32)
    bad = [
        lambda: kn.wide_stream(codes, lens, rids, k=29),
        lambda: kn.wide_stream(codes, lens, rids, k=0),
        lambda: kn.wide_stream(codes.int(), lens, rids, k=20),
        lambda: kn.wide_stream(codes, lens.long(), rids, k=20),
        lambda: kn.wide_stream(codes, lens, rids.int(), k=20),
        lambda: kn.wide_stream(codes, lens[:1], rids, k=20),
        lambda: kn.wide_stream(codes.t(), lens, rids, k=20),
        lambda: kn.wide_emit(x, sl, lens, w=0, k=20),
        lambda: kn.wide_emit(x, sl, lens, w=256, k=20),
        lambda: kn.wide_emit(x, sl, lens, w=5, k=29),
        lambda: kn.wide_emit(x.int(), sl, lens, w=5, k=20),
        lambda: kn.wide_emit(x, sl.long(), lens, w=5, k=20),
        lambda: kn.wide_emit(x, sl[:, :4], lens, w=5, k=20),
        lambda: kn.wide_emit(x, sl, lens.long(), w=5, k=20),
        lambda: kn.reduce_wide(x, x, lens, r=0),
        lambda: kn.reduce_wide(x, x, lens, r=256),
        lambda: kn.reduce_wide(x.int(), x, lens, r=4),
        lambda: kn.reduce_wide(x, x[:, :4], lens, r=4),
        lambda: kn.reduce_wide(x, x, lens.long(), r=4),
        lambda: kn.reduce_wide(x[:, ::2], x[:, ::2], lens, r=4),
        lambda: kn.reduce_wide(x, x, torch.zeros((2, 1), dtype=torch.int32),
                               r=4),
    ]
    for call in bad:
        with pytest.raises(ValueError):
            call()


def test_chunk_layout_matches_the_source():
    """reduce_wide's status is sized from REDUCE_WIDE_CHUNK, which the
    kernel knows as kWRChunk; wide_stream's from CHUNK (kChunk)."""
    with open(kn._CU) as f:
        src = f.read()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kWRChunk"]) == kn.REDUCE_WIDE_CHUNK
    assert int(const["kChunk"]) == kn.CHUNK
    assert "wide_stream_kernel<<<B * chunks, kChunkThreads" in src


class _Launches:
    """The kernel library stubbed out on the CPU: each wrapper takes its
    CUDA branch and every C entry it calls is recorded with its arguments
    instead of launched."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(kn, "_route", lambda *t: "cuda")
        monkeypatch.setattr(kn, "_status_pairs", {})
        monkeypatch.setattr(kn, "library", lambda: types.SimpleNamespace(**{
            name: name for name in kn.SIGNATURES}))
        monkeypatch.setattr(kn, "_call", lambda fn, *args:
                            self.calls.append((fn, args)))

    def names(self):
        return [fn for fn, _ in self.calls]


def test_each_wrapper_is_one_launch(monkeypatch):
    """wide_stream (which writes the compacted stream and its counts) and
    reduce_wide are one chunked launch each, with the look-back status
    sized by CHUNK and REDUCE_WIDE_CHUNK; wide_emit one launch with no
    status; each counts it; the arguments follow the C prototypes
    (SIGNATURES, checked against the .cu file by test_torch_kernels.py)."""
    launches = _Launches(monkeypatch)
    Bq, Lq = 3, kn.CHUNK + 1
    codes = torch.zeros((Bq, Lq), dtype=torch.uint8)
    lens = torch.full((Bq,), Lq, dtype=torch.int32)
    rids = torch.arange(Bq, dtype=torch.int64)
    before = [fn.launches for fn in kn.KERNELS]
    x, y, sl, n = kn.wide_stream(codes, lens, rids, k=28)
    [(fn, args)] = launches.calls
    assert fn == "pg_wide_stream"
    assert args[:3] == (codes, lens, rids)
    assert args[3].numel() == kn.STATUS_SLOT * (1 + Bq * 2)
    assert args[5] == 0  # the first launch: no earlier status to zero
    assert args[6:] == (x, y, sl, n, Bq, Lq, 28)
    assert (x.dtype, y.dtype, sl.dtype, n.dtype) == (
        torch.int64, torch.int64, torch.int32, torch.int32)
    assert x.shape == sl.shape == (Bq, Lq) and n.shape == (Bq,)

    launches.calls.clear()
    emit = kn.wide_emit(x, sl, lens, w=80, k=28)
    [(fn, args)] = launches.calls
    assert fn == "pg_wide_emit"
    assert args == (x, sl, lens, emit, Bq, Lq, 80, 28)
    assert emit.dtype == torch.bool and emit.shape == (Bq, Lq)

    launches.calls.clear()
    C = kn.REDUCE_WIDE_CHUNK + 1
    xr = torch.zeros((Bq, C), dtype=torch.int64)
    ox, oy, count = kn.reduce_wide(xr, xr.clone(), lens, r=6)
    [(fn, args)] = launches.calls
    assert fn == "pg_reduce_wide" and args[0] is xr and args[2] is lens
    assert args[3].numel() == kn.STATUS_SLOT * (1 + Bq * 2)
    assert args[6:] == (ox, oy, count, Bq, C, C, 6)
    after = [fn.launches for fn in kn.KERNELS]
    assert [a - b for a, b in zip(after, before)] == ([0] * 5 + [1, 1, 1]
                                                      + [0, 0, 0, 0, 0])


def test_sketch_wide_and_reduce_impl_are_kernel_launches_only(monkeypatch):
    """On the card, sketch_wide is wide_stream (the compacted stream),
    wide_emit and compact_planes, and a reduce_impl level one reduce_wide
    launch: no other work sits between them."""
    launches = _Launches(monkeypatch)
    Bq, Lq = 2, 300
    codes = torch.zeros((Bq, Lq), dtype=torch.uint8)
    lens = torch.full((Bq,), Lq, dtype=torch.int32)
    x, y, c = sketch.sketch_wide(codes, lens, torch.arange(Bq), w=80, k=28)
    assert launches.names() == ["pg_wide_stream", "pg_wide_emit",
                                "pg_compact_planes"]
    launches.calls.clear()
    reduce.reduce_impl(x, y, c, r=6)
    assert launches.names() == ["pg_reduce_wide"]


@pytest.mark.parametrize("Bq,Lq", [(0, 64), (3, 0)])
def test_empty_shapes_launch_nothing(monkeypatch, Bq, Lq):
    """B = 0 or L = 0: no launch, the shapes of the outputs, and
    wide_stream's and reduce_wide's counts, which the kernels write
    themselves, zero; the plain versions agree."""
    codes = torch.zeros((Bq, Lq), dtype=torch.uint8)
    lens = torch.zeros(Bq, dtype=torch.int32)
    rids = torch.zeros(Bq, dtype=torch.int64)
    x = torch.zeros((Bq, Lq), dtype=torch.int64)
    sl = torch.zeros((Bq, Lq), dtype=torch.int32)

    def run():
        *out, n = kn.wide_stream(codes, lens, rids, k=28)
        assert all(a.shape == (Bq, Lq) for a in out)
        assert n.shape == (Bq,) and not n.any()
        assert kn.wide_emit(x, sl, lens, w=5, k=28).shape == (Bq, Lq)
        ox, oy, count = kn.reduce_wide(x, x, lens, r=6)
        assert ox.shape == (Bq, Lq) and count.shape == (Bq,)
        assert not count.any()

    run()
    launches = _Launches(monkeypatch)
    empty = torch.empty  # unset memory made visible: -7 in every word
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **kw: empty(*a, **kw).fill_(-7))
    run()
    assert launches.calls == []


def test_gather_codes_without_strands_reads_forward(rng):
    """The index builds gather with strand None: the same codes as strand
    0 for every window, without the flips."""
    from peregrine_tpu_torch.ops import dbgather

    reads = [("r%d" % i, random_genome(rng, 300 + 57 * i)) for i in range(5)]
    db = SeqDB.from_reads(reads)
    pdb = dbgather.upload_seqdb(db.data, "cpu")
    goff = torch.from_numpy(db.offsets.astype(np.int64))
    lens = torch.from_numpy(db.lengths.astype(np.int32))
    assert torch.equal(
        dbgather.gather_codes(pdb, goff, lens, None, 640, fill=4),
        dbgather.gather_codes(pdb, goff, lens, torch.zeros_like(lens), 640,
                              fill=4))
