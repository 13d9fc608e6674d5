"""The wide (k > 16) stage-1 tail against the JAX package, on the CPU:
reduce_wide_drain_plain (the final reduction level with the drain as its
store stage) against the JAX reduce_impl followed by _compact_drain,
several batches through one cursor; reduce_wide on [:, :cap] views of
wider planes, which the step now hands it in place of copies; the new
and changed wrappers' input checks and launch arguments (the kernel
library stubbed out); and build_index at k=28 through the step's fused
final level, with and without the level-0 index, against the JAX
package's.

The same numpy inputs go to both packages.  Every value is an integer,
so the tolerance is exact equality.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from peregrine_tpu.config import AsmConfig as JaxConfig
from peregrine_tpu.io.seqdb import SeqDB as JaxSeqDB
from peregrine_tpu.ops import index as jindex
from peregrine_tpu.ops import reduce as jreduce
from peregrine_tpu_torch.config import AsmConfig
from peregrine_tpu_torch.io.seqdb import SeqDB
from peregrine_tpu_torch.ops import index, kernels as kn
import torch_kernel_cases as kernel_cases

torch.set_num_threads(2)

G, B = 3, 16  # batches through one cursor, rows (the crafted ten and more)
WIDTH = 40    # below many rows' level counts
WC = kn.REDUCE_WIDE_CHUNK


def _i64(a):
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int64))


def _batches(C, r):
    """G batches of wide_reduce_rows at k=28 (hashes of 56 bits, about
    half >= 2^55; counts 0, r - 2, r - 1, on and beside a chunk boundary,
    C; the least hash before each boundary; equal records; equal y; junk
    past the counts), the second tie-heavy, with sketch counts c0 >= n."""
    rng = np.random.default_rng(C + r)
    out = []
    for g in range(G):
        x, y, n = kernel_cases.wide_reduce_rows(rng, B, C, r, WC, g == 1)
        c0 = (n + rng.integers(0, 50, B)).astype(np.int32)
        out.append((x, y, n, c0))
    return out


def _jax_stream(batches, r):
    """The JAX package's records: each batch's level (reduce_impl) cut to
    WIDTH columns, then _compact_drain of all of them, cut to its valid
    count; and the levels' counts."""
    xs, ys, cs = [], [], []
    for x, y, n, _ in batches:
        jx, jy, jc = jreduce.reduce_batch(jnp.asarray(x), jnp.asarray(y),
                                          jnp.asarray(n), r=r)
        xs.append(jx[:, :WIDTH])
        ys.append(jy[:, :WIDTH])
        cs.append(np.asarray(jc))
    x, y, total = jindex._compact_drain(jnp.stack(xs), jnp.stack(ys),
                                        jnp.asarray(np.stack(cs)))
    total = int(total)
    return np.asarray(x)[:total], np.asarray(y)[:total], cs


def _drain_all(fn, batches, out, counts, cursor, r):
    for x, y, n, c0 in batches:
        fn(_i64(x), _i64(y), torch.from_numpy(n), torch.from_numpy(c0),
           cursor, out, counts, r=r, width=WIDTH)


@pytest.mark.parametrize("C,r", [(WC - 1, 6), (WC + 1, 2), (WC + 1, 6),
                                 (5000, 6)])
def test_reduce_wide_drain_plain_matches_jax(C, r):
    """Three batches through one cursor: the stream equals the JAX
    package's level drained, with rows of n = 0, rows whose level count
    exceeds the width and records >= 2^63; the count slots hold (c0, the
    level's count) a batch; the cursors moved past the records and the
    slots; the wrapper takes the plain version on the CPU."""
    batches = _batches(C, r)
    want_x, want_y, cs = _jax_stream(batches, r)
    total = len(want_x)
    assert any((c > WIDTH).any() for c in cs)
    assert all((bt[2] == 0).any() for bt in batches)
    assert (want_x >= np.uint64(2**63)).any()
    runs = []
    for fn in (kn.reduce_wide_drain_plain, kn.reduce_wide_drain):
        out = torch.full((total + 9, 2), 7, dtype=torch.int64)
        counts = torch.zeros((G + 1, 2, B + 2), dtype=torch.int32)
        cursor = torch.zeros(3, dtype=torch.int64)
        _drain_all(fn, batches, out, counts, cursor, r)
        got = out.numpy().view(np.uint64)
        np.testing.assert_array_equal(got[:total, 0], want_x)
        np.testing.assert_array_equal(got[:total, 1], want_y)
        assert (out[total:] == 7).all()
        assert cursor.tolist() == [total, G, 0]
        for g, (_, _, _, c0) in enumerate(batches):
            np.testing.assert_array_equal(counts[g, 0, :B].numpy(), c0)
            np.testing.assert_array_equal(counts[g, 1, :B].numpy(), cs[g])
        assert not counts[G].any() and not counts[:, :, B:].any()
        runs.append((out, counts, cursor))
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_reduce_wide_drain_plain_is_the_level_then_the_drain():
    """The same batches give the stream, slots and cursor that
    reduce_wide_plain followed by drain_records_plain give, also into a
    stream that ends before the records and with no count slots."""
    batches = _batches(5000, 6)

    def level_then_drain(x, y, n, c0, cursor, out, counts, *, r, width):
        ox, oy, c = kn.reduce_wide_plain(x, y, n, r)
        kn.drain_records_plain(ox, oy, None, c, c0, cursor, out, counts,
                               k=28, width=width)

    for size, slots in ((2000, G), (150, G), (2000, None)):
        runs = []
        for fn in (kn.reduce_wide_drain_plain, level_then_drain):
            out = torch.full((size, 2), -3, dtype=torch.int64)
            counts = (None if slots is None else
                      torch.full((slots, 2, B), -5, dtype=torch.int32))
            cursor = torch.zeros(3, dtype=torch.int64)
            _drain_all(fn, batches, out, counts, cursor, 6)
            runs.append((out, counts, cursor))
        for a, b in zip(*runs):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("cap", [WC - 1, WC + 1, 3000])
def test_reduce_wide_reads_views_in_place(cap):
    """reduce_wide on [:, :cap] views of 5,000-column planes (counts past
    the cap among them, as a capped sketch's) equals the same call on
    contiguous copies and the JAX reduce_impl on the cut planes with the
    counts clamped to the cap, whole rows; the output is contiguous."""
    rng = np.random.default_rng(cap)
    x, y, n = kernel_cases.wide_reduce_rows(rng, B, 5000, 6, WC, False)
    assert (n > cap).any()
    tx, ty = _i64(x), _i64(y)
    got = kn.reduce_wide(tx[:, :cap], ty[:, :cap], torch.from_numpy(n), r=6)
    copied = kn.reduce_wide(tx[:, :cap].contiguous(),
                            ty[:, :cap].contiguous(), torch.from_numpy(n),
                            r=6)
    jx, jy, jc = jax.device_get(jreduce.reduce_batch(
        jnp.asarray(x[:, :cap]), jnp.asarray(y[:, :cap]),
        jnp.asarray(np.minimum(n, cap)), r=6))
    for a, b in zip(got, copied):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint64), jx)
    np.testing.assert_array_equal(got[1].numpy().view(np.uint64), jy)
    np.testing.assert_array_equal(got[2].numpy(), jc)
    assert got[0].is_contiguous() and got[0].shape == (B, cap)


def test_wrappers_check_their_inputs():
    """reduce_wide_drain raises on r outside 1..255, a width past the
    rows' columns, a row stride below the columns, planes of other
    strides or types, and an out not on a 16-byte boundary;
    reduce_wide and drain_records raise on a row stride below the
    columns (rows that overlap)."""
    x = torch.zeros((4, 12), dtype=torch.int64)
    n = torch.zeros(4, dtype=torch.int32)
    cursor = torch.zeros(3, dtype=torch.int64)
    rec = torch.zeros((50, 2), dtype=torch.int64)
    odd = torch.zeros(101, dtype=torch.int64)[1:].view(50, 2)
    over = torch.zeros(60, dtype=torch.int64).as_strided((4, 12), (11, 1))
    wide = torch.zeros((4, 20), dtype=torch.int64)

    def drain(a, b, out=rec, **kw):
        kw = dict(dict(r=6, width=10), **kw)
        kn.reduce_wide_drain(a, b, n, n, cursor, out, None, **kw)

    bad = [lambda: drain(x, x, r=0), lambda: drain(x, x, r=256),
           lambda: drain(x, x, width=13), lambda: drain(over, over),
           lambda: drain(x, x, out=odd), lambda: drain(x.int(), x.int()),
           lambda: drain(x, wide[:, :12:1].t().contiguous().t()),
           lambda: drain(wide[:, ::2][:, :10], wide[:, ::2][:, :10]),
           lambda: kn.reduce_wide_drain(x, x, n.long(), n, cursor, rec, None,
                                        r=6, width=10),
           lambda: kn.reduce_wide(over, over, n, r=6),
           lambda: kn.drain_records(over, over, None, n, n, cursor, rec, None,
                                    k=28, width=10)]
    for call in bad:
        with pytest.raises(ValueError):
            call()
    # the same calls with good arguments run, the views of wider planes too
    drain(x, x)
    drain(wide[:, :12], wide[:, :12])
    kn.reduce_wide(wide[:, :12], wide[:, :12], n, r=6)
    kn.drain_records(wide[:, :12], wide[:, :12], None, n, n, cursor, rec,
                     None, k=28, width=10)


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


def test_wrappers_pass_views_with_their_row_stride(monkeypatch):
    """With the library stubbed out, reduce_wide_drain is one chunked
    launch with the arguments of its C prototype: the planes as they are
    (a view's own storage, no copy) with their row stride, the counts,
    the look-back status for REDUCE_WIDE_CHUNK chunks, the cursor,
    stream and count slots, the sizes; counted once.  reduce_wide and
    drain_records pass a view's row stride the same way."""
    launches = _Launches(monkeypatch)
    Bq, L, cap = 3, 5000, WC + 1
    x = torch.zeros((Bq, L), dtype=torch.int64)
    y = torch.zeros_like(x)
    n = torch.zeros(Bq, dtype=torch.int32)
    c0 = n + 1
    cursor = torch.zeros(3, dtype=torch.int64)
    rec = torch.zeros((64, 2), dtype=torch.int64)
    counts = torch.zeros((5, 2, Bq + 1), dtype=torch.int32)
    before = {fn.__name__: fn.launches for fn in kn.KERNELS}
    kn.reduce_wide_drain(x[:, :cap], y[:, :cap], n, c0, cursor, rec, counts,
                         r=6, width=30)
    [(fn, args)] = launches.calls
    assert fn == "pg_reduce_wide_drain"
    assert len(args) + 1 == len(kn.SIGNATURES[fn])
    assert args[0].data_ptr() == x.data_ptr()
    assert args[1].data_ptr() == y.data_ptr()
    assert args[2] is n and args[3] is c0
    # a slot a chunk (two a row) and a slot a row
    assert args[4].numel() == kn.STATUS_SLOT * (1 + Bq * 3)
    assert args[6] == 0  # the first launch: no earlier status to zero
    assert args[7] is cursor and args[8] is rec and args[9] is counts
    assert args[10:] == (Bq, cap, L, 6, 30, 64, 5, Bq + 1)
    launches.calls.clear()
    ox, oy, oc = kn.reduce_wide(x[:, :cap], y[:, :cap], n, r=6)
    [(fn, args)] = launches.calls
    assert fn == "pg_reduce_wide" and args[0].data_ptr() == x.data_ptr()
    assert args[6:] == (ox, oy, oc, Bq, cap, L, 6)
    assert ox.is_contiguous() and ox.shape == (Bq, cap)
    launches.calls.clear()
    kn.drain_records(x[:, :cap], y[:, :cap], None, n, c0, cursor, rec, None,
                     k=28, width=30)
    [(fn, args)] = launches.calls
    assert fn == "pg_drain_records" and args[0].data_ptr() == x.data_ptr()
    assert args[8:11] == (Bq, 30, L)
    after = {fn.__name__: fn.launches for fn in kn.KERNELS}
    assert {k: after[k] - before[k] for k in after if after[k] > before[k]} \
        == {"reduce_wide_drain": 1, "reduce_wide": 1, "drain_records": 1}
    launches.calls.clear()
    kn.reduce_wide_drain(x[:0], y[:0], n[:0], c0[:0], cursor, rec, counts,
                         r=6, width=30)  # no rows: no launch, one slot
    assert not launches.calls and cursor.tolist() == [0, 1, 0]


@pytest.fixture(scope="module")
def stage1_reads():
    return kernel_cases.stage1_reads()


@pytest.mark.parametrize("levels,w,keep_l0", [(1, 24, False), (1, 24, True),
                                              (0, 24, False), (3, 8, False)])
def test_wide_build_index_matches_jax(stage1_reads, monkeypatch, levels, w,
                                      keep_l0):
    """build_index at k=28 through the step's fused final level (level 1
    reading the capped sketch in place; three levels at w=8, whose
    overflowed batches are retried exactly) and through the drain of no
    level (the capped sketch's views, the counts clamped to the cap),
    with and without the level-0 index, in fetch groups of three
    batches: byte for byte the JAX package's build_index."""
    monkeypatch.setattr(index, "FETCH_GROUP", 3)
    cfg = dict(k=28, w=w, r=4, levels=levels, sketch_pad_len=8192,
               sketch_batch=4)
    jout = jindex.build_index(JaxSeqDB.from_reads(stage1_reads),
                              JaxConfig(**cfg), keep_l0=keep_l0)
    index.reset_stats()
    kn.reset_launches()
    tout = index.build_index(SeqDB.from_reads(stage1_reads),
                             AsmConfig(**cfg), "cpu", keep_l0=keep_l0)
    pairs = zip(jout, tout) if keep_l0 else [(jout, tout)]
    for j, t in pairs:
        for f in ("x", "y", "mc_hash", "mc_count"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                          err_msg=f)
    assert index.STATS["group_fetches"] == 3
    if w == 8:
        assert index.STATS["retried_batches"] > 0
