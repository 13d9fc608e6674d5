"""The wide sketch's two redesigned kernels on the CPU: wide_stream, which
writes the compacted stream itself, and wide_emit, whose window extrema
no longer depend on w.

Their plain versions (what the wrappers run on the CPU, and what the card
compares the CUDA kernels against) are held to the JAX package's
_sketch_impl_wide, run eagerly with its `_compact` watched: the first
compaction's outputs are the stream (sx, sy, sl, n), the second's mask
is the emission set.  Every value is an integer, so the tolerance is
exact equality of whole rows (the plain stream fills its tails as the JAX
package does).  On the card the compacted stream is stale past its
counts; junk there must leave the sketch as it was.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from peregrine_tpu.ops import sketch as jsketch
from peregrine_tpu_torch.ops import kernels as kn, sketch
import torch_kernel_cases as kernel_cases

torch.set_num_threads(2)

B, L = 16, 640
CHUNK = 256  # where kernel_cases puts its features at these small shapes
INF = kn.INF


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _jax_wide(monkeypatch, codes, lens, rids, w, k):
    """The JAX package's wide sketch of the batch, eagerly, with its two
    compactions watched: ((sx, sy, sl), n) of the stream, the emission
    mask, and the sketch's (x, y, count), all as numpy."""
    calls = []
    compact = jsketch._compact

    def watched(keep, operands, fills=None, **kw):
        out = compact(keep, operands, fills, **kw)
        calls.append((keep, out))
        return out

    monkeypatch.setattr(jsketch, "_compact", watched)
    out = jsketch._sketch_impl_wide(jnp.asarray(codes), jnp.asarray(lens),
                                    jnp.asarray(rids.astype(np.uint32)),
                                    w=w, k=k)
    (_, (stream, n)), (emit, _) = calls
    return ([np.array(a) for a in stream], np.array(n), np.array(emit),
            [np.array(a) for a in out])


def _tandem_codes(rng):
    """Reads of tandem repeats (units of 3 to 40 bases), so that equal
    k-mers, and equal records, recur inside every window: the newest of
    equal minima must win.  A few ambiguous bases and random lengths."""
    codes = np.empty((B, L), np.uint8)
    for b in range(B):
        unit = rng.integers(0, 4, int(rng.integers(3, 41))).astype(np.uint8)
        codes[b] = np.resize(unit, L)
    codes[rng.random((B, L)) < 0.003] = 4
    lens = rng.integers(L // 2, L + 1, B).astype(np.int32)
    lens[0] = L
    return codes, lens


@pytest.mark.parametrize("L_, chunk", [(L, CHUNK),
                                       (kn.CHUNK + 65, kn.CHUNK)])
@pytest.mark.parametrize("k", [17, 28])
def test_compacting_wide_stream_matches_the_jax_stream(monkeypatch, k, L_,
                                                       chunk):
    """kernel_cases.wide_compact_codes (ambiguous runs across the
    boundaries, (AT)* runs, all-kept and none-kept stretches, reads
    ending on and beside a boundary, empty reads) at the test shapes and
    across the card's CHUNK: the wrapper's CPU route, the plain
    composition of wide_stream_plain and compact_planes_plain, equals the
    JAX package's stream compaction, fills included."""
    rng = np.random.default_rng(10 * k + L_)
    codes, lens = kernel_cases.wide_compact_codes(rng, B, L_, k, chunk)
    rids = rng.integers(0, 2**31, B).astype(np.int64)
    (jx, jy, jl), jn, _, _ = _jax_wide(monkeypatch, codes, lens, rids, 80, k)
    got = kn.wide_stream(_t(codes), _t(lens), _t(rids), k=k)
    x, y, li, keep = kn.wide_stream_plain(_t(codes), _t(lens), _t(rids), k)
    pair = kn.compact_planes_plain(keep, (x, y, li), (INF, INF, 0))
    for a, b in zip(got, pair[0] + (pair[1],)):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(got[3].numpy(), jn)
    np.testing.assert_array_equal(_u64(got[0]), jx)
    np.testing.assert_array_equal(_u64(got[1]), jy)
    np.testing.assert_array_equal(got[2].numpy(), jl)
    n = got[3].numpy()
    assert n[0] == 0 and n[13] == min(L_, lens[13]) and (n > 0).sum() > 8


@pytest.mark.parametrize("w", [1, 2, 3, 31, 32, 33, 79, 80, 81, 255])
@pytest.mark.parametrize("ties", [False, True])
def test_wide_emit_matches_the_jax_emission_set(monkeypatch, w, ties):
    """wide_emit's plain version on the JAX package's own stream equals
    its emission mask at w across powers of two and the default 80, with
    random reads and with tandem repeats (ties); the sketch through the
    wrappers equals the JAX sketch."""
    k = 28
    rng = np.random.default_rng(w + 1000 * ties)
    if ties:
        codes, lens = _tandem_codes(rng)
    else:
        codes, lens = kernel_cases.wide_compact_codes(rng, B, L, k, CHUNK)
    rids = rng.integers(0, 2**31, B).astype(np.int64)
    (jx, _, jl), jn, jemit, (ox, oy, count) = _jax_wide(
        monkeypatch, codes, lens, rids, w, k)
    emit = kn.wide_emit(_t(jx.view(np.int64)), _t(jl), _t(jn), w=w, k=k)
    np.testing.assert_array_equal(emit.numpy(), jemit)
    got = sketch.sketch_wide(_t(codes), _t(lens), _t(rids), w=w, k=k)
    np.testing.assert_array_equal(got[2].numpy(), count)
    np.testing.assert_array_equal(_u64(got[0]), ox)
    np.testing.assert_array_equal(_u64(got[1]), oy)
    assert jemit.any()
    if ties:  # equal records in a row's stream
        defined = [r[:m][r[:m] != np.uint64(2**64 - 1)]
                   for r, m in zip(jx, jn)]
        assert all(len(np.unique(r)) < len(r) for r in defined)


@pytest.mark.parametrize("w", [5, 80])
@pytest.mark.parametrize("k", [17, 28])
def test_junk_past_the_stream_counts_changes_nothing(monkeypatch, w, k):
    """The card leaves wide_stream's columns at or past n stale: random
    records and run lengths there, in place of the plain version's fills,
    give the same emission mask and the same sketch (x, y, count)."""
    rng = np.random.default_rng(w * k)
    codes, lens = kernel_cases.wide_compact_codes(rng, B, L, k, CHUNK)
    args = (_t(codes), _t(lens), _t(rng.integers(0, 2**31, B)))
    want = sketch.sketch_wide(*args, w=w, k=k)
    plain = kn.wide_stream

    def stale(*a, **kw):
        sx, sy, sl, n = plain(*a, **kw)
        past = torch.arange(L)[None, :] >= n[:, None]
        sx[past] = torch.from_numpy(rng.integers(-2**63, 2**63 - 1,
                                                 int(past.sum())))
        sy[past] = torch.from_numpy(rng.integers(-2**63, 2**63 - 1,
                                                 int(past.sum())))
        sl[past] = torch.from_numpy(rng.integers(-2**31, 2**31 - 1,
                                                 int(past.sum()),
                                                 dtype=np.int32))
        junk.append((sx, sl, n))
        return sx, sy, sl, n

    junk = []
    monkeypatch.setattr(sketch, "wide_stream", stale)
    got = sketch.sketch_wide(*args, w=w, k=k)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    (sx, sl, n), = junk
    assert (n < L).sum() > 4
    filled = kn.wide_stream_compact_plain(*args, k)
    assert torch.equal(kn.wide_emit(sx, sl, n, w=w, k=k),
                       kn.wide_emit(filled[0], filled[2], n, w=w, k=k))
