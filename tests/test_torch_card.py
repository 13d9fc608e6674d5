"""The SHIMMER kernels on a CUDA card: each equals its plain version and
writes nothing outside its outputs; the int64 scans the wide sketch rests
on agree with the CPU.  Skipped without a card.

This file imports no jax (the card's machine has none), so it also runs
there on its own:

    python -m pytest --noconftest -q -p no:cacheprovider tests/test_torch_card.py

Every output of a launch is a view into a larger buffer whose margins
hold a canary; a write past either end of an output changes a margin.
"""

import numpy as np
import pytest
import torch

from peregrine_tpu_torch.ops import kernels as kn

pytestmark = [pytest.mark.cuda,
              pytest.mark.skipif(not torch.cuda.is_available(),
                                 reason="needs a CUDA card: the kernels "
                                 "build with nvcc there")]

B, K, W, R = 64, 16, 80, 6
CANARY = 0x5A5A5A5A
GUARD = 4096


def _guarded(*shape, dtype=torch.int32):
    n = int(np.prod(shape))
    buf = torch.full((n + 2 * GUARD,), CANARY, dtype=dtype, device="cuda")
    return buf, buf[GUARD:GUARD + n].view(shape)


def _outputs(*shapes, dtype=torch.int32):
    bufs, views = zip(*(_guarded(*s, dtype=dtype) for s in shapes))
    return list(bufs), list(views)


def _launch(name, bufs, *args):
    kn._call(getattr(kn.library(), name), *args)
    torch.cuda.synchronize()
    for i, buf in enumerate(bufs):
        assert (buf[:GUARD] == CANARY).all(), f"{name}: write before output {i}"
        assert (buf[-GUARD:] == CANARY).all(), f"{name}: write past output {i}"


def _codes(rng, L):
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4
    codes[2, :] = 4                       # a row of ambiguous codes only
    lens = rng.integers(0, L + 1, B).astype(np.int32)
    lens[0], lens[1], lens[2] = 0, L, L
    return (torch.from_numpy(codes).cuda(), torch.from_numpy(lens).cuda())


@pytest.mark.parametrize("L", [1000, 8192])
def test_kernels_match_plain_and_stay_in_their_outputs(L):
    """All four kernels, at a row length that is and one that is not a
    multiple of the block's tile, with rows of length 0 and L."""
    codes, lens = _codes(np.random.default_rng(L), L)

    bufs, (H, P, dest, n) = _outputs((B, L), (B, L), (B, L), (B,))
    _launch("pg_build_stream", bufs, codes, lens, H, P, dest, n, B, L, K)
    want = kn.build_stream_plain(codes, lens, K)
    for got, ref in zip((H, P, dest, n), want):
        assert torch.equal(got, ref)

    bufs, (sH,) = _outputs((B, L))
    _launch("pg_move_plane", bufs, dest, H, sH, B, L)
    ref = kn.move_plane_plain(dest, H)
    valid = torch.arange(L, device="cuda")[None, :] < n[:, None]
    assert torch.equal(sH[valid], ref[valid])
    sH, sP = ref, kn.move_plane_plain(dest, P)

    bufs, (Ap, edest, count) = _outputs((B, L), (B, L), (B,))
    count.zero_()
    _launch("pg_emit_mask", bufs, sH, sP, n, Ap, edest, count, B, L, W, K)
    for got, ref in zip((edest, count), kn.emit_mask_plain(sH, sP, n, W, K)):
        assert torch.equal(got, ref)

    bufs, outs = _outputs((B, L), (B, L), (B, L), (B,))
    outs[3].zero_()
    _launch("pg_reduce_step", bufs, sH, sP, n, *outs, B, L, R)
    for got, ref in zip(outs, kn.reduce_step_plain(sH, sP, n, R)):
        assert torch.equal(got, ref)


@pytest.mark.parametrize("L", [1000, 8192])
@pytest.mark.parametrize("density", [0.98, 2 / (W + 1)])
def test_compact_planes_matches_plain_and_stays_in_its_outputs(L, density):
    """Two int64 planes and one int32 plane, whole rows (fills included),
    with rows that keep nothing and rows that keep everything."""
    rng = np.random.default_rng(L)
    keep = rng.random((B, L)) < density
    keep[0], keep[1] = False, True
    keep = torch.from_numpy(keep).cuda()
    x, y = (torch.from_numpy(rng.integers(-2**63, 2**63 - 1, (B, L),
                                          dtype=np.int64)).cuda()
            for _ in range(2))
    li = torch.from_numpy(rng.integers(0, 2**31, (B, L)).astype(np.int32)).cuda()
    bufs64, (ox, oy) = _outputs((B, L), (B, L), dtype=torch.int64)
    bufs32, (oli, count) = _outputs((B, L), (B,))
    _launch("pg_compact_planes", bufs64 + bufs32, keep, x, y, li, ox, oy, oli,
            count, -1, -1, 0, 8, 8, 4, B, L)
    (wx, wy, wli), wc = kn.compact_planes_plain(keep, (x, y, li), (-1, -1, 0))
    for got, ref in ((ox, wx), (oy, wy), (oli, wli), (count, wc)):
        assert torch.equal(got, ref)
    assert count[0] == 0 and count[1] == L


def test_int64_cummin_cummax_match_the_cpu():
    """The wide sketch's window extrema rest on torch.cummin / cummax of
    int64 along the last axis, forwards and flipped, with values across
    the whole int64 range (the unsigned order after x ^ 2^63)."""
    from peregrine_tpu_torch.ops import sketch

    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.integers(-2**63, 2**63 - 1, (B, 512, 80),
                                      dtype=np.int64))
    a[:, :, ::7] = -1
    for op in (torch.cummin, torch.cummax):
        for t in (a, a.flip(2)):
            assert torch.equal(op(t.cuda(), dim=2).values.cpu(),
                               op(t, dim=2).values)
    flat = a.view(B, -1)
    for fn, fill in ((sketch._sliding_min_trailing, -1),
                     (sketch._sliding_max_leading, 0)):
        assert torch.equal(fn(flat.cuda(), 80, fill).cpu(),
                           fn(flat, 80, fill))
