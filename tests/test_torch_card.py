"""The SHIMMER kernels on a CUDA card: each equals its plain version and
writes nothing outside its outputs.  Skipped without a card.

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


def _guarded(*shape):
    n = int(np.prod(shape))
    buf = torch.full((n + 2 * GUARD,), CANARY, dtype=torch.int32,
                     device="cuda")
    return buf, buf[GUARD:GUARD + n].view(shape)


def _outputs(*shapes):
    bufs, views = zip(*(_guarded(*s) for s in shapes))
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
