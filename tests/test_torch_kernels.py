"""The port's SHIMMER kernels (plain PyTorch versions, the CPU route)
against the JAX package's Pallas kernels run with interpret=True.

Same numpy inputs from a seed go to both; every value is an integer, so
the tolerance is exact equality.  The TPU kernels return shift distances
r where the port returns destinations: dest = col - r on kept entries,
and the kept set itself is compared by compacting a column-index plane
with each side's own move_plane.
"""

import ctypes
import re
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from peregrine_tpu.ops import compact_pallas as pl
from peregrine_tpu_torch.ops import kernels as kn
import torch_kernel_cases as kernel_cases

torch.set_num_threads(2)

B = 8
CHUNK = 256  # where kernel_cases puts its features at these small shapes


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _kept_cols_jax(r, L):
    """Columns kept by the TPU kernel: move an iota plane by its r."""
    iota = jnp.asarray(np.broadcast_to(np.arange(L, dtype=np.uint32),
                                       (r.shape[0], L)).copy())
    return np.asarray(pl.move_plane(r, iota, interpret=True))


def _assert_dest_matches_r(dest, count, r_jax, cnt_jax):
    dest = dest.numpy()
    r_jax = np.asarray(r_jax)
    L = dest.shape[1]
    np.testing.assert_array_equal(count.numpy(), np.asarray(cnt_jax))
    col = np.arange(L)[None, :]
    kept = dest >= 0
    np.testing.assert_array_equal(dest[kept], (col - r_jax)[kept])
    moved = _kept_cols_jax(jnp.asarray(r_jax), L)
    for b in range(dest.shape[0]):
        n = int(count[b])
        np.testing.assert_array_equal(np.flatnonzero(kept[b]), moved[b, :n],
                                      err_msg=f"kept columns, row {b}")


def _codes(rng, L):
    codes = rng.integers(0, 4, (B, L)).astype(np.uint8)
    codes[rng.random((B, L)) < 0.02] = 4          # ambiguous
    lengths = rng.integers(1, L + 1, B).astype(np.int32)
    lengths[0] = L
    lengths[1] = 0                                  # n = 0
    codes[2] = 4                                    # all placeholders: n = L
    lengths[2] = L
    return codes, lengths


@pytest.mark.parametrize("L", [512, 640])
@pytest.mark.parametrize("k", [11, 12, 16])
def test_build_stream_matches_pallas(rng, L, k):
    """Random codes, then kernel_cases' rows: lengths on and beside a
    boundary, ambiguous bases ending at one, and an ambiguous base
    followed by strand-symmetric k-mers (even k)."""
    for codes, lengths in (_codes(rng, L),
                           kernel_cases.stream_codes(rng, B, L, k, CHUNK)):
        H, P, r1, n = pl.build_stream(jnp.asarray(codes),
                                      jnp.asarray(lengths), k=k,
                                      interpret=True)
        tH, tP, dest, tn = kn.build_stream(_t(codes), _t(lengths), k=k)
        np.testing.assert_array_equal(_u32(tH), np.asarray(H))
        np.testing.assert_array_equal(_u32(tP), np.asarray(P))
        np.testing.assert_array_equal(tn.numpy(), np.asarray(n))
        assert tn[2] == L and (tn[1] == 0) == (lengths[1] == 0)
        _assert_dest_matches_r(dest, tn, r1, n)
        # compacted stream planes agree up to the counts
        for jp, tp in ((H, tH), (P, tP)):
            want = np.asarray(pl.move_plane(r1, jp, interpret=True))
            got = _u32(kn.move_plane(dest, tp))
            for b in range(B):
                np.testing.assert_array_equal(got[b, :tn[b]],
                                              want[b, :tn[b]])


@pytest.mark.parametrize("L", [512, 640])
@pytest.mark.parametrize("p", [0.97, 0.03, 1.0, 0.0])
def test_move_plane_matches_pallas(rng, L, p):
    keep = rng.random((B, L)) < p
    vals = rng.integers(0, 2**32, (B, L)).astype(np.uint32)
    cvk = np.cumsum(keep, axis=1)
    col = np.arange(L)[None, :]
    r = np.where(keep, col - cvk + 1, 0).astype(np.int32)
    dest = np.where(keep, cvk - 1, -1).astype(np.int32)
    want = np.asarray(pl.move_plane(jnp.asarray(r), jnp.asarray(vals),
                                    interpret=True))
    got = _u32(kn.move_plane(_t(dest), _t(vals.view(np.int32))))
    for b in range(B):
        n = int(cvk[b, -1])
        np.testing.assert_array_equal(got[b, :n], want[b, :n])


def _stream(rng, L, ties):
    n = rng.integers(0, L, B).astype(np.int32)
    n[0] = 0
    n[1] = L
    hi = 50 if ties else 2**32
    sH = rng.integers(0, hi, (B, L)).astype(np.uint32)
    amb = rng.random((B, L)) < 0.02
    warm = rng.random((B, L)) < 0.05
    sH = np.where(amb | warm, np.uint32(0xFFFFFFFF), sH)
    sP = ((rng.integers(0, L, (B, L)).astype(np.uint32) << np.uint32(2))
          | rng.integers(0, 2, (B, L)).astype(np.uint32) << np.uint32(1)
          | amb.astype(np.uint32))
    hole = np.arange(L)[None, :] >= n[:, None]
    return (np.where(hole, np.uint32(0xFFFFFFFF), sH),
            np.where(hole, np.uint32(0xFFFFFFFF), sP), n)


@pytest.mark.parametrize("L,w,k,ties", [(512, 5, 11, False),
                                        (640, 24, 12, False),
                                        (640, 80, 16, False),
                                        (512, 24, 12, True),
                                        (640, 80, 16, True)])
def test_emit_mask_matches_pallas(rng, L, w, k, ties):
    """A random stream, then kernel_cases' rows: a placeholder at column
    0, and placeholders exactly w+k-3, w+k-2 and w+k-1 columns before the
    least hash at each boundary — where the windowed `complete` of
    emit_mask_plain and the kernel flips — n on a boundary and a final
    window across one."""
    for sH, sP, n in (_stream(rng, L, ties),
                      kernel_cases.emit_stream(rng, B, L, w, k, CHUNK, ties)):
        r2, cnt = pl.emit_mask(jnp.asarray(sH), jnp.asarray(sP),
                               jnp.asarray(n), w=w, k=k, interpret=True)
        dest, count = kn.emit_mask(_t(sH.view(np.int32)),
                                   _t(sP.view(np.int32)), _t(n), w=w, k=k)
        _assert_dest_matches_r(dest, count, r2, cnt)


@pytest.mark.parametrize("C,r", [(512, 4), (640, 6)])
@pytest.mark.parametrize("ties", [True, False])
def test_reduce_step_matches_pallas(rng, C, r, ties):
    count = rng.integers(0, C, B).astype(np.int32)
    count[0] = 0
    count[1] = C
    H = rng.integers(0, 50 if ties else 2**32, (B, C)).astype(np.uint32)
    P = ((rng.integers(0, 2**15, (B, C)).astype(np.uint32) << np.uint32(2))
         | (rng.integers(0, 2, (B, C)).astype(np.uint32) << np.uint32(1)))
    H2, P2, rs, cnt = pl.reduce_step(jnp.asarray(H), jnp.asarray(P),
                                     jnp.asarray(count), r=r, interpret=True)
    tH2, tP2, dest, tcnt = kn.reduce_step(_t(H.view(np.int32)),
                                          _t(P.view(np.int32)), _t(count), r=r)
    np.testing.assert_array_equal(_u32(tH2), np.asarray(H2))
    np.testing.assert_array_equal(_u32(tP2), np.asarray(P2))
    _assert_dest_matches_r(dest, tcnt, rs, cnt)
    for jp, tp in ((H2, tH2), (P2, tP2)):
        want = np.asarray(pl.move_plane(rs, jp, interpret=True))
        got = _u32(kn.move_plane(dest, tp))
        for b in range(B):
            np.testing.assert_array_equal(got[b, :tcnt[b]], want[b, :tcnt[b]])


def test_hash64_matches_jax(rng):
    from peregrine_tpu.ops.sketch import hash64 as jhash
    for bits in (22, 24, 32):
        mask = (1 << bits) - 1
        keys = rng.integers(0, mask + 1, 1000, dtype=np.uint64)
        want = np.asarray(jhash(jnp.asarray(keys), jnp.uint64(mask)))
        got = kn.hash64(_t(keys.astype(np.int64)), mask).numpy()
        np.testing.assert_array_equal(got.astype(np.uint64), want)


class _FakeCudaTensor:
    """Just enough of a tensor that lies on a CUDA device for the
    wrappers' checks; this host cannot allocate a real one."""

    def __init__(self, t: torch.Tensor):
        self._t = t
        self.device = torch.device("cuda", 0)
        self.dtype = t.dtype
        self.shape = t.shape

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self._t.data_ptr()


def test_cuda_call_raises_without_fallback(monkeypatch):
    """On a host without a card a CUDA call raises; it never falls back
    to the plain version, and counts no launch."""
    codes = _FakeCudaTensor(torch.zeros((8, 128), dtype=torch.uint8))
    lens = _FakeCudaTensor(torch.full((8,), 128, dtype=torch.int32))

    def no_fallback(*a, **kw):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(kn, "build_stream_plain", no_fallback)
    before = kn.build_stream.launches
    with pytest.raises((RuntimeError, AssertionError)) as exc:
        kn.build_stream(codes, lens, k=16)
    assert "fell back" not in str(exc.value)
    assert kn.build_stream.launches == before


def test_other_devices_and_bad_inputs_raise():
    codes = torch.zeros((8, 128), dtype=torch.uint8)
    lens = torch.full((8,), 128, dtype=torch.int32)
    with pytest.raises(ValueError):
        kn.build_stream(codes.to("meta"), lens.to("meta"), k=16)
    with pytest.raises(ValueError):
        kn.build_stream(codes, lens, k=17)
    with pytest.raises(ValueError):
        kn.move_plane(torch.zeros((8, 128), dtype=torch.int64),
                      torch.zeros((8, 128), dtype=torch.int32))


def test_bindings_match_c_prototypes():
    """Every extern "C" entry of the .cu file has a ctypes signature with
    its arguments' count and kinds (pointer -> c_void_p, long long ->
    c_longlong, int -> c_int): a missing or short one passes the stream
    handle as a 32-bit int.  The chunked kernels take the look-back
    status and the last launch's status, to zero, where the wrappers pass
    them, and emit_mask no scratch plane."""
    with open(kn._CU) as f:
        src = f.read()
    block = src.split('extern "C" {')[1]
    protos = re.findall(r"^int (pg_\w+)\(([^)]*)\)", block, re.M)
    assert sorted(name for name, _ in protos) == sorted(kn.SIGNATURES)
    names = {}
    for name, params in protos:
        kinds = [ctypes.c_void_p if "*" in p
                 else ctypes.c_longlong if "long long" in p else ctypes.c_int
                 for p in params.split(",")]
        assert kinds == kn.SIGNATURES[name], name
        names[name] = [p.split()[-1].lstrip("*") for p in params.split(",")]
    assert names["pg_build_stream"][:9] == [
        "codes", "lengths", "status", "stale", "stale_words", "H", "P",
        "dest", "n_out"]
    assert names["pg_emit_mask"][:8] == [
        "sH", "sP", "n_in", "status", "stale", "stale_words", "dest", "count"]


def test_chunk_layout_matches_the_source():
    """The wrappers size the look-back status from CHUNK and STATUS_SLOT,
    which the kernels know as kChunk and kSlot."""
    with open(kn._CU) as f:
        src = f.read()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kChunk"]) == kn.CHUNK
    assert int(const["kSlot"]) == kn.STATUS_SLOT


def test_chunked_launches_alternate_two_status_buffers(monkeypatch):
    """Two zeroed buffers trade places: each launch gets the one the
    launch before it had it zero, and the words that launch used, so
    that no launch needs a memset; a launch that raises leaves the turn
    where it was."""
    calls = []
    monkeypatch.setattr(kn, "_call", lambda fn, *args: calls.append(args))
    monkeypatch.setattr(kn, "_status_pairs", {})
    cpu = torch.device("cpu")
    kn._call_chunked("fn", 3, kn.CHUNK + 1, cpu, ("in",), ("out",), 7)
    kn._call_chunked("fn", 2, 1, cpu, ("in",), ("out",), 7)
    (_, a, b, wa, *rest), (_, a2, b2, wb, *_) = calls
    assert rest == ["out", 7]
    assert a.shape == b.shape == (kn.STATUS_SLOT * 7,)
    assert not a.any() and not b.any() and wa == 0
    assert a2 is b and b2 is a and wb == kn.STATUS_SLOT * 7

    def fails(fn, *args):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(kn, "_call", fails)
    with pytest.raises(RuntimeError):
        kn._call_chunked("fn", 2, 1, cpu, ("in",), ("out",), 7)
    monkeypatch.setattr(kn, "_call", lambda fn, *args: calls.append(args))
    kn._call_chunked("fn", 2, 1, cpu, ("in",), ("out",), 7)
    assert calls[-1][1] is a and calls[-1][3] == kn.STATUS_SLOT * 3


def test_call_rejects_a_wrong_argument_count():
    fn = types.SimpleNamespace(__name__="pg_move_plane",
                               argtypes=kn.SIGNATURES["pg_move_plane"])
    with pytest.raises(TypeError, match="takes 6 arguments"):
        kn._call(fn, 0, 0, 0, 8, 128, 0)
