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
        # compacted stream planes agree up to the counts (one plane a call)
        for jp, tp in ((H, tH), (P, tP)):
            want = np.asarray(pl.move_plane(r1, jp, interpret=True))
            (moved,) = kn.move_plane(dest, tp)
            got = _u32(moved)
            for b in range(B):
                np.testing.assert_array_equal(got[b, :tn[b]],
                                              want[b, :tn[b]])


@pytest.mark.parametrize("L", [512, 640])
@pytest.mark.parametrize("p", [0.97, 0.03, 1.0, 0.0])
def test_move_plane_matches_pallas(rng, L, p):
    """Two planes moved in one call, each against the Pallas move_plane."""
    keep = rng.random((B, L)) < p
    planes = [rng.integers(0, 2**32, (B, L)).astype(np.uint32)
              for _ in range(2)]
    cvk = np.cumsum(keep, axis=1)
    col = np.arange(L)[None, :]
    r = np.where(keep, col - cvk + 1, 0).astype(np.int32)
    dest = np.where(keep, cvk - 1, -1).astype(np.int32)
    got = kn.move_plane(_t(dest), *(_t(v.view(np.int32)) for v in planes))
    assert len(got) == 2
    for vals, moved in zip(planes, got):
        want = np.asarray(pl.move_plane(jnp.asarray(r), jnp.asarray(vals),
                                        interpret=True))
        for b in range(B):
            n = int(cvk[b, -1])
            np.testing.assert_array_equal(_u32(moved)[b, :n], want[b, :n])


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


def _level(rng, C, ties):
    count = rng.integers(0, C, B).astype(np.int32)
    count[0] = 0
    count[1] = C
    H = rng.integers(0, 50 if ties else 2**32, (B, C)).astype(np.uint32)
    P = ((rng.integers(0, 2**15, (B, C)).astype(np.uint32) << np.uint32(2))
         | (rng.integers(0, 2, (B, C)).astype(np.uint32) << np.uint32(1)))
    return H, P, count


@pytest.mark.parametrize("C,r", [(512, 4), (640, 6), (3200, 6)])
@pytest.mark.parametrize("ties", [True, False])
def test_reduce_step_matches_pallas(rng, C, r, ties):
    """The fused level (reduce_step) against the Pallas reduce_step
    followed by the Pallas move_plane on its two planes: the prefixes up
    to the count and the counts, exactly; and the per-column level it
    compacts against the Pallas reduce_step's planes and shifts.  A random
    level, then kernel_cases' rows: n = 0, L, r - 2, r - 1, on and beside
    a chunk boundary (REDUCE_CHUNK at C = 3200), a winner across a
    boundary, all-tie hashes, all-equal P."""
    chunk = kn.REDUCE_CHUNK if C > kn.REDUCE_CHUNK else CHUNK
    for H, P, count in (_level(rng, C, ties),
                        kernel_cases.reduce_rows(rng, 2 * B, C, r, chunk,
                                                 ties)):
        rows = H.shape[0]
        H2, P2, rs, cnt = pl.reduce_step(jnp.asarray(H), jnp.asarray(P),
                                         jnp.asarray(count), r=r,
                                         interpret=True)
        tH, tP, tcnt = kn.reduce_step(_t(H.view(np.int32)),
                                      _t(P.view(np.int32)), _t(count), r=r)
        np.testing.assert_array_equal(tcnt.numpy(), np.asarray(cnt))
        for jp, tp in ((H2, tH), (P2, tP)):
            want = np.asarray(pl.move_plane(rs, jp, interpret=True))
            got = _u32(tp)
            for b in range(rows):
                np.testing.assert_array_equal(got[b, :tcnt[b]],
                                              want[b, :tcnt[b]])
        cH, cP, dest, ccnt = kn.reduce_columns_plain(
            _t(H.view(np.int32)), _t(P.view(np.int32)), _t(count), r)
        np.testing.assert_array_equal(_u32(cH), np.asarray(H2))
        np.testing.assert_array_equal(_u32(cP), np.asarray(P2))
        _assert_dest_matches_r(dest, ccnt, rs, cnt)
        if rows > B:  # the crafted rows' counts
            assert tcnt[0] == 0 and tcnt[2] == 0 and tcnt[3] == 1
            assert tcnt[9] == 1


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
    plane = torch.zeros((8, 128), dtype=torch.int32)
    for planes in ((), (plane,) * 3):
        with pytest.raises(ValueError):
            kn.move_plane(plane, *planes)


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
    assert names["pg_reduce_step"][:9] == [
        "H", "P", "n_in", "status", "stale", "stale_words", "oH", "oP",
        "count"]
    assert names["pg_move_plane"] == [
        "dest", "in0", "in1", "out0", "out1", "B", "L", "stream"]
    assert names["pg_compact_planes"][:11] == [
        "keep", "in0", "in1", "in2", "status", "stale", "stale_words",
        "out0", "out1", "out2", "count"]


def test_chunk_layout_matches_the_source():
    """The wrappers size the look-back status from CHUNK, REDUCE_CHUNK,
    COMPACT_CHUNK and STATUS_SLOT, which the kernels know as kChunk,
    kRChunk, kCChunk and kSlot."""
    with open(kn._CU) as f:
        src = f.read()
    const = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(const["kChunk"]) == kn.CHUNK
    assert int(const["kRChunk"]) == kn.REDUCE_CHUNK
    assert int(const["kCChunk"]) == kn.COMPACT_CHUNK
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
    with pytest.raises(TypeError, match="takes 8 arguments"):
        kn._call(fn, 0, 0, 0, 8, 128, 0)


class _Launches:
    """The kernel library stubbed out on the CPU: each wrapper takes its
    CUDA branch (the route says "cuda") and every C entry it calls is
    recorded with its arguments instead of launched."""

    def __init__(self, monkeypatch):
        self.calls = []
        monkeypatch.setattr(kn, "_route", lambda *t: "cuda")
        monkeypatch.setattr(kn, "_status_pairs", {})
        monkeypatch.setattr(kn, "library", lambda: types.SimpleNamespace(**{
            name: name for name in kn.SIGNATURES}))
        monkeypatch.setattr(kn, "_call", lambda fn, *args:
                            self.calls.append((fn, args)))


def test_one_launch_per_level_and_per_move(monkeypatch):
    """reduce_step is one pg_reduce_step launch with its look-back status
    sized by REDUCE_CHUNK, and nothing else; move_plane moves two planes
    in one pg_move_plane launch, and one plane with null pointers for the
    second."""
    launches = _Launches(monkeypatch)
    Bq, L = 3, kn.REDUCE_CHUNK + 1
    H = torch.zeros((Bq, L), dtype=torch.int32)
    n = torch.full((Bq,), L, dtype=torch.int32)
    before = kn.reduce_step.launches
    oH, oP, count = kn.reduce_step(H, H.clone(), n, r=6)
    assert kn.reduce_step.launches == before + 1
    [(fn, args)] = launches.calls
    assert fn == "pg_reduce_step" and args[0] is H and args[2] is n
    assert args[3].numel() == kn.STATUS_SLOT * (1 + Bq * 2)
    assert args[6:] == (oH, oP, count, Bq, L, 6)

    launches.calls.clear()
    before = kn.move_plane.launches
    a, b = kn.move_plane(H, H, n[:, None].expand(Bq, L).contiguous())
    (c,) = kn.move_plane(H, H)
    assert kn.move_plane.launches == before + 2
    (f2, two), (f1, one) = launches.calls
    assert f2 == f1 == "pg_move_plane"
    assert two[3] is a and two[4] is b and two[5:] == (Bq, L)
    assert one[2] == 0 and one[3] is c and one[4] == 0


def test_compact_planes_is_one_chunked_launch(monkeypatch):
    """compact_planes is one pg_compact_planes launch with its look-back
    status sized by COMPACT_CHUNK; absent planes pass null pointers, fill
    0 and width 0, and fills go over as the signed value of their bits."""
    launches = _Launches(monkeypatch)
    Bq, L = 3, kn.COMPACT_CHUNK + 1
    keep = torch.zeros((Bq, L), dtype=torch.bool)
    wide = torch.zeros((Bq, L), dtype=torch.int64)
    narrow = torch.zeros((Bq, L), dtype=torch.int32)
    before = kn.compact_planes.launches
    (ow, on), count = kn.compact_planes(keep, (wide, narrow),
                                        (-1, 0xFFFFFFFF))
    assert kn.compact_planes.launches == before + 1
    [(fn, args)] = launches.calls
    assert fn == "pg_compact_planes"
    assert args[0] is keep and args[1] is wide and args[2] is narrow
    assert args[3] == 0
    assert args[4].numel() == kn.STATUS_SLOT * (1 + Bq * 2)
    assert args[6] == 0  # the first launch: no earlier status to zero
    assert args[7] is ow and args[8] is on and args[9] == 0
    assert args[10] is count
    assert args[11:] == (-1, 2**32 - 1, 0, 8, 4, 0, Bq, L)


@pytest.mark.parametrize("Bq,L", [(0, 64), (3, 0)])
def test_empty_shapes_count_zero_without_a_launch(monkeypatch, Bq, L):
    """B = 0 or L = 0: no kernel launches, and every count, which the
    kernels write themselves and the wrappers allocate unset, is zero, on
    the CUDA branch and in the plain versions."""
    codes = torch.zeros((Bq, L), dtype=torch.uint8)
    lens = torch.zeros(Bq, dtype=torch.int32)
    plane = torch.zeros((Bq, L), dtype=torch.int32)
    keep = torch.zeros((Bq, L), dtype=torch.bool)
    wide = torch.zeros((Bq, L), dtype=torch.int64)

    def counts():
        return [kn.build_stream(codes, lens, k=16)[3],
                kn.emit_mask(plane, plane, lens, w=5, k=16)[1],
                kn.reduce_step(plane, plane, lens, r=6)[2],
                kn.compact_planes(keep, (wide, plane), (-1, 0))[1]]

    for count in counts():
        assert count.shape == (Bq,) and not count.any()
    launches = _Launches(monkeypatch)
    empty = torch.empty  # unset memory made visible: -7 in every word
    monkeypatch.setattr(torch, "empty",
                        lambda *a, **kw: empty(*a, **kw).fill_(-7))
    for count in counts():
        assert count.shape == (Bq,) and not count.any()
    assert kn.move_plane(plane, plane, plane)[0].shape == (Bq, L)
    assert launches.calls == []
