"""The four SHIMMER index kernels: CUDA wrappers beside plain PyTorch.

Each public function here replaces one Pallas kernel of
peregrine_tpu/ops/compact_pallas.py:

  build_stream  <- build_stream :229 (pallas_call :243)
  move_plane    <- move_plane   :112 (pallas_call :124)
  emit_mask     <- emit_mask    :331 (pallas_call :351)
  reduce_step   <- reduce_step  :451 (pallas_call :464)

On a CUDA tensor a function launches its kernel from
csrc/shimmer_kernels.cu (built with nvcc for sm_90a on first use, bound
through a plain C interface with ctypes) and counts the launch in its
`launches` attribute; on a CPU tensor it runs the plain version
(`*_plain`), which is the same function written in PyTorch and is what the
CPU tests hold against the Pallas kernels.  Any other device raises.

What bounds the kernels on an H100: device-memory bytes (each reads and
writes about three to four B x L x 4-byte planes once); the windowed taps
re-read neighbours through L1.  See the source note in the .cu file.

Conventions: torch has no usable uint32 (no shifts, compares or minimum),
so the u32 planes ride in int32 tensors holding the same bits; the plain
versions widen to int64 & 0xFFFFFFFF before any compare.  Where the TPU
kernels returned shift distances r, these return a destination column
(`dest`, the rank among kept entries, -1 where dropped): dest = col - r
on kept entries.  Positions of a compacted plane at or past its count are
stale, as on the TPU; every consumer masks by count.
"""

from __future__ import annotations

import ctypes
import os
import shutil

import torch

from .._build import build_shared

_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "csrc", "shimmer_kernels.cu")
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC"]
_U32 = 0xFFFFFFFF
_VP, _INT = ctypes.c_void_p, ctypes.c_int
# argtypes of each C entry, in the order of its prototype in the .cu file
# (tests check the two agree).  ctypes passes any argument past a short
# list, and every argument of a function without one, as a C int, which
# cuts a 64-bit pointer or stream handle to 32 bits without an error.
SIGNATURES = {
    "pg_build_stream": [_VP] * 6 + [_INT] * 3 + [_VP],
    "pg_move_plane": [_VP] * 3 + [_INT] * 2 + [_VP],
    "pg_emit_mask": [_VP] * 6 + [_INT] * 4 + [_VP],
    "pg_reduce_step": [_VP] * 7 + [_INT] * 3 + [_VP],
}
_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the SHIMMER kernels are built with "
                       "the CUDA toolkit on the machine with the card")


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_shared("shimmer_kernels", [_CU],
                                       [_nvcc()] + _NVCC_FLAGS))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _INT
        _lib = lib
    return _lib


def _route(*tensors: torch.Tensor) -> str:
    """'cpu' (plain version) or 'cuda' (kernel); anything else raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"}:
        return "cuda"
    raise ValueError(f"SHIMMER kernels take cpu or cuda tensors on one "
                     f"device, got {sorted(kinds)}")


def _check(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str):
    if t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(f"{name}: want contiguous {dtype} {shape}, got "
                         f"{'' if t.is_contiguous() else 'strided '}"
                         f"{t.dtype} {tuple(t.shape)}")


def _call(fn, *args) -> None:
    """Launch C entry fn on the current stream; raise on a CUDA error."""
    if len(args) + 1 != len(fn.argtypes):
        raise TypeError(f"{fn.__name__} takes {len(fn.argtypes)} arguments "
                        f"with the stream, got {len(args) + 1}")
    stream = torch.cuda.current_stream().cuda_stream
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def u32(t: torch.Tensor) -> torch.Tensor:
    """int32 bit pattern -> its unsigned value as int64."""
    return t.to(torch.int64) & _U32


def i32(v: torch.Tensor) -> torch.Tensor:
    """Unsigned values in [0, 2^32) as int64 -> int32 with the same bits."""
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def _shift_right(a: torch.Tensor, d: int, fill: int) -> torch.Tensor:
    """a[:, i - d], with fill where i < d."""
    if d == 0:
        return a
    out = torch.full_like(a, fill)
    if d < a.shape[1]:
        out[:, d:] = a[:, :-d]
    return out


def _dest(keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Destination column of each kept entry (-1 elsewhere) and counts."""
    rank = torch.cumsum(keep.to(torch.int32), dim=1, dtype=torch.int32)
    return (torch.where(keep, rank - 1, -1).to(torch.int32),
            keep.sum(dim=1, dtype=torch.int32))


def hash64(key: torch.Tensor, mask: int) -> torch.Tensor:
    """Invertible minimizer hash (peregrine_tpu/ops/sketch.py:hash64) on
    non-negative int64 keys below 2^32, under a mask of at most 32 bits:
    every step is masked before the next right shift, so torch's
    arithmetic shift and wrapping int64 products give the unsigned
    result."""
    key = (~key + (key << 21)) & mask
    key = key ^ (key >> 24)
    key = (key + (key << 3) + (key << 8)) & mask
    key = key ^ (key >> 14)
    key = (key + (key << 2) + (key << 4)) & mask
    key = key ^ (key >> 28)
    key = (key + (key << 31)) & mask
    return key


# --- build_stream ---------------------------------------------------------

def build_stream_plain(codes: torch.Tensor, lengths: torch.Tensor, k: int):
    """Plain version of build_stream (the XLA block of
    peregrine_tpu/ops/sketch.py:_sketch_impl_packed)."""
    B, L = codes.shape
    mask = (1 << (2 * k)) - 1
    pos = torch.arange(L, device=codes.device)[None, :]
    c = codes.to(torch.int64)
    inlen = pos < lengths.to(torch.int64)[:, None]
    valid = (c < 4) & inlen
    amb = (c >= 4) & inlen
    cb = c & 3
    fwd = torch.zeros_like(c)
    rev = torch.zeros_like(c)
    for d in range(k):
        fwd |= _shift_right(cb, d, 0) << (2 * d)
        rev |= _shift_right(cb ^ 3, d, 0) << (2 * (k - 1 - d))
    fwd &= mask
    sym = (fwd == rev) & valid
    strand = (fwd >= rev).to(torch.int64)
    hsh = hash64(torch.minimum(fwd, rev), mask)
    vns = valid & ~sym
    cv = torch.cumsum(vns.to(torch.int32), dim=1, dtype=torch.int32)
    at_amb = torch.cummax(torch.where(amb, cv, 0), dim=1).values
    defined = vns & ((cv - at_amb) >= k)
    H = i32(torch.where(defined, hsh, _U32))
    P = ((pos << 2) | (strand << 1) | amb.to(torch.int64)).to(torch.int32)
    dest, n = _dest(vns | amb)
    return H, P, dest, n


def build_stream(codes: torch.Tensor, lengths: torch.Tensor, *, k: int):
    """[B, L] uint8 codes (>= 4 ambiguous) and [B] int32 lengths ->
    (H, P, dest, n): the stream planes (int32 holding u32), each kept
    entry's stream column, and the stream count per row."""
    B, L = codes.shape
    if not 0 < k <= 16:
        raise ValueError(f"build_stream: k={k} outside 1..16 (the wide "
                         "k > 16 sketch is not yet ported)")
    _check(codes, torch.uint8, (B, L), "codes")
    _check(lengths, torch.int32, (B,), "lengths")
    if _route(codes, lengths) == "cpu":
        return build_stream_plain(codes, lengths, k)
    H = torch.empty((B, L), dtype=torch.int32, device=codes.device)
    P = torch.empty_like(H)
    dest = torch.empty_like(H)
    n = torch.empty(B, dtype=torch.int32, device=codes.device)
    if B and L:
        _call(library().pg_build_stream, codes, lengths, H, P, dest, n,
              B, L, k)
        build_stream.launches += 1
    else:
        n.zero_()
    return H, P, dest, n


build_stream.launches = 0


# --- move_plane -----------------------------------------------------------

def move_plane_plain(dest: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    out = plane.clone()
    keep = dest >= 0
    rows = torch.arange(plane.shape[0], device=plane.device)[:, None]
    out[rows.expand_as(dest)[keep], dest[keep].to(torch.int64)] = plane[keep]
    return out


def move_plane(dest: torch.Tensor, plane: torch.Tensor) -> torch.Tensor:
    """Stable compaction of one int32 plane: out[b, dest[b, i]] =
    plane[b, i] where dest >= 0.  Columns past the count are stale."""
    B, L = plane.shape
    _check(dest, torch.int32, (B, L), "dest")
    _check(plane, torch.int32, (B, L), "plane")
    if _route(dest, plane) == "cpu":
        return move_plane_plain(dest, plane)
    out = torch.empty_like(plane)
    if B and L:
        _call(library().pg_move_plane, dest, plane, out, B, L)
        move_plane.launches += 1
    return out


move_plane.launches = 0


# --- emit_mask ------------------------------------------------------------

def emit_mask_plain(sH: torch.Tensor, sP: torch.Tensor, n: torch.Tensor,
                    w: int, k: int):
    """Plain version of emit_mask (the XLA block of
    peregrine_tpu/ops/sketch.py:_sketch_impl_packed, :332-353)."""
    B, L = sH.shape
    col = torch.arange(L, device=sH.device)[None, :]
    in_n = col < n.to(torch.int64)[:, None]
    if L == 0:
        return _dest(in_n)
    h = u32(sH)
    samb = ((sP & 1) != 0) & in_n
    last_amb = torch.cummax(torch.where(samb, col, -1), dim=1).values
    W = h.clone()
    for d in range(1, w):
        W = torch.minimum(W, _shift_right(h, d, _U32))
    complete = (col - last_amb) >= (w + k - 1)
    Ap = torch.where(complete & in_n, W, 0)
    M = Ap.clone()
    for d in range(1, w):
        M[:, :L - d] = torch.maximum(M[:, :L - d], Ap[:, d:])
    emit = (h != _U32) & (M == h)
    in_final = (col >= n.to(torch.int64)[:, None] - w) & in_n
    xm = torch.where(in_final, h, _U32)
    fmin = xm.min(dim=1, keepdim=True).values
    t_f = torch.where((xm == fmin) & in_final, col, -1).max(
        dim=1, keepdim=True).values
    has_final = (fmin != _U32) & (t_f >= 0)
    emit = (emit | ((col == t_f) & has_final)) & in_n
    return _dest(emit)


def emit_mask(sH: torch.Tensor, sP: torch.Tensor, n: torch.Tensor, *,
              w: int, k: int):
    """Window-minimum emission over the compacted stream (sH, sP, n):
    returns (dest, count) of the emitted entries."""
    B, L = sH.shape
    if not 0 < w < 256:
        raise ValueError(f"emit_mask: w={w} outside 1..255")
    _check(sH, torch.int32, (B, L), "sH")
    _check(sP, torch.int32, (B, L), "sP")
    _check(n, torch.int32, (B,), "n")
    if _route(sH, sP, n) == "cpu":
        return emit_mask_plain(sH, sP, n, w, k)
    Ap = torch.empty_like(sH)  # scratch plane: the gated window minima
    dest = torch.empty_like(sH)
    count = torch.zeros(B, dtype=torch.int32, device=sH.device)
    if B and L:
        _call(library().pg_emit_mask, sH, sP, n, Ap, dest, count, B, L, w, k)
        emit_mask.launches += 1
    return dest, count


emit_mask.launches = 0


# --- reduce_step ----------------------------------------------------------

def reduce_step_plain(H: torch.Tensor, P: torch.Tensor, n: torch.Tensor,
                      r: int):
    """Plain version of reduce_step: the r-wide trailing winner on
    (hash, ring slot col % r) — the order of the reference composite key
    (peregrine_tpu/ops/reduce.py:reduce_impl) — then dedup and emission."""
    B, L = H.shape
    col = torch.arange(L, device=H.device)[None, :]
    slot = (col % r).expand(B, L).contiguous()
    best_h, best_s, best_p = u32(H), slot, P
    for d in range(1, r):
        hd = _shift_right(u32(H), d, _U32)
        sd = _shift_right(slot, d, _U32)
        pd = _shift_right(P, d, 0)
        win = (hd < best_h) | ((hd == best_h) & (sd < best_s))
        best_h = torch.where(win, hd, best_h)
        best_s = torch.where(win, sd, best_s)
        best_p = torch.where(win, pd, best_p)
    nn = n.to(torch.int64)[:, None]
    valid = (col >= r - 1) & (col < nn)
    prev_p = _shift_right(best_p, 1, 0)
    prev_valid = (col >= r) & (col < nn + 1)
    emit = valid & ((best_p != prev_p) | ~prev_valid)
    dest, count = _dest(emit)
    return i32(best_h), best_p.contiguous(), dest, count


def reduce_step(H: torch.Tensor, P: torch.Tensor, n: torch.Tensor, *, r: int):
    """One reduction level on (H, P, n): returns (H', P', dest, count);
    move_plane(dest, .) on H' and P' compacts the winners."""
    B, L = H.shape
    if not 1 < r < 256:
        raise ValueError(f"reduce_step: r={r} outside 2..255")
    _check(H, torch.int32, (B, L), "H")
    _check(P, torch.int32, (B, L), "P")
    _check(n, torch.int32, (B,), "n")
    if _route(H, P, n) == "cpu":
        return reduce_step_plain(H, P, n, r)
    Ho = torch.empty_like(H)
    Po = torch.empty_like(H)
    dest = torch.empty_like(H)
    count = torch.zeros(B, dtype=torch.int32, device=H.device)
    if B and L:
        _call(library().pg_reduce_step, H, P, n, Ho, Po, dest, count, B, L, r)
        reduce_step.launches += 1
    return Ho, Po, dest, count


reduce_step.launches = 0

KERNELS = (build_stream, move_plane, emit_mask, reduce_step)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
