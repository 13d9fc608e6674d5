"""The SHIMMER index kernels: CUDA wrappers beside plain PyTorch.

Five public functions here replace one Pallas kernel each of
peregrine_tpu/ops/compact_pallas.py:

  build_stream    <- build_stream   :230 (pallas_call :243)
  move_plane      <- move_plane     :113 (pallas_call :124)
  emit_mask       <- emit_mask      :333 (pallas_call :351)
  reduce_step     <- reduce_step    :452 (pallas_call :464), followed by
                     move_plane on its two planes
  compact_planes  <- compact_planes :365 (pallas_call :391)

and three replace the XLA code of the wide (k > 16) route, which the JAX
package leaves to XLA between its compactions:

  wide_stream     <- peregrine_tpu/ops/sketch.py:_sketch_impl_wide,
                     :371-422, its stream compaction (_compact, :422,
                     compact_planes on the TPU) included
  wide_emit       <- the same, :425-441 (window extrema, emission set)
  reduce_wide     <- peregrine_tpu/ops/reduce.py:reduce_impl, :26-61
                     (the shifted winners, the dedup and the compaction)

and stage 1's batch step (ops/index.py) adds two more for the JAX
package's XLA code around the kernels:

  drain_records   <- peregrine_tpu/ops/index.py:_compact_drain (:66), with
                     assemble_records (peregrine_tpu/ops/sketch.py:257)
  gather_codes    <- peregrine_tpu/ops/dbgather.py:gather_codes (:233),
                     re-exported by ops/dbgather.py with GUARD_BASES

and three fuse those into their neighbours, where the step runs them in
place of the pairs they compute, two on the k <= 16 main path:

  gather_build_stream <- gather_codes then build_stream (pallas_call :243)
  reduce_drain        <- the final reduce_step (pallas_call :464) then
                         drain_records

and one on the k > 16 path:

  reduce_wide_drain   <- the final reduce_wide (reduce_impl) level then
                         drain_records

On a CUDA tensor a function launches its kernel from
csrc/shimmer_kernels.cu (built with nvcc for sm_90a on first use, bound
through a plain C interface with ctypes) and counts the launch in its
`launches` attribute; on a CPU tensor it runs the plain version
(`*_plain`), which is the same function written in PyTorch and is what the
CPU tests hold against the Pallas kernels and the JAX package.  Any other
device raises.

What bounds the kernels on an H100: device-memory bytes (each reads and
writes a few bytes per column once).  build_stream, emit_mask,
reduce_step, compact_planes, wide_stream, reduce_wide and the fused
kernels split rows into chunks (CHUNK columns, REDUCE_CHUNK for
reduce_step and reduce_drain, COMPACT_CHUNK for compact_planes,
REDUCE_WIDE_CHUNK for reduce_wide and reduce_wide_drain), one block
each, and carry row prefixes across chunks by a decoupled look-back over
a zeroed status buffer (the two fused final levels across the batch's
rows too); each launch zeroes the one the launch before it
used, so the wrappers alternate two (`_call_chunked`).  wide_emit needs
no row prefix.  See the source note in the .cu file.

Conventions: torch has no usable uint32 (no shifts, compares or minimum),
so the u32 planes ride in int32 tensors holding the same bits; the plain
versions widen to int64 & 0xFFFFFFFF before any compare.  Wide records
are int64 tensors holding the uint64 bits (INF, all ones, is -1); x ^ SIGN
orders as signed int64 exactly as x does as uint64.  Where the TPU
kernels returned shift distances r, build_stream and emit_mask return a
destination column (`dest`, the rank among kept entries, -1 where
dropped): dest = col - r on kept entries; reduce_step returns its winners
compacted.  Positions of a plane compacted by move_plane or reduce_step
at or past its count are stale, as on the TPU; every consumer masks by
count.  compact_planes and reduce_wide instead fill them (INF for
records); wide_stream's compacted stream is stale past its counts too
(its plain version has compact_planes' fills there), and wide_emit reads
nothing past them.
"""

from __future__ import annotations

import contextlib
import ctypes
import os
from typing import TYPE_CHECKING

import torch

from .._build import load_cuda

if TYPE_CHECKING:
    from .dbgather import PackedSeqDB

INF = -1  # uint64 0xFFFF_FFFF_FFFF_FFFF as int64
SIGN = -(1 << 63)  # x ^ SIGN: unsigned order as signed order
_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "csrc", "shimmer_kernels.cu")
_U32 = 0xFFFFFFFF
_VP, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of each C entry, in the order of its prototype in the .cu file
# (tests check the two agree).  ctypes passes any argument past a short
# list, and every argument of a function without one, as a C int, which
# cuts a 64-bit pointer or stream handle to 32 bits without an error.
SIGNATURES = {
    "pg_build_stream": [_VP] * 4 + [_INT] + [_VP] * 4 + [_INT] * 3 + [_VP],
    "pg_move_plane": [_VP] * 5 + [_INT] * 2 + [_VP],
    "pg_emit_mask": [_VP] * 5 + [_INT] + [_VP] * 2 + [_INT] * 4 + [_VP],
    "pg_reduce_step": [_VP] * 5 + [_INT] + [_VP] * 3 + [_INT] * 3 + [_VP],
    "pg_compact_planes": [_VP] * 6 + [_INT] + [_VP] * 4 + [_I64] * 3
    + [_INT] * 5 + [_VP],
    "pg_wide_stream": [_VP] * 5 + [_INT] + [_VP] * 4 + [_INT] * 3 + [_VP],
    "pg_wide_emit": [_VP] * 4 + [_INT] * 4 + [_VP],
    "pg_reduce_wide": [_VP] * 5 + [_INT] + [_VP] * 3 + [_INT] * 4 + [_VP],
    "pg_gather_codes": [_VP, _I64, _VP, _I64] + [_VP] * 4 + [_INT] * 3
    + [_VP],
    "pg_drain_records": [_VP] * 8 + [_INT] * 5 + [_I64] + [_INT] * 2 + [_VP],
    "pg_gather_build_stream": [_VP, _I64, _VP, _I64] + [_VP] * 4 + [_INT]
    + [_VP] * 4 + [_INT] * 3 + [_VP],
    "pg_reduce_drain": [_VP] * 7 + [_INT] + [_VP] * 3 + [_INT] * 5 + [_I64]
    + [_INT] * 2 + [_VP],
    "pg_reduce_wide_drain": [_VP] * 6 + [_INT] + [_VP] * 3 + [_INT] * 5
    + [_I64] + [_INT] * 2 + [_VP],
}
# The chunked kernels' layout (kChunk, kRChunk, kCChunk, kWRChunk and
# kSlot in the .cu file; tests check they agree): columns per block of
# build_stream, emit_mask, wide_stream and wide_emit, of reduce_step, of
# compact_planes, of reduce_wide, and int32 words per look-back status
# slot (slot 0 holds the ticket counter, then one per chunk).
CHUNK = 4096
REDUCE_CHUNK = 3072
COMPACT_CHUNK = 4096
REDUCE_WIDE_CHUNK = 2048
STATUS_SLOT = 8
_lib = None
# (device, stream) -> [status of the next launch, status of the last, the
# words the last launch used, whether the pair is status_scope's]
_status_pairs: dict = {}


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    if _lib is None:
        _lib = load_cuda("shimmer_kernels", _CU, SIGNATURES)
    return _lib


def require_device(device) -> torch.device:
    """torch.device(device), raising where cuda is asked for and torch
    sees no card: there is no quiet switch to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but torch sees no CUDA "
                           "device (pass the cpu device explicitly to run "
                           "the device work on the host)")
    return device


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


def _rows(a: torch.Tensor, b: torch.Tensor, dtype: torch.dtype, B: int,
          C: int, name: str) -> int:
    """Check two [B, C] planes of `dtype` whose rows may lie apart in
    larger buffers (a [:, :C] view of wider planes): adjacent columns,
    one row stride ld >= C for both.  Returns ld."""
    for t, which in ((a, f"{name} a"), (b, f"{name} b")):
        if t.dtype != dtype or tuple(t.shape) != (B, C):
            raise ValueError(f"{which}: want {dtype} {(B, C)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    ld = a.stride(0) if B > 1 else C
    cols = C < 2 or a.stride(1) == b.stride(1) == 1
    if B and C and not (cols and (B < 2 or b.stride(0) == ld) and ld >= C):
        raise ValueError(f"{name}: want rows of adjacent columns, one row "
                         f"stride >= {C} for both planes, got strides "
                         f"{a.stride()} and {b.stride()}")
    return ld


def _count_slots(counts_out, B: int) -> list:
    """Check the drains' count slots, [S, 2, B'] int32 with B' >= B, or
    None; returns them as a list of the tensors to route by."""
    if counts_out is None:
        return []
    S, _, Bc = counts_out.shape
    if Bc < B:
        raise ValueError(f"counts_out: {Bc} counts a slot, {B} rows")
    _check(counts_out, torch.int32, (S, 2, Bc), "counts_out")
    return [counts_out]


def _call(fn, *args) -> None:
    """Launch C entry fn on the current stream of its tensors' card, with
    that card current (the entry points never pick a device themselves);
    raise on a CUDA error."""
    if len(args) + 1 != len(fn.argtypes):
        raise TypeError(f"{fn.__name__} takes {len(fn.argtypes)} arguments "
                        f"with the stream, got {len(args) + 1}")
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    device = tensors[0].device
    if any(t.device != device for t in tensors):
        raise ValueError(f"{fn.__name__}: tensors on several devices, "
                         f"{sorted({str(t.device) for t in tensors})}")
    args = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        rc = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {rc}")


def _call_chunked(fn, B: int, L: int, device, inputs, outputs, *tail,
                  chunk: int = CHUNK, row_slots: bool = False):
    """Launch chunked kernel fn(*inputs, status, stale, stale_words,
    *outputs, *tail) on rows of `chunk`-column chunks: status is zeroed
    look-back status for this launch (a slot a chunk, and with row_slots
    one more a row), and the kernel zeroes the first stale_words of stale,
    the status of the last launch on this stream, which then serves the
    next.  The two buffers start as zeros and are replaced by larger ones
    as needed."""
    words = STATUS_SLOT * (1 + B * (-(-L // chunk) + row_slots))
    key = (device, torch.cuda.current_stream(device).cuda_stream
           if device.type == "cuda" else None)
    pair = _status_pairs.get(key)
    if pair is None or pair[0].numel() < words:
        if pair is not None and pair[3]:
            raise RuntimeError(f"status_scope holds {pair[0].numel()} words "
                               f"a launch, this launch needs {words}")
        pair = [torch.zeros(words, dtype=torch.int32, device=device)
                for _ in range(2)] + [0, False]
    status, stale, stale_words, scoped = pair
    _call(fn, *inputs, status, stale, stale_words, *outputs, *tail)
    _status_pairs[key] = [stale, status, words, scoped]


def status_words(rows: int, L: int) -> int:
    """Look-back status words that any chunked launch on `rows` rows of
    at most L columns takes (reduce_wide_drain's row slots included)."""
    chunk = min(CHUNK, REDUCE_CHUNK, COMPACT_CHUNK, REDUCE_WIDE_CHUNK)
    return STATUS_SLOT * (1 + rows * (-(-L // chunk) + 1))


@contextlib.contextmanager
def status_scope(status: torch.Tensor):
    """For as long as the block runs, the chunked launches on the current
    stream of status's card take the two halves of `status` in turn, each
    of at least status_words() words, after one zero_() of the whole: a
    memset, which a CUDA graph captures with the launches.  A captured
    step thus starts every replay on zeroed status, whatever number of
    chunked launches it holds (each launch zeroes only the status of the
    one before it), and shares no status with launches outside it."""
    device = status.device
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    half = status.numel() // 2
    status.zero_()
    saved = _status_pairs.get(key)
    _status_pairs[key] = [status[:half], status[half:], 0, True]
    try:
        yield
    finally:
        if saved is None:
            del _status_pairs[key]
        else:
            _status_pairs[key] = saved


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
    non-negative int64 keys under a mask of at most 56 bits (k <= 28):
    every step is masked before the next right shift, so torch's
    arithmetic shift sees a non-negative value, and the left shifts and
    adds wrap modulo 2^64 as they do in uint64."""
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
        raise ValueError(f"build_stream: k={k} outside 1..16 (k > 16 "
                         "takes the wide sketch, ops.sketch.sketch_wide)")
    _check(codes, torch.uint8, (B, L), "codes")
    _check(lengths, torch.int32, (B,), "lengths")
    if _route(codes, lengths) == "cpu":
        return build_stream_plain(codes, lengths, k)
    H = torch.empty((B, L), dtype=torch.int32, device=codes.device)
    P = torch.empty_like(H)
    dest = torch.empty_like(H)
    n = torch.empty(B, dtype=torch.int32, device=codes.device)
    if B and L:
        _call_chunked(library().pg_build_stream, B, L, codes.device,
                      (codes, lengths), (H, P, dest, n), B, L, k)
        build_stream.launches += 1
    else:
        n.zero_()
    return H, P, dest, n


build_stream.launches = 0


# --- move_plane -----------------------------------------------------------

def move_plane_plain(dest: torch.Tensor, *planes: torch.Tensor) -> tuple:
    keep = dest >= 0
    rows = torch.arange(dest.shape[0], device=dest.device)[:, None]
    rows, cols = rows.expand_as(dest)[keep], dest[keep].to(torch.int64)
    outs = []
    for plane in planes:
        out = plane.clone()
        out[rows, cols] = plane[keep]
        outs.append(out)
    return tuple(outs)


def move_plane(dest: torch.Tensor, *planes: torch.Tensor) -> tuple:
    """Stable compaction of one or two int32 planes by one destination
    plane, in one launch: out[b, dest[b, i]] = plane[b, i] where
    dest >= 0.  Returns a tuple of the moved planes; columns past the
    count are stale."""
    B, L = dest.shape
    if not 0 < len(planes) <= 2:
        raise ValueError(f"move_plane: one or two planes, got {len(planes)}")
    _check(dest, torch.int32, (B, L), "dest")
    for i, p in enumerate(planes):
        _check(p, torch.int32, (B, L), f"plane {i}")
    if _route(dest, *planes) == "cpu":
        return move_plane_plain(dest, *planes)
    outs = tuple(torch.empty_like(p) for p in planes)
    if B and L:
        second = (planes[1], outs[1]) if len(planes) == 2 else (0, 0)
        _call(library().pg_move_plane, dest, planes[0], second[0], outs[0],
              second[1], B, L)
        move_plane.launches += 1
    return outs


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
    W = h.clone()
    for d in range(1, w):
        W = torch.minimum(W, _shift_right(h, d, _U32))
    # complete: t >= w + k - 2 and no placeholder in [t - (w + k - 2), t],
    # the window form of the TPU kernel's t - last_amb >= w + k - 1
    span = w + k - 1
    n_amb = torch.cumsum(samb.to(torch.int32), dim=1)
    complete = (col >= span - 1) & (n_amb == _shift_right(n_amb, span, 0))
    Ap = torch.where(complete & in_n, W, 0)
    M = Ap.clone()
    for d in range(1, min(w, L)):
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
    if not 0 < w < 256 or not 0 < k <= 16:
        raise ValueError(f"emit_mask: w={w} outside 1..255 or k={k} "
                         "outside 1..16")
    _check(sH, torch.int32, (B, L), "sH")
    _check(sP, torch.int32, (B, L), "sP")
    _check(n, torch.int32, (B,), "n")
    if _route(sH, sP, n) == "cpu":
        return emit_mask_plain(sH, sP, n, w, k)
    dest = torch.empty_like(sH)
    count = torch.empty(B, dtype=torch.int32, device=sH.device)
    if B and L:  # the last chunk of each row writes its count
        _call_chunked(library().pg_emit_mask, B, L, sH.device, (sH, sP, n),
                      (dest, count), B, L, w, k)
        emit_mask.launches += 1
    else:
        count.zero_()
    return dest, count


emit_mask.launches = 0


# --- reduce_step ----------------------------------------------------------

def reduce_columns_plain(H: torch.Tensor, P: torch.Tensor, n: torch.Tensor,
                         r: int):
    """One reduction level per column, as the TPU kernel computed it: the
    r-wide trailing winner on (hash, ring slot col % r) — the order of the
    reference composite key (peregrine_tpu/ops/reduce.py:reduce_impl) —
    then dedup and emission.  Returns the winners' planes (H', P') at
    every column, the emitted columns' destinations and the count."""
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


def reduce_step_plain(H: torch.Tensor, P: torch.Tensor, n: torch.Tensor,
                      r: int):
    """Plain version of reduce_step: the per-column level, then the
    compaction of its two planes."""
    Ho, Po, dest, count = reduce_columns_plain(H, P, n, r)
    return move_plane_plain(dest, Ho, Po) + (count,)


def reduce_step(H: torch.Tensor, P: torch.Tensor, n: torch.Tensor, *, r: int):
    """One reduction level on (H, P, n), in one launch: returns
    (H', P', count), the emitted winners at the row fronts in column order
    and their exact count.  Columns of H', P' at or past the count are
    stale; the values of H, P at or past n are never used."""
    B, L = H.shape
    if not 1 < r < 256:
        raise ValueError(f"reduce_step: r={r} outside 2..255")
    _check(H, torch.int32, (B, L), "H")
    _check(P, torch.int32, (B, L), "P")
    _check(n, torch.int32, (B,), "n")
    if _route(H, P, n) == "cpu":
        return reduce_step_plain(H, P, n, r)
    oH = torch.empty_like(H)
    oP = torch.empty_like(H)
    count = torch.empty(B, dtype=torch.int32, device=H.device)
    if B and L:  # the chunk of each row's column n - 1 writes its count
        _call_chunked(library().pg_reduce_step, B, L, H.device, (H, P, n),
                      (oH, oP, count), B, L, r, chunk=REDUCE_CHUNK)
        reduce_step.launches += 1
    else:
        count.zero_()
    return oH, oP, count


reduce_step.launches = 0

# --- compact_planes -------------------------------------------------------

_MAX_PLANES = 3


def _signed(v: int, bits: int) -> int:
    """An int in [-2^(bits-1), 2^bits) as the signed value of its bits."""
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def compact_planes_plain(keep: torch.Tensor, planes, fills):
    """Plain version of compact_planes: a cumsum, an index scatter and a
    fill."""
    dest, count = _dest(keep)
    kept = dest >= 0
    rows = torch.arange(keep.shape[0], device=keep.device)[:, None]
    rows, cols = rows.expand_as(dest)[kept], dest[kept].to(torch.int64)
    outs = []
    for p, f in zip(planes, fills):
        out = torch.full_like(p, _signed(f, p.element_size() * 8))
        out[rows, cols] = p[kept]
        outs.append(out)
    return tuple(outs), count


def compact_planes(keep: torch.Tensor, planes, fills):
    """Stable compaction of up to three [B, L] int64 or int32 planes by one
    [B, L] bool mask: kept entries go to the row front in order, every
    column at or past the row's count holds that plane's fill (given as
    the plane's bits, e.g. -1 or 0xFFFFFFFF), and count [B] int32 is
    exact.  Returns (planes', count)."""
    B, L = keep.shape
    planes, fills = tuple(planes), tuple(fills)
    if not 0 < len(planes) <= _MAX_PLANES or len(fills) != len(planes):
        raise ValueError(f"compact_planes: 1..{_MAX_PLANES} planes with one "
                         f"fill each, got {len(planes)} and {len(fills)}")
    _check(keep, torch.bool, (B, L), "keep")
    for i, p in enumerate(planes):
        if p.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"plane {i}: want int32 or int64, got {p.dtype}")
        _check(p, p.dtype, (B, L), f"plane {i}")
    if _route(keep, *planes) == "cpu":
        return compact_planes_plain(keep, planes, fills)
    outs = tuple(torch.empty_like(p) for p in planes)
    count = torch.empty(B, dtype=torch.int32, device=keep.device)
    if B and L:  # the chunk of each row's column L - 1 writes its count
        pad = [0] * (_MAX_PLANES - len(planes))
        _call_chunked(library().pg_compact_planes, B, L, keep.device,
                      (keep, *planes, *pad), (*outs, *pad, count),
                      *[_signed(f, 64) for f in fills], *pad,
                      *[p.element_size() for p in planes], *pad, B, L,
                      chunk=COMPACT_CHUNK)
        compact_planes.launches += 1
    else:
        count.zero_()
    return outs, count


compact_planes.launches = 0


# --- the wide route (k > 16): wide_stream, wide_emit, reduce_wide --------

MAX_K = 28  # 56-bit hashes: x = hash << 8 | span fills 64 bits


def wide_stream_plain(codes: torch.Tensor, lengths: torch.Tensor,
                      rids: torch.Tensor, k: int):
    """Plain version of wide_stream (the XLA code of
    peregrine_tpu/ops/sketch.py:_sketch_impl_wide, :383-423): rolling
    k-mers on raw positions (zero padding mirrors the zeroed rolling
    registers, and the complement is taken before the shift,
    src/mm_sketch.c:102), the 56-bit hash, the run length and the
    records."""
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
    cvns = torch.cumsum(vns.to(torch.int32), dim=1, dtype=torch.int32)
    at_amb = torch.cummax(torch.where(amb, cvns, 0), dim=1).values
    run = cvns - at_amb  # valid non-symmetric entries since the last amb
    defined = vns & (run >= k)
    x = torch.where(defined, (hsh << 8) | k, INF)
    y = torch.where(defined, (rids.to(torch.int64)[:, None] << 32)
                    | ((pos << 1) & 0xFFFFFFFE) | strand, INF)
    return x, y, torch.where(vns, run, 0), vns | amb


def wide_stream_compact_plain(codes: torch.Tensor, lengths: torch.Tensor,
                              rids: torch.Tensor, k: int):
    """Plain version of wide_stream: wide_stream_plain's columns compacted
    by compact_planes_plain (INF, INF, 0 past the counts)."""
    x, y, li, keep = wide_stream_plain(codes, lengths, rids, k)
    (sx, sy, sl), n = compact_planes_plain(keep, (x, y, li), (INF, INF, 0))
    return sx, sy, sl, n


def wide_stream(codes: torch.Tensor, lengths: torch.Tensor,
                rids: torch.Tensor, *, k: int):
    """[B, L] uint8 codes (>= 4 ambiguous), [B] int32 lengths and [B]
    int64 read ids -> the wide sketch's compacted buffer stream: the
    entries kept (valid non-symmetric k-mers and ambiguous placeholders)
    in order at the row front of sx, sy (int64 records, INF where no k-mer
    is defined) and sl (int32 run length: valid non-symmetric entries
    since the last ambiguous base, 0 at a placeholder), and their count n
    [B] int32.  Columns at or past n are stale on the card."""
    B, L = codes.shape
    if not 0 < k <= MAX_K:
        raise ValueError(f"wide_stream: k={k} outside 1..{MAX_K}")
    _check(codes, torch.uint8, (B, L), "codes")
    _check(lengths, torch.int32, (B,), "lengths")
    _check(rids, torch.int64, (B,), "rids")
    if _route(codes, lengths, rids) == "cpu":
        return wide_stream_compact_plain(codes, lengths, rids, k)
    sx = torch.empty((B, L), dtype=torch.int64, device=codes.device)
    sy = torch.empty_like(sx)
    sl = torch.empty((B, L), dtype=torch.int32, device=codes.device)
    n = torch.empty(B, dtype=torch.int32, device=codes.device)
    if B and L:  # the chunk of each read's last column writes its count
        _call_chunked(library().pg_wide_stream, B, L, codes.device,
                      (codes, lengths, rids), (sx, sy, sl, n), B, L, k)
        wide_stream.launches += 1
    else:
        n.zero_()
    return sx, sy, sl, n


wide_stream.launches = 0


def _shift_left(a: torch.Tensor, d: int, fill: int) -> torch.Tensor:
    """a[:, i + d], with fill where i + d >= L."""
    if d == 0:
        return a
    out = torch.full_like(a, fill)
    if d < a.shape[1]:
        out[:, :-d] = a[:, d:]
    return out


def _blocks(a: torch.Tensor, w: int, fill: int):
    """Pad [B, L] to whole blocks of w columns: a [B, nb, w] view."""
    B, L = a.shape
    P = -(-L // w) * w
    ap = torch.full((B, P), fill, dtype=a.dtype, device=a.device)
    ap[:, :L] = a
    return ap.view(B, P // w, w)


def _sliding_min_trailing(a: torch.Tensor, w: int, fill: int) -> torch.Tensor:
    """W[t] = min(a[t-w+1 .. t]) in unsigned order, fill out of range:
    per-block prefix and suffix minima combined by one static shift."""
    B, L = a.shape
    s, f = a ^ SIGN, fill ^ SIGN
    blocks = _blocks(s, w, f)
    pref = torch.cummin(blocks, dim=2).values.reshape(B, -1)
    suf = torch.cummin(blocks.flip(2), dim=2).values.flip(2).reshape(B, -1)
    left = _shift_right(suf, w - 1, f)[:, :L]
    return torch.minimum(left, pref[:, :L]) ^ SIGN


def _sliding_max_leading(a: torch.Tensor, w: int, fill: int) -> torch.Tensor:
    """M[t] = max(a[t .. t+w-1]) in unsigned order, fill out of range."""
    B, L = a.shape
    s, f = a ^ SIGN, fill ^ SIGN
    blocks = _blocks(s, w, f)
    pref = torch.cummax(blocks, dim=2).values.reshape(B, -1)
    suf = torch.cummax(blocks.flip(2), dim=2).values.flip(2).reshape(B, -1)
    right = _shift_left(pref, w - 1, f)[:, :L]
    return torch.maximum(suf[:, :L], right) ^ SIGN


def wide_emit_plain(sx: torch.Tensor, sl: torch.Tensor, n: torch.Tensor,
                    w: int, k: int) -> torch.Tensor:
    """Plain version of wide_emit (the XLA code of
    peregrine_tpu/ops/sketch.py:_sketch_impl_wide, :425-441), restricted
    to the columns below n, which is all it emits where the columns past
    n hold compact_planes' fills; whatever they hold, no column below n
    depends on them."""
    B, L = sx.shape
    col = torch.arange(L, device=sx.device)[None, :]
    nn = n.to(torch.int64)[:, None]
    in_n = col < nn
    if not sx.numel():
        return in_n
    # window minima and the emission set; Ap's sentinel 0 lies below
    # every finite x (x >= span > 0) and never equals one
    W = _sliding_min_trailing(sx, w, INF)
    Ap = torch.where((sl >= w + k - 1) & in_n, W, 0)
    M = _sliding_max_leading(Ap, w, 0)
    emit = (sx != INF) & (M == sx)
    # the final held minimum: min of the last window, the newest tie wins
    in_final = (col >= nn - w) & in_n
    xm = torch.where(in_final, sx, INF)
    fmin = ((xm ^ SIGN).min(dim=1, keepdim=True).values) ^ SIGN
    t_f = torch.where((xm == fmin) & in_final, col, -1).max(
        dim=1, keepdim=True).values
    emit |= (col == t_f) & (fmin != INF) & (t_f >= 0)
    return emit & in_n


def wide_emit(sx: torch.Tensor, sl: torch.Tensor, n: torch.Tensor, *,
              w: int, k: int) -> torch.Tensor:
    """The emission set over the compacted wide stream (sx int64 records,
    sl int32 run lengths, n [B] int32 counts): [B, L] bool, the entries
    that are the unsigned minimum of a complete window (run length
    >= w + k - 1 at its end) or the newest minimum of the final window.
    Only the columns below n are read."""
    B, L = sx.shape
    if not 0 < w < 256 or not 0 < k <= MAX_K:
        raise ValueError(f"wide_emit: w={w} outside 1..255 or k={k} "
                         f"outside 1..{MAX_K}")
    _check(sx, torch.int64, (B, L), "sx")
    _check(sl, torch.int32, (B, L), "sl")
    _check(n, torch.int32, (B,), "n")
    if _route(sx, sl, n) == "cpu":
        return wide_emit_plain(sx, sl, n, w, k)
    emit = torch.empty((B, L), dtype=torch.bool, device=sx.device)
    if B and L:
        _call(library().pg_wide_emit, sx, sl, n, emit, B, L, w, k)
        wide_emit.launches += 1
    return emit


wide_emit.launches = 0


def reduce_wide_columns_plain(x: torch.Tensor, y: torch.Tensor,
                              count: torch.Tensor, r: int):
    """One wide reduction level per column (peregrine_tpu/ops/reduce.py:
    reduce_impl before its compaction): the r-step shift tournament on
    the composite key and the dedup.  Returns the winners' (x, y) at every
    column and the emitted columns."""
    C = x.shape[1]
    col = torch.arange(C, device=x.device)[None, :]
    key = ((x & ~0xFF) | (col % r)) ^ SIGN
    best_k, best_x, best_y = key, x, y
    for d in range(1, r):
        kd = _shift_right(key, d, INF ^ SIGN)
        win = kd < best_k
        best_k = torch.where(win, kd, best_k)
        best_x = torch.where(win, _shift_right(x, d, INF), best_x)
        best_y = torch.where(win, _shift_right(y, d, INF), best_y)
    valid = (col >= r - 1) & (col < count.to(torch.int64)[:, None])
    emit = valid & ((best_y != _shift_right(best_y, 1, INF))
                    | ~_shift_right(valid, 1, False))
    return best_x, best_y, emit


def reduce_wide_plain(x: torch.Tensor, y: torch.Tensor, count: torch.Tensor,
                      r: int):
    """Plain version of reduce_wide (peregrine_tpu/ops/reduce.py:
    reduce_impl): the per-column level, then the compaction of the
    emitted winners with INF fills."""
    best_x, best_y, emit = reduce_wide_columns_plain(x, y, count, r)
    (ox, oy), ocount = compact_planes_plain(emit, (best_x, best_y),
                                            (INF, INF))
    return ox, oy, ocount


def reduce_wide(x: torch.Tensor, y: torch.Tensor, count: torch.Tensor, *,
                r: int):
    """One reduction level on int64 record rows (x, y, count), in one
    launch: the window winner at each column j < count minimizes the key
    (x & ~0xFF) | (j % r) over its r trailing columns in unsigned order;
    winners are deduplicated against the previous column and compacted.
    Returns (x', y', count'), contiguous, INF at and past count'; the
    values of x, y at or past count are never used, and a count past the
    rows' C columns counts as C.  x, y may be [:, :C] views of wider
    planes, read in place (rows of adjacent columns, one row stride)."""
    B, C = x.shape
    if not 0 < r < 256:
        raise ValueError(f"reduce_wide: r={r} outside 1..255")
    ld = _rows(x, y, torch.int64, B, C, "reduce_wide")
    _check(count, torch.int32, (B,), "count")
    if _route(x, y, count) == "cpu":
        return reduce_wide_plain(x, y, count, r)
    ox = torch.empty((B, C), dtype=torch.int64, device=x.device)
    oy = torch.empty_like(ox)
    ocount = torch.empty(B, dtype=torch.int32, device=x.device)
    if B and C:  # the chunk of each row's column count - 1 writes ocount
        _call_chunked(library().pg_reduce_wide, B, C, x.device,
                      (x, y, count), (ox, oy, ocount), B, C, ld, r,
                      chunk=REDUCE_WIDE_CHUNK)
        reduce_wide.launches += 1
    else:
        ocount.zero_()
    return ox, oy, ocount


reduce_wide.launches = 0

# --- gather_codes: stage 1's code windows --------------------------------

# guard (in bases) below the packed db start: a strand-1 window of true
# length len padded to L gathers from  start + len - L >= -L, so any
# L <= GUARD_BASES stays in bounds.  Multiple of 1024 (one amb row).
GUARD_BASES = 1 << 16


def gather_codes(pdb: PackedSeqDB, goff: torch.Tensor, lens: torch.Tensor,
                 strand: torch.Tensor | None, L: int,
                 fill: int) -> torch.Tensor:
    """[B] windows -> [B, L] uint8 2-bit codes (ambiguous/padding = fill).

    pdb: a PackedSeqDB (ops/dbgather.py); goff is the GATHER start from
    gather_offsets (mirror-adjusted for strand 1); strand-1 windows come out flipped and complemented.
    strand None: every window on strand 0, as the index builds read them.
    The windows run on the planes' device: on a CUDA card one
    pg_gather_codes launch (counted in gather_codes.launches), on the CPU
    gather_codes_plain.  A byte index past a plane's end reads its last
    byte, and the planes may be views into larger buffers.
    """
    assert L % 8 == 0 and L <= GUARD_BASES
    if _route(pdb.fw, pdb.amb) == "cpu":
        return gather_codes_plain(pdb, goff, lens, strand, L, fill)
    dev = pdb.fw.device
    if not (pdb.fw.is_contiguous() and pdb.amb.is_contiguous()
            and pdb.fw.dtype == pdb.amb.dtype == torch.uint8):
        raise ValueError("gather_codes: contiguous uint8 planes")
    if not 0 <= fill < 256:
        raise ValueError(f"gather_codes: fill {fill} outside 0..255")
    B = goff.shape[0]
    goff = goff.to(dev, torch.int64).contiguous()
    lens = lens.to(dev, torch.int64).contiguous()
    if goff.shape != (B,) or lens.shape != (B,):
        raise ValueError(f"gather_codes: [B] goff and lens, got "
                         f"{tuple(goff.shape)} and {tuple(lens.shape)}")
    st = 0 if strand is None else strand.to(dev, torch.int32).contiguous()
    out = torch.empty((B, L), dtype=torch.uint8, device=dev)
    if B and L:
        _call(library().pg_gather_codes, pdb.fw, pdb.fw.numel(), pdb.amb,
              pdb.amb.numel(), goff, lens, st, out, B, L, fill)
        gather_codes.launches += 1
    return out


gather_codes.launches = 0


def gather_codes_plain(pdb: PackedSeqDB, goff: torch.Tensor,
                       lens: torch.Tensor, strand: torch.Tensor | None,
                       L: int, fill: int) -> torch.Tensor:
    """Plain version of gather_codes: tensor indexing, each byte index
    clamped to its plane."""
    assert L % 8 == 0 and L <= GUARD_BASES
    dev = pdb.fw.device
    q = (goff.to(dev, torch.int64)[:, None] + GUARD_BASES
         + torch.arange(L, device=dev)[None, :])
    fw = pdb.fw.reshape(-1)
    ab = pdb.amb.reshape(-1)
    code = (fw[(q >> 2).clamp(0, fw.numel() - 1)] >> (2 * (q & 3))) & 3
    amb = (ab[(q >> 3).clamp(0, ab.numel() - 1)] >> (q & 7)) & 1
    if strand is not None:
        rev = strand.to(dev)[:, None] == 1
        code = torch.where(rev, torch.flip(code, dims=[1]) ^ 3, code)
        amb = torch.where(rev, torch.flip(amb, dims=[1]), amb)
    inlen = (torch.arange(L, device=dev)[None, :]
             < lens.to(dev, torch.int64)[:, None])
    out = torch.where((amb == 1) | ~inlen, fill, code)
    return out.to(torch.uint8)


def gather_build_stream_plain(pdb: PackedSeqDB, goff: torch.Tensor,
                              lens: torch.Tensor, L: int, k: int):
    """Plain version of gather_build_stream: the two plain versions."""
    codes = gather_codes_plain(pdb, goff, lens, None, L, 4)
    return build_stream_plain(codes, lens.to(codes.device, torch.int32), k)


def gather_build_stream(pdb: PackedSeqDB, goff: torch.Tensor,
                        lens: torch.Tensor, L: int, *, k: int):
    """build_stream(gather_codes(pdb, goff, lens, None, L, fill=4), lens
    as int32, k=k) in one launch: the [B] strand-0 windows of the packed
    seqdb (goff, lens: [B] int64 on the planes' device, as the batch
    step's metas hold them) -> (H, P, dest, n), build_stream's stream
    planes.  On a CUDA card one pg_gather_build_stream launch (counted in
    gather_build_stream.launches), with build_stream's look-back status;
    on the CPU gather_build_stream_plain."""
    if not 0 < k <= 16:
        raise ValueError(f"gather_build_stream: k={k} outside 1..16")
    if L % 8 or not 0 <= L <= GUARD_BASES:
        raise ValueError(f"gather_build_stream: L={L} not a multiple of 8 "
                         f"in 0..{GUARD_BASES}")
    B = goff.shape[0]
    _check(goff, torch.int64, (B,), "goff")
    _check(lens, torch.int64, (B,), "lens")
    if _route(pdb.fw, pdb.amb, goff, lens) == "cpu":
        return gather_build_stream_plain(pdb, goff, lens, L, k)
    if not (pdb.fw.is_contiguous() and pdb.amb.is_contiguous()
            and pdb.fw.dtype == pdb.amb.dtype == torch.uint8):
        raise ValueError("gather_build_stream: contiguous uint8 planes")
    dev = pdb.fw.device
    H = torch.empty((B, L), dtype=torch.int32, device=dev)
    P = torch.empty_like(H)
    dest = torch.empty_like(H)
    n = torch.empty(B, dtype=torch.int32, device=dev)
    if B and L:
        _call_chunked(library().pg_gather_build_stream, B, L, dev,
                      (pdb.fw, pdb.fw.numel(), pdb.amb, pdb.amb.numel(),
                       goff, lens), (H, P, dest, n), B, L, k)
        gather_build_stream.launches += 1
    else:
        n.zero_()
    return H, P, dest, n


gather_build_stream.launches = 0


# --- drain_records: stage 1's tight record stream -----------------------

def assemble_records(oH: torch.Tensor, oP: torch.Tensor, count: torch.Tensor,
                     rids: torch.Tensor, k: int):
    """(H, P) planes -> reference-encoded (x, y) int64 records, INF past
    the counts (peregrine_tpu/ops/sketch.py:assemble_records)."""
    L = oH.shape[1]
    valid = torch.arange(L, device=oH.device)[None, :] < count[:, None]
    h = oH.to(torch.int64) & _U32
    p = oP.to(torch.int64) & _U32
    x = torch.where(valid, (h << 8) | k, INF)
    y = torch.where(valid, (rids.to(torch.int64)[:, None] << 32)
                    | ((p >> 2) << 1) | ((p >> 1) & 1), INF)
    return x, y


def drain_records_plain(a, b, rids, count, c0, cursor, out, counts_out, *,
                        k: int, width: int) -> None:
    """Plain version of drain_records: the valid prefixes by a mask, the
    records assembled from (H, P) by assemble_records."""
    B = a.shape[0]
    n = count.to(torch.int64).clamp(0, width)
    a, b = a[:, :width], b[:, :width]
    if a.dtype == torch.int32:
        a, b = assemble_records(a, b, n, rids, k)
    valid = torch.arange(width, device=a.device)[None, :] < n[:, None]
    rec = torch.stack([a[valid], b[valid]], dim=1)
    base, slot = int(cursor[0]), int(cursor[1])
    m = max(0, min(len(rec), out.shape[0] - base))
    out[base:base + m] = rec[:m]
    if counts_out is not None and slot < counts_out.shape[0]:
        counts_out[slot, 0, :B] = c0
        counts_out[slot, 1, :B] = count
    cursor[0] += len(rec)
    cursor[1] += 1


def drain_records(a: torch.Tensor, b: torch.Tensor, rids, count: torch.Tensor,
                  c0: torch.Tensor, cursor: torch.Tensor, out: torch.Tensor,
                  counts_out, *, k: int, width: int) -> None:
    """Append a batch's records to a tight stream, in one launch.

    a, b: [B, C] planes (rows of adjacent columns, one row stride, so
    [:, :C] views of wider planes are read in place), (H, P) int32
    (records assembled with rids [B] int64 and span k) or (x, y) int64
    records; count [B] int32: each row's
    valid entries, of which the first min(count, width) columns go out,
    in (row, column) order; c0 [B] int32: the sketch counts.  cursor [3]
    int64 on the device: the stream's length, the next count slot, and
    the kernel's own counter (0 between launches).  out [N, 2] int64: the
    (x, y) stream, written from cursor[0] on (nothing at or past N);
    counts_out [S, 2, B'] int32 (B' >= B) or None: slot cursor[1] gets
    (c0, count).  The launch advances both cursors, so its arguments do
    not change from batch to batch."""
    B, C = a.shape
    if a.dtype not in (torch.int32, torch.int64) or not 0 <= width <= C:
        raise ValueError(f"drain_records: int32 or int64 planes of at least "
                         f"width {width} columns, got {a.dtype} [{B}, {C}]")
    ld = _rows(a, b, a.dtype, B, C, "drain_records")
    packed = a.dtype == torch.int32
    if packed:
        _check(rids, torch.int64, (B,), "rids")
    _check(count, torch.int32, (B,), "count")
    _check(c0, torch.int32, (B,), "c0")
    _check(cursor, torch.int64, (3,), "cursor")
    _check(out, torch.int64, (out.shape[0], 2), "out")
    extra = [rids] if packed else []
    extra += _count_slots(counts_out, B)
    if _route(a, b, count, c0, cursor, out, *extra) == "cpu":
        return drain_records_plain(a, b, rids, count, c0, cursor, out,
                                   counts_out, k=k, width=width)
    if not B:  # the plain version's empty batch: one more slot
        cursor[1] += 1
    else:
        slots = 0 if counts_out is None else counts_out.shape[0]
        _call(library().pg_drain_records, a, b, rids if packed else 0, count,
              c0, cursor, out, 0 if counts_out is None else counts_out, B,
              width, ld, a.element_size(), k, out.shape[0], slots,
              0 if counts_out is None else counts_out.shape[2])
        drain_records.launches += 1
    return None


drain_records.launches = 0


def reduce_drain_plain(H, P, n, rids, c0, cursor, out, counts_out, *, r: int,
                       k: int, width: int) -> None:
    """Plain version of reduce_drain: the two plain versions."""
    oH, oP, count = reduce_step_plain(H, P, n, r)
    drain_records_plain(oH, oP, rids, count, c0, cursor, out, counts_out,
                        k=k, width=width)


def reduce_drain(H: torch.Tensor, P: torch.Tensor, n: torch.Tensor,
                 rids: torch.Tensor, c0: torch.Tensor, cursor: torch.Tensor,
                 out: torch.Tensor, counts_out, *, r: int, k: int,
                 width: int) -> None:
    """reduce_step(H, P, n, r=r) followed by drain_records of its output
    (rids, c0, cursor, out, counts_out, k, width as there), in one launch:
    the level's first min(count, width) winners of each row go to the
    tight (x, y) stream at cursor[0], slot cursor[1] of counts_out gets
    (c0, count), both cursors advance, and the level's planes are never
    written.  H, P: [B, L] int32 (u32 bits), n: [B] int32, L >= width.
    On a CUDA card one pg_reduce_drain launch (counted in
    reduce_drain.launches), with a look-back across the batch's rows; on
    the CPU reduce_drain_plain."""
    B, L = H.shape
    if not 1 < r < 256:
        raise ValueError(f"reduce_drain: r={r} outside 2..255")
    if not 0 <= width <= L or (B and not 0 < L < 1 << 25):
        raise ValueError(f"reduce_drain: width {width} of [{B}, {L}] planes "
                         "(rows of 1..2^25 - 1 columns)")
    _check(H, torch.int32, (B, L), "H")
    _check(P, torch.int32, (B, L), "P")
    _check(n, torch.int32, (B,), "n")
    _check(rids, torch.int64, (B,), "rids")
    _check(c0, torch.int32, (B,), "c0")
    _check(cursor, torch.int64, (3,), "cursor")
    _check(out, torch.int64, (out.shape[0], 2), "out")
    extra = _count_slots(counts_out, B)
    if _route(H, P, n, rids, c0, cursor, out, *extra) == "cpu":
        return reduce_drain_plain(H, P, n, rids, c0, cursor, out, counts_out,
                                  r=r, k=k, width=width)
    if not B:  # the plain version's empty batch: one more slot
        cursor[1] += 1
    else:
        slots = 0 if counts_out is None else counts_out.shape[0]
        _call_chunked(library().pg_reduce_drain, B, L, H.device,
                      (H, P, n, rids, c0),
                      (cursor, out, 0 if counts_out is None else counts_out),
                      B, L, r, k, width, out.shape[0], slots,
                      0 if counts_out is None else counts_out.shape[2],
                      chunk=REDUCE_CHUNK)
        reduce_drain.launches += 1
    return None


reduce_drain.launches = 0


def reduce_wide_drain_plain(x, y, n, c0, cursor, out, counts_out, *, r: int,
                            width: int) -> None:
    """Plain version of reduce_wide_drain: the two plain versions."""
    ox, oy, count = reduce_wide_plain(x, y, n, r)
    drain_records_plain(ox, oy, None, count, c0, cursor, out, counts_out,
                        k=0, width=width)


def reduce_wide_drain(x: torch.Tensor, y: torch.Tensor, n: torch.Tensor,
                      c0: torch.Tensor, cursor: torch.Tensor,
                      out: torch.Tensor, counts_out, *, r: int,
                      width: int) -> None:
    """reduce_wide(x, y, n, r=r) followed by drain_records of its output
    (c0, cursor, out, counts_out, width as there), in one launch: the
    level's first min(count, width) winners of each row go to the tight
    (x, y) stream at cursor[0], slot cursor[1] of counts_out gets (c0,
    count), both cursors advance, and the level's planes are never
    written.  x, y: [B, C] int64 records, which may be [:, :C] views of
    wider planes (read in place), n: [B] int32 (a count past C counts as
    C), C >= width; out [N, 2] int64 on a 16-byte boundary.  On a CUDA
    card one pg_reduce_wide_drain launch (counted in
    reduce_wide_drain.launches), with a look-back across the batch's rows
    (its status a slot a chunk and a slot a row); on the CPU
    reduce_wide_drain_plain."""
    B, C = x.shape
    if not 0 < r < 256:
        raise ValueError(f"reduce_wide_drain: r={r} outside 1..255")
    if not 0 <= width <= C or (B and not 0 < C < 1 << 25):
        raise ValueError(f"reduce_wide_drain: width {width} of [{B}, {C}] "
                         "planes (rows of 1..2^25 - 1 columns)")
    ld = _rows(x, y, torch.int64, B, C, "reduce_wide_drain")
    _check(n, torch.int32, (B,), "n")
    _check(c0, torch.int32, (B,), "c0")
    _check(cursor, torch.int64, (3,), "cursor")
    _check(out, torch.int64, (out.shape[0], 2), "out")
    if out.data_ptr() % 16:
        raise ValueError("reduce_wide_drain: out must start on a 16-byte "
                         "boundary (one record a 16-byte store)")
    extra = _count_slots(counts_out, B)
    if _route(x, y, n, c0, cursor, out, *extra) == "cpu":
        return reduce_wide_drain_plain(x, y, n, c0, cursor, out, counts_out,
                                       r=r, width=width)
    if not B:  # the plain version's empty batch: one more slot
        cursor[1] += 1
    else:
        slots = 0 if counts_out is None else counts_out.shape[0]
        _call_chunked(library().pg_reduce_wide_drain, B, C, x.device,
                      (x, y, n, c0),
                      (cursor, out, 0 if counts_out is None else counts_out),
                      B, C, ld, r, width, out.shape[0], slots,
                      0 if counts_out is None else counts_out.shape[2],
                      chunk=REDUCE_WIDE_CHUNK, row_slots=True)
        reduce_wide_drain.launches += 1
    return None


reduce_wide_drain.launches = 0

KERNELS = (build_stream, move_plane, emit_mask, reduce_step, compact_planes,
           wide_stream, wide_emit, reduce_wide, gather_codes, drain_records,
           gather_build_stream, reduce_drain, reduce_wide_drain)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0
