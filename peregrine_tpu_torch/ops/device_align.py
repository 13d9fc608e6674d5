"""Batched banded Myers bit-parallel aligner: the device overlap aligner.

The port of peregrine_tpu/ops/device_align.py (see its docstring for how
its results differ from the host aligner's).  A lane aligns a query
against a target, both anchored at a SHIMMER hit: the optimal edit
distance within a band of NB 32-bit words (256 DP cells) that slides
along the anchor diagonal, and the alignment's ends.

  myers_batch_db   <- myers_batch_db_packed (:216) and _myers_core (:66):
                      requests as seven int64 columns against the packed
                      device seqdb; on a CUDA tensor one launch of
                      pg_myers_align (csrc/myers_align.cu) for every lane,
                      longest target first (launch_order), on a CPU
                      tensor gather_codes then myers_core_plain
  myers_core_plain <- _myers_core: the plain PyTorch version, vectorised
                      over lanes with a Python loop over columns
  myers_batch_np   <- myers_batch_np (:257): lists of code arrays

The kernel builds with nvcc for sm_90a at its first launch (ctypes, a
plain C interface) and counts its launches in myers_batch_db.launches.
Torch has no usable uint32, so the plain version keeps each 32-bit word
in int64, masked to 32 bits after every +, ~ and <<.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np
import torch

from .._build import load_cuda
from .dbgather import PackedSeqDB, gather_codes, packed_from_numpy, pack_db_np
from .kernels import _call

NB = 8      # window words; the kernel is built for this width
WB = 32     # DP cells per word
BIG = 1 << 30
_M = 0xFFFFFFFF

_CU = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "csrc", "myers_align.cu")
_VP, _INT, _I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of the C entry, in the order of its prototype in the .cu file
# (a test checks the two agree)
SIGNATURES = {
    "pg_myers_align": [_VP, _VP, _I64, _I64, _VP, _VP, _INT, _INT, _VP, _VP,
                       _VP, _VP],
}
_lib = None


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the aligner library."""
    global _lib
    if _lib is None:
        _lib = load_cuda("myers_align", _CU, SIGNATURES)
    return _lib


def _pack_peq(q_codes: torch.Tensor, nbq: int) -> torch.Tensor:
    """[B, LQ] codes -> [B, 5, nbq] match masks of codes 0..3 and, as
    row 4, no match (the column code 7 selects it)."""
    B, LQ = q_codes.shape
    qc = torch.full((B, nbq * WB), 7, dtype=torch.int64, device=q_codes.device)
    qc[:, :LQ] = q_codes.to(torch.int64)
    blocks = qc.view(B, nbq, WB)
    weight = 1 << torch.arange(WB, dtype=torch.int64, device=q_codes.device)
    peq = [((blocks == c).to(torch.int64) * weight).sum(2) for c in range(4)]
    return torch.stack(peq + [torch.zeros_like(peq[0])], dim=1)


def _block_update(pv, mv, eq, hp, hm):
    """One Myers block step on [B] lanes of 32-bit words in int64.  The
    horizontal delta into and out of the block is (hp, hm): +1 is (1, 0),
    -1 is (0, 1), 0 is (0, 0); the two are never both set (pv & mv and
    ph & mh are disjoint), so hin < 0 is hm and hin > 0 is hp."""
    xv = eq | mv
    eq = eq | hm
    xh = ((((eq & pv) + pv) & _M) ^ pv) | eq
    ph = mv | ((xh | pv) ^ _M)
    mh = pv & xh
    hp_out, hm_out = ph >> 31, mh >> 31
    ph = ((ph << 1) & _M) | hp
    mh = ((mh << 1) & _M) | hm
    return mh | ((xv | ph) ^ _M), ph & xv, hp_out, hm_out


def myers_core_plain(q_codes: torch.Tensor, q_lens: torch.Tensor,
                     t_codes: torch.Tensor, t_lens: torch.Tensor, *,
                     nb: int = NB):
    """Plain version of _myers_core (peregrine_tpu/ops/device_align.py:66).

    q_codes [B, LQ] and t_codes [B, LT] are 2-bit codes (>= 4 matches
    nothing), q_lens and t_lens [B] their true lengths.  Returns (dist,
    q_end, t_end) int32 [B]."""
    dev = q_codes.device
    B, LQ = q_codes.shape
    LT = t_codes.shape[1]
    nbq = -(-max(LQ, LT + nb * WB) // WB) + nb + 1
    peq = _pack_peq(q_codes, nbq)
    q_lens = q_lens.to(dev, torch.int64)
    t_lens = t_lens.to(dev, torch.int64)
    n_chunks = -(-LT // WB)
    tc = torch.full((B, n_chunks * WB), 7, dtype=torch.int64, device=dev)
    tc[:, :LT] = t_codes.to(torch.int64)
    tc = torch.where(tc < 4, tc, 4)   # row 4 of peq: no match

    pv = [torch.full((B,), _M, dtype=torch.int64, device=dev)] * nb
    mv = [torch.zeros(B, dtype=torch.int64, device=dev)] * nb
    bot = torch.full((B,), nb * WB, dtype=torch.int64, device=dev)
    best_te_d = torch.full((B,), BIG, dtype=torch.int64, device=dev)
    best_te_j = torch.zeros(B, dtype=torch.int64, device=dev)
    snap_pv, snap_mv, snap_bot = list(pv), list(mv), bot.clone()
    snap_w0 = torch.zeros(B, dtype=torch.int64, device=dev)
    ends = set((t_lens - 1).tolist())   # the columns that take a snapshot

    for chunk in range(n_chunks):
        w0 = max(0, chunk - nb // 2)
        if chunk > 0 and w0 > max(0, chunk - 1 - nb // 2):
            pv = pv[1:] + [torch.full((B,), _M, dtype=torch.int64, device=dev)]
            mv = mv[1:] + [torch.zeros(B, dtype=torch.int64, device=dev)]
            bot = bot + WB
        win = peq[:, :, w0:w0 + nb]                         # [B, 5, nb]
        bottom_row = (w0 + nb) * WB
        covers_q = bottom_row >= q_lens
        for u in range(WB):
            j = chunk * WB + u
            c = tc[:, j]
            eqw = win.gather(1, c[:, None, None].expand(B, 1, nb))[:, 0]
            hp, hm = 1, 0
            for b in range(nb):
                pv[b], mv[b], hp, hm = _block_update(pv[b], mv[b], eqw[:, b],
                                                     hp, hm)
            bot = bot + hp - hm
            d_lq = bot - (bottom_row - q_lens)
            better = (j < t_lens) & covers_q & (d_lq < best_te_d)
            best_te_d = torch.where(better, d_lq, best_te_d)
            best_te_j = torch.where(better, j + 1, best_te_j)
            if j in ends:
                last = t_lens == j + 1
                snap_pv = [torch.where(last, a, s) for a, s in zip(pv, snap_pv)]
                snap_mv = [torch.where(last, a, s) for a, s in zip(mv, snap_mv)]
                snap_bot = torch.where(last, bot, snap_bot)
                snap_w0 = torch.where(last, w0, snap_w0)

    # query-end readout: walk the scores up the snapshot column
    bit = torch.arange(WB, device=dev)
    words_p, words_m = torch.stack(snap_pv, 1), torch.stack(snap_mv, 1)
    pv_bits = ((words_p[:, :, None] >> bit) & 1).reshape(B, nb * WB)
    mv_bits = ((words_m[:, :, None] >> bit) & 1).reshape(B, nb * WB)
    suffix = torch.cumsum((pv_bits - mv_bits).flip(1), dim=1)
    bottom = (snap_w0 + nb) * WB
    rows = torch.cat([bottom[:, None], bottom[:, None] - torch.arange(
        1, nb * WB + 1, device=dev)[None, :]], dim=1)
    scores = torch.cat([snap_bot[:, None], snap_bot[:, None] - suffix], dim=1)
    valid = (rows >= 0) & (rows <= q_lens[:, None])
    scores = torch.where(valid, scores, BIG)
    qe_idx = torch.argmin(scores, dim=1, keepdim=True)  # the first minimum
    best_qe_d = scores.gather(1, qe_idx)[:, 0]
    best_qe_row = rows.gather(1, qe_idx)[:, 0]

    use_te = best_te_d <= best_qe_d
    dist = torch.where(use_te, best_te_d, best_qe_d)
    q_end = torch.where(use_te, q_lens, best_qe_row)
    t_end = torch.where(use_te, best_te_j, t_lens)
    return dist.to(torch.int32), q_end.to(torch.int32), t_end.to(torch.int32)


def myers_batch_db_plain(pdb: PackedSeqDB, cols: torch.Tensor, *,
                         nb: int = NB):
    """Plain version of myers_batch_db: gather both windows with
    gather_codes (fill 7) at the longest lane's length, rounded up to 8
    (the result does not depend on it), then myers_core_plain."""
    dev = pdb.fw.device
    cols = cols.to(dev)
    q_off, q_rs, q_len, q_str, t_off, t_len, t_str = cols.unbind(1)
    q_len, t_len = q_len.to(torch.int32), t_len.to(torch.int32)
    q_str, t_str = q_str.to(torch.int32), t_str.to(torch.int32)
    L = max(8, -(-int(max(int(q_len.max()), int(t_len.max()))) // 8) * 8)
    qgo = torch.where(q_str == 0, q_off, q_rs + q_len - L)
    tgo = torch.where(t_str == 0, t_off, t_off + t_len - L)
    qc = gather_codes(pdb, qgo, q_len, q_str, L, fill=7)
    tc = gather_codes(pdb, tgo, t_len, t_str, L, fill=7)
    return myers_core_plain(qc, q_len, tc, t_len, nb=nb)


def launch_order(cols: torch.Tensor) -> torch.Tensor:
    """The order in which the kernel's lanes take the requests: by
    descending t_len, then request index (a stable sort), so that a
    warp's 32 lanes end together and the longest start first."""
    return torch.sort(cols[:, 5], descending=True, stable=True).indices


def myers_batch_db(pdb: PackedSeqDB, cols: torch.Tensor, *, nb: int = NB):
    """Align [B, 7] int64 requests (q_off, q_rstart, q_len, q_strand,
    t_off, t_len, t_strand) against the packed seqdb on its device.
    Returns (dist, q_end, t_end) int32 [B] on that device: on a CUDA
    device from one pg_myers_align launch for all B lanes (lane i works
    on request launch_order(cols)[i] and writes its outputs there, so
    they come back in request order), on the CPU from the plain
    version."""
    B = cols.shape[0]
    if cols.dtype != torch.int64 or cols.dim() != 2 or cols.shape[1] != 7:
        raise ValueError(f"cols: want int64 [B, 7], got {cols.dtype} "
                         f"{tuple(cols.shape)}")
    kinds = {t.device.type for t in (pdb.fw, pdb.amb, cols)}
    if kinds == {"cpu"}:
        if B == 0:
            z = torch.zeros(0, dtype=torch.int32)
            return z, z.clone(), z.clone()
        return myers_batch_db_plain(pdb, cols, nb=nb)
    if kinds != {"cuda"} or len({pdb.fw.device, pdb.amb.device,
                                 cols.device}) != 1:
        raise ValueError(f"myers_batch_db takes cpu or cuda tensors on one "
                         f"device, got {sorted(kinds)}")
    if nb != NB:
        raise ValueError(f"myers_batch_db: the kernel is built for nb={NB}, "
                         f"got {nb}")
    for name, t in (("fw", pdb.fw), ("amb", pdb.amb)):
        if t.dtype != torch.uint8 or not t.is_contiguous():
            raise ValueError(f"{name}: want a contiguous uint8 plane")
    if not cols.is_contiguous():
        raise ValueError("cols: want a contiguous tensor")
    out = [torch.empty(B, dtype=torch.int32, device=cols.device)
           for _ in range(3)]
    if B:
        _call(library().pg_myers_align, pdb.fw, pdb.amb, pdb.fw.numel(),
              pdb.amb.numel(), cols, launch_order(cols), B, nb, *out)
        myers_batch_db.launches += 1
    return tuple(out)


myers_batch_db.launches = 0


def myers_batch_np(qs: list[np.ndarray], ts: list[np.ndarray], nb: int = NB,
                   device="cuda") -> list[tuple[int, int, int]]:
    """Host convenience: align query i against target i (2-bit code
    arrays, >= 4 matches nothing) on `device`, the card unless the caller
    asks for the CPU; returns [(dist, q_end, t_end)].  The sequences go
    into a packed seqdb, codes >= 4 as ambiguous bases."""
    seqs = [np.asarray(s, np.uint8) for s in list(qs) + list(ts)]
    offs = np.cumsum([0] + [len(s) for s in seqs[:-1]]).astype(np.int64)
    codes = np.concatenate(seqs)
    nibbles = np.frombuffer(b"\x01\x02\x04\x08", np.uint8)  # A C G T
    fw, amb = pack_db_np(np.where(codes < 4, nibbles[np.minimum(codes, 3)], 0)
                         .astype(np.uint8))
    pdb = packed_from_numpy(fw, amb, torch.device(device))
    B = len(qs)
    cols = np.zeros((B, 7), np.int64)
    cols[:, 0] = cols[:, 1] = offs[:B]
    cols[:, 2] = [len(q) for q in qs]
    cols[:, 4] = offs[B:]
    cols[:, 5] = [len(t) for t in ts]
    out = myers_batch_db(pdb, torch.from_numpy(cols).to(pdb.fw.device), nb=nb)
    d, qe, te = (o.cpu().tolist() for o in out)
    return list(zip(d, qe, te))
