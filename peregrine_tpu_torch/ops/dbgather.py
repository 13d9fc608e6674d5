"""Device-resident seqdb: 2-bit packed upload + window gather.

The port of peregrine_tpu/ops/dbgather.py (see its docstring for the
packed layout).  The seqdb lives on the device as two uint8 planes:

  * fw:  2-bit forward base codes, 4 bases/byte, [rows, 128];
  * amb: 1-bit ambiguity flags (non-ACGT), 8 bases/byte, [rows, 128];

both with GUARD_BASES of zeros before the first base, so mirrored
strand-1 window starts stay in bounds.  The planes are byte-identical to
the JAX package's.  gather_codes is plain tensor indexing: the TPU's
whole-row gather with its shift-select ladder is a workaround for slow
element gathers that a GPU does not need.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

# guard (in bases) below the packed db start: a strand-1 window of true
# length len padded to L gathers from  start + len - L >= -L, so any
# L <= GUARD_BASES stays in bounds.  Multiple of 1024 (one amb row).
GUARD_BASES = 1 << 16


class PackedSeqDB(NamedTuple):
    """Two-plane packed seqdb on one device."""
    fw: torch.Tensor    # [Rf, 128] uint8 — 2-bit codes, 4 bases/byte
    amb: torch.Tensor   # [Ra, 128] uint8 — ambiguity bits, 8 bases/byte


def pack_db_np(data: np.ndarray, guard_bases: int = GUARD_BASES
               ) -> tuple[np.ndarray, np.ndarray]:
    """Host packing: 4-bit codec bytes -> (fw bytes, amb bytes) with the
    guard region prepended (one C++ pass, native/pack2.cpp)."""
    assert guard_bases % 1024 == 0
    from ..native import pack_db
    return pack_db(data, guard_bases)


def _pad_rows(flat: np.ndarray, floor_rows: int) -> np.ndarray:
    """[N] bytes -> [rows, 128] with a bounded set of row counts: pow2
    with 3 mantissa bits (<= 8 shape classes per octave) — the JAX
    package's shape classes, kept so both packages hold the same planes."""
    n_rows = max(1, -(-len(flat) // 128))
    if n_rows <= floor_rows:
        rpad = floor_rows
    else:
        unit = max(floor_rows, 1 << max(0, (n_rows - 1).bit_length() - 3))
        rpad = -(-n_rows // unit) * unit
    rows = np.zeros((rpad, 128), np.uint8)
    rows.reshape(-1)[:len(flat)] = flat
    return rows


def packed_from_numpy(fw: np.ndarray, amb: np.ndarray, device) -> PackedSeqDB:
    """A PackedSeqDB from numpy planes (e.g. the JAX package's planes)."""
    def put(a):
        return torch.from_numpy(np.require(a, np.uint8, ["C", "W"])).to(device)
    return PackedSeqDB(fw=put(fw), amb=put(amb))


def upload_seqdb(data: np.ndarray, device) -> PackedSeqDB:
    """Pack the 4-bit seqdb bytes and move both planes to `device`."""
    fw, ambb = pack_db_np(data)
    return packed_from_numpy(_pad_rows(fw, 1 << 19), _pad_rows(ambb, 1 << 17),
                             device)


def gather_offsets(off: np.ndarray, lens: np.ndarray, strand: np.ndarray,
                   read_start: np.ndarray, L: int):
    """Host helper: gather start per request.  strand 0 -> window start;
    strand 1 -> mirrored start (windows must end at their read's end)."""
    return np.where(strand == 0, off, read_start + lens - L)


def gather_codes(pdb: PackedSeqDB, goff: torch.Tensor, lens: torch.Tensor,
                 strand: torch.Tensor | None, L: int,
                 fill: int) -> torch.Tensor:
    """[B] windows -> [B, L] uint8 2-bit codes (ambiguous/padding = fill).

    goff is the GATHER start from gather_offsets (mirror-adjusted for
    strand 1); strand-1 windows come out flipped and complemented.
    strand None: every window on strand 0, as the index builds read them.
    """
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
