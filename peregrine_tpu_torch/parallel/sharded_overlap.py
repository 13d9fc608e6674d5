"""Multi-device overlap alignment over a read-sharded seqdb.

The port of peregrine_tpu/parallel/sharded_overlap.py.  When the packed
seqdb outgrows one device, each shard holds only its reads' 2-bit and
ambiguity planes (ops.dbgather's layout), and alignment requests travel
to the data instead of the data being replicated.  Per call:

1. the host routes each request to the shard owning its query read,
   grouped by the shard owning its target read (gather starts of strand
   1 mirror-adjusted, ops.dbgather.gather_offsets' rule);
2. the query owner gathers each query window with its strand applied
   (gather_codes, fill 7), packs it 2-bit plus ambiguity bits (_pack2)
   and sends it to the target owner (Mesh.all_to_all);
3. the target owner gathers its target windows the same way, writes the
   two windows of every lane into one temporary PackedSeqDB (GUARD_BASES
   first, as pack_db_np lays a seqdb out) and aligns them with one
   myers_batch_db call (pg_myers_align on a card) whose strand-0
   request columns point at the windows.  The aligner reads exactly the
   codes the reference's _myers_core reads in _exchange_align;
4. results come back in request order (gathered to every rank under a
   process group).

The reference unpacks the exchanged windows (_unpack2) before its
aligner; here they stay packed, since the aligner reads packed planes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.dbgather import (GUARD_BASES, PackedSeqDB, _pad_rows, gather_codes,
                            pack_db_np)
from ..ops.device_align import NB, myers_batch_db
from .mesh import Mesh

# gather_codes' peak bytes per window base (its int64 index, code and
# ambiguity planes), and the transients one gather may hold
GATHER_BYTES_PER_BASE = 64
GATHER_BYTES = 1 << 30


@dataclass
class ShardedSeqDB:
    """Read-sharded packed seqdb: planes of this process's shards."""
    planes: dict             # shard -> PackedSeqDB on its device
    base: np.ndarray         # [n] base offset where each shard starts
    owner: np.ndarray        # [n_reads] owning shard of each read
    read_off: np.ndarray     # [n_reads] absolute read start offsets
    read_len: np.ndarray     # [n_reads] read lengths
    mesh: Mesh


def shard_seqdb(data: np.ndarray, offsets: np.ndarray, lengths: np.ndarray,
                mesh: Mesh) -> ShardedSeqDB:
    """Split the seqdb into read-aligned shards and pack each on its
    device (only this process's shards).

    Greedy byte-balanced cuts at read starts, floored to 1024-base blocks
    (one ambiguity row): flooring can pull the previous read's tail into
    the next shard, so segment d runs from cut[d] to the start of the
    first read of shard d + 1, and a read never straddles two shards."""
    n = mesh.n
    total = len(data)
    n_reads = len(offsets)
    offsets = np.asarray(offsets, np.int64)
    target = total / n
    cut = np.zeros(n + 1, np.int64)
    r = 0
    for d in range(1, n):
        want = int(round(d * target))
        while r < n_reads and offsets[r] < want:
            r += 1
        cut[d] = (int(offsets[r]) >> 10) << 10 if r < n_reads else total
    cut[n] = total
    base = cut[:n].copy()
    owner = np.searchsorted(cut[1:n], offsets, side="right").astype(np.int32)
    first_of = np.searchsorted(owner, np.arange(n + 1))
    seg_end = np.where(first_of[1:] < n_reads,
                       offsets[np.minimum(first_of[1:], n_reads - 1)], total)
    planes = {}
    for d, dev in mesh.shards():
        fw, amb = pack_db_np(np.asarray(data[base[d]:seg_end[d]]))
        planes[d] = PackedSeqDB(
            fw=torch.from_numpy(_pad_rows(fw, 1)).to(dev),
            amb=torch.from_numpy(_pad_rows(amb, 1)).to(dev))
    return ShardedSeqDB(planes=planes, base=base, owner=owner,
                        read_off=offsets,
                        read_len=np.asarray(lengths, np.int64), mesh=mesh)


def _pack2(codes: torch.Tensor):
    """[B, L] u8 codes (0-3, or >= 4 for none) -> ([B, L/4] 2-bit codes,
    [B, L/8] ambiguity bits), pack_db_np's bit order."""
    B, L = codes.shape
    amb = (codes >= 4).to(torch.uint8)
    c = torch.where(amb == 1, 0, codes).to(torch.uint8).view(B, L // 4, 4)
    packed = c[..., 0] | (c[..., 1] << 2) | (c[..., 2] << 4) | (c[..., 3] << 6)
    a = amb.view(B, L // 8, 8).to(torch.int32)
    bits = (a << torch.arange(8, device=codes.device, dtype=torch.int32)
            ).sum(2)
    return packed, bits.to(torch.uint8)


def _gather_packed(pdb: PackedSeqDB, loc, lens, strand, L: int):
    """gather_codes(fill=7) then _pack2 of [B] windows, gather_lanes(L)
    lanes at a time: gather_codes holds int64 planes of [lanes, L], so a
    call's transients stay near GATHER_BYTES whatever B is, and only the
    packed windows, 3/8 of a byte a base, are kept."""
    step = gather_lanes(L)
    packed = [_pack2(gather_codes(pdb, lo, ln, st, L, fill=7))
              for lo, ln, st in zip(loc.split(step), lens.split(step),
                                    strand.split(step))]
    return (torch.cat([p for p, _ in packed]),
            torch.cat([a for _, a in packed]))


def gather_lanes(L: int) -> int:
    """Lanes of L bases whose gather_codes transients fit GATHER_BYTES."""
    return max(1, GATHER_BYTES // (GATHER_BYTES_PER_BASE * L))


def _window_db(qp, qa, tp, ta) -> PackedSeqDB:
    """One packed seqdb holding lane i's query window at bases
    [2iL, 2iL + L) and its target window at [2iL + L, 2(i + 1)L), after
    GUARD_BASES of zeros."""
    dev = qp.device
    fw = torch.cat([torch.zeros(GUARD_BASES // 4, dtype=torch.uint8,
                                device=dev),
                    torch.cat([qp, tp], 1).reshape(-1)])
    amb = torch.cat([torch.zeros(GUARD_BASES // 8, dtype=torch.uint8,
                                 device=dev),
                     torch.cat([qa, ta], 1).reshape(-1)])

    def rows(a):
        out = a.new_zeros((-(-a.numel() // 128), 128))
        out.view(-1)[:a.numel()] = a
        return out
    return PackedSeqDB(fw=rows(fw), amb=rows(amb))


def sharded_align(sdb: ShardedSeqDB,
                  q_rid: np.ndarray, q_off: np.ndarray, q_len: np.ndarray,
                  q_strand: np.ndarray,
                  t_rid: np.ndarray, t_off: np.ndarray, t_len: np.ndarray,
                  t_strand: np.ndarray, *, L: int, nb: int = NB):
    """Banded alignment of (query window, target read) requests against
    the sharded seqdb; returns (dist, q_end, t_end) int32 numpy arrays in
    request order, equal to myers_batch_db's on the whole seqdb.

    q_off/t_off are absolute offsets into the unsharded seqdb; every
    window ends at its read's end and is at most L bases (L % 8 == 0)."""
    mesh = sdb.mesh
    n = mesh.n
    nreq = len(q_rid)
    src = sdb.owner[q_rid].astype(np.int64)
    dst = sdb.owner[t_rid].astype(np.int64)
    q_len = np.asarray(q_len, np.int64)
    t_len = np.asarray(t_len, np.int64)
    if nreq and max(q_len.max(), t_len.max()) > L:
        raise ValueError(f"sharded_align: a window is longer than L={L}")
    qloc = np.where(q_strand == 0, q_off,
                    sdb.read_off[q_rid] + q_len - L) - sdb.base[src]
    tloc = np.where(t_strand == 0, t_off, t_off + t_len - L) - sdb.base[dst]

    # slots per (source, target) pair; the cap is the largest group
    pair = src * n + dst
    order = np.argsort(pair, kind="stable")
    counts = np.bincount(pair, minlength=n * n).reshape(n, n)
    cap = max(1, int(counts.max()))
    starts = np.concatenate([[0], np.cumsum(counts.reshape(-1))[:-1]])
    slot = np.empty(nreq, np.int64)
    slot[order] = np.arange(nreq) - np.repeat(starts, counts.reshape(-1))
    fields = np.stack([q_len, tloc, t_len, np.asarray(t_strand, np.int64)], 1)

    # query owners: gather, pack and send the windows and target fields
    sends_q, sends_a, sends_f = [], [], []
    for s, dev in mesh.shards():
        mine = np.flatnonzero(src == s)
        at = torch.from_numpy(dst[mine] * cap + slot[mine]).to(dev)
        qp, qa = _gather_packed(sdb.planes[s], torch.from_numpy(qloc[mine]),
                                torch.from_numpy(q_len[mine]),
                                torch.from_numpy(np.asarray(q_strand)[mine]),
                                L)
        bq = qp.new_zeros((n * cap, L // 4))
        ba = qa.new_zeros((n * cap, L // 8))
        bf = torch.zeros((n * cap, 4), dtype=torch.int64, device=dev)
        bq[at], ba[at] = qp, qa
        bf[at] = torch.from_numpy(fields[mine]).to(dev)
        sends_q.append(bq.view(n, cap, -1))
        sends_a.append(ba.view(n, cap, -1))
        sends_f.append(bf.view(n, cap, -1))
    recv = zip(mesh.all_to_all(sends_q), mesh.all_to_all(sends_a),
               mesh.all_to_all(sends_f))

    # target owners: gather their windows and align every lane received
    outs = []
    for (d, dev), (rq, ra, rf) in zip(mesh.shards(), recv):
        lanes = (torch.arange(cap, device=dev)[None, :]
                 < torch.from_numpy(counts[:, d]).to(dev)[:, None])
        qp, qa, f = rq[lanes], ra[lanes], rf[lanes]
        B = f.shape[0]
        tp, ta = _gather_packed(sdb.planes[d], f[:, 1], f[:, 2], f[:, 3], L)
        lane0 = torch.arange(B, device=dev) * (2 * L)
        zero = torch.zeros_like(lane0)
        cols = torch.stack([lane0, lane0, f[:, 0], zero, lane0 + L, f[:, 2],
                            zero], 1)
        res = myers_batch_db(_window_db(qp, qa, tp, ta), cols, nb=nb)
        outs.append(torch.stack([r.to(torch.int64) for r in res], 1))

    # lane order at target d: by source, then slot
    got = mesh.all_gather(outs)
    first = np.concatenate([np.zeros((1, n), np.int64),
                            np.cumsum(counts, 0)])[:-1]
    at = first[src, dst] + slot
    res = np.zeros((nreq, 3), np.int32)
    for d in range(n):
        sel = np.flatnonzero(dst == d)
        res[sel] = got[d].numpy()[at[sel]]
    return res[:, 0], res[:, 1], res[:, 2]
