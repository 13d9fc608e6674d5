"""Shards over devices, and the two collectives the sharded algorithms use.

The port's counterpart of the JAX package's one-axis device mesh
(peregrine_tpu/parallel/sharded_index.py:make_mesh and the shard_map
programs over it).  A Mesh has two forms with the same interface:

  * Mesh(devices): every shard lives in this process, one torch.device
    each (a device may repeat: four shards on one card, or eight on the
    CPU).  all_to_all is a transpose of the per-shard send buffers.
    --mesh uses it over the visible cards.
  * Mesh.from_group(group, device): one shard per rank of a
    torch.distributed process group, this rank's on `device`.  The
    collectives are dist.all_to_all_single and dist.all_gather with equal
    splits (NCCL on cuda; gloo on cpu, or on a card two ranks share).
    gloo takes no CUDA tensors for these, so a gloo group on a card
    exchanges through host memory.  --multihost uses it.

Every collective takes one tensor per local shard (all n in the first
form, this rank's one in the second) in `mesh.local` order, and every
process that holds a shard must call it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class Mesh:
    def __init__(self, devices, group=None):
        """devices: the device of each shard this process holds."""
        self.devices = [torch.device(d) for d in devices]
        self.group = group
        if group is None:
            self.n = len(self.devices)
            self.local = list(range(self.n))
            self._staged = False
        else:
            if len(self.devices) != 1:
                raise ValueError("a process group's mesh holds one shard a "
                                 f"rank, not {len(self.devices)}")
            self.n = dist.get_world_size(group)
            self.local = [dist.get_rank(group)]
            self._staged = (dist.get_backend(group) == "gloo"
                            and self.devices[0].type == "cuda")

    @classmethod
    def from_group(cls, group, device) -> "Mesh":
        return cls([device], group)

    def __repr__(self) -> str:
        form = "in-process" if self.group is None else "process group"
        return f"Mesh({self.n} shards, {form}, {self.devices})"

    def shards(self):
        """(shard index, device) of each shard this process holds."""
        return zip(self.local, self.devices)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.contiguous().cpu() if self._staged else t.contiguous()

    def all_to_all(self, sends: list) -> list:
        """sends[i]: [n, cap, ...] rows of local shard i, row j bound for
        shard j.  Returns per local shard the [n, cap, ...] rows it
        received, row j from shard j, on its device."""
        if self.group is None:
            return [torch.stack([s[d].to(dev) for s in sends])
                    for d, dev in self.shards()]
        send = self._wire(sends[0])
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.group)
        return [recv.to(self.devices[0])]

    def all_gather(self, parts: list) -> list:
        """parts[i]: a tensor of local shard i whose first dimension may
        differ between shards (the rest may not).  Returns every shard's
        tensor, in shard order, on the host."""
        if self.group is None:
            return [p.cpu() for p in parts]
        part = self._wire(parts[0])
        n0 = torch.tensor([part.shape[0]], dtype=torch.int64,
                          device=part.device)
        sizes = [torch.empty_like(n0) for _ in range(self.n)]
        dist.all_gather(sizes, n0, group=self.group)
        sizes = [int(s) for s in sizes]
        buf = part.new_zeros((max(sizes),) + tuple(part.shape[1:]))
        buf[:part.shape[0]] = part
        got = [torch.empty_like(buf) for _ in range(self.n)]
        dist.all_gather(got, buf, group=self.group)
        return [g[:s].cpu() for g, s in zip(got, sizes)]


def exchange(mesh: Mesh, targets: list, lanes: list) -> list:
    """Send records to their target shards.  targets[i]: int64 [m_i]
    target of each record of local shard i; lanes[i]: its int64 [m_i,
    c] record columns (c the same on every shard).  Returns per local
    shard the [m, c] records sent to it, by source shard and in each
    source's order.

    Each shard sorts its records stably by target and scatters each one
    straight to its slot of an [n, cap, c] send buffer; the [n] send
    counts are exchanged first, so cap is the largest count of any
    (source, target) pair and nothing can overflow."""
    routed, sent = [], []
    for t, cols in zip(targets, lanes):
        order = torch.sort(t, stable=True).indices
        st = t[order]
        cnt = torch.bincount(st, minlength=mesh.n)
        slot = (torch.arange(st.numel(), device=st.device)
                - (torch.cumsum(cnt, 0) - cnt)[st])
        routed.append((st, slot, cols[order]))
        sent.append(cnt)
    counts = torch.stack(mesh.all_gather(sent))      # [source, target]
    cap = max(1, int(counts.max()))
    sends = []
    for st, slot, cols in routed:
        buf = cols.new_zeros((mesh.n, cap, cols.shape[1]))
        buf[st, slot] = cols
        sends.append(buf)
    out = []
    for (d, dev), recv in zip(mesh.shards(), mesh.all_to_all(sends)):
        keep = (torch.arange(cap, device=dev)[None, :]
                < counts[:, d].to(dev)[:, None])
        out.append(recv[keep])
    return out


def make_mesh(device, n: int | None = None) -> Mesh:
    """A mesh of this process's devices: on cuda the first n visible cards
    (all of them by default), on cpu n CPU shards (one by default)."""
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        if count == 0:
            raise RuntimeError("a cuda mesh was asked for but torch sees no "
                               "CUDA device")
        n = count if n is None else n
        if not 1 <= n <= count:
            raise ValueError(f"a mesh of {n} cards asked for; {count} visible")
        return Mesh([torch.device("cuda", i) for i in range(n)])
    return Mesh([device] * (n or 1))
