"""Multi-process execution over torch.distributed.

The port of peregrine_tpu/parallel/distributed.py.  A multi-process run
starts one process per card (torchrun sets RANK, WORLD_SIZE,
MASTER_ADDR, MASTER_PORT and LOCAL_RANK), each calls init_distributed(),
and the sharded programs (parallel.sharded_index and friends) run over
global_mesh(), one shard per rank: reads stay data-parallel across the
ranks and SHIMMER records ride the collectives to their hash shard.
Stage files remain checkpoints on a shared filesystem; only rank 0
writes merged outputs.

The backend is NCCL for cuda and gloo for cpu unless the caller names
one.  NCCL takes one rank per card; ranks that share a card (more ranks
than cards: rank r runs on cuda:(LOCAL_RANK % cards)) need gloo.  With
no group (no torchrun environment and no arguments) every function here
describes a single process: rank 0 of 1, and barrier() does nothing.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from .mesh import Mesh, make_mesh

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def local_device(device) -> torch.device:
    """This rank's device: cuda:(LOCAL_RANK % visible cards) for cuda,
    the device itself otherwise."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % max(1, torch.cuda.device_count()))


def init_distributed(init_method: str | None = None,
                     world_size: int | None = None,
                     rank: int | None = None, backend: str | None = None,
                     device="cuda",
                     timeout: datetime.timedelta | None = None) -> int:
    """Join the process group; returns this process's rank.

    With no arguments it reads torchrun's environment (env:// init), and
    without that environment it creates no group and returns 0, as the
    JAX package's single-process branch does.  device names where this
    rank computes, which picks the default backend."""
    if dist.is_initialized():
        return dist.get_rank()
    if init_method is None and world_size is None and not all(
            v in os.environ for v in _ENV):
        return 0
    if backend is None:
        backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    kw = {} if timeout is None else {"timeout": timeout}
    dev = local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank, **kw)
    return dist.get_rank()


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    return rank() == 0


def barrier(tag: str = "") -> None:
    """Wait for every rank (the JAX package's sync_global_devices(tag));
    nothing without a group."""
    if dist.is_initialized():
        dist.barrier()


def global_mesh(device) -> Mesh:
    """One shard per rank of the process group, this rank's on
    local_device(device); without a group, the mesh of this process's
    devices (make_mesh)."""
    if dist.is_initialized():
        return Mesh.from_group(dist.group.WORLD, local_device(device))
    return make_mesh(device)
