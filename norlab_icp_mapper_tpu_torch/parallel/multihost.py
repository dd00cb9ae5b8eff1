"""Multi-process entry: ``torch.distributed`` set-up and per-rank blocks.

One rank per device, as PyTorch runs it (the JAX package runs one
controller over all devices; its ``shard_map`` code sees one block per
device, which is what a rank holds here).  A multi-process run needs:

  1. ``initialize()``: one call per process before the first collective.
     It wraps ``torch.distributed.init_process_group`` (NCCL for the card,
     gloo for the CPU) and reads torchrun's ``MASTER_ADDR`` /
     ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``, as the JAX version reads
     ``JAX_COORDINATOR_ADDRESS`` / ``JAX_NUM_PROCESSES`` /
     ``JAX_PROCESS_ID``, so one entry point works under any launcher;
  2. ``make_global_array``: each rank keeps only its own leading-axis block
     of a value every rank passes whole;
  3. replicated inputs (the reading, poses, stamps) passed alike on every
     rank.

NCCL takes one GPU per rank: two ranks on one card are refused
("Duplicate GPU detected").  Runs with several ranks on one machine use the
CPU and gloo, or one card per rank.
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
import torch
import torch.distributed as dist

from ..draws import resolve_device

__all__ = ["initialize", "make_global_array", "process_count",
           "process_index", "rank_device"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: Union[str, torch.device, None] = None) -> None:
    """Join this process to the run's process group.

    ``coordinator_address`` is ``host:port`` (default ``MASTER_ADDR`` and
    ``MASTER_PORT``), ``num_processes`` the world size (``WORLD_SIZE``),
    ``process_id`` this rank (``RANK``).  ``device`` picks the backend:
    NCCL for the card (the default; raises without one), gloo for
    ``"cpu"``.  On the card, rank ``r`` takes GPU ``LOCAL_RANK`` (default
    ``r`` modulo the cards here).  Does nothing for a single process with
    no coordinator, or when the group already exists.
    """
    dev = resolve_device(device)
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None and (num_processes or 1) == 1:
        return  # single process: nothing to coordinate
    if dist.is_initialized():
        return
    if coordinator_address is None or process_id is None \
            or num_processes is None:
        raise ValueError(
            "initialize needs the coordinator address, the number of "
            "processes and this process's id (arguments, or MASTER_ADDR / "
            "MASTER_PORT, WORLD_SIZE and RANK)")
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK",
                                   process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(
        backend="nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device_type: str) -> torch.device:
    """This rank's device for a mesh of ``device_type``."""
    if device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device_type)


def make_global_array(full: np.ndarray, mesh, axis: str = "cells"
                      ) -> torch.Tensor:
    """This rank's leading-axis block of ``full`` as a plain tensor on its
    device.  Every rank passes the same ``full``; its leading dimension
    must divide by the mesh's size along ``axis``."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    r = mesh.get_local_rank(axis)
    if full.shape[0] % n:
        raise ValueError(f"leading dimension {full.shape[0]} does not "
                         f"divide into {n} blocks")
    b = full.shape[0] // n
    block = torch.from_numpy(np.ascontiguousarray(full[r * b:(r + 1) * b]))
    return block.to(rank_device(mesh.device_type))
