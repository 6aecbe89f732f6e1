"""Multi-process execution of the column-sharded step (port of
pcseg_tpu.parallel.distributed).

Each process is one rank of a ``torch.distributed`` process group and owns
a contiguous block of the grid's columns; the sharded step
(parallel/sharded.py) exchanges halos and merges moments through the
group's collectives. Usage on each rank::

    from pcseg_tpu_torch.parallel import distributed, sharded
    distributed.initialize("nccl")            # torchrun's environment
    comm = distributed.make_group(device=f"cuda:{local_rank}")
    step = sharded.build_sharded_segment_step(comm)
    out = step(distributed.local_columns(points, comm), origin)
    labels = distributed.gather_columns(out.labels, comm)

The backend is the caller's choice, never a fallback: ``"nccl"`` for one
rank per card, ``"gloo"`` for CPU tensors or for ranks sharing one card
(NCCL refuses two ranks on one device; the Comm then stages each gather
through host memory, parallel/halo.py).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from pcseg_tpu_torch.parallel.halo import Comm


def initialize(backend: str, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               store=None, timeout_s: float = 300.0) -> bool:
    """Join the default process group (idempotent: a second call keeps the
    group). The arguments default from torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with
    neither arguments nor environment the run stays single-process.
    ``store`` (a ``torch.distributed.Store``, e.g. a FileStore) replaces
    the address. Returns True when the run is multi-process."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    if world_size is None and "WORLD_SIZE" in env:
        world_size = int(env["WORLD_SIZE"])
    if rank is None and "RANK" in env:
        rank = int(env["RANK"])
    if init_method is None and store is None and "MASTER_ADDR" in env:
        init_method = f"tcp://{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if world_size is None:
        return False
    if init_method is None and store is None:
        raise ValueError("a multi-process run needs an address or a store")
    dist.init_process_group(
        backend, init_method=init_method, store=store,
        world_size=world_size, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return world_size > 1


def make_group(device="cuda") -> Comm:
    """A Comm over every rank of the job, in rank order, whose tensors
    live on ``device``."""
    return Comm(None, device=device)


def local_columns(full, comm: Comm) -> torch.Tensor:
    """This rank's contiguous block of columns of a full [H, W, ...] grid
    (numpy or tensor), on ``comm.device``; W must split evenly."""
    full = torch.as_tensor(full)
    w = full.shape[1]
    if w % comm.size:
        raise ValueError(f"{w} columns do not split over {comm.size} ranks")
    wl = w // comm.size
    return full[:, comm.rank * wl:(comm.rank + 1) * wl].contiguous() \
        .to(comm.device)


def gather_columns(local: torch.Tensor, comm: Comm) -> torch.Tensor:
    """The full [H, W, ...] grid on every rank from the ranks' column
    blocks (the counterpart of JAX's global_to_host_replicated)."""
    g = comm.all_gather(local)
    return torch.cat(list(g), dim=1)
