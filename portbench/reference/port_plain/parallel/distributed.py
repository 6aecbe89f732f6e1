"""Multi-process execution of the column-sharded step (port of
pcseg_tpu.parallel.distributed).

Each process is one rank of a ``torch.distributed`` process group and owns
a contiguous block of the grid's columns; the sharded step
(parallel/sharded.py) exchanges halos and merges moments through the
group's collectives. Usage on each rank::

    from portbench.reference.port_plain.parallel import distributed, sharded
    distributed.initialize("nccl")   # torchrun's environment; binds the card
    comm = distributed.make_group()  # on cuda:{LOCAL_RANK}
    step = sharded.build_sharded_segment_step(comm)
    out = step(distributed.local_columns(points, comm), origin)
    labels = distributed.gather_columns(out.labels, comm)

with the ranks started by ``torchrun --nproc-per-node <cards> script.py``.
The backend is the caller's choice, never a fallback: ``"nccl"`` for one
rank per card (the card torchrun's ``LOCAL_RANK`` names), ``"gloo"`` for
CPU tensors or for ranks sharing one card (NCCL refuses two ranks on one
device; the Comm then stages each gather through host memory,
parallel/halo.py).
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from portbench.reference.port_plain.parallel.halo import Comm


def rank_device(backend: str, env=None) -> torch.device:
    """The device of this rank's tensors: under NCCL the card that
    torchrun's ``LOCAL_RANK`` names, ``cuda:{LOCAL_RANK}`` (one rank per
    card); otherwise ``cuda``, the current card. ``env`` defaults to
    ``os.environ``. Raises under NCCL without ``LOCAL_RANK``."""
    if backend != "nccl":
        return torch.device("cuda")
    env = os.environ if env is None else env
    if "LOCAL_RANK" not in env:
        raise ValueError("an NCCL rank takes its card from torchrun's "
                         "LOCAL_RANK, which is not set")
    return torch.device("cuda", int(env["LOCAL_RANK"]))


def initialize(backend: str, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None,
               store=None, timeout_s: float = 300.0) -> bool:
    """Join the default process group (idempotent: a second call keeps the
    group). The arguments default from torchrun's environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); with
    neither arguments nor environment the run stays single-process.
    ``store`` (a ``torch.distributed.Store``, e.g. a FileStore) replaces
    the address. ``timeout_s`` bounds every collective: a rank that hangs
    fails instead of waiting. Returns True when the run is multi-process.

    Under ``"nccl"`` the rank first binds its card, :func:`rank_device`
    (``torch.cuda.set_device``, and the group's ``device_id``), so that
    each rank's context and communicator live on its own card; without a
    card or without ``LOCAL_RANK`` it raises before any group starts."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    device_id = None
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("an NCCL group needs a CUDA card; none is "
                               "available")
        device_id = rank_device(backend)
        if device_id.index >= torch.cuda.device_count():
            raise ValueError(f"LOCAL_RANK {device_id.index} names no card "
                             f"of the {torch.cuda.device_count()} here")
        torch.cuda.set_device(device_id)
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
        timeout=datetime.timedelta(seconds=timeout_s), device_id=device_id)
    return world_size > 1


def make_group(device=None) -> Comm:
    """A Comm over every rank of the job, in rank order, whose tensors
    live on ``device``: by default :func:`rank_device` of the group's
    backend, the card :func:`initialize` bound under NCCL."""
    if device is None:
        backend = (str(dist.get_backend()) if dist.is_initialized()
                   else "none")
        device = rank_device(backend)
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
