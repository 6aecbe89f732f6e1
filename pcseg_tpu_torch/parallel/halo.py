"""Collectives and halo exchange for column-sharded grids (port of
pcseg_tpu.parallel.halo).

The cloud grid [H, W] is sharded over columns across the ranks of a
``torch.distributed`` process group; every windowed op (normal scans, seed
windows, region dilation, cluster linking) needs a ring of neighbour
columns. A :class:`Comm` takes the place of JAX's mesh axis name.

Every collective is an ``all_gather``: gloo has no point-to-point
operations on CUDA tensors, and a float sum taken as gather-then-add in
rank order gives every rank the same bytes on any backend (NCCL's own
reductions add in an order of their own), so the replicated host loops of
the sharded step (parallel/sharded.py) take the same branches on every
rank. Halos are built from the gathered edge strips.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from pcseg_tpu_torch.utils import profiling

# the gather into one buffer; newer releases renamed it
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class Comm:
    """The ranks of a process group, for the sharded step.

    ``group`` is a ``torch.distributed`` group (None: the default group
    when one is initialised, else a single rank of its own). ``device`` is
    where this rank's tensors live: the card unless the caller passes
    ``"cpu"``. The transport of every collective is fixed here, from the
    backend and the device: ``"nccl"`` (one rank per card) and gloo on CPU
    tensors gather in place; gloo with CUDA tensors (ranks sharing one
    card, which NCCL refuses) stages each gather through host memory,
    ``"gloo via host"``. :attr:`transport` names it; :attr:`gathers`
    counts the collectives made, and each is the span ``comm.all_gather``
    of ``utils/profiling`` (its staging copies the host sync
    ``comm.stage``). Every transport gathers into one preallocated buffer
    (``all_gather_into_tensor``)."""

    def __init__(self, group=None, device="cuda"):
        self.device = torch.device(device)
        self.group = group
        if group is None and not (dist.is_available()
                                  and dist.is_initialized()):
            self.rank, self.size, backend = 0, 1, "none"
        else:
            self.rank = dist.get_rank(group)
            self.size = dist.get_world_size(group)
            backend = str(dist.get_backend(group))
        self.staged = backend == "gloo" and self.device.type == "cuda"
        self.transport = "gloo via host" if self.staged else backend
        self.gathers = 0
        if backend == "nccl" and self.device.type != "cuda":
            raise ValueError("an NCCL group needs CUDA tensors")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[size, *x.shape]: every rank's ``x`` in rank order."""
        if self.size == 1:
            return x[None]
        self.gathers += 1
        with profiling.stage("comm.all_gather"):
            dtype = x.dtype
            y = x.to(torch.uint8) if dtype == torch.bool else x
            if self.staged:
                with profiling.blocking("comm.stage"):
                    y = y.cpu()
            y = y.contiguous()
            out = torch.empty((self.size, *y.shape), dtype=y.dtype,
                              device=y.device)
            # flat: gloo takes the rank blocks laid end to end along dim 0
            _gather_into(out.view(-1), y.view(-1), group=self.group)
            if self.staged:
                with profiling.blocking("comm.stage"):
                    out = out.to(self.device)
            return out.to(torch.bool) if dtype == torch.bool else out

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum over the ranks, added in rank order (the same bytes on
        every rank)."""
        g = self.all_gather(x)
        out = g[0]
        for i in range(1, self.size):
            out = out + g[i]
        return out

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_gather(x).amin(dim=0)

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_gather(x).amax(dim=0)


def exchange_halo(block: torch.Tensor, k: int, comm: Comm, fill=float("nan"),
                  dim: int = 1) -> torch.Tensor:
    """Pad a local block with ``k`` neighbour columns per side along
    ``dim`` (the columns of [H, W_local, ...] by default).

    The first and last ranks get ``fill`` (the grid edge, as the
    single-device ops' out-of-bounds fill). A halo wider than the block
    (k > W_local) reaches over several ranks: the whole blocks are
    gathered and the k nearest columns kept."""
    if k == 0:
        return block
    dim = dim % block.dim()
    w_local = block.shape[dim]
    n, idx = comm.size, comm.rank
    if k <= w_local:
        edges = torch.cat([block.narrow(dim, 0, k),
                           block.narrow(dim, w_local - k, k)], dim=dim)
        g = comm.all_gather(edges)
        fill_strip = torch.full_like(block.narrow(dim, 0, k), fill)
        left = g[idx - 1].narrow(dim, k, k) if idx > 0 else fill_strip
        right = g[idx + 1].narrow(dim, 0, k) if idx < n - 1 else fill_strip
        return torch.cat([left, block, right], dim=dim)
    hops = -(-k // w_local)
    g = comm.all_gather(block)
    fill_block = torch.full_like(block, fill)
    lefts = [g[idx - j] if idx >= j else fill_block
             for j in range(hops, 0, -1)]
    rights = [g[idx + j] if idx < n - j else fill_block
              for j in range(1, hops + 1)]
    left = torch.cat(lefts, dim=dim)
    right = torch.cat(rights, dim=dim)
    return torch.cat([left.narrow(dim, left.shape[dim] - k, k), block,
                      right.narrow(dim, 0, k)], dim=dim)


def crop_halo(block: torch.Tensor, k: int, dim: int = 1) -> torch.Tensor:
    """Remove the ``k`` columns per side that exchange_halo added."""
    if k == 0:
        return block
    dim = dim % block.dim()
    return block.narrow(dim, k, block.shape[dim] - 2 * k)
