"""The port's graft entry points: the single-card forward and the sharded
dry run (the counterparts of the JAX package's ``__graft_entry__``).

    from pcseg_tpu_torch import graft_entry
    forward, args = graft_entry.entry()       # on the card
    labels, normals, regions, clusters = forward(*args)
    graft_entry.dryrun_multichip(4)           # 4 ranks, one per card, NCCL

``python -m pcseg_tpu_torch.graft_entry N`` runs the dry run over N
cards; under ``torchrun --nproc-per-node N -m pcseg_tpu_torch.graft_entry``
each process is one NCCL rank of it, joining from torchrun's environment.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import torch

from pcseg_tpu_torch.models.config import (
    ClusterRegionConfig, ComputeNormalsParams, PlanarRegionConfig,
    SeedsFromPlaneSupportParams, SegmenterConfig)
from pcseg_tpu_torch.models.pipeline import Segmenter
from pcseg_tpu_torch.parallel import distributed, sharded
from pcseg_tpu_torch.utils.synthetic import synthetic_room_cloud

DRYRUN_ROWS = 40
DRYRUN_COLS_PER_RANK = 8  # >= every halo of the step
DRYRUN_TIMEOUT_S = 600.0


def entry(device=None):
    """(forward, (points, sensor_origin)): the flagship forward, the full
    device segmentation (normals, seeds, planar growth, clustering) of an
    organized QVGA cloud, ``Segmenter(SegmenterConfig(), device)
    .device_forward``, with its inputs on ``device`` (the card unless the
    caller passes ``"cpu"``)."""
    seg = Segmenter(SegmenterConfig(), device)
    pts, origin = synthetic_room_cloud(240, 320, f=240.0, seed=1)
    return seg.device_forward, (torch.from_numpy(pts).to(seg.device),
                                torch.from_numpy(origin).to(seg.device))


def _dryrun_step(comm) -> str:
    """The sharded step on this rank's columns of a 40 x 8n room cloud
    (seed 9) with JAX's dry-run settings; checks the gathered label shape
    and returns JAX's ok line."""
    n = comm.size
    h, w = DRYRUN_ROWS, DRYRUN_COLS_PER_RANK * n
    step = sharded.build_sharded_segment_step(
        comm,
        normals_params=ComputeNormalsParams(max_scan_steps=4),
        seed_params=SeedsFromPlaneSupportParams(max_seeds=128),
        planar_config=PlanarRegionConfig(max_regions=8, max_growth_iters=256),
        cluster_config=ClusterRegionConfig(max_regions=32),
        max_attempts=16)
    pts, origin = synthetic_room_cloud(h, w, f=float(h), seed=9)
    res = step(distributed.local_columns(pts, comm), origin)
    labels = distributed.gather_columns(res.labels, comm)
    if tuple(labels.shape) != (h, w):
        raise RuntimeError(f"dry run labels are {tuple(labels.shape)}, not "
                           f"{(h, w)}")
    return (f"dryrun_multichip ok: {n} devices, "
            f"{int(res.planar.num_regions)} planar regions, "
            f"{int(res.num_clusters)} clusters")


def _spawned_rank(rank, n, backend, tmp):
    """Rank ``rank`` of :func:`dryrun_multichip`: joins through a file in
    ``tmp``; rank 0 writes the ok line there."""
    os.environ["LOCAL_RANK"] = str(rank)
    distributed.initialize(backend, init_method=f"file://{tmp}/store",
                           world_size=n, rank=rank,
                           timeout_s=DRYRUN_TIMEOUT_S)
    try:
        # a rank's tensors: its card under NCCL, the CPU under gloo
        comm = distributed.make_group(None if backend == "nccl" else "cpu")
        line = _dryrun_step(comm)
        if rank == 0:
            with open(os.path.join(tmp, "result.json"), "w") as f:
                json.dump(line, f)
    finally:
        torch.distributed.destroy_process_group()


def dryrun_multichip(n_devices: int, backend: str = "nccl") -> None:
    """Run the FULL sharded segmentation step (column blocks with halo
    exchange, moment merges in rank order, label unification) on tiny
    shapes over ``n_devices`` ranks, each a process of its own: one per
    card over NCCL, or CPU ranks over gloo when ``backend="gloo"``.
    Prints JAX's ``dryrun_multichip ok: ...`` line. Raises when NCCL is
    asked for and fewer than ``n_devices`` cards are present."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got {backend!r}")
    if backend == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n_devices:
            raise RuntimeError(f"{n_devices} NCCL ranks need {n_devices} "
                               f"cards, {cards} present")
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.start_processes(
            _spawned_rank, args=(n_devices, backend, tmp), nprocs=n_devices,
            join=False, start_method="spawn")
        deadline = time.monotonic() + DRYRUN_TIMEOUT_S
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the dry run's {n_devices} ranks "
                                       f"took over {DRYRUN_TIMEOUT_S} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                    p.join()
        with open(os.path.join(tmp, "result.json")) as f:
            print(json.load(f), flush=True)


def _torchrun_rank():
    """One NCCL rank of the dry run started by torchrun."""
    distributed.initialize("nccl", timeout_s=DRYRUN_TIMEOUT_S)
    try:
        comm = distributed.make_group()
        line = _dryrun_step(comm)
        if comm.rank == 0:
            print(line, flush=True)
    finally:
        torch.distributed.destroy_process_group()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("n_devices", type=int, nargs="?", default=1)
    args = parser.parse_args(argv)
    if "RANK" in os.environ:
        _torchrun_rank()
    else:
        dryrun_multichip(args.n_devices)


if __name__ == "__main__":
    main()
