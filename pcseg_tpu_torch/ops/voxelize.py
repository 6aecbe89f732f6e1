"""Voxel-grid organization of unorganized point clouds (port of
pcseg_tpu.ops.voxelize).

An unorganized [N, 3] cloud is scattered into a dense bird's-eye [Gx, Gy]
grid of cell centroids; the organized windowed algorithms run on that grid
and the labels go back to the points through each point's cell id
(row-major ``ix * Gy + iy``, -1 off the grid).

The cell sums decide the centroids, and the centroids the distance gates,
so their order matters. JAX adds each cell's points in f32 in point order
(a sequential segment sum on the CPU); a CPU tensor here takes the same
order (``index_add_``), so its centroids are JAX's bit for bit. On the
card ``index_add_`` adds by atomics in no fixed order, so reruns would
differ: there the points are stably sorted by cell and each cell summed by
a fixed pairwise tree in f64, rounded once to f32 as the NumPy host copy
(:func:`voxelize_xy_np`) and the native library do. Both are
deterministic; they differ from each other by f32 rounding only.

One path on both devices was tried: the tree on CPU tensors keeps JAX's
labels but not its centroids (``test_voxelize_matches_jax[blobs_nan]``
finds means near zero up to 4,073 f32 ulps from JAX's, whose f32 running
sums cancel), so the CPU keeps JAX's order. A sorted f64 ``cumsum`` with
differences at the cell starts would replace the tree's passes, but it is
not deterministic on CUDA tensors and loses the low bits of a cell's sum
once the running sum is large.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pcseg_tpu_torch.ops import nansafe
from pcseg_tpu_torch.ops.frames import takes_frames


class VoxelGrid(NamedTuple):
    points: torch.Tensor       # [Gx, Gy, 3] cell centroids (NaN empty)
    counts: torch.Tensor       # [Gx, Gy] int32 points per cell
    point_cell: torch.Tensor   # [N] int32 row-major cell id (-1 off-grid)
    origin: torch.Tensor       # [2]
    cell_size: torch.Tensor    # scalar


@takes_frames()
def cell_ids(points: torch.Tensor, cell_size: float, grid_shape, origin=None):
    """(cell [N] int64 row-major id, gx*gy off the grid; in-grid [N] bool;
    zeroed points [N, 3]; origin [2] f32) of an [N, 3] f32 cloud.

    The origin defaults to the minimum XY over the finite points. The cell
    index is ``floor((p - origin) / cell_size)`` with a true f32 division,
    and the grid test runs on the floats, before any integer cast (a float
    past 2^31 has no defined int32 value)."""
    gx, gy = grid_shape
    finite = nansafe.all_finite(points)
    pts = torch.where(finite[:, None], points, 0.0)
    if origin is None:
        origin = torch.where(finite[:, None], pts[:, :2], 1e30).amin(dim=0)
    origin = torch.as_tensor(origin, dtype=points.dtype,
                             device=points.device).reshape(2)
    f = torch.floor((pts[:, :2] - origin)
                    / torch.tensor(cell_size, dtype=points.dtype,
                                   device=points.device))
    inb = finite & (f[:, 0] >= 0) & (f[:, 0] < gx) \
        & (f[:, 1] >= 0) & (f[:, 1] < gy)
    ij = torch.where(inb[:, None], f, 0.0).to(torch.int64)
    cell = torch.where(inb, ij[:, 0] * gy + ij[:, 1], gx * gy)
    return cell, inb, pts, origin


def _cell_means_tree(pts, cell, inb, counts):
    """Per-cell means [n_cells, 3] f32 (NaN where empty) from a stable sort
    by cell and a pairwise tree of f64 sums within each cell: pass k adds
    the partial sum 2^k places on into every cell-relative position that
    is a multiple of 2^(k+1), so each cell's association is fixed by its
    size alone. ``counts``: [n_cells + 1] int64 points per cell id (the
    last id is off the grid)."""
    n_cells = counts.numel() - 1
    if cell.numel() == 0:
        return torch.full((n_cells, 3), float("nan"), dtype=pts.dtype,
                          device=pts.device)
    order = torch.sort(cell, stable=True).indices
    key = cell[order]
    vals = torch.where(inb[order, None], pts[order], 0.0).to(torch.float64)
    n = key.numel()
    pos = torch.arange(n, device=pts.device)
    start = torch.cumsum(counts, 0) - counts   # each cell's first position
    rank = pos - start[key]
    length = counts[key]
    longest = int(counts[:n_cells].max()) if n_cells else 0
    stride = 1
    while stride < longest:
        take = (rank % (2 * stride) == 0) & (rank + stride < length)
        partner = (pos + stride).clamp(max=n - 1)
        vals = vals + torch.where(take[:, None], vals[partner], 0.0)
        stride *= 2
    cnt = counts[:n_cells]
    sums = vals[start[:n_cells].clamp(max=n - 1)]
    means = (sums / cnt.clamp(min=1).to(torch.float64)[:, None]) \
        .to(pts.dtype)
    return torch.where(cnt[:, None] > 0, means, float("nan"))


@takes_frames()
def voxelize_xy(points: torch.Tensor, cell_size: float, grid_shape,
                origin=None) -> VoxelGrid:
    """Scatter an unorganized [N, 3] f32 cloud into a [Gx, Gy] XY grid of
    cell centroids (the reference-free config-3 layout; JAX's
    ``voxelize_xy``). Counts and ``point_cell`` are exact on either device;
    the centroid sums follow the order the module docstring gives."""
    gx, gy = grid_shape
    n_cells = gx * gy
    cell, inb, pts, origin = cell_ids(points, cell_size, grid_shape, origin)
    all_counts = torch.bincount(cell, minlength=n_cells + 1)
    counts = all_counts[:n_cells].to(torch.int32)
    if points.is_cuda:
        centroids = _cell_means_tree(pts, cell, inb, all_counts)
    else:
        sums = torch.zeros((n_cells + 1, 3), dtype=points.dtype)
        sums.index_add_(0, cell, torch.where(inb[:, None], pts, 0.0))
        denom = counts.clamp(min=1).to(points.dtype)
        centroids = torch.where(counts[:, None] > 0,
                                sums[:n_cells] / denom[:, None],
                                float("nan"))
    return VoxelGrid(points=centroids.reshape(gx, gy, 3),
                     counts=counts.reshape(gx, gy),
                     point_cell=torch.where(inb, cell, -1).to(torch.int32),
                     origin=origin,
                     cell_size=torch.tensor(cell_size, dtype=points.dtype,
                                            device=points.device))


@takes_frames()
def scatter_labels_to_points(grid_labels: torch.Tensor,
                             point_cell: torch.Tensor,
                             fill=-1) -> torch.Tensor:
    """Per-point labels from per-cell labels ([Gx, Gy] row-major ids); the
    gather index is clipped, -1 cells give ``fill``."""
    flat = grid_labels.reshape(-1)
    safe = point_cell.clamp(0, flat.numel() - 1).long()
    return torch.where(point_cell >= 0, flat[safe], fill)


def voxelize_xy_np(points, cell_size: float, grid_shape, origin=None):
    """NumPy copy of :func:`voxelize_xy` for the host paths: the same cell
    assignment; the centroids summed in f64 (``np.bincount``) and rounded
    once to f32."""
    gx, gy = grid_shape
    pts = np.asarray(points, np.float32)
    finite = np.isfinite(pts).all(axis=-1)
    safe = np.where(finite[:, None], pts, 0.0)
    if origin is None:
        xy = np.where(finite[:, None], safe[:, :2], np.float32(1e30))
        origin = xy.min(axis=0)
    origin = np.asarray(origin, np.float32)
    f = np.floor((safe[:, :2] - origin) / np.float32(cell_size))
    inb = finite & (f[:, 0] >= 0) & (f[:, 0] < gx) \
        & (f[:, 1] >= 0) & (f[:, 1] < gy)
    ij = np.where(inb[:, None], f, 0).astype(np.int64)
    cell = np.where(inb, ij[:, 0] * gy + ij[:, 1], gx * gy)

    counts = np.bincount(cell, minlength=gx * gy + 1)[:gx * gy]
    sums = np.stack([
        np.bincount(cell, weights=np.where(inb, safe[:, k], 0.0),
                    minlength=gx * gy + 1)[:gx * gy]
        for k in range(3)], axis=-1)
    denom = np.maximum(counts, 1).astype(np.float32)
    centroids = np.where(counts[:, None] > 0,
                         (sums / denom[:, None]).astype(np.float32),
                         np.float32(np.nan))
    return VoxelGrid(points=centroids.reshape(gx, gy, 3),
                     counts=counts.reshape(gx, gy).astype(np.int32),
                     point_cell=np.where(inb, cell, -1).astype(np.int32),
                     origin=origin,
                     cell_size=np.float32(cell_size))
