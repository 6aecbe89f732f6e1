"""Clustering of unorganized (~1M-point) clouds through voxel grids (port of
pcseg_tpu.models.unorganized; BASELINE config 3).

The cloud is voxelized into a bird's-eye grid of cell centroids
(ops/voxelize.py), the organized clustering runs on that grid, and the cell
labels go back to the points. Euclidean clustering
(:func:`cluster_unorganized`) runs the general seed-vector path of
``segment_clusters`` on the grid (the gated CCL, B2 on the card), then
gates components on their POINT counts; :func:`cluster_unorganized_host`
does the same in one native call, with the same ids. :func:`cluster_unorganized_mean_shift` runs the sliding mean shift
on the grid, natively or on the device. Cluster granularity is the cell
size: keep it well below the distance threshold's root.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from pcseg_tpu_torch import native
from pcseg_tpu_torch.models import cluster as cluster_model
from pcseg_tpu_torch.models import mean_shift
from pcseg_tpu_torch.models.config import (
    UNLABELED, ClusterRegionConfig, MeanShiftParams)
from pcseg_tpu_torch.ops import voxelize


class UnorganizedClusterResult(NamedTuple):
    point_labels: object   # [N] int32 cluster id (-1 unclustered)
    grid_labels: object    # [Gx, Gy] int32
    num_regions: object    # scalar int32
    region_sizes: object   # [max_regions] int32 per-region POINT counts


def _point_sizes(point_labels, r_cap):
    """[r_cap] int32 point counts of the ids in [0, r_cap)."""
    keep = (point_labels >= 0) & (point_labels < r_cap)
    return torch.bincount(point_labels[keep].long(), minlength=r_cap) \
        .to(torch.int32)


def cluster_unorganized(points,
                        config: ClusterRegionConfig = ClusterRegionConfig(),
                        cell_size: float = 0.25,
                        grid_shape=(512, 512),
                        origin=None, device=None,
                        impl=None) -> UnorganizedClusterResult:
    """Euclidean clusters of an [N, 3] f32 cloud on ``device`` (the card
    unless the caller passes ``device="cpu"``). Every occupied cell seeds,
    popped in ascending col-major order; any seeded cell component is
    accepted on the grid (``min_region_inliers=1``) and
    ``config.min_region_inliers`` then gates POINT counts; survivors get
    dense ids in ascending root order. Tensors out, on ``device``.
    ``impl="plain"`` forces the CCL kernel's plain version."""
    device = mean_shift._card(device)
    pts = torch.as_tensor(points, dtype=torch.float32, device=device)
    gx, gy = grid_shape
    grid = voxelize.voxelize_xy(pts, cell_size, grid_shape, origin)

    labels0 = torch.full((gx, gy), UNLABELED, dtype=torch.int32,
                         device=pts.device)
    cell_config = dataclasses.replace(config, min_region_inliers=1)
    cell_labels = cluster_model.segment_clusters(
        grid.points, labels0,
        cluster_model.canonical_seed_vector(gx, gy, pts.device), cell_config,
        initial_id_offset=0, impl=impl).labels
    raw = voxelize.scatter_labels_to_points(cell_labels, grid.point_cell)

    # raw cell-component ids are dense but reach gx*gy (every noise cell
    # is a component before the point-count gate): count points over the
    # full id space, then compact the survivors
    id_cap = gx * gy
    raw_sizes = torch.bincount(raw[raw >= 0].long(), minlength=id_cap)
    keep = raw_sizes >= config.min_region_inliers
    new_id = torch.where(keep, torch.cumsum(keep.to(torch.int32), 0,
                                            dtype=torch.int32) - 1, -1)

    def relabel(lbl):
        return torch.where(lbl >= 0, new_id[lbl.clamp(0, id_cap - 1).long()],
                           -1)

    point_labels = relabel(raw)
    grid_labels = torch.where(cell_labels < 0, cell_labels,
                              relabel(cell_labels))
    return UnorganizedClusterResult(
        point_labels=point_labels, grid_labels=grid_labels,
        num_regions=keep.sum(dtype=torch.int32),
        region_sizes=_point_sizes(point_labels, config.max_regions))


def _native_origin(origin):
    if origin is None:
        # the native call takes the minimum over the finite points
        return np.float32(np.nan), np.float32(np.nan)
    return tuple(np.float32(v) for v in np.asarray(origin)[:2])


def _host_result(point_labels, cell_labels, n_regions, grid_shape, r_cap):
    keep = (point_labels >= 0) & (point_labels < r_cap)
    sizes = np.bincount(point_labels[keep], minlength=r_cap)[:r_cap]
    return UnorganizedClusterResult(
        point_labels=point_labels,
        grid_labels=cell_labels.reshape(grid_shape),
        num_regions=np.int32(n_regions),
        region_sizes=sizes.astype(np.int32))


def _c_ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def cluster_unorganized_host(points,
                             config: ClusterRegionConfig
                             = ClusterRegionConfig(),
                             cell_size: float = 0.25,
                             grid_shape=(512, 512),
                             origin=None) -> UnorganizedClusterResult:
    """:func:`cluster_unorganized` in one native call
    (``hostops.pcseg_cluster_unorganized``: voxelize with f64 sums,
    union-find over the window edges, point-count gate, scatter), with the
    device path's ids (ascending min-root order). NumPy arrays out."""
    lib = native.load_hostops()
    if lib is None:
        raise RuntimeError("native hostops unavailable")
    gx, gy = grid_shape
    pts = np.ascontiguousarray(np.asarray(points, np.float32))
    point_labels = np.empty((len(pts),), np.int32)
    cell_labels = np.empty((gx * gy,), np.int32)
    ox, oy = _native_origin(origin)
    n_regions = lib.pcseg_cluster_unorganized(
        _c_ptr(pts, ctypes.c_float), len(pts), gx, gy,
        ctypes.c_float(cell_size), ctypes.c_float(ox), ctypes.c_float(oy),
        int(config.half_search_window),
        ctypes.c_float(config.squared_distance_threshold),
        int(config.min_region_inliers),
        _c_ptr(point_labels, ctypes.c_int32),
        _c_ptr(cell_labels, ctypes.c_int32))
    return _host_result(point_labels, cell_labels, n_regions, grid_shape,
                        config.max_regions)


def cluster_unorganized_mean_shift(
        points,
        config: ClusterRegionConfig = ClusterRegionConfig(),
        cell_size: float = 0.25,
        grid_shape=(512, 512),
        origin=None,
        iterations: int = 5,
        params: MeanShiftParams = MeanShiftParams(),
        backend: str = "device", device=None) -> UnorganizedClusterResult:
    """ClusterMethod.MEAN_SHIFT on an [N, 3] unorganized cloud: voxelize,
    SlidingMeanShift over the cell-centroid grid, labels back to points.

    ``backend``: ``"device"`` (the default) voxelizes on ``device`` (the
    card unless the caller passes ``device="cpu"``) and runs
    ``sliding_mean_shift`` there with its default (device) growth (tensors
    out); ``"host"`` runs voxelization, modes and growth in one native call
    on the CPU (``hostops.pcseg_mean_shift_points``; NumPy arrays out), the
    faster path at config 3's size; ``"auto"`` takes the host when the
    native library loads, JAX's default. The port defaults to the card as
    its other entry points do, so the CPU runs only when asked for."""
    if backend not in ("auto", "host", "device"):
        raise ValueError(f"unknown backend {backend!r}")
    gx, gy = grid_shape
    lib = native.load_hostops() if backend in ("auto", "host") else None
    if backend == "host" and lib is None:
        raise RuntimeError("native hostops unavailable for backend='host'")
    if lib is not None:
        pts = np.ascontiguousarray(np.asarray(points, np.float32))
        point_labels = np.empty((len(pts),), np.int32)
        cell_labels = np.empty((gx * gy,), np.int32)
        ox, oy = _native_origin(origin)
        n_regions = lib.pcseg_mean_shift_points(
            _c_ptr(pts, ctypes.c_float), len(pts), gx, gy,
            ctypes.c_float(cell_size), ctypes.c_float(ox),
            ctypes.c_float(oy), int(iterations),
            int(params.half_search_window),
            ctypes.c_float(params.square_distance_threshold),
            ctypes.c_float(params.min_support),
            ctypes.c_float(params.squared_centroid_distance_threshold),
            ctypes.c_float(params.squared_neighbor_distance_threshold),
            int(config.min_region_inliers), 0,
            _c_ptr(point_labels, ctypes.c_int32),
            _c_ptr(cell_labels, ctypes.c_int32))
        return _host_result(point_labels, cell_labels, n_regions, grid_shape,
                            config.max_regions)

    device = mean_shift._card(device)
    grid = voxelize.voxelize_xy(
        torch.as_tensor(points, dtype=torch.float32, device=device),
        cell_size, grid_shape, origin)
    labels = np.full((gx, gy), UNLABELED, np.int32)
    regions = mean_shift.sliding_mean_shift(
        grid.points.cpu().numpy(), labels, config, iterations, 0, params,
        device=device)
    grid_labels = torch.from_numpy(labels).to(grid.point_cell.device)
    point_labels = voxelize.scatter_labels_to_points(grid_labels,
                                                     grid.point_cell)
    return UnorganizedClusterResult(
        point_labels=point_labels, grid_labels=grid_labels,
        num_regions=torch.tensor(len(regions), dtype=torch.int32),
        region_sizes=_point_sizes(point_labels, config.max_regions))
