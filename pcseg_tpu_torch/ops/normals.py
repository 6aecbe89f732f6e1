"""Organized-cloud normal estimation (port of pcseg_tpu.ops.normals).

The reference walks outward along the four grid axes from every pixel
until a neighbor falls inside a [min, max] distance band, optionally adds
the four diagonal neighbors, and fits a plane through the supports
oriented toward the sensor (algorithms.h:106-257,330-375). Here the walk is
bounded by ``max_scan_steps`` offsets, the walks and the moment sums run
in one kernel on the card (``kernels/normal_support``, whose plain version
is a directional scan of torch ops), and the eigensolve runs in
component-grid form. Each function takes
JAX's single frame ([H, W, 3] points) or a batch with a leading frame axis
``B`` (ops/frames.py); the shapes below are the batch's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from pcseg_tpu_torch.kernels import normal_support
from pcseg_tpu_torch.models.config import ComputeNormalsParams
from pcseg_tpu_torch.ops import nansafe, plane_fit
from pcseg_tpu_torch.ops.frames import takes_frames


class NormalSupport(NamedTuple):
    count: torch.Tensor                # [B, H, W] int32 support size
    moments: plane_fit.PlaneMoments    # batched [B, H, W]
    center_valid: torch.Tensor         # [B, H, W] bool


@takes_frames(points=3)
def find_normal_support(points: torch.Tensor,
                        params: ComputeNormalsParams,
                        impl=None) -> NormalSupport:
    """Vectorized FindNormalSupportNeighbors (algorithms.h:106-257).

    points: [B, H, W, 3]. Returns per-pixel support counts and moment sums
    over the center + up to 4 axis + 4 diagonal supports: one launch of
    the kernel for CUDA points, which must be f32
    (``kernels/normal_support``); CPU points and ``impl="plain"`` take its
    plain version.
    """
    count, moments, center_valid = normal_support.normal_support(
        points, params, impl)
    return NormalSupport(count=count, moments=moments,
                         center_valid=center_valid)


@takes_frames(points=3, support=2)
def normals_from_support(support: NormalSupport, points: torch.Tensor,
                         sensor_origin: torch.Tensor,
                         params: ComputeNormalsParams) -> torch.Tensor:
    """Orient (toward ``sensor_origin``, algorithms.h:354-355) and solve
    the per-pixel plane fits."""
    origin = sensor_origin.to(points.dtype).reshape(-1, 1, 1, 3)
    hint = origin - points
    hint = torch.where(nansafe.isfinite(hint), hint, 1.0)
    moments = plane_fit.set_normal_orientation(support.moments, hint)
    sol = plane_fit.solve(moments)
    ok = (support.center_valid
          & (support.count >= params.min_num_support_neighbors)
          & sol.valid)
    return torch.where(ok[..., None], sol.normal, float("nan"))


@takes_frames(points=3, out_normals=3)
def compute_normals_organized(
        points: torch.Tensor, sensor_origin: torch.Tensor,
        params: ComputeNormalsParams = ComputeNormalsParams(),
        row_range: Optional[Tuple[int, int]] = None,
        col_range: Optional[Tuple[int, int]] = None,
        out_normals: Optional[torch.Tensor] = None,
        impl=None) -> torch.Tensor:
    """ComputeNormalsOrganized (algorithms.h:330-375) over [H, W, 3] or
    [B, H, W, 3].

    ``sensor_origin`` is [3] (shared) or [B, 3]. Returns unit normals
    toward the sensor, of the points' shape; NaN where the center is
    invalid, support < ``min_num_support_neighbors``, or the fit is
    degenerate. ``row_range``/``col_range`` (half-open) restrict the
    result to a sub-rectangle, the reference's tiling seam
    (algorithms.h:333): outside it each pixel keeps ``out_normals`` (of the
    points' shape) or NaN. ``impl`` as :func:`find_normal_support`'s.
    """
    support = find_normal_support(points, params, impl)
    normals = normals_from_support(support, points, sensor_origin, params)
    if row_range is None and col_range is None:
        return normals
    h, w = points.shape[1:3]
    r0, r1 = row_range if row_range is not None else (0, h)
    c0, c1 = col_range if col_range is not None else (0, w)
    rows = torch.arange(h, device=points.device)[:, None]
    cols = torch.arange(w, device=points.device)[None, :]
    in_range = (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
    outside = out_normals if out_normals is not None \
        else torch.full_like(normals, float("nan"))
    return torch.where(in_range[..., None], normals, outside)
