"""Organized-cloud normal estimation (port of pcseg_tpu.ops.normals).

The reference walks outward along the four grid axes from every pixel
until a neighbor falls inside a [min, max] distance band, optionally adds
the four diagonal neighbors, and fits a plane through the supports
oriented toward the sensor (algorithms.h:106-257,330-375). Here the walk is
a bounded directional scan over offsets 1..``max_scan_steps``, the moments
accumulate into ten [B, H, W] grids, the diagonals come from one gather,
and the eigensolve runs in component-grid form. Each function takes
JAX's single frame ([H, W, 3] points) or a batch with a leading frame axis
``B`` (ops/frames.py); the shapes below are the batch's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from portbench.reference.port_plain.models.config import ComputeNormalsParams
from portbench.reference.port_plain.ops import nansafe, plane_fit
from portbench.reference.port_plain.ops.frames import takes_frames


class _Moments10:
    """Ten moment grids (xx, xy, xz, yy, yz, zz, x, y, z, w)."""

    def __init__(self, shape, dtype, device):
        self.v = [torch.zeros(shape, dtype=dtype, device=device)
                  for _ in range(10)]

    def add(self, p, ok):
        px = torch.where(ok, p[..., 0], 0.0)
        py = torch.where(ok, p[..., 1], 0.0)
        pz = torch.where(ok, p[..., 2], 0.0)
        terms = (px * px, px * py, px * pz, py * py, py * pz, pz * pz,
                 px, py, pz, ok.to(p.dtype))
        self.v = [a + t for a, t in zip(self.v, terms)]

    def to_plane_moments(self, hint):
        return plane_fit.PlaneMoments(
            s2=torch.stack(self.v[:6], dim=-1),
            s1=torch.stack(self.v[6:9], dim=-1),
            w=self.v[9], normal_hint=hint)


class NormalSupport(NamedTuple):
    count: torch.Tensor                # [B, H, W] int32 support size
    moments: plane_fit.PlaneMoments    # batched [B, H, W]
    center_valid: torch.Tensor         # [B, H, W] bool


def _sq_dist(p, center):
    d = p - center
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


@takes_frames(points=3)
def find_normal_support(points: torch.Tensor,
                        params: ComputeNormalsParams) -> NormalSupport:
    """Vectorized FindNormalSupportNeighbors (algorithms.h:106-257).

    points: [B, H, W, 3]. Returns per-pixel support counts and moment sums
    over the center + up to 4 axis + 4 diagonal supports.
    """
    b, h, w = points.shape[:3]
    dev, dtype = points.device, points.dtype
    min_d2 = params.min_neighbor_distance ** 2
    max_d2 = params.max_neighbor_distance ** 2
    k_max = params.max_scan_steps

    center = points
    center_valid = nansafe.all_finite(points)
    rows_idx = torch.arange(h, dtype=torch.int32, device=dev)[:, None] \
        .expand(h, w)
    cols_idx = torch.arange(w, dtype=torch.int32, device=dev)[None, :] \
        .expand(h, w)

    pk = k_max
    padded = torch.nn.functional.pad(
        points.permute(0, 3, 1, 2), (pk, pk, pk, pk),
        value=float("nan")).permute(0, 2, 3, 1)
    padded_ok = torch.nn.functional.pad(center_valid, (pk, pk, pk, pk),
                                        value=False)

    def scan(dr, dc):
        found = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
        acc_point = torch.zeros_like(center)
        acc_coord = torch.zeros((b, h, w), dtype=torch.int32, device=dev)
        # offsets past the grid edge only ever see padding: skipping them
        # is exact
        reach = min(k_max, (h if dr else w) - 1)
        for k in range(1, reach + 1):
            r0, c0 = pk + dr * k, pk + dc * k
            p = padded[:, r0:r0 + h, c0:c0 + w]
            p_ok = padded_ok[:, r0:r0 + h, c0:c0 + w]
            d2 = _sq_dist(p, center)
            take = p_ok & (d2 >= min_d2) & (d2 <= max_d2) & ~found
            found = found | take
            acc_point = torch.where(take[..., None], p, acc_point)
            coord = (rows_idx + dr * k) if dr != 0 else (cols_idx + dc * k)
            acc_coord = torch.where(take, coord, acc_coord)
        return found, acc_point, acc_coord

    up = scan(-1, 0)
    down = scan(1, 0)
    left = scan(0, -1)
    right = scan(0, 1)

    acc = _Moments10((b, h, w), dtype, dev)
    acc.add(center, center_valid)
    for found, pt, _ in (up, down, left, right):
        acc.add(pt, found)
    count = (center_valid.to(torch.int32) + up[0].to(torch.int32)
             + down[0].to(torch.int32) + left[0].to(torch.int32)
             + right[0].to(torch.int32))

    if params.include_diagonal_neighbors:
        # defaults clamped +-1 like the reference init (algorithms.h:129-132)
        min_row = torch.where(up[0], up[2], (rows_idx - 1).clamp_min(0))
        max_row = torch.where(down[0], down[2], (rows_idx + 1).clamp_max(h - 1))
        min_col = torch.where(left[0], left[2], (cols_idx - 1).clamp_min(0))
        max_col = torch.where(right[0], right[2],
                              (cols_idx + 1).clamp_max(w - 1))
        has_up = min_row != rows_idx
        has_down = max_row != rows_idx
        has_left = min_col != cols_idx
        has_right = max_col != cols_idx
        diag_sel = [
            (has_left & has_up, min_row, min_col),
            (has_left & has_down, max_row, min_col),
            (has_right & has_up, min_row, max_col),
            (has_right & has_down, max_row, max_col),
        ]
        # one combined gather of the four diagonal supports per frame
        lin = torch.stack([(r * w + c).long() for _, r, c in diag_sel],
                          dim=1).reshape(b, 4 * h * w)
        flat = points.reshape(b, h * w, 3)
        diag_pts = torch.gather(flat, 1, lin[..., None].expand(-1, -1, 3)) \
            .reshape(b, 4, h, w, 3)
        diag_ok = torch.gather(center_valid.reshape(b, h * w), 1, lin) \
            .reshape(b, 4, h, w)
        for i, (gate, _, _) in enumerate(diag_sel):
            p = diag_pts[:, i]
            d2 = _sq_dist(p, center)
            ok = gate & diag_ok[:, i] & (d2 >= min_d2) & (d2 <= max_d2)
            acc.add(p, ok)
            count = count + ok.to(torch.int32)

    # 0 supports for a non-finite center (algorithms.h:125-127)
    count = torch.where(center_valid, count, 0)
    hint = torch.zeros((b, h, w, 3), dtype=dtype, device=dev)
    hint[..., 0] = 1.0
    return NormalSupport(count=count, moments=acc.to_plane_moments(hint),
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
        out_normals: Optional[torch.Tensor] = None) -> torch.Tensor:
    """ComputeNormalsOrganized (algorithms.h:330-375) over [H, W, 3] or
    [B, H, W, 3].

    ``sensor_origin`` is [3] (shared) or [B, 3]. Returns unit normals
    toward the sensor, of the points' shape; NaN where the center is
    invalid, support < ``min_num_support_neighbors``, or the fit is
    degenerate. ``row_range``/``col_range`` (half-open) restrict the
    result to a sub-rectangle, the reference's tiling seam
    (algorithms.h:333): outside it each pixel keeps ``out_normals`` (of the
    points' shape) or NaN.
    """
    support = find_normal_support(points, params)
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
