"""Plane-support seed ranking (port of pcseg_tpu.ops.seeds: the
FindSeedPointsFromPlaneSupport finder, segmentation.h:190-230).

Every pixel with a finite point and normal counts the window points within
``max_plane_distance`` of its tangent plane; qualifying pixels get a unique
pop rank in the reference's order (count desc, col-major index desc). The
reference indexes its grids transposed (``points.AtUnsafe(col, row)``);
the JAX package replicates that quirk and so does this port, including
the min-fold over shifted planes that non-square grids produce (see
pcseg_tpu.ops.seeds.plane_support_rank_grid). Shapes carry a leading frame
axis ``B``.

Only the dense rank grid is built: it is what the batched grower consumes.
The top-``max_seeds`` seed vector of the JAX finder is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pcseg_tpu_torch.models.config import SeedsFromPlaneSupportParams
from pcseg_tpu_torch.ops import nansafe

# == models.planar_batched.INF_RANK
SEED_RANK_INF = int(np.int32(2 ** 30))


class RankedSeeds(NamedTuple):
    count: torch.Tensor      # [B, H, W] int32 support counts (diagnostic)
    # [B, H, W] int32 pop-priority grid over EVERY qualifying seed (smaller
    # = popped earlier); SEED_RANK_INF where not a seed
    rank_grid: torch.Tensor


def plane_support_counts(points, normals, params):
    """Per-pixel plane-support counts in the orientation given: the plane
    at (r, c) tested against the window points[r±h, c±h]. [B, A, C, 3] in,
    ([B, A, C] int32 counts, [B, A, C] center-ok) out."""
    b, ha, wa = points.shape[:3]
    finite_pts = nansafe.all_finite(points)
    center_ok = finite_pts & nansafe.all_finite(normals)
    half = params.neighborhood_size // 2
    nx, ny, nz = normals[..., 0], normals[..., 1], normals[..., 2]
    d = -(nx * points[..., 0] + ny * points[..., 1] + nz * points[..., 2])
    padded = torch.nn.functional.pad(
        points.permute(0, 3, 1, 2), (half, half, half, half),
        value=float("nan")).permute(0, 2, 3, 1)
    padded_ok = torch.nn.functional.pad(finite_pts, (half, half, half, half),
                                        value=False)
    count = torch.zeros((b, ha, wa), dtype=torch.int32, device=points.device)
    for dr in range(-half, half + 1):
        for dc in range(-half, half + 1):
            # q[a, b] = points[a + dr, b + dc]
            q = padded[:, half + dr:half + dr + ha, half + dc:half + dc + wa]
            q_ok = padded_ok[:, half + dr:half + dr + ha,
                             half + dc:half + dc + wa]
            dist = (nx * q[..., 0] + ny * q[..., 1] + nz * q[..., 2] + d).abs()
            count = count + ((dist < params.max_plane_distance)
                             & q_ok).to(torch.int32)
    return count, center_ok


def plane_support_rank_grid(count, qualifies, h, w, cmax):
    """Dense [B, H, W] pop-priority grid from the support counts (see
    pcseg_tpu.ops.seeds.plane_support_rank_grid for the derivation).
    ``count``/``qualifies`` are [B, H, W] (natural) or [B, W, H]
    (transposed parity)."""
    b, ha, wa = count.shape
    dev = count.device
    rows = torch.arange(ha, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(wa, dtype=torch.int32, device=dev)[None, :]
    lin_idx = cols * h + rows
    hw = h * w
    rank = (cmax - count) * hw + (hw - 1 - lin_idx)
    vals = torch.where(qualifies, rank, SEED_RANK_INF).to(torch.int32)
    if (ha, wa) == (h, w):
        return vals
    assert (ha, wa) == (w, h), (count.shape, h, w)
    out = torch.full((b, h, w), SEED_RANK_INF, dtype=torch.int32, device=dev)
    for k in range(-(-w // h)):
        # term[r, c] = vals[r + k*h, c - k] (out of range -> INF)
        r0 = k * h
        rows_avail = min(h, w - r0)
        cols_keep = min(h, w - k)
        if rows_avail <= 0 or cols_keep <= 0:
            break
        block = vals[:, r0:r0 + rows_avail, :cols_keep]
        out[:, :rows_avail, k:k + cols_keep] = torch.minimum(
            out[:, :rows_avail, k:k + cols_keep], block)
    if (h - 1) * h + (w - 1) >= hw:  # emitted indices >= h*w fold into the
        # last cell (the JAX finder's clip)
        clipped = torch.where(lin_idx >= hw, vals, SEED_RANK_INF) \
            .amin(dim=(1, 2))
        out[:, h - 1, w - 1] = torch.minimum(out[:, h - 1, w - 1], clipped)
    return out


def seeds_from_plane_support(
        points: torch.Tensor, normals: torch.Tensor,
        params: SeedsFromPlaneSupportParams = SeedsFromPlaneSupportParams()
) -> RankedSeeds:
    """FindSeedPointsFromPlaneSupport over [B, H, W, 3] points/normals, in
    the reference's transposed grid orientation."""
    b, h, w = points.shape[:3]
    dev = points.device
    if h < params.neighborhood_size or w < params.neighborhood_size:
        return RankedSeeds(
            torch.zeros((b, h, w), dtype=torch.int32, device=dev),
            torch.full((b, h, w), SEED_RANK_INF, dtype=torch.int32,
                       device=dev))
    count, center_ok = plane_support_counts(points.transpose(1, 2),
                                            normals.transpose(1, 2), params)
    qualifies = center_ok & (count >= params.min_num_support_points)
    rank_grid = plane_support_rank_grid(
        count, qualifies, h, w, cmax=params.neighborhood_size ** 2 + 1)
    return RankedSeeds(count=count.transpose(1, 2).contiguous(),
                       rank_grid=rank_grid)
