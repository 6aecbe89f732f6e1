"""Seed finders (port of pcseg_tpu.ops.seeds): the plane-support rank grid
(FindSeedPointsFromPlaneSupport, segmentation.h:190-230), the average-normal
seed list (FindSeedPointsFromAverageNormals, segmentation.h:136-184) and the
temporal seeds of the previous frame's regions
(FindSeedPointsFromLastPlanarRegions, planar_region.h:478-519).

Plane support: every pixel with a finite point and normal counts the window points within
``max_plane_distance`` of its tangent plane; qualifying pixels get a unique
pop rank in the reference's order (count desc, col-major index desc). The
reference indexes its grids transposed (``points.AtUnsafe(col, row)``);
the JAX package replicates that quirk and so does this port, including
the min-fold over shifted planes that non-square grids produce (see
pcseg_tpu.ops.seeds.plane_support_rank_grid). Shapes carry a leading frame
axis ``B``.

The dense rank grid is what the batched grower consumes; the sequential
grower takes the top-``max_seeds`` seed vector (``seed_vector=True``).

Average normals: the weighted-average recurrence of the reference is
sum_i n_i * S_i / sum_i n_i over the window's per-row normal sums S_i, and a
window whose first row has no valid normal hits a 0/0 that rejects it; both
are kept, with the transposed indexing and the ``lin - half`` re-centring of
the emitted seed. The box sums and the squared length add in XLA:CPU's
order (``ops/xla_order``), so the scores, and the knife edges of the score
gate, are JAX's bit for bit.

Temporal seeds: JAX takes the [R, H*W] distance and normal products as f32
dots; the port evaluates them in XLA:CPU's fused order (``ops/xla_order``),
so the argmin sees JAX's values.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from pcseg_tpu_torch.kernels.common import shift2
from pcseg_tpu_torch.models.config import (SeedsFromAverageNormalsParams,
                                           SeedsFromPlaneSupportParams)
from pcseg_tpu_torch.ops import nansafe, xla_order

# == models.planar_batched.INF_RANK
SEED_RANK_INF = int(np.int32(2 ** 30))


class RankedSeeds(NamedTuple):
    count: torch.Tensor      # [B, H, W] int32 support counts (diagnostic)
    # [B, H, W] int32 pop-priority grid over EVERY qualifying seed (smaller
    # = popped earlier); SEED_RANK_INF where not a seed
    rank_grid: torch.Tensor
    # [B, S] int32 col-major seed vector in the reference's order (the
    # last pops first) and its valid mask; only with ``seed_vector=True``
    indices: Optional[torch.Tensor] = None
    valid: Optional[torch.Tensor] = None


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


def rank_plane_support_seeds(count, qualifies, h, w, max_seeds):
    """The reference's multimap order as a seed vector ([B, S] int32
    col-major indices, [B, S] valid; S = min(max_seeds, H*W)): ascending
    (count, col-major index), of which the TOP ``max_seeds`` (the back of
    the vector, which the driver pops first) are kept; invalid entries key
    below every valid one and read 0. Layouts as in
    :func:`plane_support_rank_grid`."""
    b, ha, wa = count.shape
    dev = count.device
    rows = torch.arange(ha, dtype=torch.int64, device=dev)[:, None]
    cols = torch.arange(wa, dtype=torch.int64, device=dev)[None, :]
    lin_idx = cols * h + rows
    key = torch.where(qualifies, count.to(torch.int64) * (h * w) + lin_idx,
                      -1).reshape(b, -1)
    order = torch.argsort(key, dim=1, stable=True)[:, -max_seeds:]
    valid = torch.gather(key, 1, order) >= 0
    return torch.where(valid, lin_idx.reshape(-1)[order], 0) \
        .to(torch.int32), valid


def seeds_from_plane_support(
        points: torch.Tensor, normals: torch.Tensor,
        params: SeedsFromPlaneSupportParams = SeedsFromPlaneSupportParams(),
        seed_vector: bool = False) -> RankedSeeds:
    """FindSeedPointsFromPlaneSupport over [B, H, W, 3] points/normals, in
    the reference's transposed grid orientation. ``seed_vector=True`` also
    ranks the top-``max_seeds`` seed vector (the sequential grower's
    input)."""
    b, h, w = points.shape[:3]
    dev = points.device
    if h < params.neighborhood_size or w < params.neighborhood_size:
        none = torch.zeros((b, params.max_seeds), dtype=torch.int32,
                           device=dev)
        return RankedSeeds(
            torch.zeros((b, h, w), dtype=torch.int32, device=dev),
            torch.full((b, h, w), SEED_RANK_INF, dtype=torch.int32,
                       device=dev),
            *((none, none.bool()) if seed_vector else ()))
    count, center_ok = plane_support_counts(points.transpose(1, 2),
                                            normals.transpose(1, 2), params)
    qualifies = center_ok & (count >= params.min_num_support_points)
    rank_grid = plane_support_rank_grid(
        count, qualifies, h, w, cmax=params.neighborhood_size ** 2 + 1)
    vector = rank_plane_support_seeds(count, qualifies, h, w,
                                      params.max_seeds) \
        if seed_vector else ()
    return RankedSeeds(count.transpose(1, 2).contiguous(), rank_grid,
                       *vector)


# -- average-normal seeds -----------------------------------------------------

def _box_sum_trailing(arr, n, dim):
    """Trailing box sum of length n along ``dim``: out[k] = sum(arr[k-n+1 :
    k+1]) (partial near the leading edge)."""
    cs = xla_order.cumsum_last(arr.movedim(dim, -1)).movedim(-1, dim)
    shifted = torch.roll(cs, n, dims=dim)
    idx = torch.arange(arr.shape[dim], device=arr.device)
    idx = idx.reshape((-1,) + (1,) * (arr.dim() - 1 - dim % arr.dim()))
    return cs - torch.where(idx >= n, shifted, 0.0)


def _box_sum_centered(arr, half, dim):
    """Centered box sum of radius ``half`` along ``dim``; like JAX's, the
    last ``half`` entries wrap around to the first ones."""
    trailing = _box_sum_trailing(arr, 2 * half + 1, dim)
    return torch.roll(trailing, -half, dims=dim) if half else trailing


class SeedMask(NamedTuple):
    mask: torch.Tensor        # [B, H, W] bool: (r, c) produces a seed
    seed_index: torch.Tensor  # [B, H, W] int32 emitted col-major index
    score: torch.Tensor       # [B, H, W] squared average normal length


def seeds_from_average_normals(
        normals: torch.Tensor,
        params: SeedsFromAverageNormalsParams = SeedsFromAverageNormalsParams()
) -> SeedMask:
    """FindSeedPointsFromAverageNormals over [B, H, W, 3] normals, dense:
    position (r, c) emits the seed index ``lin(r, c) - half``."""
    b, h, w = normals.shape[:3]
    dev = normals.device
    nbh = params.neighborhood_size
    half = nbh // 2
    if h < nbh or w < nbh:
        return SeedMask(torch.zeros((b, h, w), dtype=torch.bool, device=dev),
                        torch.zeros((b, h, w), dtype=torch.int32, device=dev),
                        torch.zeros((b, h, w), dtype=normals.dtype,
                                    device=dev))
    nt = normals.transpose(1, 2)  # [B, W, H, 3]: the reference's indexing
    valid = nansafe.all_finite(nt)
    nvals = torch.where(valid[..., None], nt, 0.0)
    s = _box_sum_trailing(nvals, nbh, 2)
    cnt = _box_sum_trailing(valid.to(nt.dtype), nbh, 2)
    numer = _box_sum_centered(cnt[..., None] * s, half, 1)
    denom = _box_sum_centered(cnt, half, 1)
    avg = numer / torch.where(denom > 0, denom, 1.0)[..., None]
    score = xla_order.sumsq(avg)
    first_cnt = shift2(cnt, -half, 0, 0.0)  # cnt[r - half]
    rows_t = torch.arange(w, device=dev)[:, None]
    cols_t = torch.arange(h, device=dev)[None, :]
    mask_t = ((rows_t >= half) & (rows_t < h - half)
              & (cols_t >= nbh - 1) & (cols_t < w)
              & (denom >= params.min_num_valid_normals)
              & (first_cnt > 0)
              & (score >= params.min_avg_normal_length ** 2))
    hh, ww = min(h, w), min(w, h)
    mask = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    mask[:, :hh, :ww] = mask_t[:, :hh, :ww]
    score_rc = torch.zeros((b, h, w), dtype=score.dtype, device=dev)
    score_rc[:, :hh, :ww] = score[:, :hh, :ww]
    rows = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    seed_index = (cols * h + rows - half).expand(b, h, w)
    return SeedMask(mask=mask, seed_index=seed_index, score=score_rc)


def average_normal_seed_list(seed_mask: SeedMask, max_seeds: int):
    """Seed vectors [B, S] in the reference's emit order (row-outer, then
    column), S = min(max_seeds, H*W): (indices int32, valid bool). The
    grower pops back to front; over capacity the back of the vector (the
    first-popped seeds) is kept."""
    b, h, w = seed_mask.mask.shape
    dev = seed_mask.mask.device
    scan_pos = torch.arange(h * w, dtype=torch.int32, device=dev)
    key = torch.where(seed_mask.mask.reshape(b, -1), scan_pos, -1)
    order = torch.argsort(key, dim=1, stable=True)[:, -max_seeds:]
    valid = torch.gather(key, 1, order) >= 0
    indices = torch.gather(seed_mask.seed_index.reshape(b, -1), 1, order)
    return torch.where(valid, indices, 0), valid


# -- temporal seeds -----------------------------------------------------------

def append_temporal_to_rank_grid(rank_grid, t_idx, t_found):
    """Scatter temporal seeds [B, T] into [B, H, W] rank grids with ranks
    -1, -2, ... (-(i + 1)), below every per-frame seed's: the reference
    appends them to the vector (planar_region.h:516) and pops back to
    front, so they pop first."""
    b, h, w = rank_grid.shape
    hw = h * w
    t = t_idx.shape[1]
    rank = -(torch.arange(t, dtype=torch.int32, device=rank_grid.device) + 1)
    ok = t_found & (t_idx >= 0) & (t_idx < hw)
    flat_cm = rank_grid.transpose(1, 2).reshape(b, hw).clone()
    flat_cm.scatter_reduce_(1, t_idx.clamp(0, hw - 1).long(),
                            torch.where(ok, rank, SEED_RANK_INF), "amin")
    return flat_cm.reshape(b, w, h).transpose(1, 2).contiguous()


def seeds_from_last_regions(points, normals, prev_centroids, prev_normals,
                            prev_counts, prev_valid, pose_cur_prev,
                            max_distance: float,
                            max_normal_difference_angle: float):
    """Temporal seed transfer over [B, H, W, 3] points/normals and [B, R]
    previous-region tables (centroids and normals [B, R, 3], int32 counts,
    bool valid). Each region, moved into the current frame by
    ``pose_cur_prev`` (a geom.Pose shared by the batch), seeds at the
    nearest current point within ``max_distance`` whose normal passes the
    angle gate. Returns (col-major indices int32 [B, R], found [B, R]) in
    the reference's order: ascending previous count, then region index."""
    b, h, w = points.shape[:3]
    c_cur = pose_cur_prev.apply(prev_centroids)
    n_cur = pose_cur_prev.rotate(prev_normals)
    cos_gate = math.cos(max_normal_difference_angle)
    flat_p = points.reshape(b, -1, 3)
    flat_n = normals.reshape(b, -1, 3)
    cross = xla_order.dot3(c_cur, flat_p)
    c2 = xla_order.sumsq(c_cur)[..., None]  # [B, R, 1]
    p2 = xla_order.sumsq(flat_p)
    d2 = c2 - 2.0 * cross + p2[:, None, :]
    ndot = xla_order.dot3(n_cur, flat_n)
    ok = ((ndot > cos_gate) & (d2 < max_distance * max_distance)
          & nansafe.all_finite(flat_p)[:, None, :]
          & nansafe.all_finite(flat_n)[:, None, :])
    masked = torch.where(ok, d2, float("inf"))
    best = torch.argmin(masked, dim=-1)
    found = (torch.gather(masked, 2, best[..., None])[..., 0]
             < float("inf")) & prev_valid
    lin = ((best % w) * h + best // w).to(torch.int32)
    r = prev_counts.shape[1]
    order = torch.argsort(
        prev_counts * r + torch.arange(r, dtype=torch.int32,
                                       device=points.device),
        dim=1, stable=True)
    return torch.gather(lin, 1, order), torch.gather(found, 1, order)
