"""Planar region growing from a seed vector, one region at a time (port of
pcseg_tpu.models.planar: the sequential grower of ``growth_mode=
"wavefront"`` and ``"hybrid"``).

SegmentRegions<PlanarRegion> (segmentation.h:239-292, planar_region.h:
89-465): seeds pop back to front; the next still-unlabeled seed founds a
region, which grows from it:

  * ``"wavefront"``: a BFS wavefront over the 4-neighbourhood whose
    candidates pass the inlier gate |plane . p| < max_plane_distance; the
    plane is re-fitted whenever the inlier count crosses a multiple of
    ``plane_model_reestimation_period``, and after a re-fit the whole
    member set is the next frontier (candidates are retested against the
    new plane);
  * ``"hybrid"``: the wavefront until ``warmup_inliers``, then epochs:
    between re-fits the gate is fixed, so the members' 4-connected
    component of the gate (``connectivity.reachable_from``) is the next
    member set, re-fitted, until it stops growing or ``max_growth_epochs``.

A region with fewer than ``min_region_inliers`` members marks them
examined for the rest of the call (then unlabeled); the area and hull
checks run in the host finalize. JAX's ``while_loop``s are host loops here,
one frame after another. ``grow_planar_regions`` takes JAX's single frame
or a batch with a leading frame axis ``B`` (ops/frames.py).
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.kernels.common import shift2
from pcseg_tpu_torch.models.config import (
    EXAMINED, UNLABELED, PlanarRegionConfig)
from pcseg_tpu_torch.models.planar_batched import PlanarRegions
from pcseg_tpu_torch.ops import connectivity, geom, nansafe, plane_fit
from pcseg_tpu_torch.ops.frames import takes_frames


def _dilate4(mask):
    return (shift2(mask, 1, 0, False) | shift2(mask, -1, 0, False)
            | shift2(mask, 0, 1, False) | shift2(mask, 0, -1, False))


def _moments(mask, points):
    """(s2, s1, w) of the cells of ``mask``."""
    pts = torch.where(mask[..., None], points, 0.0).reshape(-1, 3)
    return plane_fit.moments_of_points(pts,
                                       mask.to(points.dtype).reshape(-1))


def _refit(m, plane_fallback_hint):
    """(moments with the refreshed hint, plane) after a re-fit: the solve's
    plane and normal when valid; otherwise the plane through the new
    centroid with the previous normal (plane_estimator.cc:209-227)."""
    sol = plane_fit.solve(m)
    hint = torch.where(sol.valid, sol.normal, m.normal_hint)
    recentered = geom.plane_from_normal_point(plane_fallback_hint,
                                              sol.centroid)
    return m._replace(normal_hint=hint), \
        torch.where(sol.valid, sol.plane, recentered)


def _grow_one(points, normals, eligible, seed_r, seed_c, config):
    """Grow one region from the seed cell; returns (members [H, W],
    plane [4], moments, count)."""
    h, w = points.shape[:2]
    dev = points.device
    tau = config.max_plane_distance
    period = config.plane_model_reestimation_period
    seed_normal = normals[seed_r, seed_c]
    plane = geom.plane_from_normal_point(seed_normal, points[seed_r, seed_c])
    m = plane_fit.set_normal_orientation(
        plane_fit.empty((), points.dtype, dev), seed_normal)
    member = torch.zeros((h, w), dtype=torch.bool, device=dev)
    frontier = member.clone()
    frontier[seed_r, seed_c] = True
    count = 0
    it = 0
    first = True
    warmup = config.warmup_inliers if config.growth_mode == "hybrid" \
        else None
    # the wavefront (and the hybrid mode's warm-up)
    while (first or bool(frontier.any())) \
            and it < config.max_growth_iters \
            and (warmup is None or count < warmup):
        # wave 0's candidate is the seed itself (planar_region.h:158)
        cand = frontier if first else \
            _dilate4(frontier) & eligible & ~member
        # NaN fails the gate
        accepted = cand & (geom.plane_abs_distance(plane, points) < tau)
        member = member | accepted
        ds2, ds1, dw = _moments(accepted, points)
        m = m._replace(s2=m.s2 + ds2, s1=m.s1 + ds1, w=m.w + dw)
        new_count = count + int(accepted.sum())
        crossed = new_count // period > count // period
        if crossed:
            m, plane = _refit(m, m.normal_hint)
        frontier = member if crossed else accepted
        count = new_count
        it += 1
        first = False
    if warmup is None:
        return member, plane, m, count
    # the epochs: the members' component of the fixed gate, re-fitted
    grew = True
    epoch = 0
    while grew and epoch < config.max_growth_epochs:
        gate = (eligible & (geom.plane_abs_distance(plane, points) < tau)) \
            | member
        member = connectivity.reachable_from(gate, member)
        new_count = int(member.sum())
        s2, s1, wsum = _moments(member, points)
        m, plane = _refit(m._replace(s2=s2, s1=s1, w=wsum), m.normal_hint)
        grew = new_count > count
        count = new_count
        epoch += 1
    return member, plane, m, count


def _grow_frame(points, normals, labels, seed_indices, seed_valid, config,
                initial_id_offset, max_attempts):
    h, w = points.shape[:2]
    hw = h * w
    dev = points.device
    r_cap = config.max_regions
    planes = torch.zeros((r_cap, 4), dtype=points.dtype, device=dev)
    centroids = torch.zeros((r_cap, 3), dtype=points.dtype, device=dev)
    curvatures = torch.zeros((r_cap,), dtype=points.dtype, device=dev)
    counts = torch.zeros((r_cap,), dtype=torch.int32, device=dev)
    seeds_out = torch.zeros((r_cap,), dtype=torch.int32, device=dev)
    moments = plane_fit.empty((r_cap,), points.dtype, dev)
    finite = nansafe.all_finite(points)
    s = seed_indices.shape[0]
    order = torch.arange(s, device=dev)
    # the seeds' cells, clipped as JAX's gathers clamp
    seed_flat = ((seed_indices % h) * w
                 + torch.div(seed_indices, h, rounding_mode="floor")) \
        .clamp(0, hw - 1).long()
    consumed = torch.zeros((s,), dtype=torch.bool, device=dev)
    num_regions = 0
    attempts = 0
    while attempts < max_attempts and num_regions < r_cap:
        available = seed_valid & ~consumed \
            & (labels.reshape(-1)[seed_flat] == UNLABELED)
        if not bool(available.any()):
            break
        # pop order: the highest vector position first
        pick = int(torch.where(available, order, -1).argmax())
        consumed[pick] = True
        seed_idx = int(seed_indices[pick])
        cell = int(seed_flat[pick])
        eligible = (labels == UNLABELED) & finite
        member, plane, m, count = _grow_one(
            points, normals, eligible, cell // w, cell % w, config)
        attempts += 1
        if count < config.min_region_inliers:
            labels = torch.where(member, EXAMINED, labels)
            continue
        labels = torch.where(member, num_regions + initial_id_offset, labels)
        # the final fit keeps the last plane's orientation
        sol = plane_fit.solve(m._replace(normal_hint=plane[:3]))
        planes[num_regions] = torch.where(sol.valid, sol.plane, plane)
        centroids[num_regions] = sol.centroid
        curvatures[num_regions] = sol.curvature
        counts[num_regions] = count
        seeds_out[num_regions] = seed_idx
        for field in plane_fit.PlaneMoments._fields:
            getattr(moments, field)[num_regions] = getattr(m, field)
        num_regions += 1
    # kAlreadyExamedPoint -> kUnlabeled at call end (segmentation.h:287-291)
    labels = torch.where(labels == EXAMINED, UNLABELED, labels)
    overflow = attempts >= max_attempts or num_regions >= r_cap
    return (labels, num_regions, planes, centroids, curvatures, counts,
            seeds_out, moments, overflow)


@takes_frames(points=3, normals=3, labels=2, seed_indices=1, seed_valid=1)
def grow_planar_regions(points: torch.Tensor, normals: torch.Tensor,
                        labels: torch.Tensor, seed_indices: torch.Tensor,
                        seed_valid: torch.Tensor,
                        config: PlanarRegionConfig = PlanarRegionConfig(),
                        initial_id_offset: int = 0,
                        max_attempts: int = 256) -> PlanarRegions:
    """Grow planar regions from ranked seeds, one at a time.

    ``points``/``normals`` [(B,) H, W, 3] (NaN invalid); ``labels``
    [(B,) H, W] int32 (only UNLABELED cells can be claimed);
    ``seed_indices`` [(B,) S] col-major seeds in the reference's vector
    order (popped back to front) and ``seed_valid`` [(B,) S];
    ``config.growth_mode`` is ``"wavefront"`` or ``"hybrid"``;
    ``max_attempts`` bounds the region attempts (accepted and rejected) of
    a frame. ``overflow`` is set when the attempts or the region table ran
    out."""
    if config.growth_mode not in ("wavefront", "hybrid"):
        raise ValueError(f"the sequential grower runs 'wavefront' or "
                         f"'hybrid', not {config.growth_mode!r}")
    frames = [_grow_frame(points[i], normals[i], labels[i], seed_indices[i],
                          seed_valid[i], config, initial_id_offset,
                          max_attempts)
              for i in range(points.shape[0])]
    dev = points.device

    def stack(k):
        return torch.stack([f[k] for f in frames])

    return PlanarRegions(
        labels=stack(0),
        num_regions=torch.tensor([f[1] for f in frames], dtype=torch.int32,
                                 device=dev),
        planes=stack(2), centroids=stack(3), curvatures=stack(4),
        counts=stack(5), seed_indices=stack(6),
        moments=plane_fit.PlaneMoments(*[
            torch.stack([getattr(f[7], k) for f in frames])
            for k in plane_fit.PlaneMoments._fields]),
        overflow=torch.tensor([f[8] for f in frames], device=dev))
