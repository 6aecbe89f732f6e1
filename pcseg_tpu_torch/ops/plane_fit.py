"""Incremental-PCA plane fitting (port of pcseg_tpu.ops.plane_fit: the
moment state, the orientation hint and the closed-form solve).

The reference keeps a running plane fit in 10 scalars: six second moments
(xx, xy, xz, yy, yz, zz), a 3-vector point sum and a weight sum
(plane_estimator.h:112-119); the plane is the smallest-eigenvalue
eigenvector of the mean-centred covariance (plane_estimator.cc:184-229).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pcseg_tpu_torch.ops import geom


class PlaneMoments(NamedTuple):
    """Accumulator state; all fields share leading batch dims ``[...]``.

    s2: [..., 6] second moments (xx, xy, xz, yy, yz, zz).
    s1: [..., 3] point sum.
    w:  [...]    weight sum.
    normal_hint: [..., 3] sticky normal orientation.
    """
    s2: torch.Tensor
    s1: torch.Tensor
    w: torch.Tensor
    normal_hint: torch.Tensor


def set_normal_orientation(m: PlaneMoments, hint) -> PlaneMoments:
    """Store the orientation hint used to sign the computed normal."""
    return m._replace(normal_hint=hint)


def _covariance_c(m: PlaneMoments):
    """Mean-centred covariance components and centroid
    (plane_estimator.cc:187-199)."""
    w_safe = torch.where(m.w > 0, m.w, torch.ones_like(m.w))
    centroid = m.s1 / w_safe[..., None]
    accu = m.s2 / w_safe[..., None]
    cx, cy, cz = centroid[..., 0], centroid[..., 1], centroid[..., 2]
    c00 = accu[..., 0] - cx * cx
    c01 = accu[..., 1] - cx * cy
    c02 = accu[..., 2] - cx * cz
    c11 = accu[..., 3] - cy * cy
    c12 = accu[..., 4] - cy * cz
    c22 = accu[..., 5] - cz * cz
    return (c00, c01, c02, c11, c12, c22), centroid


class PlaneSolution(NamedTuple):
    plane: torch.Tensor      # [..., 4] coeffs (n, d)
    centroid: torch.Tensor   # [..., 3]
    curvature: torch.Tensor  # [...]
    valid: torch.Tensor      # [...] bool
    normal: torch.Tensor     # [..., 3]
    # lambda_1 / trace: ~0 for a collinear set (see pcseg_tpu.ops.plane_fit)
    mid_ratio: Optional[torch.Tensor] = None


def solve(m: PlaneMoments) -> PlaneSolution:
    """Closed-form plane solve, batched (plane_estimator.cc:184-229).

    Valid when w > 0 and the second-smallest eigenvalue exceeds FLT_MIN;
    an invalid entry returns the plane through the centroid with the
    (sticky) hint normal (plane_estimator.cc:224-228).
    """
    (c00, c01, c02, c11, c12, c22), centroid = _covariance_c(m)
    evals, vec = geom.eigh3x3_smallest_c(
        c00, c01, c02, c11, c12, c22, prev_normal=m.normal_hint)

    valid = (m.w > 0) & (evals[..., 1] > geom.FLT_MIN)
    normal = torch.where(valid[..., None], vec, m.normal_hint)
    plane = geom.plane_from_normal_point(normal, centroid)

    trace = c00 + c11 + c22
    lam0 = evals[..., 0]
    curv_ok = (trace > lam0) & (lam0 > geom.FLT_MIN) & valid
    safe_trace = torch.where(trace != 0, trace, torch.ones_like(trace))
    curvature = torch.where(curv_ok, (lam0 / safe_trace).abs(),
                            torch.zeros_like(trace))
    pos_trace = torch.where(trace > 0, trace, torch.ones_like(trace))
    mid_ratio = torch.where(trace > 0, evals[..., 1] / pos_trace,
                            torch.zeros_like(trace))
    return PlaneSolution(plane=plane, centroid=centroid, curvature=curvature,
                         valid=valid, normal=normal, mid_ratio=mid_ratio)
