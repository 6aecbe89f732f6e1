"""Incremental-PCA plane fitting (port of pcseg_tpu.ops.plane_fit).

The reference keeps a running plane fit in 10 scalars: six second moments
(xx, xy, xz, yy, yz, zz), a 3-vector point sum and a weight sum
(plane_estimator.h:112-119); the plane is the smallest-eigenvalue
eigenvector of the mean-centred covariance (plane_estimator.cc:184-229).
Merging is accumulator addition (plane_estimator.cc:128-133); a frame
change conjugates the covariance by the rotation (:142-182). The state is
batched over any leading axes. ``to_dict``/``from_dict`` carry it in the
PlaneEstimatorProto's field names (plane_estimator.proto:22-32), so moments
that the JAX package wrote load here.

:func:`moments_of_points` forms the f32 products as JAX does and sums them
in f64, rounded once to f32: deterministic on the card, and JAX's f32 sums
(in XLA:CPU's order) differ from it by f32 rounding only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.reference.port_plain import precision

from portbench.reference.port_plain.ops import geom


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


def empty(batch_shape=(), dtype=torch.float32, device=None) -> PlaneMoments:
    """Cleared estimator; normal_hint = +x like the reference Clear()
    (plane_estimator.cc:46-53)."""
    batch_shape = tuple(batch_shape)
    hint = torch.zeros(batch_shape + (3,), dtype=dtype, device=device)
    hint[..., 0] = 1.0
    return PlaneMoments(
        s2=torch.zeros(batch_shape + (6,), dtype=dtype, device=device),
        s1=torch.zeros(batch_shape + (3,), dtype=dtype, device=device),
        w=torch.zeros(batch_shape, dtype=dtype, device=device),
        normal_hint=hint)


def moments_of_points(points, weights=None):
    """(s2 [..., 6], s1 [..., 3], w [...]) of [..., N, 3] points with
    optional [..., N] weights (0 masks a point out), reduced over N: the
    f32 products summed in f64 and rounded to f32."""
    if weights is None:
        weights = torch.ones(points.shape[:-1], dtype=points.dtype,
                             device=points.device)
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    terms = torch.stack([x * x * weights, x * y * weights, x * z * weights,
                         y * y * weights, y * z * weights, z * z * weights,
                         x * weights, y * weights, z * weights, weights],
                        dim=-1)
    sums = terms.to(precision.MOMENT_SUM_DTYPE).sum(dim=-2).to(points.dtype)
    return sums[..., :6], sums[..., 6:9], sums[..., 9]


def add_points(m: PlaneMoments, points, weights=None) -> PlaneMoments:
    """Add (masked, weighted) points; points [..., N, 3] batched like m."""
    s2, s1, w = moments_of_points(points, weights)
    return m._replace(s2=m.s2 + s2, s1=m.s1 + s1, w=m.w + w)


def merge(a: PlaneMoments, b: PlaneMoments) -> PlaneMoments:
    """Accumulator addition (plane_estimator.cc:128-133); keeps a's hint."""
    return PlaneMoments(a.s2 + b.s2, a.s1 + b.s1, a.w + b.w, a.normal_hint)


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


def transform(m: PlaneMoments, pose: geom.Pose) -> PlaneMoments:
    """Re-express the accumulators in a new frame (plane_estimator.cc:
    142-182): cov' = R cov R^T on the mean-centred covariance, the centroid
    moved by the full pose, the moments reassembled (so merge after
    transform is exact); the sticky hint rotates with the frame."""
    (c00, c01, c02, c11, c12, c22), centroid = _covariance_c(m)
    cov = torch.stack([torch.stack([c00, c01, c02], dim=-1),
                       torch.stack([c01, c11, c12], dim=-1),
                       torch.stack([c02, c12, c22], dim=-1)], dim=-2)
    rot = pose.rotation_matrix()
    cov_t = geom.matmul_sums(geom.matmul_sums(rot, cov),
                             rot.transpose(-1, -2))
    c = pose.apply(centroid)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    s2 = torch.stack([
        cov_t[..., 0, 0] + cx * cx, cov_t[..., 0, 1] + cx * cy,
        cov_t[..., 0, 2] + cx * cz, cov_t[..., 1, 1] + cy * cy,
        cov_t[..., 1, 2] + cy * cz, cov_t[..., 2, 2] + cz * cz,
    ], dim=-1) * m.w[..., None]
    return PlaneMoments(s2=s2, s1=c * m.w[..., None], w=m.w,
                        normal_hint=pose.rotate(m.normal_hint))


def to_dict(m: PlaneMoments) -> dict:
    """The state under the PlaneEstimatorProto's field names."""
    return {"covariance_accumulator": m.s2, "cumulative_centroid": m.s1,
            "cumulative_weights": m.w, "normal": m.normal_hint}


def from_dict(d: dict, device=None) -> PlaneMoments:
    """The state from :func:`to_dict`'s form, of either package (any
    array-like values; f32 tensors on ``device``)."""
    def t(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)
    return PlaneMoments(s2=t(d["covariance_accumulator"]),
                        s1=t(d["cumulative_centroid"]),
                        w=t(d["cumulative_weights"]),
                        normal_hint=t(d["normal"]))
