"""Point-cloud registration (port of pcseg_tpu.ops.registration): nearest
neighbours, Kabsch and ICP, after algorithms.h.

  * NearestNeighbors (:612-631): one distance matrix per block of source
    points, |s|^2 - 2 s.d + |d|^2, the cross term as f32 dots in XLA:CPU's
    fused order (ops/xla_order), so its argmin (the first minimum) picks
    JAX's index, ties included;
  * ComputeRigidTransform (:554-607): Kabsch by the SVD of the 3x3 cross
    covariance with the det(R) = -1 mirror correction (the SVD's factors
    have free signs; the transform does not);
  * IterativeClosestPoint (:637-684): a host loop with the reference's
    mean-error tolerance early-out.

All products are elementwise sums (no library matmul, so no TF32).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from pcseg_tpu_torch.ops import geom, xla_order


def nearest_neighbors(source: torch.Tensor, dest: torch.Tensor,
                      tile: Optional[int] = None) -> torch.Tensor:
    """[N] int32 index into ``dest`` [M, 3] of each ``source`` [N, 3]
    point's nearest neighbour (the first one on a tie); ``tile`` bounds the
    rows of one distance block."""
    def block(src):
        s2 = (src[:, 0] * src[:, 0] + src[:, 1] * src[:, 1]
              + src[:, 2] * src[:, 2])
        d2 = (dest[:, 0] * dest[:, 0] + dest[:, 1] * dest[:, 1]
              + dest[:, 2] * dest[:, 2])
        cross = xla_order.dot3(src, dest) if src.dtype == torch.float32 \
            else (src[:, None, :] * dest[None, :, :]).sum(dim=-1)
        return torch.argmin(s2[:, None] - 2.0 * cross + d2[None, :],
                            dim=-1).to(torch.int32)

    if tile is None or source.shape[0] <= tile:
        return block(source)
    return torch.cat([block(c) for c in torch.split(source, tile)])


class RigidTransform(NamedTuple):
    rotation: torch.Tensor     # [3, 3]
    translation: torch.Tensor  # [3]

    def apply(self, points):
        return (points[..., None, :] * self.rotation).sum(dim=-1) \
            + self.translation


def compute_rigid_transform(source: torch.Tensor, dest: torch.Tensor,
                            weights: Optional[torch.Tensor] = None
                            ) -> RigidTransform:
    """Best-fit rotation and translation mapping paired ``source`` points
    onto ``dest`` (Kabsch, optionally weighted)."""
    if weights is None:
        weights = torch.ones(source.shape[:-1], dtype=source.dtype,
                             device=source.device)
    wsum = torch.clamp_min(weights.sum(), geom.FLT_MIN)
    c_s = (source * weights[:, None]).sum(dim=0) / wsum
    c_d = (dest * weights[:, None]).sum(dim=0) / wsum
    s = (source - c_s) * weights[:, None]
    d = dest - c_d
    sdt = (s[:, :, None] * d[:, None, :]).sum(dim=0)
    u, _, vt = torch.linalg.svd(sdt)
    v = vt.T
    det = torch.linalg.det(u) * torch.linalg.det(v)
    sign = torch.stack([torch.ones_like(det), torch.ones_like(det), det])
    # R = V S U^T with S = diag(1, 1, det) (the mirror correction, :593-601)
    r = geom.matmul_sums(v * sign[None, :], u.T)
    t = c_d - (r * c_s[None, :]).sum(dim=-1)
    return RigidTransform(rotation=r, translation=t)


class ICPResult(NamedTuple):
    transform: RigidTransform
    mean_error: torch.Tensor
    iterations: int


def iterative_closest_point(source: torch.Tensor, dest: torch.Tensor,
                            max_iterations: int = 20,
                            tolerance: float = 1e-3) -> ICPResult:
    """ICP: match each point to its nearest neighbour, fit the step by
    Kabsch, accumulate, and stop once the mean error changes by less than
    ``tolerance`` (the first step compares with 0, as the reference)."""
    acc_r = torch.eye(3, dtype=source.dtype, device=source.device)
    acc_t = torch.zeros(3, dtype=source.dtype, device=source.device)
    moved = source
    prev_err = err = torch.zeros((), dtype=source.dtype,
                                 device=source.device)
    it = 0
    while it < max_iterations:
        matched = dest[nearest_neighbors(moved, dest).long()]
        step = compute_rigid_transform(moved, matched)
        moved = step.apply(moved)
        err = torch.linalg.vector_norm(moved - matched, dim=-1).mean()
        acc_r = geom.matmul_sums(step.rotation, acc_r)
        acc_t = (step.rotation * acc_t[None, :]).sum(dim=-1) \
            + step.translation
        it += 1
        if bool((prev_err - err).abs() < tolerance):
            break
        prev_err = err
    return ICPResult(transform=RigidTransform(acc_r, acc_t), mean_error=err,
                     iterations=it)
