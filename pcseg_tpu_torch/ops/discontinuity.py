"""Device-side geometric discontinuity stencil (port of
pcseg_tpu.ops.discontinuity).

The reference flags boundary points of a planar region as discontinuous
via per-pixel checks against same-label 4-neighbours
(planar_region.h:356-417): range gate, all 4 neighbours in bounds, then a
point is discontinuous unless the step to some same-label neighbour is
"smooth" (normal angle < 5 deg and robot-frame |dz| < 0.05 m) or a
"shadow" (|dz| / ||delta|| < 0.7). This module flags every pixel on the
device; the host finalize intersects the flags with each accepted region's
boundary, so the normals never leave the device. A rejected region's cells
carry a label of their own, so the same-label tests of accepted pixels do
not depend on whether the rejection happened yet.

|dz| and ||delta|| stay f32 here, as in the JAX stencil (the host stencil
of the reference widens them to f64; the gates sit far above the
difference). ``discontinuity_flags`` takes JAX's single frame or a batch
with a leading frame axis ``B`` (ops/frames.py).
"""

from __future__ import annotations

import math

import torch

from pcseg_tpu_torch.kernels.common import shift2
from pcseg_tpu_torch.models.config import PlanarRegionConfig
from pcseg_tpu_torch.ops import nansafe
from pcseg_tpu_torch.ops.frames import takes_frames
from pcseg_tpu_torch.utils import profiling


def _shift_cells(x, dr, dc, fill):
    """shift2 on the [B, H, W] axes of a [B, H, W, C] grid."""
    return shift2(x.movedim(-1, 1), dr, dc, fill).movedim(1, -1)


@takes_frames(points=3, normals=3, labels=2)
def discontinuity_flags(points: torch.Tensor, normals: torch.Tensor,
                        labels: torch.Tensor, rot_robot: torch.Tensor,
                        config: PlanarRegionConfig) -> torch.Tensor:
    """[H, W] or [B, H, W] bool: the pixel fails every same-label
    smooth/shadow test.

    ``points``/``normals`` [(B,) H, W, 3] f32, ``labels`` [(B,) H, W] int32
    (the device labels at growth time), ``rot_robot`` [3, 3]: the rotation
    of robot_pose_point_cloud. Every sum runs in the JAX stencil's order,
    each product and sum rounded to f32.
    """
    b, h, w = points.shape[:3]
    dev = points.device

    def f32(v):
        with profiling.blocking("discontinuity.gates"):
            return torch.tensor(v, dtype=torch.float32, device=dev)

    rows = torch.arange(h, device=dev)[:, None]
    cols = torch.arange(w, device=dev)[None, :]
    px, py, pz = points.unbind(-1)
    sq = px * px + py * py + pz * pz
    # kNSkipCycles: all 4 neighbours in bounds (planar_region.h:368-371)
    cand = ((sq > f32(config.discontinuity_min_range ** 2))
            & (sq < f32(config.discontinuity_max_range ** 2))
            & (rows > 0) & (rows < h - 1) & (cols > 0) & (cols < w - 1))
    rot = rot_robot.to(device=dev, dtype=torch.float32)
    angle_gate = f32(config.discontinuity_normal_angle_diff)
    z_gate = f32(config.discontinuity_z_diff)
    ratio_gate = f32(config.discontinuity_z_ratio)
    to_deg = f32(180.0 / math.pi)

    p_valid = nansafe.isfinite(pz)
    disc = torch.zeros((b, h, w), dtype=torch.bool, device=dev)
    for d_row, d_col in ((0, -1), (-1, 0), (0, 1), (1, 0)):
        pn = _shift_cells(points, d_row, d_col, float("nan"))
        nn = _shift_cells(normals, d_row, d_col, float("nan"))
        ln = shift2(labels, d_row, d_col, -(2 ** 30))
        ok = cand & p_valid & nansafe.isfinite(pn[..., 2]) & (ln == labels)
        d0, d1, d2 = (points - pn).unbind(-1)
        dr0, dr1, dr2 = (rot[i, 0] * d0 + rot[i, 1] * d1 + rot[i, 2] * d2
                         for i in range(3))
        cosang = (normals[..., 0] * nn[..., 0] + normals[..., 1] * nn[..., 1]
                  + normals[..., 2] * nn[..., 2])
        ang_ok = nansafe.isfinite(cosang) & (cosang >= -1.0) & (cosang <= 1.0)
        ang = (torch.arccos(cosang.clamp(-1.0, 1.0)) * to_deg).abs()
        dz = dr2.abs()
        smooth = ang_ok & (ang < angle_gate) & (dz < z_gate)
        norm = torch.sqrt(dr0 * dr0 + dr1 * dr1 + dr2 * dr2)
        shadow = (norm > 0) & (dz / torch.where(norm > 0, norm, 1.0)
                               < ratio_gate)
        disc = disc | (ok & ~smooth & ~shadow)
    return disc
