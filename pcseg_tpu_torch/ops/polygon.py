"""Batched polygon utilities (port of pcseg_tpu.ops.polygon: the batched
subset of algorithms.h). Triangulation and hulls of single polygons are on
the host (utils/hostgeom.py); these forms serve batched area gates and
plane projection on the device.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.ops import geom


def _dot(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def is_inside_triangle(u, v, w, p):
    """Barycentric point-in-triangle for both windings (algorithms.h:39-64),
    batched over leading axes; a degenerate triangle contains nothing."""
    v0, v1, v2 = w - u, v - u, p - u
    dot00, dot01, dot02 = _dot(v0, v0), _dot(v0, v1), _dot(v0, v2)
    dot11, dot12 = _dot(v1, v1), _dot(v1, v2)
    denom = dot00 * dot11 - dot01 * dot01
    inv = 1.0 / torch.where(denom != 0, denom, torch.ones_like(denom))
    a = (dot11 * dot02 - dot01 * dot12) * inv
    b = (dot00 * dot12 - dot01 * dot02) * inv
    return (denom != 0) & (a >= 0) & (b >= 0) & (a + b < 1)


def cumulative_polygon_normal(vertices, valid=None):
    """Stokes cumulative normal of ordered polygons [..., N, 3]
    (algorithms.h:265-275). ``valid`` [..., N] masks trailing padding: the
    closing edge runs from the last valid vertex to the first."""
    if valid is None:
        nxt = torch.roll(vertices, -1, dims=-2)
        return geom.cross(vertices, nxt).sum(dim=-2)
    n = vertices.shape[-2]
    idx = torch.arange(n, device=vertices.device)
    count = valid.sum(dim=-1, keepdim=True)
    nxt_idx = torch.where(idx + 1 < count, idx + 1, 0)
    nxt = torch.gather(vertices, -2,
                       nxt_idx[..., None].expand(vertices.shape))
    cross = geom.cross(vertices, nxt)
    return torch.where(valid[..., None], cross, 0.0).sum(dim=-2)


def polygon_area(vertices, valid=None):
    """algorithms.h:289-292, batched."""
    return 0.5 * torch.linalg.vector_norm(
        cumulative_polygon_normal(vertices, valid), dim=-1)


def polygon_normal(vertices, valid=None):
    """algorithms.h:279-284, batched (unit normal)."""
    n = cumulative_polygon_normal(vertices, valid)
    return n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1,
                                                        keepdim=True),
                               geom.FLT_MIN)


def project_points_to_plane(points, plane):
    """algorithms.h:301-311, batched."""
    return geom.plane_project(plane, points)
