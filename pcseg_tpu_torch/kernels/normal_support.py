"""The normals' support scan and moment sums: wrapper of
``csrc/normal_support.cu`` and its plain PyTorch version (the port of
pcseg_tpu/ops/normals.py::find_normal_support, which JAX computes with jnp
shift scans, not a Pallas kernel).

Per pixel of [B, H, W, 3] points: the first neighbour along each grid axis
within ``max_scan_steps`` offsets whose distance lies in the
[min, max] band (algorithms.h:106-257), optionally the four diagonal
corners of the box they span, and the ten moment sums and the count of the
center and those supports. The kernel forms every f32 product and sum in
the plain version's order, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from pcseg_tpu_torch.kernels import build, common
from pcseg_tpu_torch.ops import nansafe, plane_fit

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("normal_support")
    fn = lib.normal_support_launch
    if fn.argtypes is None:
        fn.argtypes = ([_VP] * 7 + [_I] * 4 + [ctypes.c_float] * 2
                       + [_I, _VP])
        fn.restype = _I
    return lib


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


def _sq_dist(p, center):
    d = p - center
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def normal_support_plain(points: torch.Tensor, params):
    """Plain PyTorch version: a bounded directional scan over offsets
    1..``max_scan_steps`` on NaN-padded points, the moments accumulated
    into ten [B, H, W] grids, the diagonals from one gather. Returns
    (count [B, H, W] int32, PlaneMoments, center_valid [B, H, W] bool)."""
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
    return count, acc.to_plane_moments(hint), center_valid


def normal_support(points: torch.Tensor, params, impl=None):
    """Support counts and moment sums of [B, H, W, 3] ``points`` under
    ``params`` (models/config.ComputeNormalsParams). Returns (count
    [B, H, W] int32, PlaneMoments with s2 [B, H, W, 6], s1 [B, H, W, 3], w
    [B, H, W] and the +x hint, center_valid [B, H, W] bool).

    CUDA points launch the kernel, which writes every output: one launch
    per call for any B, H and W; CUDA points other than f32 raise a
    TypeError. CPU points and ``impl="plain"`` take the plain version, in
    the points' dtype."""
    if points.dim() != 4 or points.shape[-1] != 3:
        raise ValueError(f"points must be [B, H, W, 3], got "
                         f"{tuple(points.shape)}")
    dev = points.device
    if not common.use_kernel(dev, impl):
        return normal_support_plain(points, params)
    b, h, w = points.shape[:3]
    pts = points.contiguous()
    common.check("normal_support: points", pts, torch.float32, (b, h, w, 3),
                 dev)
    s2 = torch.empty((b, h, w, 6), dtype=torch.float32, device=dev)
    s1 = torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
    wsum = torch.empty((b, h, w), dtype=torch.float32, device=dev)
    count = torch.empty((b, h, w), dtype=torch.int32, device=dev)
    center_valid = torch.empty((b, h, w), dtype=torch.bool, device=dev)
    hint = torch.empty((b, h, w, 3), dtype=torch.float32, device=dev)
    common.launch(
        _lib().normal_support_launch, dev, common.ptr(pts), common.ptr(s2),
        common.ptr(s1), common.ptr(wsum), common.ptr(count),
        common.ptr(center_valid), common.ptr(hint), b, h, w,
        int(params.max_scan_steps),
        params.min_neighbor_distance ** 2, params.max_neighbor_distance ** 2,
        int(bool(params.include_diagonal_neighbors)))
    return (count, plane_fit.PlaneMoments(s2=s2, s1=s1, w=wsum,
                                          normal_hint=hint), center_valid)
