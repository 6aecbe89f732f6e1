"""Gated connected-component labelling on dense grids (port of
pcseg_tpu.ops.connectivity: the scan CCL of the cluster stage).

The reference grows euclidean clusters by BFS with a per-step distance
gate (cluster_region.h:85-150); the accepted set is the closure of the
gated window graph. Every component is labelled at once with its minimum
col-major index by min-propagation (kernels/ccl_gated.py). Shapes carry a
leading frame axis ``B``.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.kernels import ccl_gated
from pcseg_tpu_torch.kernels.common import shift2 as _shift2


def colmajor_index_grid(h, w, device=None):
    """[H, W] int32 grid of col-major linear indices (col*H + row),
    the reference's cloud.h:38-41 convention."""
    rows = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    cols = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    return cols * h + rows


def window_offsets(half_window):
    """Window offsets in the JAX order: dc outer, dr inner, (0, 0) left
    out."""
    return [(dr, dc)
            for dc in range(-half_window, half_window + 1)
            for dr in range(-half_window, half_window + 1)
            if (dr, dc) != (0, 0)]


def _gate_bits(points, eligible, squared_threshold, offsets):
    """[B, H, W] int32 word: bit o set iff the edge to ``offsets[o]``
    passes (both ends eligible, ||p - q||^2 < tau). len(offsets) <= 32."""
    gate = torch.zeros(points.shape[:3], dtype=torch.int32,
                       device=points.device)
    thr = torch.tensor(squared_threshold, dtype=points.dtype,
                       device=points.device)
    for o, (dr, dc) in enumerate(offsets):
        d = _shift2_pts(points, dr, dc) - points
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        ok = (d2 < thr) & eligible & _shift2(eligible, dr, dc, False)
        gate |= ok.to(torch.int32) << o
    return gate


def _shift2_pts(points, dr, dc):
    """_shift2 on the [B, H, W] axes of a [B, H, W, 3] cloud (NaN fill)."""
    return _shift2(points.movedim(-1, 1), dr, dc, float("nan")).movedim(1, -1)


def connected_components_scan(points, eligible, squared_threshold,
                              half_window, rounds=24, impl=None):
    """Gated CCL of [B, H, W, 3] points over the eligible cells.

    Returns [B, H, W] int32: the min col-major index of each cell's
    component (under the ``rounds`` cap), H*W where ineligible."""
    b, h, w = points.shape[:3]
    big = h * w
    offsets = window_offsets(half_window)
    labels0 = torch.where(eligible, colmajor_index_grid(h, w, points.device),
                          big).to(torch.int32).contiguous()
    gate = _gate_bits(points, eligible, squared_threshold, offsets)
    out = ccl_gated.ccl_gated(gate, labels0, offsets, rounds, big, impl=impl)
    return torch.where(eligible, out, big)
