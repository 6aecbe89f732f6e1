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
    passes (both ends eligible, ||p - q||^2 < tau). len(offsets) <= 32.

    All offsets at once: the cloud is padded once (NaN points, ineligible
    cells) and the shifted views stacked, so a call costs a fixed number of
    device ops; the distance keeps the per-offset f32 expression, so the
    bits are those of one offset at a time."""
    b, h, w = points.shape[:3]
    dev = points.device
    p = max(max(abs(dr), abs(dc)) for dr, dc in offsets)
    padded = torch.full((b, h + 2 * p, w + 2 * p, 3), float("nan"),
                        dtype=points.dtype, device=dev)
    padded[:, p:p + h, p:p + w] = points
    elig = torch.zeros((b, h + 2 * p, w + 2 * p), dtype=torch.bool,
                       device=dev)
    elig[:, p:p + h, p:p + w] = eligible
    nb = torch.stack([padded[:, p + dr:p + dr + h, p + dc:p + dc + w]
                      for dr, dc in offsets])
    nb_elig = torch.stack([elig[:, p + dr:p + dr + h, p + dc:p + dc + w]
                           for dr, dc in offsets])
    thr = torch.tensor(squared_threshold, dtype=points.dtype, device=dev)
    d = nb - points
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    ok = (d2 < thr) & eligible & nb_elig
    # distinct bits: the int64 sum is their OR; bit 31 lands on the sign
    bits = (ok.to(torch.int64) << torch.arange(
        len(offsets), device=dev)[:, None, None, None]).sum(dim=0)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)


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
