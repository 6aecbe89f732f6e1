"""Euclidean cluster segmentation (port of pcseg_tpu.models.cluster on its
canonical-seed paths).

Membership is the gated connected component over the (2w+1)^2 window
(ops/connectivity.py); with canonical seeds (every pixel seeds, popped in
ascending col-major order) a component's founding priority is its root, so
dense ids ascend with the root index. Two tails, as in JAX:

  * ``need_sizes=False`` (stream path): acceptance by an exact windowed
    same-root count — a component has >= m members iff a member sees >= m
    same-root cells within Chebyshev radius w*(m-1);
  * ``need_sizes=True``: per-root sizes by a segment sum, plus the size
    table of the first ``max_regions`` accepted clusters.

The general seed-vector path (sort by founding priority) is not ported.
Shapes carry a leading frame axis ``B``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pcseg_tpu_torch.kernels.common import shift2
from pcseg_tpu_torch.models.config import UNLABELED, ClusterRegionConfig
from pcseg_tpu_torch.ops import connectivity, nansafe


class ClusterResult(NamedTuple):
    labels: torch.Tensor        # [B, H, W] int32 final label grid
    num_regions: torch.Tensor   # [B] int32
    region_sizes: torch.Tensor  # [B, max_regions] int32 (0 past num_regions)
    roots: torch.Tensor         # [B, H, W] int32 component roots


def _colmajor_flat(x):
    """[B, H, W] -> [B, H*W] in col-major order."""
    return x.transpose(1, 2).reshape(x.shape[0], -1)


def segment_clusters(points: torch.Tensor, labels: torch.Tensor,
                     config: ClusterRegionConfig = ClusterRegionConfig(),
                     need_sizes: bool = True,
                     impl=None) -> ClusterResult:
    """Cluster the UNLABELED finite cells of [B, H, W, 3] ``points`` with
    canonical seeds (the pipeline's cluster closure; the JAX call with
    ``canonical_seeds=True``). ``config.ccl_mode`` picks the scan CCL
    (``"scan"``) or the window CCL with pointer jumping (``"while"``).
    ``impl="plain"`` forces the CCL kernel's plain version (tests and the
    smoke script only)."""
    b, h, w = points.shape[:3]
    hw = h * w
    dev = points.device
    eligible = (labels == UNLABELED) & nansafe.all_finite(points)
    if config.ccl_mode == "scan":
        roots = connectivity.connected_components_scan(
            points, eligible, config.squared_distance_threshold,
            config.half_search_window, rounds=config.scan_rounds, impl=impl)
    elif config.ccl_mode == "while":
        roots = connectivity.connected_components_window(
            points, eligible, config.squared_distance_threshold,
            config.half_search_window)
    else:
        raise ValueError(f"unknown ccl_mode {config.ccl_mode!r}")
    lin_grid = connectivity.colmajor_index_grid(h, w, dev)
    max_regions = config.max_regions
    win_r = config.half_search_window * (config.min_region_inliers - 1)

    if not need_sizes and win_r <= 6:
        cnt = torch.ones((b, h, w), dtype=torch.int32, device=dev)
        for dr in range(-win_r, win_r + 1):
            for dc in range(-win_r, win_r + 1):
                if dr == 0 and dc == 0:
                    continue
                nb = shift2(roots, dr, dc, hw)
                cnt += (nb == roots).to(torch.int32)
        acc_px = eligible & (cnt >= config.min_region_inliers)
        acc_root_cm = _colmajor_flat(acc_px & (roots == lin_grid)) \
            .to(torch.int32)
        order_cm = torch.cumsum(acc_root_cm, dim=1, dtype=torch.int32) - 1
        num_regions = acc_root_cm.sum(dim=1, dtype=torch.int32)
        region = torch.gather(order_cm, 1,
                              roots.clamp(0, hw - 1).reshape(b, -1).long())
        point_region = torch.where(acc_px, region.reshape(b, h, w), -1)
        new_labels = torch.where(point_region >= 0, point_region, labels)
        return ClusterResult(
            labels=new_labels, num_regions=num_regions,
            region_sizes=torch.zeros((b, max_regions), dtype=torch.int32,
                                     device=dev),
            roots=roots)

    # per-root sizes (roots are col-major indices; H*W = ineligible)
    sizes = connectivity.segment_field(eligible.to(torch.int32), roots,
                                       eligible)
    accepted = sizes >= config.min_region_inliers
    region_id_by_root = torch.where(
        accepted, torch.cumsum(accepted.to(torch.int32), 1,
                               dtype=torch.int32) - 1, -1)
    num_regions = accepted.sum(dim=1, dtype=torch.int32)
    # size table: the first max_regions accepted roots, ascending
    ar = torch.arange(hw, dtype=torch.int64, device=dev)
    key = torch.where(accepted, ar, hw)
    first = torch.sort(key, dim=1, stable=True).values[:, :max_regions]
    k_sel = first.shape[1]
    table = torch.gather(sizes, 1, first.clamp(max=hw - 1))
    table = torch.where(
        torch.arange(k_sel, device=dev)[None] < num_regions[:, None],
        table, 0)
    region_sizes = torch.zeros((b, max_regions), dtype=torch.int32,
                               device=dev)
    region_sizes[:, :k_sel] = table
    point_region = torch.gather(
        region_id_by_root, 1, roots.clamp(0, hw - 1).reshape(b, -1).long()) \
        .reshape(b, h, w)
    point_region = torch.where((roots < hw) & eligible, point_region, -1)
    new_labels = torch.where(point_region >= 0, point_region, labels)
    return ClusterResult(labels=new_labels, num_regions=num_regions,
                         region_sizes=region_sizes, roots=roots)
