"""Euclidean cluster segmentation (port of pcseg_tpu.models.cluster).

Membership is the gated connected component over the (2w+1)^2 window
(ops/connectivity.py). The reference assigns dense ids in acceptance
order, which is the order of each component's earliest-popped seed (the
driver pops the seed vector back to front, segmentation.h:254-255):

  * the general seed-vector path: every seed's pop priority is scattered
    (min) into the grid, reduced (min) over each component, and accepted
    components are numbered by a stable sort of their founding priority;
  * ``canonical_seeds=True`` (every pixel seeds, popped in ascending
    col-major order: the pipeline's cluster closure): a component's
    founding priority is its root, so ids ascend with the root index, and
    two tails as in JAX: ``need_sizes=False`` (stream path) accepts by an
    exact windowed same-root count (a component has >= m members iff a
    member sees >= m same-root cells within Chebyshev radius w*(m-1));
    ``need_sizes=True`` sums per-root sizes for the size table.

``segment_clusters`` takes JAX's single frame ([H, W, 3] points, [H, W]
labels) or a batch with a leading frame axis ``B`` (ops/frames.py); the
shapes below are the batch's.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.reference.port_plain.kernels.common import shift2
from portbench.reference.port_plain.models.config import UNLABELED, ClusterRegionConfig
from portbench.reference.port_plain.ops import connectivity, nansafe
from portbench.reference.port_plain.ops.frames import takes_frames


class ClusterResult(NamedTuple):
    labels: torch.Tensor        # [B, H, W] int32 final label grid
    num_regions: torch.Tensor   # [B] int32
    region_sizes: torch.Tensor  # [B, max_regions] int32 (0 past num_regions)
    roots: torch.Tensor         # [B, H, W] int32 component roots


def _colmajor_flat(x):
    """[B, H, W] -> [B, H*W] in col-major order."""
    return x.transpose(1, 2).reshape(x.shape[0], -1)


def canonical_seed_vector(h, w, device=None):
    """The canonical sweep [H*W - 1 .. 0]: every pixel seeds, popped in
    ascending col-major order (the convention of clustering_test.cc:56-59
    and of the pipeline's cluster closure)."""
    return torch.arange(h * w - 1, -1, -1, dtype=torch.int32, device=device)


@takes_frames(points=3, labels=2)
def segment_clusters(points: torch.Tensor, labels: torch.Tensor,
                     seed_indices: Optional[torch.Tensor],
                     config: ClusterRegionConfig = ClusterRegionConfig(),
                     initial_id_offset: int = 0,
                     seed_valid: Optional[torch.Tensor] = None,
                     canonical_seeds: bool = False,
                     need_sizes: bool = True,
                     impl=None) -> ClusterResult:
    """Cluster the UNLABELED finite cells of [B, H, W, 3] ``points``
    (JAX's ``segment_clusters``, its parameters in its order).

    ``seed_indices``: [S] or [B, S] col-major linear seeds in the
    reference's vector order (the last pops first); ``seed_valid`` masks
    padded entries. ``canonical_seeds`` promises the canonical sweep
    (:func:`canonical_seed_vector`) with no mask, which takes the
    root-ordered tails and never reads ``seed_indices`` (None may stand in
    for it there). ``initial_id_offset`` is added to every assigned
    id. ``config.ccl_mode`` picks the scan CCL (``"scan"``) or the window
    CCL with pointer jumping (``"while"``). ``impl="plain"`` forces the CCL
    kernel's plain version (tests and the smoke script only)."""
    if seed_indices is None and not canonical_seeds:
        raise ValueError("seed_indices is None without canonical_seeds")
    b, h, w = points.shape[:3]
    hw = h * w
    dev = points.device
    inf = torch.iinfo(torch.int32).max
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

    if canonical_seeds and not need_sizes and win_r <= 6:
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
        new_labels = torch.where(point_region >= 0,
                                 point_region + initial_id_offset, labels)
        return ClusterResult(
            labels=new_labels, num_regions=num_regions,
            region_sizes=torch.zeros((b, max_regions), dtype=torch.int32,
                                     device=dev),
            roots=roots)

    # per-root sizes (roots are col-major indices; H*W = ineligible)
    sizes = connectivity.segment_field(eligible.to(torch.int32), roots,
                                       eligible, h, w)
    if canonical_seeds:
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
    else:
        seeds = torch.as_tensor(seed_indices, device=dev).expand(b, -1)
        s = seeds.shape[1]
        # pop priorities: the last seed pops first
        pop_pos = ((s - 1) - torch.arange(s, dtype=torch.int32,
                                          device=dev)).expand(b, -1)
        if seed_valid is not None:
            pop_pos = torch.where(
                torch.as_tensor(seed_valid, device=dev).expand(b, -1),
                pop_pos, inf)
        safe = seeds.clamp(0, hw - 1).long()
        # a pre-labeled seed is skipped (segmentation.h:258-260)
        elig_seed = torch.gather(_colmajor_flat(eligible), 1, safe)
        pop_pos = torch.where(elig_seed, pop_pos, inf)
        prio_cm = torch.full((b, hw), inf, dtype=torch.int32, device=dev)
        prio_cm.scatter_reduce_(1, safe, pop_pos, "amin")
        prio_grid = prio_cm.reshape(b, w, h).transpose(1, 2)
        min_prio = connectivity.segment_field(
            torch.where(eligible, prio_grid, inf), roots, eligible, h, w,
            "min")
        accepted = (sizes >= config.min_region_inliers) & (min_prio < inf)
        # dense ids in acceptance order (ascending founding priority)
        order = torch.argsort(torch.where(accepted, min_prio, inf), dim=1,
                              stable=True)
        acc_sorted = torch.gather(accepted, 1, order)
        ranks = torch.cumsum(acc_sorted.to(torch.int32), 1,
                             dtype=torch.int32) - 1
        region_id_by_root = torch.full((b, hw), -1, dtype=torch.int32,
                                       device=dev)
        region_id_by_root.scatter_(1, order,
                                   torch.where(acc_sorted, ranks, -1))
        num_regions = accepted.sum(dim=1, dtype=torch.int32)
        valid_root = accepted & (region_id_by_root >= 0) \
            & (region_id_by_root < max_regions)
        region_sizes = torch.zeros((b, max_regions), dtype=torch.int32,
                                   device=dev)
        region_sizes.scatter_add_(
            1, torch.where(valid_root, region_id_by_root,
                           max_regions - 1).long(),
            torch.where(valid_root, sizes, 0))

    point_region = torch.gather(
        region_id_by_root, 1, roots.clamp(0, hw - 1).reshape(b, -1).long()) \
        .reshape(b, h, w)
    point_region = torch.where((roots < hw) & eligible, point_region, -1)
    new_labels = torch.where(point_region >= 0,
                             point_region + initial_id_offset, labels)
    return ClusterResult(labels=new_labels, num_regions=num_regions,
                         region_sizes=region_sizes, roots=roots)


def gather_region_indices(labels, region_id, order="colmajor"):
    """Host helper: col-major linear indices of a region's members in an
    [H, W] label grid (an array or a CPU tensor), ascending. The
    reference's inlier lists follow BFS order; both packages give the
    ascending order (the set is what the outputs depend on). ``order`` is
    JAX's parameter, which JAX does not read either: col-major is the only
    order."""
    del order
    lbl = np.asarray(labels)
    rows, cols = np.nonzero(lbl == region_id)
    return np.sort(cols * lbl.shape[0] + rows)
