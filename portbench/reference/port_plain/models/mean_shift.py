"""SlidingMeanShift of one frame in plain PyTorch and NumPy, the
reference of the mean-shift configuration (``vga_frame_mean_shift``).

Written for this copy, not copied from the program: the program shifts in
a CUDA kernel (or its host-ops library) and grows in that library; this is
a port of the upstream's loop (mean_shift_segmentation.h:207-330,
constants :31-51) at the precision the port states:

  * every finite pixel labelled UNLABELED seeds a mode and is a window
    neighbour (fixed at entry, :219-229);
  * each of ``iterations`` steps moves a seed by the mean difference to
    the neighbours of the (2 * 5 + 1)^2 index window around its rounded
    fractional (row, col) within 1 m^2 of it (rows outer, columns inner;
    the squared distance ``(dx*dx + dy*dy) + dz*dz`` in f32), in 3-D and
    in the index; the f32 differences are summed in
    ``precision.MOMENT_SUM_DTYPE`` (f64 as the port states; the control
    lowers it to f32) and each step, the sum over the support, is rounded
    to f32; a support under 50 invalidates the seed for good (:232-260);
  * the valid modes, by ascending intensity (the last support), each grow
    a region FIFO from the rounded index: a candidate joins if within
    1 m^2 of the mode, or, after the first expansion, within 0.2^2 m^2 of
    the member that reached it; a region of 7 or more members is accepted
    and suppresses the later modes within 1 m^2, a smaller one is undone
    (:152-199, :262-328).

Where it departs from the upstream, as the port and the JAX package do:
the growth's window is 3x3 (the upstream's is the cluster
configuration's (2 half_search_window + 1)^2, the same at its default of
1); every fractional index rounds half away from zero (``std::lround``);
exact intensity ties keep the row-major seed order (a stable sort, where
the upstream's ``std::sort`` leaves ties in no fixed order).
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch

from portbench.reference.port_plain import precision
from portbench.reference.port_plain.models.config import (UNLABELED,
                                                          MeanShiftParams)
from portbench.reference.port_plain.ops import nansafe


def _round_half_away(v):
    """``std::lround`` of f32 values, exact (the half added in f64)."""
    d = v.astype(np.float64)
    return np.trunc(d + np.copysign(0.5, d)).astype(np.int64)


def shift(points: np.ndarray, labels: np.ndarray, iterations: int,
          params: MeanShiftParams, device):
    """The shift state of every pixel of one [H, W, 3] f32 frame, computed
    on ``device``: (mode [N, 3] f32, fr [N], fc [N] f32, valid [N] bool,
    intensity [N] f32), row-major; a pixel that never seeds holds mode 0,
    fr 0, fc 0, intensity 1."""
    h, w = labels.shape
    n = h * w
    acc = precision.MOMENT_SUM_DTYPE
    hw = params.half_search_window
    flat = torch.as_tensor(points, device=device).reshape(n, 3)
    nb_ok = nansafe.all_finite(flat) & (torch.as_tensor(
        labels, device=device).reshape(n) == UNLABELED)
    cell = torch.where(nb_ok[:, None], flat, 0.0)
    lin = torch.arange(n, device=device)
    mode = cell.clone()
    fr = torch.where(nb_ok, (lin // w).to(torch.float32), 0.0)
    fc = torch.where(nb_ok, (lin % w).to(torch.float32), 0.0)
    valid = nb_ok.clone()
    intensity = torch.ones(n, dtype=torch.float32, device=device)
    for _ in range(iterations):
        d0 = fr.double()
        r0 = torch.trunc(d0 + torch.where(d0 < 0, -0.5, 0.5)).long()
        d0 = fc.double()
        c0 = torch.trunc(d0 + torch.where(d0 < 0, -0.5, 0.5)).long()
        sums = torch.zeros((n, 5), dtype=acc, device=device)
        support = torch.zeros(n, dtype=torch.int32, device=device)
        for dr in range(-hw, hw + 1):
            for dc in range(-hw, hw + 1):
                rr, cc = r0 + dr, c0 + dc
                inside = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
                q = torch.where(inside, rr * w + cc, 0)
                d = cell[q] - mode
                d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) \
                    + d[:, 2] * d[:, 2]
                ok = valid & inside & nb_ok[q] \
                    & (d2 <= params.square_distance_threshold)
                terms = torch.cat([d, (rr.float() - fr)[:, None],
                                   (cc.float() - fc)[:, None]], dim=1)
                sums = sums + torch.where(ok[:, None], terms.to(acc), 0.0)
                support = support + ok.int()
        valid = valid & (support.float() >= params.min_support)
        steps = (sums / support.clamp_min(1)[:, None].to(acc)).float()
        mode = torch.where(valid[:, None], mode + steps[:, :3], mode)
        fr = torch.where(valid, fr + steps[:, 3], fr)
        fc = torch.where(valid, fc + steps[:, 4], fc)
        intensity = torch.where(valid, support.float(), intensity)
    return tuple(t.cpu().numpy() for t in (mode, fr, fc, valid, intensity))


def _d2(ax, ay, az, bx, by, bz):
    dx, dy, dz = ax - bx, ay - by, az - bz
    return (dx * dx + dy * dy) + dz * dz


def grow(points: np.ndarray, labels: np.ndarray, state, min_inliers: int,
         offset: int, params: MeanShiftParams) -> list:
    """The growth of every mode of ``state`` over one frame: ``labels``
    ([H, W] int32) is mutated; accepted regions take the ids ``offset``,
    ``offset + 1``, ... Returns each accepted region's member count. All
    distances are f32 (NumPy f32 scalars and arrays)."""
    h, w = labels.shape
    n = h * w
    mode, fr, fc, valid, intensity = state
    flat = np.asarray(points, np.float32).reshape(n, 3)
    px, py, pz = (list(flat[:, i]) for i in range(3))
    free = list(np.isfinite(flat).all(axis=1))
    lab = labels.reshape(n).tolist()
    sq_c = np.float32(params.squared_centroid_distance_threshold)
    sq_n = np.float32(params.squared_neighbor_distance_threshold)
    order = np.nonzero(valid)[0]
    order = order[np.argsort(intensity[order], kind="stable")]
    r0s, c0s = _round_half_away(fr), _round_half_away(fc)
    suppressed = np.zeros(n, bool)
    sizes = []
    for oi, s in enumerate(order):
        if suppressed[s]:
            continue
        r0, c0 = int(r0s[s]), int(c0s[s])
        if not (0 <= r0 < h and 0 <= c0 < w):
            continue
        sx, sy, sz = mode[s]
        label_id = offset + len(sizes)
        members = []
        queue = deque([r0 * w + c0])
        first = True
        while queue:
            center = queue.popleft()
            cr, ccol = divmod(center, w)
            for dc in (-1, 0, 1):
                for dr in (-1, 0, 1):
                    if not first and dr == 0 and dc == 0:
                        continue
                    rr, cc = cr + dr, ccol + dc
                    if not (0 <= rr < h and 0 <= cc < w):
                        continue
                    cand = rr * w + cc
                    if lab[cand] != UNLABELED or not free[cand]:
                        continue
                    if _d2(px[cand], py[cand], pz[cand], sx, sy, sz) > sq_c:
                        if first or _d2(px[cand], py[cand], pz[cand],
                                        px[center], py[center],
                                        pz[center]) > sq_n:
                            continue
                    lab[cand] = label_id
                    members.append(cand)
                    queue.append(cand)
            first = False
        if len(members) >= min_inliers:
            later = order[oi + 1:]
            m = mode[later]
            near = _d2(m[:, 0], m[:, 1], m[:, 2], sx, sy, sz) < sq_c
            suppressed[later[near]] = True
            sizes.append(len(members))
        else:
            for c in members:
                lab[c] = UNLABELED
    labels[...] = np.asarray(lab, np.int32).reshape(h, w)
    return sizes


def sliding_mean_shift(points: np.ndarray, labels: np.ndarray,
                       min_inliers: int, iterations: int, offset: int,
                       params: MeanShiftParams, device) -> list:
    """The shift on ``device``, then the growth on the host; mutates
    ``labels`` and returns the accepted regions' member counts."""
    state = shift(points, labels, iterations, params, device)
    return grow(points, labels, state, min_inliers, offset, params)
