"""Sliding-window mean-shift clustering (port of pcseg_tpu.models.mean_shift;
the reference's mean_shift_segmentation.h:207-330).

  * every unlabeled finite point seeds a mode; a fixed number of shift
    iterations moves each seed by the mean of its neighbours inside an 11x11
    index window and a 1 m^2 ball (flat kernel), tracking the shift in 3-D
    and in fractional grid index; seeds whose window support drops below
    0.5 * 4 * half^2 = 50 are invalidated for good (:232-260);
  * surviving modes are processed by ascending intensity; each grows a
    region (inlier if within 1 m^2 of the mode, or within 0.2^2 of an
    accepted neighbour; the first expansion ignores the neighbour rule),
    accepted regions suppress later modes within 1 m^2, rejected regions
    revert to UNLABELED (:262-328).

Growths, as in JAX: ``"native"`` (the pipeline's path: the shift with
f64 sums, by kernel M1 on a card or by the host-ops library elsewhere, then
the library's FIFO growth; the spans ``mean_shift``, ``mean_shift.modes``
and ``mean_shift.grow``, the counters ``mean_shift.seeds``,
``.valid_modes`` and ``.regions``), ``"host"`` (the exact
FIFO port in NumPy after the device shift), ``"device"`` (every mode's
growth as a closure of window components on the device, one host loop over
the modes) and ``"device_permode"`` (the same closure, ordered and
suppressed in NumPy). The device loops (the window CCL's rounds, a
closure's rounds, the mode walk) test "changed?" on the host after each
round. Modes sort stably: exact intensity ties keep the seed order.
"""

from __future__ import annotations

import ctypes
import warnings
from collections import deque
from typing import List, NamedTuple

import numpy as np
import torch

from pcseg_tpu_torch import native
from pcseg_tpu_torch.kernels import mean_shift_modes as ms_kernel
from pcseg_tpu_torch.kernels.common import shift2
from pcseg_tpu_torch.models.config import (UNLABELED, ClusterRegionConfig,
                                           MeanShiftParams)
from pcseg_tpu_torch.ops import connectivity, nansafe, xla_order
from pcseg_tpu_torch.ops.frames import frame0, takes_frames
from pcseg_tpu_torch.utils import profiling


class MeanShiftState(NamedTuple):
    pos: torch.Tensor        # [B, N, 3] mode positions
    idx: torch.Tensor        # [B, N, 2] fractional (row, col) indices
    valid: torch.Tensor      # [B, N] sticky validity
    intensity: torch.Tensor  # [B, N] last window support
    is_seed: torch.Tensor    # [B, N] took part (unlabeled, finite)


class MeanShiftRegion(NamedTuple):
    label_id: int
    inlier_indices: np.ndarray  # col-major linear indices
    seed: np.ndarray            # mode position [3]


def _card(device):
    """The device an entry point runs on: the CUDA card unless the caller
    names one (``device="cpu"``); raises without a card."""
    if device is not None:
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "mean shift on the CPU")
    return "cuda"


@takes_frames(points=3, labels=2)
def mean_shift_modes(points: torch.Tensor, labels: torch.Tensor,
                     iterations: int,
                     params: MeanShiftParams = MeanShiftParams()
                     ) -> MeanShiftState:
    """The shift fixed point of every eligible pixel of [H, W, 3] or
    [B, H, W, 3] ``points`` ([H, W] or [B, H, W] int32 ``labels``: only
    UNLABELED pixels seed and contribute); the state's tables are [N, ...]
    or [B, N, ...]. Indices are row-major (r * W + c). The window's offsets
    sum in JAX's order (dc outer, dr inner), in f32."""
    b, h, w = points.shape[:3]
    n = h * w
    dtype = points.dtype
    dev = points.device
    hw = params.half_search_window
    flat_pts = points.reshape(b, n, 3)
    finite = nansafe.all_finite(flat_pts)
    unlabeled = (labels == UNLABELED).reshape(b, n)
    is_seed = finite & unlabeled
    lin0 = torch.arange(n, dtype=torch.int32, device=dev)
    idx = torch.stack([torch.div(lin0, w, rounding_mode="floor"), lin0 % w],
                      dim=-1).to(dtype).expand(b, n, 2)
    pos = torch.where(is_seed[..., None], nansafe.sanitize(flat_pts), 0.0)
    valid = is_seed
    intensity = torch.ones((b, n), dtype=dtype, device=dev)
    offsets = [(dr, dc) for dc in range(-hw, hw + 1)
               for dr in range(-hw, hw + 1)]
    for _ in range(iterations):
        r = torch.round(idx[..., 0]).to(torch.int32)
        c = torch.round(idx[..., 1]).to(torch.int32)
        sum_dpos = torch.zeros_like(pos)
        sum_didx = torch.zeros_like(idx)
        count = torch.zeros((b, n), dtype=dtype, device=dev)
        for dr, dc in offsets:
            rr = r + dr
            cc = c + dc
            inb = (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w)
            lin = (rr * w + cc).clamp(0, n - 1).long()
            q = torch.gather(flat_pts, 1, lin[..., None].expand(b, n, 3))
            ok = inb & torch.gather(is_seed, 1, lin)
            dpos = q - pos
            ok = ok & (xla_order.sumsq(dpos)
                       <= params.square_distance_threshold)
            sum_dpos = sum_dpos + torch.where(ok[..., None], dpos, 0.0)
            didx = torch.stack([rr.to(dtype) - idx[..., 0],
                                cc.to(dtype) - idx[..., 1]], dim=-1)
            sum_didx = sum_didx + torch.where(ok[..., None], didx, 0.0)
            count = count + ok.to(dtype)
        upd = valid & (count >= params.min_support)
        denom = torch.where(count > 0, count, 1.0)[..., None]
        pos = torch.where(upd[..., None], pos + sum_dpos / denom, pos)
        idx = torch.where(upd[..., None], idx + sum_didx / denom, idx)
        intensity = torch.where(upd, count, intensity)
        valid = upd
    return MeanShiftState(pos=pos, idx=idx, valid=valid & is_seed,
                          intensity=intensity, is_seed=is_seed)


def _frame_state(state: MeanShiftState):
    """The state of one frame (JAX's [N, ...] tables, or frame 0 of a
    batch) as NumPy arrays (pos, idx, valid, intensity)."""
    if state.valid.dim() == 2:
        state = frame0(state)
    return tuple(t.cpu().numpy()
                 for t in (state.pos, state.idx, state.valid,
                           state.intensity))


def _mode_order(valid, intensity):
    """The valid modes by ascending intensity; exact ties keep the seed
    order (JAX's stable argsort of the intensity key)."""
    order = np.nonzero(valid)[0]
    return order[np.argsort(intensity[order], kind="stable")]


def grow_mean_shift_regions(points: np.ndarray, labels: np.ndarray,
                            state: MeanShiftState,
                            config: ClusterRegionConfig,
                            initial_region_id_offset: int = 0,
                            params: MeanShiftParams = MeanShiftParams()
                            ) -> List[MeanShiftRegion]:
    """Host growth of one frame: mode order, sequential FIFO growth and
    suppression, exact (mean_shift_segmentation.h:262-328). Mutates
    ``labels``."""
    h, w = points.shape[0], points.shape[1]
    pos, idx, valid, intensity = _frame_state(state)

    order = _mode_order(valid, intensity)

    regions: List[MeanShiftRegion] = []
    suppressed = np.zeros(len(valid), bool)
    hw_win = config.half_search_window

    for i, s in enumerate(order):
        if suppressed[s]:
            continue
        seed_pos = pos[s].astype(np.float32)
        label_id = len(regions) + initial_region_id_offset
        inliers = []
        q = deque()
        r0 = int(round(float(idx[s, 0])))
        c0 = int(round(float(idx[s, 1])))
        q.append(r0 * w + c0)
        first = True
        while q:
            center = q.popleft()
            cr, cc = center // w, center % w
            center_pt = points[cr, cc]
            for dc in range(-hw_win, hw_win + 1):
                for dr in range(-hw_win, hw_win + 1):
                    if not first and dc == 0 and dr == 0:
                        continue
                    rr, ccc = cr + dr, cc + dc
                    if not (0 <= rr < h and 0 <= ccc < w):
                        continue
                    if labels[rr, ccc] != UNLABELED \
                            or np.any(np.isnan(points[rr, ccc])):
                        continue
                    cand = points[rr, ccc].astype(np.float32)
                    if float(np.sum((cand - seed_pos) ** 2)) \
                            > params.squared_centroid_distance_threshold:
                        if first or float(np.sum(
                                (cand - center_pt.astype(np.float32)) ** 2)) \
                                > params.squared_neighbor_distance_threshold:
                            continue
                    labels[rr, ccc] = label_id
                    inliers.append(ccc * h + rr)  # col-major output index
                    q.append(rr * w + ccc)
            first = False

        if len(inliers) >= config.min_region_inliers:
            later = order[i + 1:]
            d2 = np.sum((pos[later] - seed_pos) ** 2, axis=-1)
            suppressed[later[
                d2 < params.squared_centroid_distance_threshold]] = True
            regions.append(MeanShiftRegion(
                label_id=label_id,
                inlier_indices=np.asarray(inliers, np.int64),
                seed=seed_pos))
        else:
            for lin_cm in inliers:
                labels[lin_cm % h, lin_cm // h] = UNLABELED
    return regions


def mode_members(points, labels, seed_pos, start_lin, config, params):
    """One mode's growth as a closure on the device (JAX's
    ``_mode_members_impl``): the window component of the centroid ball that
    holds the start pixel, joined to a fixed point with 0.04-edge window
    chains hanging off it. [H, W, 3] points, [H, W] int32 labels, [3] mode
    position, ROW-major start index. Returns [H, W] bool members (empty if
    the start pixel is claimed). Same closure-vs-BFS divergence class as
    JAX's (a candidate the BFS rejects but the closure reaches joins)."""
    h, w = points.shape[:2]
    hw = h * w
    elig = (labels == UNLABELED) & nansafe.all_finite(points)
    ball = elig & (xla_order.sumsq(points - seed_pos)
                   <= params.squared_centroid_distance_threshold)
    half = config.half_search_window
    comp_ball = connectivity.connected_components_window(
        points, ball, float("inf"), half)
    comp_004 = connectivity.connected_components_window(
        points, elig, params.squared_neighbor_distance_threshold, half)
    lin = torch.arange(hw, dtype=torch.int64, device=points.device) \
        .reshape(h, w)
    start = (lin == int(start_lin)) & ball
    offsets = connectivity.window_offsets(half)

    def joined(r, comp, cells):
        table = connectivity.segment_field(r.to(torch.int32), comp, cells,
                                           h, w) > 0
        return r | (cells & (comp < hw) & table[comp.clamp(0, hw - 1)
                                                .long()])

    def one_round(r):
        d = r
        for dr, dc in offsets:
            d = d | shift2(r, dr, dc, False)
        r = r | (ball & d)
        r = joined(r, comp_ball, ball)
        return joined(r, comp_004, elig)

    prev, r = start, one_round(start)
    while bool((r != prev).any()):
        prev, r = r, one_round(r)
    return r


def _rounded_starts(idx, h, w):
    """(row, col, in bounds) of the rounded mode indices (half to even, as
    ``jnp.round``)."""
    r0 = np.round(idx[:, 0]).astype(np.int64)
    c0 = np.round(idx[:, 1]).astype(np.int64)
    return r0, c0, (r0 >= 0) & (r0 < h) & (c0 >= 0) & (c0 < w)


def _regions_from_labels(labels, num, offset, seeds):
    h = labels.shape[0]
    regions = []
    for rid in range(num):
        rr, cc = np.nonzero(labels == rid + offset)
        regions.append(MeanShiftRegion(
            label_id=rid + offset,
            inlier_indices=np.sort(cc * h + rr).astype(np.int64),
            seed=np.asarray(seeds[rid], np.float32)))
    return regions


def grow_mean_shift_regions_batched(points: np.ndarray, labels: np.ndarray,
                                    state: MeanShiftState,
                                    config: ClusterRegionConfig,
                                    initial_region_id_offset: int = 0,
                                    params: MeanShiftParams
                                    = MeanShiftParams(),
                                    device=None) -> List[MeanShiftRegion]:
    """Growth of every surviving mode of one frame (JAX's
    ``_grow_all_modes_impl``): the modes in ascending-intensity order, a
    mode skipped when suppressed, out of bounds or its start pixel
    claimed, the others grown by :func:`mode_members` on ``device`` (the
    card unless the caller passes ``device="cpu"``); an accepted region
    suppresses every valid mode within the centroid ball.
    The region table holds ``config.max_regions``: past it, modes are not
    attempted and a warning says so. Mutates ``labels``; inliers are
    sorted col-major."""
    h, w = points.shape[:2]
    device = _card(device)
    cap = int(config.max_regions)
    pos, idx, valid, intensity = _frame_state(state)
    order = _mode_order(valid, intensity)
    r0, c0, inb = _rounded_starts(idx, h, w)
    pts_d = torch.as_tensor(np.asarray(points, np.float32), device=device)
    lab_d = torch.as_tensor(labels.astype(np.int32), device=device)
    pos_d = torch.as_tensor(pos, device=device)
    valid_d = torch.as_tensor(valid, device=device)
    suppressed = torch.zeros(len(valid), dtype=torch.bool, device=device)
    host_labels = labels.astype(np.int32).copy()
    seeds, num_acc, overflow = [], 0, False
    supp_host = np.zeros(len(valid), bool)
    for s in order:
        if supp_host[s] or not inb[s] or \
                host_labels[r0[s], c0[s]] != UNLABELED:
            continue
        if num_acc >= cap:
            overflow = True
            continue
        members = mode_members(pts_d, lab_d, pos_d[s], r0[s] * w + c0[s],
                               config, params)
        if int(members.sum()) < config.min_region_inliers:
            continue
        lab_d = torch.where(members, num_acc + initial_region_id_offset,
                            lab_d)
        suppressed |= valid_d & (xla_order.sumsq(pos_d - pos_d[s])
                                 < params.squared_centroid_distance_threshold)
        supp_host = suppressed.cpu().numpy()
        host_labels = lab_d.cpu().numpy()
        seeds.append(pos[s])
        num_acc += 1
    if overflow:
        warnings.warn(
            f"mean-shift region table full (max_regions={cap}): further "
            "modes were not attempted", stacklevel=2)
    labels[...] = host_labels
    return _regions_from_labels(host_labels, num_acc,
                                initial_region_id_offset, seeds)


def grow_mean_shift_regions_device(points: np.ndarray, labels: np.ndarray,
                                   state: MeanShiftState,
                                   config: ClusterRegionConfig,
                                   initial_region_id_offset: int = 0,
                                   params: MeanShiftParams = MeanShiftParams(),
                                   device=None) -> List[MeanShiftRegion]:
    """Mode order and suppression in NumPy (exact, tiny), each attempted
    mode's growth by :func:`mode_members` on ``device`` (the card unless
    the caller passes ``device="cpu"``). Mutates ``labels``."""
    h, w = points.shape[0], points.shape[1]
    device = _card(device)
    pos, idx, valid, intensity = _frame_state(state)
    order = _mode_order(valid, intensity)
    r0s, c0s, inb = _rounded_starts(idx, h, w)
    pts_d = torch.as_tensor(np.asarray(points, np.float32), device=device)

    regions: List[MeanShiftRegion] = []
    suppressed = np.zeros(len(valid), bool)
    for i, s in enumerate(order):
        if suppressed[s] or not inb[s] or \
                labels[r0s[s], c0s[s]] != UNLABELED:
            continue  # a claimed start pixel is an empty attempt
        seed_pos = pos[s].astype(np.float32)
        members = mode_members(
            pts_d, torch.as_tensor(labels.astype(np.int32), device=device),
            torch.as_tensor(seed_pos, device=device), r0s[s] * w + c0s[s],
            config, params).cpu().numpy()
        count = int(members.sum())
        if count >= config.min_region_inliers:
            label_id = len(regions) + initial_region_id_offset
            labels[members] = label_id
            later = order[i + 1:]
            d2 = np.sum((pos[later] - seed_pos) ** 2, axis=-1)
            suppressed[later[
                d2 < params.squared_centroid_distance_threshold]] = True
            rr, cc = np.nonzero(members)
            regions.append(MeanShiftRegion(
                label_id=label_id,
                inlier_indices=np.sort(cc * h + rr).astype(np.int64),
                seed=seed_pos))
    return regions


def sliding_mean_shift(points, labels, config: ClusterRegionConfig,
                       iterations: int, initial_region_id_offset: int = 0,
                       params: MeanShiftParams = MeanShiftParams(),
                       growth: str = "device", device=None,
                       points_device=None, impl=None):
    """SlidingMeanShift of one frame (mean_shift_segmentation.h:208):
    [H, W, 3] points and [H, W] int32 NumPy ``labels``, mutated in place.
    Returns the region list. ``growth``: "device", "device_permode",
    "host" or "native" (module docstring). The shift and the device
    growths run on ``device``: the CUDA card unless the caller passes
    ``device="cpu"``. "native" grows on the host; its shift is kernel M1
    when ``device`` is a CUDA card (on ``points_device``, the points
    already there, when given; ``impl="plain"`` takes its plain version),
    else the host-ops library's."""
    if growth == "native":
        return _sliding_mean_shift_native(points, labels, config,
                                          iterations,
                                          initial_region_id_offset, params,
                                          device, points_device, impl)
    if growth not in ("device", "device_permode", "host"):
        raise ValueError(f"unknown growth {growth!r}")
    device = _card(device)
    points = np.asarray(points, np.float32)
    state = mean_shift_modes(
        torch.as_tensor(points, device=device),
        torch.as_tensor(labels.astype(np.int32), device=device),
        iterations, params)
    grow = {"device": grow_mean_shift_regions_batched,
            "device_permode": grow_mean_shift_regions_device}.get(growth)
    if grow is None:
        return grow_mean_shift_regions(points, labels, state, config,
                                       initial_region_id_offset, params)
    return grow(points, labels, state, config, initial_region_id_offset,
                params, device=device)


def _sliding_mean_shift_native(points, labels, config, iterations,
                               initial_region_id_offset, params,
                               device=None, points_device=None, impl=None):
    """growth='native': the shift, then the host-ops library's growth
    (``pcseg_mean_shift_grow``). On a CUDA ``device`` the shift is kernel
    M1 (kernels/mean_shift_modes.py) on ``points_device``, the frame's
    [H, W, 3] f32 points already there (uploaded from ``points`` when
    None), and the state comes back in one copy; elsewhere it is the
    library's ``pcseg_mean_shift_shift``. The two give the same state bit
    for bit, with f64 sums (against the f32 device shift of
    :func:`mean_shift_modes` they are agreement-tested, not bitwise). Two
    faults of the reference's library are kept, so that the port gives
    JAX's pipeline result: the growth window is 3x3 whatever
    ``half_search_window`` says, and the mode index rounds half away from
    zero."""
    lib = native.load_hostops()
    if lib is None:
        raise RuntimeError("native hostops unavailable for growth='native'")
    h, w = labels.shape
    n = h * w
    pts = np.asarray(points, np.float32)
    occ_b = np.isfinite(pts).all(axis=-1)
    occ = np.ascontiguousarray(occ_b.astype(np.uint8))
    cells = np.ascontiguousarray(np.nan_to_num(pts, nan=0.0)
                                 .astype(np.float32))
    labels_c = np.ascontiguousarray(labels.astype(np.int32))
    with profiling.stage("mean_shift"):
        profiling.count("mean_shift.seeds", int(np.count_nonzero(
            occ_b & (labels_c == UNLABELED))))
        with profiling.stage("mean_shift.modes"):
            if device is not None and torch.device(device).type == "cuda":
                state = _device_modes(points_device, pts, labels_c,
                                      iterations, params, device, impl)
            else:
                state = ms_kernel.unpack(
                    np.empty(ms_kernel.BYTES_PER_PIXEL * n, np.uint8), n)
                lib.pcseg_mean_shift_shift(
                    _ptr(cells), _ptr(occ), h, w, int(iterations),
                    int(params.half_search_window),
                    ctypes.c_float(params.square_distance_threshold),
                    ctypes.c_float(params.min_support), int(UNLABELED),
                    _ptr(labels_c), *_state_ptrs(state))
        profiling.count("mean_shift.valid_modes",
                        int(np.count_nonzero(state.valid)))
        with profiling.stage("mean_shift.grow"):
            n_regions = lib.pcseg_mean_shift_grow(
                _ptr(cells), _ptr(occ), h, w, *_state_ptrs(state),
                ctypes.c_float(params.squared_centroid_distance_threshold),
                ctypes.c_float(params.squared_neighbor_distance_threshold),
                int(config.min_region_inliers), int(UNLABELED),
                int(initial_region_id_offset), _ptr(labels_c))
        profiling.count("mean_shift.regions", n_regions)
    labels[...] = labels_c
    return _member_regions(pts, labels_c, n_regions,
                           initial_region_id_offset)


_CTYPES = {np.dtype(np.float32): ctypes.c_float,
           np.dtype(np.uint8): ctypes.c_uint8,
           np.dtype(np.int32): ctypes.c_int32}


def _ptr(a: np.ndarray):
    """A C pointer to the contiguous NumPy array ``a``."""
    return a.ctypes.data_as(ctypes.POINTER(_CTYPES[a.dtype]))


def _state_ptrs(state):
    """The shift state's fields in the host library's argument order
    (mode, fr, fc, valid, intensity)."""
    return [_ptr(a) for a in (state.mode, state.fr, state.fc, state.valid,
                              state.intensity)]


def _device_modes(points_device, points, labels, iterations, params,
                  device, impl):
    """Kernel M1's state of one frame on the card, read back to the host in
    one copy (the sync ``mean_shift.modes``): ``unpack``'s NumPy views."""
    h, w = labels.shape
    pts_d = points_device if points_device is not None else \
        profiling.to_device(points, torch.float32, device, "mean_shift.points")
    labels_d = profiling.to_device(labels, torch.int32, device,
                                   "mean_shift.labels")
    packed = ms_kernel.mean_shift_modes(pts_d.reshape(h, w, 3), labels_d,
                                        iterations, params, impl=impl)
    with profiling.blocking("mean_shift.modes"):
        host = packed.cpu().numpy()
    return ms_kernel.unpack(host, h * w)


def _member_regions(points, labels, num, offset):
    """The regions ``offset`` .. ``offset + num - 1`` of a label grid from
    one pass over it: each region's inliers sorted col-major, and as its
    seed the centroid of its members in row-major order (the seed
    positions stay inside the library)."""
    h, w = labels.shape
    rid = labels.reshape(-1).astype(np.int64) - offset
    members = np.nonzero((rid >= 0) & (rid < num))[0]
    members = members[np.argsort(rid[members], kind="stable")]
    flat_pts = points.reshape(-1, 3)
    regions: List[MeanShiftRegion] = []
    groups = np.split(members, np.cumsum(np.bincount(rid[members],
                                                     minlength=num))[:-1]) \
        if num else []
    for k, lin in enumerate(groups):
        rr, cc = lin // w, lin % w
        regions.append(MeanShiftRegion(
            label_id=k + offset,
            inlier_indices=np.sort(cc * h + rr).astype(np.int64),
            seed=flat_pts[lin].mean(axis=0).astype(np.float32)
            if len(lin) else np.zeros(3, np.float32)))
    return regions
