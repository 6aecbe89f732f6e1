"""The mean shift's fixed point (M1): wrapper of
``csrc/mean_shift_modes.cu`` and its plain PyTorch version, the twin of
the host-ops library's ``pcseg_mean_shift_shift`` (native/hostops.cc).

Per pixel of one [H, W, 3] f32 frame whose [H, W] int32 labels are given:
a finite UNLABELED pixel seeds and is a window neighbour; each seed takes
``iterations`` shift steps over the (2 half + 1)^2 index window around its
rounded fractional (row, col), within a ball of the squared distance
threshold, and is invalidated for good when its support falls below the
floor (models/config.MeanShiftParams; mean_shift_segmentation.h:232-260).
The order of every operation is the host library's:

  * the window centre rounds half away from zero (``std::lround``);
  * the offsets run rows outer, columns inner; a neighbour's squared
    distance is ``(dx*dx + dy*dy) + dz*dz`` in f32 with d = point - mode;
  * the f32 differences (point - mode, row - fr, col - fc) are summed in
    f64, in that order;
  * a step is ``float(sum / support)``, added to the f32 state.

Kernel, plain version and host library agree bit for bit (g++ builds the
library without FMA, the kernel takes ``--fmad=false``).

The outputs of a frame of N pixels lie in one packed byte buffer of 25 N
bytes (:func:`unpack`): the modes [N, 3] f32, fr, fc and intensity [N]
f32, valid [N] u8, so one copy brings a frame's state to the host. A pixel
that never seeds holds mode 0, fr 0, fc 0, intensity 1 and valid 0.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from pcseg_tpu_torch.kernels import build, common
from pcseg_tpu_torch.models.config import UNLABELED
from pcseg_tpu_torch.ops import nansafe

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

BYTES_PER_PIXEL = 25


class Modes(NamedTuple):
    """Views of a packed buffer (NumPy or torch): mode [N, 3], fr, fc,
    intensity [N] f32, valid [N] u8."""
    mode: object
    fr: object
    fc: object
    intensity: object
    valid: object


def unpack(buf, n: int) -> Modes:
    """The fields of a packed buffer of ``n`` pixels (a [25 n] uint8 NumPy
    array or torch tensor), as views."""
    f32 = np.float32 if isinstance(buf, np.ndarray) else torch.float32
    floats = buf[:24 * n].view(f32)
    return Modes(mode=floats[:3 * n].reshape(n, 3),
                 fr=floats[3 * n:4 * n], fc=floats[4 * n:5 * n],
                 intensity=floats[5 * n:6 * n], valid=buf[24 * n:])


def _lib():
    lib = build.load("mean_shift_modes")
    fn = lib.mean_shift_modes_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 7 + [_I] * 4 + [_F, _F, _I, _VP]
        fn.restype = _I
    return lib


def _lround(v: torch.Tensor) -> torch.Tensor:
    """``std::lround`` of f32 values (half away from zero), exact: the
    half is added in f64, where every f32 value plus 0.5 is exact."""
    d = v.double()
    return torch.trunc(d + torch.copysign(torch.full_like(d, 0.5), d)) \
        .to(torch.int64)


def mean_shift_modes_plain(points: torch.Tensor, labels: torch.Tensor,
                           iterations: int, params,
                           out: torch.Tensor) -> None:
    """Plain PyTorch version, vectorised over the pixels: every seed's
    step loops over the window's offsets in the host library's order,
    with f64 sums. Writes the packed buffer ``out``."""
    h, w = labels.shape
    n = h * w
    dev = points.device
    flat = points.reshape(n, 3)
    half_window = params.half_search_window
    nb_ok = nansafe.all_finite(flat) & (labels.reshape(n) == UNLABELED)
    cell = torch.where(nb_ok[:, None], flat, 0.0)
    lin = torch.arange(n, device=dev)
    mode = cell.clone()
    fr = torch.where(nb_ok, torch.div(lin, w, rounding_mode="floor")
                     .to(torch.float32), 0.0)
    fc = torch.where(nb_ok, (lin % w).to(torch.float32), 0.0)
    valid = nb_ok.clone()
    intensity = torch.ones(n, dtype=torch.float32, device=dev)
    for _ in range(iterations):
        r0 = _lround(fr)
        c0 = _lround(fc)
        sums = torch.zeros((n, 5), dtype=torch.float64, device=dev)
        support = torch.zeros(n, dtype=torch.int32, device=dev)
        for dr in range(-half_window, half_window + 1):
            rr = r0 + dr
            drow = rr.to(torch.float32) - fr
            for dc in range(-half_window, half_window + 1):
                cc = c0 + dc
                q = (rr * w + cc).clamp(0, n - 1)
                ok = valid & (rr >= 0) & (rr < h) & (cc >= 0) & (cc < w) \
                    & nb_ok[q]
                d = cell[q] - mode
                d2 = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) \
                    + d[:, 2] * d[:, 2]
                ok = ok & ~(d2 > params.square_distance_threshold)
                terms = torch.cat([d, drow[:, None],
                                   (cc.to(torch.float32) - fc)[:, None]],
                                  dim=1).double()
                sums = sums + torch.where(ok[:, None], terms, 0.0)
                support = support + ok.to(torch.int32)
        valid = valid & ~(support.to(torch.float32) < params.min_support)
        steps = (sums / support.clamp_min(1)[:, None].double()) \
            .to(torch.float32)
        mode = torch.where(valid[:, None], mode + steps[:, :3], mode)
        fr = torch.where(valid, fr + steps[:, 3], fr)
        fc = torch.where(valid, fc + steps[:, 4], fc)
        intensity = torch.where(valid, support.to(torch.float32), intensity)
    fields = unpack(out, n)
    fields.mode.copy_(mode)
    fields.fr.copy_(fr)
    fields.fc.copy_(fc)
    fields.intensity.copy_(intensity)
    fields.valid.copy_(valid.to(torch.uint8))


def mean_shift_modes(points: torch.Tensor, labels: torch.Tensor,
                     iterations: int, params, impl=None) -> torch.Tensor:
    """The shift state of every pixel of [H, W, 3] f32 ``points`` whose
    [H, W] int32 ``labels`` are given, under ``params``
    (models/config.MeanShiftParams), as the packed [25 H W] uint8 buffer of
    :func:`unpack` on the points' device.

    CUDA points launch the kernel, which writes every output once: one
    launch a call. CPU points and ``impl="plain"`` take the plain
    version."""
    if points.dim() != 3 or points.shape[-1] != 3:
        raise ValueError(f"points must be [H, W, 3], got "
                         f"{tuple(points.shape)}")
    h, w = points.shape[:2]
    dev = points.device
    out = torch.empty(BYTES_PER_PIXEL * h * w, dtype=torch.uint8,
                      device=dev)
    if not common.use_kernel(dev, impl):
        mean_shift_modes_plain(points, labels, iterations, params, out)
        return out
    pts = points.contiguous()
    common.check("mean_shift_modes: points", pts, torch.float32, (h, w, 3),
                 dev)
    common.check("mean_shift_modes: labels", labels, torch.int32, (h, w),
                 dev)
    f = unpack(out, h * w)
    common.launch(
        _lib().mean_shift_modes_launch, dev, common.ptr(pts),
        common.ptr(labels), common.ptr(f.mode), common.ptr(f.fr),
        common.ptr(f.fc), common.ptr(f.intensity), common.ptr(f.valid), h,
        w, int(iterations), int(params.half_search_window),
        float(params.square_distance_threshold), float(params.min_support),
        UNLABELED)
    return out
