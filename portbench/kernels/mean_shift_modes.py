"""M1, ``pcseg_tpu_torch/csrc/mean_shift_modes.cu``: the mean shift's
fixed point of one frame. Counted from the shapes of the call's logical
arguments alone, as N1's: each pixel's point and label read once (16 B),
its mode, fractional row and column, intensity and valid written once
(25 B); no operations. The window's work (up to 121 neighbours a step, a
seed's only) depends on the data, and counting it from the inputs on the
card would add a sync to the profiled window; so the share read from this
count is a floor.

A program without the kernel (one that shifts on the host) has no wrapper
to spy on: ``WRAPPER`` then names :func:`absent`, which nothing calls, and
the metric reads nothing."""

import importlib.util

PROGRAM_MODULE = "pcseg_tpu_torch.kernels.mean_shift_modes"
DEVICE_NAME = "mean_shift_modes_kernel"


def absent(*args, **kwargs):
    """Stands for the wrapper in a program that has none; never called."""


WRAPPER = (f"{PROGRAM_MODULE}:mean_shift_modes"
           if importlib.util.find_spec(PROGRAM_MODULE) is not None
           else f"{__name__}:absent")


def cost(a: dict):
    """(bytes, f32 operations) of one call from its bound arguments."""
    h, w = a["points"].shape[:2]
    return (16 + 25) * h * w, 0
