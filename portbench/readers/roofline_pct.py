"""Share of the roofline of the kernels named in ``spec["kernels"]``, in
%: the sum of each call's least time (``portbench/kernels/<name>.py``'s
bytes and operations at the H100's published peaks) over the sum of the
kernels' device time in the profiled window, the device events found by
name. Kernels that made no call or no device event are left out;
nothing when none is left."""

import importlib

from portbench.bench import roofline


def read(spec, ctx):
    p = ctx.profile
    if not p:
        return None
    least = device = 0.0
    for k in spec["kernels"]:
        mod = importlib.import_module(f"portbench.kernels.{k}")
        calls = p["kernel_calls"].get(k, [])
        dev = sum(s for n, s in p["by_name"].items() if mod.DEVICE_NAME in n)
        if calls and dev > 0:
            least += sum(roofline.least_seconds(b, o) for b, o in calls)
            device += dev
    if device <= 0:
        return None
    return 100.0 * least / device
