"""The device's idle share of the profiled window, in %: 1 - busy / wall,
busy being the union of the trace's kernel, copy and fill intervals."""


def read(spec, ctx):
    p = ctx.profile
    if not p or not p["window_s"] or not p["device_events"]:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
