"""Device events (kernels, copies, fills) in the profiled window per
request profiled."""


def read(spec, ctx):
    p = ctx.profile
    if not p or not p["requests"] or not p["device_events"]:
        return None
    return p["device_events"] / p["requests"]
