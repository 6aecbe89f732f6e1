"""A counter the path keeps (``spec["counter"]``), per request of the
traced window, times ``spec.get("scale", 1)``; nothing when the path
keeps no such counter."""


def read(spec, ctx):
    value = ctx.counters.get(spec["counter"])
    if value is None or not ctx.requests:
        return None
    return value / ctx.requests * spec.get("scale", 1)
