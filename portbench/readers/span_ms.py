"""Host ms per request inside a synced span on ``spec["target"]``, all
its calls in the traced window summed (nothing when it never ran)."""


def read(spec, ctx):
    calls = ctx.span_calls.get(spec["target"], 0)
    if not calls or not ctx.requests:
        return None
    return ctx.span_seconds[spec["target"]] / ctx.requests * 1e3
