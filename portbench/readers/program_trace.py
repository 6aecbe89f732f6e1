"""A span or counter the program records itself, read from its request
recorder (``pcseg_tpu_torch.utils.profiling``) without importing it.

``spec``: ``"request"`` (the kind of request: ``"stream"``, ``"frame"``)
and either ``"span"`` (the summed ms of the spans of that name in a
request) or ``"counter"`` (the counter's value in a request, times
``spec.get("scale", 1)``). Returns the median over the traced window's
requests of that kind: the last ``ctx.requests`` before the profiled
ones, so the warm-up requests before the window and the two profiled
windows after it are left out. Nothing when the process holds no such
recorder (the control's runs, or a program without one) or it recorded
no request of that kind.
"""

import statistics
import sys

RECORDER = "pcseg_tpu_torch.utils.profiling"


def read(spec, ctx):
    rec = sys.modules.get(RECORDER)
    if rec is None or not hasattr(rec, "requests") or not ctx.requests:
        return None
    reqs = [r for r in rec.requests() if r.kind == spec["request"]]
    if ctx.profile:
        reqs = reqs[:len(reqs) - 2 * ctx.profile["requests"]]
    window = reqs[-ctx.requests:]
    if not window:
        return None
    if "span" in spec:
        values = [r.span_ns(spec["span"]) * 1e-6 for r in window]
    else:
        values = [r.counters.get(spec["counter"], 0) * spec.get("scale", 1)
                  for r in window]
    return statistics.median(values)
