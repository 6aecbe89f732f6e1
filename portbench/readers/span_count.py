"""How many spans of one name the program records in a request, read
from its request recorder as ``program_trace`` reads it (the same
window of requests; nothing without the recorder).

``spec``: ``"request"`` (the kind of request) and ``"span"`` (the name
counted). Returns the median count over the traced window's requests."""

import statistics
import sys

from portbench.readers.program_trace import RECORDER


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
    return statistics.median(
        sum(s.name == spec["span"] for s in r.spans) for r in window)
