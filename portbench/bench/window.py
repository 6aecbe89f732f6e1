"""The measured window of a closed loop, and the end-to-end metrics taken
from it.

A closed loop sends request ``i + 1`` when request ``i``'s result is on
the host. Requests start while fewer than ``seconds`` have passed since
the window opened; the window closes when the last of them ends, so a
rate counts all the work and all the time of the window, and a
percentile is over every request.
"""

from __future__ import annotations

import re
import time

LATENCY = re.compile(r"latency_ms_p(\d+)$")


def closed_loop(request, seconds: float, sink=None, keep_going=None,
                first: int = 0, clock=time.perf_counter):
    """Run ``request(i)`` for i = first, first + 1, ... Returns (opened,
    closed, [(start, end)]); ``sink(i, output)`` takes each output after
    its request's clock stops. ``keep_going(go)`` may overrule the local
    decision (ranks that must agree on it)."""
    records = []
    opened = clock()
    i = first
    while True:
        go = clock() - opened < seconds
        if keep_going is not None:
            go = keep_going(go)
        if not go:
            break
        start = clock()
        out = request(i)
        end = clock()
        records.append((start, end))
        if sink is not None:
            sink(i, out)
        i += 1
    closed = records[-1][1] if records else clock()
    return opened, closed, records


def percentile(values, q: float) -> float:
    """The q-th percentile (0..100) with linear interpolation between
    order statistics (numpy's default)."""
    v = sorted(values)
    if len(v) == 1:
        return float(v[0])
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return float(v[lo] + (v[hi] - v[lo]) * (pos - lo))


def end_to_end(name: str, opened, closed, records, work_per_request,
               setup_s: float):
    """The value of end-to-end metric ``name`` from the window."""
    if name == "setup_s":
        return setup_s
    if name == "points_per_s":
        return work_per_request * len(records) / (closed - opened)
    m = LATENCY.match(name)
    if m:
        return percentile([(e - s) * 1e3 for s, e in records],
                          float(m.group(1)))
    raise KeyError(f"no end-to-end metric {name!r}")

