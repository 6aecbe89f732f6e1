"""The harness's own spans and its reading of the profiler's trace.

Spans wrap a program function named as ``"package.module:attr[.attr]"``
(``"pcseg_tpu_torch.models.pipeline:Segmenter._host_finalize"``). A
synced span puts ``torch.cuda.synchronize()`` before and after the call
and adds its wall time; an unsynced span only opens a
``torch.profiler.record_function`` range, so the trace can name what the
host was doing while the device idled. Spies on the kernel wrappers
record each call's logical bytes and operations (``portbench/kernels``).
"""

from __future__ import annotations

import importlib
import inspect
import json
import os
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def resolve(target: str):
    """(owner, attribute name) of ``"module:attr.attr"``."""
    mod, _, path = target.partition(":")
    owner = importlib.import_module(mod)
    parts = path.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


def span_name(target: str) -> str:
    return target.rpartition(":")[2].rpartition(".")[2].lstrip("_")


class Patches:
    """Replace attributes for the life of a ``with`` block."""

    def __init__(self):
        self._saved = []

    def put(self, owner, name, value):
        self._saved.append((owner, name, owner.__dict__[name]
                            if isinstance(owner, type) else
                            getattr(owner, name)))
        setattr(owner, name, value)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for owner, name, real in reversed(self._saved):
            setattr(owner, name, real)
        self._saved.clear()


class Spans(Patches):
    """Spans around each target; ``seconds[target]`` and ``calls[target]``
    accumulate while installed."""

    def __init__(self, torch, targets, synced: bool):
        super().__init__()
        self.seconds = {t: 0.0 for t in targets}
        self.calls = {t: 0 for t in targets}
        self._torch = torch
        self._targets = list(targets)
        self._synced = synced

    def __enter__(self):
        torch = self._torch
        for t in self._targets:
            owner, name = resolve(t)
            real = getattr(owner, name)
            label = span_name(t)

            def wrap(*a, _real=real, _t=t, _label=label, **kw):
                if self._synced:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    try:
                        return _real(*a, **kw)
                    finally:
                        torch.cuda.synchronize()
                        self.seconds[_t] += time.perf_counter() - t0
                        self.calls[_t] += 1
                with torch.profiler.record_function(_label):
                    return _real(*a, **kw)
            self.put(owner, name, wrap)
        return self


class KernelSpies(Patches):
    """Spies on the wrappers of the kernel cost modules in ``costs``
    ({name: module with WRAPPER and cost(bound arguments)}); ``calls[name]``
    lists each call's (bytes, f32 operations)."""

    def __init__(self, costs: dict):
        super().__init__()
        self.costs = costs
        self.calls = {n: [] for n in costs}

    def __enter__(self):
        for n, mod in self.costs.items():
            owner, name = resolve(mod.WRAPPER)
            real = getattr(owner, name)
            sig = inspect.signature(real)

            def spy(*a, _real=real, _sig=sig, _n=n, _mod=mod, **kw):
                bound = _sig.bind(*a, **kw)
                bound.apply_defaults()
                self.calls[_n].append(_mod.cost(bound.arguments))
                return _real(*a, **kw)
            self.put(owner, name, spy)
        return self


def merge(intervals):
    """Sorted, merged [(start, end)]."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(events: list, wall_s: float) -> dict:
    """A chrome trace's events -> device busy seconds, device events, the
    device time by operation name, and the idle gaps between device work
    named by the innermost harness span open on the host (µs in, s out)."""
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    busy = merge([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    gaps = []
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        mid = (e0 + s1) / 2
        open_ = [s for s in spans if s["ts"] <= mid <= s["ts"] + s["dur"]]
        name = max(open_, key=lambda s: s["ts"])["name"] if open_ \
            else "harness"
        gaps.append((name, (s1 - e0) * 1e-6))
    return dict(busy_s=sum(e - s for s, e in busy) * 1e-6, window_s=wall_s,
                device_events=len(dev), by_name=by_name,
                device_ops=sorted(by_name.items(), key=lambda x: -x[1])[:10],
                idle_gaps=sorted(gaps, key=lambda x: -x[1])[:10])


def _trace_events(torch, run, activities):
    """(chrome-trace events, wall seconds) of ``run()`` under
    torch.profiler with ``activities``."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"], wall
    finally:
        os.unlink(path)


def profile(torch, run, costs: dict, span_targets) -> dict:
    """Two profiled windows of ``run()``. The first traces the device
    alone (CUDA activity, which slows the host least), with spies on the
    kernel wrappers: busy and window seconds, device events and time by
    name, ``kernel_calls``. The second adds the host (CPU activity) and
    unsynced spans on ``span_targets``, to name the idle gaps."""
    from torch.profiler import ProfilerActivity
    with KernelSpies(costs) as spies:
        events, wall = _trace_events(torch, run, [ProfilerActivity.CUDA])
    out = reduce_trace(events, wall)
    out["kernel_calls"] = spies.calls
    with Spans(torch, span_targets, synced=False):
        events, wall = _trace_events(
            torch, run, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    out["idle_gaps"] = reduce_trace(events, wall)["idle_gaps"]
    return out
