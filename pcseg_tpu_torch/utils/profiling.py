"""Tracing and timing of the port (port of pcseg_tpu.utils.profiling, with
the request recorder the serving path keeps).

The recorder is on by default: it is the telemetry an operator of the
serving path keeps, at 1-2 µs a span or counter on the host of an H100
machine (about 0.05% of a VGA request).

  * ``request(kind)``: the root span ``request.<kind>`` of one public call,
    with a fresh request id. The entry points open it
    (``Segmenter.device_forward_stream``: ``"stream"``;
    ``device_forward`` and ``device_forward_batched``: ``"forward"``;
    ``segment_frame`` and ``segment_frame_stream``: ``"frame"``; the
    sharded step: ``"sharded"``). A call made inside an open request joins
    that request.
  * ``stage(name)``: a child span of the innermost open span, its ends
    read on ``time.perf_counter_ns()``. While a ``torch.profiler`` is
    recording it also opens a ``record_function`` range, so the program's
    spans land in the profiler's trace beside the kernels they launched.
  * ``count(name, n)``: adds to the open request's counters and to the
    process totals (``total(name)``); ``diverted()`` collects a block's
    counts apart (a CUDA graph's capture).
  * ``blocking(site, n)``: wraps a call at which the host waits for the
    card (a copy to or from pageable host memory, a device value read on
    the host): counts ``host_syncs`` (``n`` of them), adds its time to
    ``sync_wait_ns`` and records the child span ``sync:<site>``.

Closed requests go into a ring of the last ``RING`` (``requests()``).
``recording(False)`` turns the recorder off: it then reads no clock,
opens no range, counts nothing and appends nothing. Each thread has its
own open request; the totals are shared.

Beside it: ``Timer`` (wall-clock stage times that wait for the stage's
results: CUDA work is asynchronous, and without a sync the clock measures
the enqueue) and ``trace_to(log_dir)`` (a ``torch.profiler`` window
written as a Chrome trace into ``log_dir``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Dict, List

import torch

RING = 1024

_clock = time.perf_counter_ns
_profiler_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()
_ids = itertools.count(1)
_ring: collections.deque = collections.deque(maxlen=RING)
_totals: Dict[str, int] = {}
_lock = threading.Lock()
_on = True


class _Thread(threading.local):
    req = None  # the thread's open Request
    diverted = None  # the dict that takes the thread's counts (diverted())


_thread = _Thread()


class Span:
    """One closed or open span: ``parent`` is the index of the enclosing
    span in its request's ``spans`` (-1 for the root); ``t0``/``t1`` are
    ``perf_counter_ns`` readings (``t1`` None while open); ``syncs`` the
    host syncs of a ``blocking`` span (0 for a stage)."""

    __slots__ = ("name", "parent", "t0", "t1", "syncs")

    def __init__(self, name: str, parent: int, t0: int, syncs: int = 0):
        self.name = name
        self.parent = parent
        self.t0 = t0
        self.t1 = None
        self.syncs = syncs

    def __repr__(self):
        return (f"Span({self.name!r}, parent={self.parent}, "
                f"ns={None if self.t1 is None else self.t1 - self.t0})")


class Request:
    """The spans and counters of one public call; ``spans[0]`` is the root
    ``request.<kind>``."""

    __slots__ = ("id", "kind", "spans", "counters", "_open")

    def __init__(self, rid: int, kind: str, t0: int):
        self.id = rid
        self.kind = kind
        self.spans: List[Span] = [Span("request." + kind, -1, t0)]
        self.counters: Dict[str, int] = {}
        self._open = [0]

    def span_ns(self, name: str) -> int:
        """The summed ns of the closed spans called ``name``."""
        return sum(s.t1 - s.t0 for s in self.spans
                   if s.name == name and s.t1 is not None)

    def innermost(self) -> str:
        """The name of the innermost open span."""
        return self.spans[self._open[-1]].name

    def _add(self, name: str, n: int):
        self.counters[name] = self.counters.get(name, 0) + n


def _count(req, name: str, n: int):
    if req is not None:
        req._add(name, n)
    with _lock:
        _totals[name] = _totals.get(name, 0) + n


class _Span:
    """The context of one ``stage`` (``syncs`` 0) or ``blocking`` span."""

    __slots__ = ("_name", "_syncs", "_req", "_idx", "_t0", "_range")

    def __init__(self, name: str, syncs: int):
        self._name = name
        self._syncs = syncs
        self._range = None

    def __enter__(self):
        req = self._req = _thread.req
        if _profiler_enabled():
            self._range = torch.profiler.record_function(self._name)
            self._range.__enter__()
        t0 = self._t0 = _clock()
        if req is not None:
            self._idx = len(req.spans)
            req.spans.append(Span(self._name, req._open[-1], t0,
                                  self._syncs))
            req._open.append(self._idx)
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        req = self._req
        if req is not None:
            req.spans[self._idx].t1 = t1
            req._open.pop()
        if self._syncs:
            _count(req, "host_syncs", self._syncs)
            _count(req, "sync_wait_ns", t1 - self._t0)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


class _Root:
    """The context of one ``request``: opens the root span, closes it and
    puts the request into the ring."""

    __slots__ = ("_kind", "_req", "_range")

    def __init__(self, kind: str):
        self._kind = kind
        self._range = None

    def __enter__(self) -> Request:
        if _profiler_enabled():
            self._range = torch.profiler.record_function(
                "request." + self._kind)
            self._range.__enter__()
        req = self._req = Request(next(_ids), self._kind, _clock())
        _thread.req = req
        return req

    def __exit__(self, *exc):
        req = self._req
        req.spans[0].t1 = _clock()
        _thread.req = None
        _ring.append(req)
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def request(kind: str):
    """Open the root span ``request.<kind>`` of one public call (yields
    its Request); inside an open request, join it (yields None)."""
    if not _on or _thread.req is not None:
        return _NULL
    return _Root(kind)


def stage(name: str):
    """Record the block as a span ``name`` of the open request, and as a
    ``torch.profiler`` range while a profiler is recording."""
    return _Span(name, 0) if _on else _NULL


def blocking(site: str, n: int = 1):
    """Wrap a call at which the host waits for the card ``n`` times:
    ``host_syncs`` += n, ``sync_wait_ns`` += the block's time, and the span
    ``sync:<site>``."""
    return _Span("sync:" + site, n) if _on else _NULL


def to_device(x, dtype, device, site: str = "input"):
    """``torch.as_tensor(x, dtype, device)``; a copy from host memory (any
    ``x`` but a tensor, or a CPU tensor bound for a card) is the host sync
    ``site``, as the card waits for it."""
    device = torch.device(device)
    if torch.is_tensor(x) and (x.device.type != "cpu"
                               or device.type == "cpu"):
        return torch.as_tensor(x, dtype=dtype, device=device)
    with blocking(site):
        return torch.as_tensor(x, dtype=dtype, device=device)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to counter ``name`` of the open request and of the
    process (inside ``diverted()``, to its dict alone)."""
    if _on:
        into = _thread.diverted
        if into is None:
            _count(_thread.req, name, n)
        else:
            into[name] = into.get(name, 0) + n


@contextlib.contextmanager
def diverted():
    """Collect the thread's counts in the block into the yielded dict,
    and neither into its request nor into the totals: a CUDA graph's
    capture runs the program's code without running its work, so what it
    counts belongs to each replay."""
    was, _thread.diverted = _thread.diverted, {}
    try:
        yield _thread.diverted
    finally:
        _thread.diverted = was


def total(name: str) -> int:
    """Counter ``name`` summed over the process's life."""
    with _lock:
        return _totals.get(name, 0)


def requests() -> List[Request]:
    """The closed requests in the ring, oldest first."""
    return list(_ring)


def current():
    """The thread's open Request, or None."""
    return _thread.req


def recording(on: bool) -> bool:
    """Turn the recorder on or off; returns the previous setting."""
    global _on
    was, _on = _on, bool(on)
    return was


def _cuda_devices(value, found):
    """Add the CUDA devices of every tensor in ``value`` (tensors, lists,
    tuples and NamedTuples, dicts, dataclasses) to the set ``found``."""
    if torch.is_tensor(value):
        if value.is_cuda:
            found.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, found)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, found)
    elif dataclasses.is_dataclass(value) and not isinstance(value, type):
        for f in dataclasses.fields(value):
            _cuda_devices(getattr(value, f.name), found)
    return found


class Timer:
    """Accumulates per-stage wall times; ``sync_value`` makes a stage's
    time include the device work behind its results."""

    def __init__(self):
        self.times: Dict[str, List[float]] = {}

    @contextlib.contextmanager
    def measure(self, name: str, sync_value=None):
        """Time the block. ``sync_value`` (tensors, or containers of them;
        it is read when the block exits, so a block may fill it in) names
        the results: every card that holds one of them is synchronised
        before the clock stops."""
        t0 = time.perf_counter()
        yield
        for dev in _cuda_devices(sync_value, set()):
            torch.cuda.synchronize(dev)
        self.times.setdefault(name, []).append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, float]:
        """The fastest time of each stage, in seconds."""
        return {k: min(v) for k, v in self.times.items()}


@contextlib.contextmanager
def trace_to(log_dir: str):
    """Profile the block (host activity, and the card's where one is
    present) and write a Chrome trace into ``log_dir`` (made if missing).
    Yields the trace file's path; the file exists once the block exits,
    also when it raised."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    try:
        with prof:
            yield path
    finally:
        prof.export_chrome_trace(path)
