"""Tracing and timing helpers (port of pcseg_tpu.utils.profiling).

  * ``stage(name)``: a ``torch.profiler`` range, and an NVTX range where a
    card is present, so a stage shows up by name in profiler traces;
  * ``Timer``: wall-clock stage times that wait for the stage's results
    (CUDA work is asynchronous: without a sync the clock measures the
    enqueue);
  * ``trace_to(log_dir)``: a ``torch.profiler`` window written as a Chrome
    trace into ``log_dir``.

Nothing in the pipeline calls ``stage``, as in the JAX package: callers
wrap what they want to see.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List

import torch


@contextlib.contextmanager
def stage(name: str):
    """Annotate a pipeline stage for profiler traces."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


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
