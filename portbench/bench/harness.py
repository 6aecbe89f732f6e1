"""One run of one cell in one process: set-up, the measured window, the
traced readings, the check against the reference, the result line."""

from __future__ import annotations

import gc
import importlib
import sys
import time
from contextlib import nullcontext

from portbench.bench import trace, window
from portbench.paths.common import PROGRAM


class Context:
    """What the per-layer readers read."""

    def __init__(self):
        self.requests = 0
        self.span_seconds = {}
        self.span_calls = {}
        self.profile = None


def span_targets(cell) -> list:
    out = []
    for _, spec in cell.per_layer:
        if spec["reader"] == "span_ms" and spec["target"] not in out:
            out.append(spec["target"])
    return out


def kernel_costs(cell) -> dict:
    names = []
    for _, spec in cell.per_layer:
        for k in spec.get("kernels", ()):
            if k not in names:
                names.append(k)
    return {k: importlib.import_module(f"portbench.kernels.{k}")
            for k in names}


def is_cuda(device) -> bool:
    return str(device).startswith("cuda")


def sync(torch, device):
    if is_cuda(device):
        torch.cuda.synchronize(device)


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def measure(torch, path, cell, seconds, trace_on, device, keep_going=None,
            profile_here=True):
    """Set-up is done: the window (spans synced when tracing), then with
    tracing on a card the two profiled windows of ``trace.profile``, each
    of ``path.profile_requests`` requests (rank 0 alone profiles; the
    other ranks run the same requests).
    Returns (window tuple, kept outputs {pool index: [output]}, Context,
    memory peak)."""
    kept = {}

    def sink(i, out):
        if path.keep(i):
            kept.setdefault(path.pool_index(i), []).append(out)

    ctx = Context()
    targets = span_targets(cell) if trace_on else []
    spans = trace.Spans(torch, targets, synced=True) if trace_on \
        else nullcontext()
    with spans:
        opened, closed, records = window.closed_loop(
            path.request, seconds, sink, keep_going)
    ctx.requests = len(records)
    if trace_on:
        ctx.span_seconds, ctx.span_calls = spans.seconds, spans.calls
    if trace_on and is_cuda(device):
        n = path.profile_requests
        runs = [len(records)]

        def run():
            first = runs[-1]
            for i in range(first, first + n):
                sink(i, path.request(i))
            runs.append(first + n)
        if profile_here:
            ctx.profile = trace.profile(torch, run, kernel_costs(cell),
                                        targets)
            ctx.profile["requests"] = n
        else:
            run()
            run()
    sync(torch, device)
    peak = torch.cuda.max_memory_allocated(device) if is_cuda(device) else 0
    return (opened, closed, records), kept, ctx, peak


def check(torch, path, kept):
    """Free the program's state, run the reference on the sampled pool
    requests, compare every kept output. Returns the tally."""
    path.release()
    gc.collect()
    if is_cuda(path.device):
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    refs = path.reference()
    t = path.tally()
    for p, outs in kept.items():
        for out in outs:
            path.compare(t, out, refs[p])
    log(f"check: {t.compared} outputs of pool requests {sorted(kept)} "
        f"against the reference in {time.perf_counter() - t0:.1f} s")
    return t


def judge(values: dict, compared: int, limits: dict):
    """(correct, {name: {"value", "limit"}}): correct when something was
    compared and every number is at or under its limit."""
    judged = {n: {"value": v, "limit": limits[n]} for n, v in values.items()}
    return compared > 0 and all(j["value"] <= j["limit"]
                                for j in judged.values()), judged


def metrics(cell, trace_on, win, ctx, setup_s, work) -> dict:
    opened, closed, records = win
    out = {}
    if not trace_on:
        for m in cell.end_to_end:
            out[m["name"]] = {"value": window.end_to_end(
                m["name"], opened, closed, records, work, setup_s),
                "unit": m["unit"]}
        return out
    return per_layer(cell, ctx)


def in_process(metric: dict) -> bool:
    """Whether a per-layer metric reads the state of the process that ran
    the requests (the program's recorder, the harness's spans), not the
    profile: its ``source`` is not ``device_trace``."""
    return metric["source"] != "device_trace"


def per_layer(cell, ctx, pick=None) -> dict:
    """The per-layer metrics (those ``pick`` accepts) whose readers find
    something in ``ctx``, in the cell's order."""
    out = {}
    for m, spec in cell.per_layer:
        if pick is not None and not pick(m):
            continue
        reader = importlib.import_module(f"portbench.readers.{spec['reader']}")
        v = reader.read(spec, ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


NOISE = ("void ", "at::native::", "(anonymous namespace)::", "at::",
         "std::", "binary_internal::", "gpu_kernel_impl_nocast<")


def short(name: str, width: int = 96) -> str:
    """A device operation's name without its namespaces, cut to
    ``width`` characters."""
    for n in NOISE:
        name = name.replace(n, "")
    name = " ".join(name.split())
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(profile) -> dict:
    return {"device_ops": [[short(n), s] for n, s in profile["device_ops"]],
            "idle_gaps": [[n, s] for n, s in profile["idle_gaps"]]}


def run(torch, cell, seed, seconds, trace_on, device, started,
        program=PROGRAM, wrap=None) -> dict:
    """One run in this process; ``started`` is the perf_counter reading
    when the run began; ``wrap`` (the control) wraps the path driver.
    Returns the result dict (``check`` last)."""
    mod = importlib.import_module(f"portbench.paths.{cell.config['entry']}")
    path = mod.Path(torch, cell, seed, device, program)
    if wrap is not None:
        path = wrap(path)
    path.setup()
    sync(torch, device)
    setup_s = time.perf_counter() - started
    win, kept, ctx, peak = measure(torch, path, cell, seconds, trace_on,
                                   device)
    log(f"window: {len(win[2])} requests in {win[1] - win[0]:.3f} s")
    work = path.points_per_request
    t = check(torch, path, kept)
    correct, judged = judge(t.values, t.compared, cell.config["limits"])
    return result(cell, device_kind(torch, device), correct, len(win[2]),
                  metrics(cell, trace_on, win, ctx, setup_s, work), peak,
                  ctx.profile, judged)


def device_kind(torch, device) -> str:
    return torch.cuda.get_device_name(device) if is_cuda(device) else "cpu"


def result(cell, kind, correct, attempted, values, peak, profile,
           judged) -> dict:
    """The result line's dict; ``kind`` "cpu" only in the tests' runs."""
    dev = {"platform": "cpu" if kind == "cpu" else "gpu", "kind": kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": attempted, "failed": 0,
           "metrics": values, "device": dev}
    if profile is not None:
        dev["busy_s"] = profile["busy_s"]
        dev["window_s"] = profile["window_s"]
        out["breakdown"] = breakdown(profile)
    out["check"] = judged
    return out
