#!/usr/bin/env python3
"""What the request recorder of ``utils/profiling`` sees, and what it
costs, on the benchmark's stream and frame traffic.

    python3 tools/recorder_report.py [--requests N] [--seed S] [--out FILE]

For each of the cells ``stream_cluttered`` and ``frame_cluttered``
(``portbench``'s drivers, at their real sizes, the program in this
checkout): after the drivers' two warm-up requests, N requests with the
recorder on alternate with N with it off (``recording(True)`` /
``recording(False)``), each timed on the host clock. Then, from the
recorded requests:

  * per ``sync:<site>``: host syncs per request and the median ms waited
    there per request;
  * the recorder's own host cost per request: each recorded request's
    spans and counters replayed without the program (the same nesting and
    names) with the recorder on, off, and on under a running
    ``torch.profiler`` (the profiler-gated ranges), in µs per request.

Prints one JSON line per cell, with the card's name and power limit, and
writes them to ``--out`` as well. Needs a CUDA card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def quartiles(values):
    q = statistics.quantiles(values, n=4) if len(values) > 1 \
        else [values[0]] * 3
    return {"median": q[1], "q1": q[0], "q3": q[2]}


def sync_table(reqs):
    """{site: {"syncs": per request, "wait_ms": median per request}}."""
    sites = sorted({s.name for r in reqs for s in r.spans if s.syncs})
    out = {}
    for site in sites:
        syncs = [sum(s.syncs for s in r.spans if s.name == site)
                 for r in reqs]
        waits = [r.span_ns(site) * 1e-6 for r in reqs]
        out[site] = {"syncs": statistics.median(syncs),
                     "wait_ms": statistics.median(waits)}
    return out


def replayer(profiling, req):
    """A function that makes the recorder calls of ``req`` again: its
    spans in their nesting, its counters one ``count`` each."""
    children = {i: [] for i in range(len(req.spans))}
    for i, s in enumerate(req.spans[1:], 1):
        children[s.parent].append(i)
    counts = [(k, v) for k, v in req.counters.items()
              if k not in ("host_syncs", "sync_wait_ns")]

    def span(i):
        s = req.spans[i]
        cm = profiling.blocking(s.name[5:], s.syncs) if s.syncs \
            else profiling.stage(s.name)
        with cm:
            for c in children[i]:
                span(c)

    def run():
        with profiling.request("replay." + req.kind):
            for c in children[0]:
                span(c)
            for k, v in counts:
                for _ in range(v if k != "grower.epochs_scheduled" else 1):
                    profiling.count(k)

    return run


def replay_us(profiling, torch, reqs, on, profiled, reps=20):
    """Median µs per request of replaying ``reqs``' recorder calls."""
    runs = [replayer(profiling, r) for r in reqs]
    was = profiling.recording(on)
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU]) if profiled \
        else None
    times = []
    try:
        if prof is not None:
            prof.__enter__()
        for _ in range(reps):
            t0 = time.perf_counter_ns()
            for run in runs:
                run()
            times.append((time.perf_counter_ns() - t0) / len(runs) * 1e-3)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
        profiling.recording(was)
    return statistics.median(times)


def cell_report(torch, workload, n, seed, card):
    import importlib
    from portbench.bench import spec
    from pcseg_tpu_torch.utils import profiling
    cell = spec.Cell(workload)
    path = importlib.import_module(
        f"portbench.paths.{cell.config['entry']}").Path(
            torch, cell, seed, "cuda:0")
    path.setup()
    torch.cuda.synchronize()
    wall = {True: [], False: []}
    recorded = []
    kind = cell.config["entry"]
    for i in range(2 * n):
        on = i % 2 == 0
        was = profiling.recording(on)
        try:
            t0 = time.perf_counter()
            path.request(2 + i)
            wall[on].append((time.perf_counter() - t0) * 1e3)
        finally:
            profiling.recording(was)
        if on:
            last = profiling.requests()[-1]
            assert last.kind == kind, last.kind
            recorded.append(last)
    spans = [len(r.spans) for r in recorded]
    events = [len(r.spans) + sum(v for k, v in r.counters.items()
                                 if k not in ("host_syncs", "sync_wait_ns",
                                              "grower.epochs_scheduled"))
              + 1 for r in recorded]
    out = dict(
        cell=workload, card=card, seed=seed, requests_each=n,
        wall_ms_on=quartiles(wall[True]), wall_ms_off=quartiles(wall[False]),
        spans_per_request=statistics.median(spans),
        recorder_calls_per_request=statistics.median(events),
        host_syncs=statistics.median(r.counters["host_syncs"]
                                     for r in recorded),
        sync_wait_ms=statistics.median(r.counters["sync_wait_ns"] * 1e-6
                                       for r in recorded),
        grower_epochs=statistics.median(r.counters["grower.epochs"]
                                        for r in recorded),
        launches=statistics.median(
            r.counters.get("launches.epoch_word", 0) for r in recorded),
        request_ms=statistics.median(r.span_ns("request." + kind) * 1e-6
                                     for r in recorded),
        sync_sites=sync_table(recorded),
        replay_us_on=replay_us(profiling, torch, recorded, True, False),
        replay_us_off=replay_us(profiling, torch, recorded, False, False),
        replay_us_profiled=replay_us(profiling, torch, recorded, True, True))
    out["recorder_share_pct"] = 100.0 * out["replay_us_on"] * 1e-3 \
        / out["request_ms"]
    path.release()
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--requests", type=int, default=20)
    parser.add_argument("--seed", type=int, default=2 ** 31 + 1801)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("recorder_report: no CUDA card")
    from pcseg_tpu_torch import native
    from pcseg_tpu_torch.kernels import build
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    build.build_all()
    native.load_hostops()
    lines = []
    for workload in ("stream_cluttered", "frame_cluttered"):
        line = json.dumps(cell_report(torch, workload, args.requests,
                                      args.seed, card))
        print(line, flush=True)
        lines.append(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
