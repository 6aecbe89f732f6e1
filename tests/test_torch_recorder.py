"""The request recorder of ``utils/profiling``: the span tree and counters
of a stream and a frame request, the switch, the ring, the profiler
ranges, the benchmark's reader of it, and (on the card, marked ``cuda``)
that every host sync of a request is counted.

Imports no JAX: on a card machine run
``python3 -m pytest --noconftest tests/test_torch_recorder.py``.
"""

import ast
import collections
import importlib
import json
import sys
import traceback
import types
import warnings

import numpy as np
import pytest
import torch

from pcseg_tpu_torch.kernels import epoch_word
from pcseg_tpu_torch.models import config, pipeline, planar_batched
from pcseg_tpu_torch.ops import unproject
from pcseg_tpu_torch.utils import profiling
from pcseg_tpu_torch.utils.synthetic import synthetic_cluttered_room_cloud
from portbench.bench import harness, spec
from portbench.readers import program_trace
from portbench.tests.helpers import small_cell

torch.set_num_threads(1)

H, W = 48, 64
STREAM_SPANS = {"unproject": "request.stream", "normals": "request.stream",
                "seeds": "request.stream", "grower": "request.stream",
                "grower.stage_a": "grower", "grower.closure": "grower",
                "grower.tail": "grower", "clusters": "request.stream"}
FRAME_SPANS = {
    **{k: v.replace("stream", "frame") for k, v in STREAM_SPANS.items()},
    "discontinuity": "request.frame", "host_finalize": "request.frame",
    **{"finalize." + k: "host_finalize"
       for k in ("copy", "boundary", "classify", "recluster", "extract")}}
# the 16 metrics that read the recorder, by the request kind they read
RECORDER_METRICS = {
    kind: {f"{m}.{kind}" for m in (
        "host_syncs", "sync_wait_ms", "grower_epochs", "grower_stage_a_ms",
        "grower_closure_ms", "grower_tail_ms", "stage_a_graph_replays",
        "closure_graph_replays")}
    for kind in ("stream", "frame")}


def scenes(h, w, n):
    rays = unproject.camera_ray_table(h, w, f=float(h))
    d16 = np.stack([unproject.encode_range(synthetic_cluttered_room_cloud(
        h, w, f=float(h), seed=s)[0]) for s in range(1, n + 1)])
    return d16, rays


def parents(req):
    """{span name: the names of the spans that hold one}."""
    out = collections.defaultdict(set)
    for s in req.spans:
        out[s.name].add(req.spans[s.parent].name if s.parent >= 0 else None)
    return out


def epoch_spy(monkeypatch, k_cap=32):
    """Count the grower's epoch steps: one epoch-kernel call each in the
    word step (K <= 32), one flood each in the flood step (K > 32; the
    full-grid stage A of grids under 64 rows floods nothing)."""
    calls = []
    mod, name = (epoch_word, "epoch_word") if k_cap <= 32 \
        else (planar_batched, "flood_fill_static")
    real = getattr(mod, name)

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(mod, name, spy)
    return calls


def freeze_tests(req):
    """The freeze tests the flood step's closure loop made: one before
    every epoch but the first, and one more where it stopped before the
    schedule's end."""
    ran = req.counters["grower.epochs"]
    return ran - 1 + (ran < req.counters["grower.epochs_scheduled"])


def check_tree(req, expected):
    assert req.spans[0].name == f"request.{req.kind}"
    assert req.spans[0].parent == -1
    got = parents(req)
    for name, parent in expected.items():
        assert parent in got[name], (name, got[name])
    for i, s in enumerate(req.spans):
        assert s.t1 is not None and s.t1 >= s.t0
        if i:
            p = req.spans[s.parent]
            assert s.parent < i and p.t0 <= s.t0 and s.t1 <= p.t1
        if s.name.startswith("sync:"):
            assert s.syncs >= 1 and not any(
                c.parent == i for c in req.spans)
        else:
            assert s.syncs == 0
    assert req.counters["host_syncs"] == sum(s.syncs for s in req.spans)
    assert req.counters["sync_wait_ns"] == sum(
        s.t1 - s.t0 for s in req.spans if s.syncs)


def sync_sites(req):
    out = collections.Counter()
    for s in req.spans:
        out[s.name] += s.syncs
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("k_cap", [32, 40])
def test_a_stream_request_records_its_span_tree(monkeypatch, k_cap):
    """At 32 slots the closure runs the word step, every scheduled epoch
    with the freeze on the device and no host sync; at 40 the flood step,
    whose loop tests the freeze on the host."""
    d16, rays = scenes(H, W, 2)
    seg = pipeline.Segmenter(config.SegmenterConfig(
        planar=config.PlanarRegionConfig(max_regions=k_cap)), device="cpu")
    calls = epoch_spy(monkeypatch, k_cap)
    n0 = len(profiling.requests())
    seg.device_forward_stream(d16, torch.from_numpy(rays), torch.zeros(3))
    reqs = profiling.requests()
    assert len(reqs) == n0 + 1 or len(reqs) == profiling.RING
    req = reqs[-1]
    assert req.kind == "stream" and req.id > 0
    check_tree(req, STREAM_SPANS)
    assert req.counters["grower.epochs"] == len(calls) > 0
    assert req.counters["grower.epochs_scheduled"] >= len(calls)
    # the depth frames come from host memory; rays and origin are tensors
    # on the device already
    want = {"sync:input": 1, "sync:clusters.threshold": 1}
    if k_cap <= 32:
        assert req.counters["grower.epochs_scheduled"] == len(calls)
    else:
        assert parents(req)["sync:grower.freeze"] == {"grower.closure"}
        want["sync:grower.freeze"] = freeze_tests(req)
    assert sync_sites(req) == want


def test_a_frame_request_records_its_span_tree(monkeypatch):
    d16, rays = scenes(H, W, 1)
    seg = pipeline.Segmenter(device="cpu")
    calls = epoch_spy(monkeypatch)
    res = seg.segment_frame_stream(d16[0], rays, np.zeros(3, np.float32))
    req = profiling.requests()[-1]
    assert req.kind == "frame"
    check_tree(req, FRAME_SPANS)
    assert req.counters["grower.epochs"] == len(calls) == \
        req.counters["grower.epochs_scheduled"]
    reclustered = res.metrics.num_planar_regions != \
        res.metrics.num_device_planar_regions
    want = {"sync:rays": 1, "sync:input": 2, "sync:rot": 1,
            "sync:discontinuity.gates": 6,
            "sync:clusters.threshold": 1 + reclustered,
            "sync:payload": 13}
    if reclustered:
        want.update({"sync:recluster": 1, "sync:recluster.read": 3})
        assert parents(req)["sync:recluster.read"] == {"finalize.recluster"}
        assert parents(req)["clusters"] == {"request.frame",
                                            "finalize.recluster"}
    assert sync_sites(req) == want
    # the ray table stays on the device between calls with the same table
    seg.segment_frame_stream(d16[0], rays, np.zeros(3, np.float32))
    assert "sync:rays" not in sync_sites(profiling.requests()[-1])


def test_a_public_call_inside_a_request_joins_it():
    d16, rays = scenes(H, W, 1)
    seg = pipeline.Segmenter(device="cpu")
    with profiling.request("outer") as outer:
        seg.device_forward_stream(d16, torch.from_numpy(rays),
                                  torch.zeros(3))
        assert profiling.current() is outer
    assert profiling.current() is None
    req = profiling.requests()[-1]
    assert req is outer and req.kind == "outer"
    assert parents(req)["grower"] == {"request.outer"}
    assert all(s.name != "request.stream" for s in req.spans)


def test_the_sharded_step_records_a_request():
    """One rank of its own (no process group): the step's request and its
    stages; a single rank gathers nothing."""
    from pcseg_tpu_torch.parallel import halo, sharded
    d16, rays = scenes(H, W, 1)
    pts = unproject.unproject_range_np(d16[0], rays,
                                       unproject.DEFAULT_DEPTH_SCALE)
    comm = halo.Comm(device="cpu")
    sharded.build_sharded_segment_step(comm)(pts, np.zeros(3, np.float32))
    req = profiling.requests()[-1]
    assert req.kind == "sharded"
    check_tree(req, {k: "request.sharded"
                     for k in ("normals", "seeds", "grower", "clusters")})
    assert parents(req)["grower.closure"] == {"grower"}
    # points and origin from host memory; the flood epochs (the backend's
    # path at any K): their freeze tests, and each flood's test for a
    # change across the blocks; the local and the cross-block cluster
    # thresholds; the union-find's rounds
    sites = sync_sites(req)
    assert set(sites) == {"sync:input", "sync:grower.freeze",
                          "sync:sharded.flood", "sync:clusters.threshold",
                          "sync:sharded.union_find"}
    assert sites["sync:input"] == sites["sync:clusters.threshold"] == 2
    assert sites["sync:grower.freeze"] == freeze_tests(req)
    assert sites["sync:sharded.flood"] >= req.counters["grower.epochs"]
    assert comm.gathers == 0 and "comm.all_gather" not in parents(req)


def test_recording_off_records_nothing():
    d16, rays = scenes(H, W, 1)
    seg = pipeline.Segmenter(device="cpu")
    before = profiling.requests()
    names = ("host_syncs", "sync_wait_ns", "grower.epochs", "unit.count")
    totals = [profiling.total(n) for n in names]
    was = profiling.recording(False)
    try:
        seg.device_forward_stream(d16, torch.from_numpy(rays),
                                  torch.zeros(3))
        with profiling.request("unit") as req, profiling.stage("unit"), \
                profiling.blocking("unit"):
            profiling.count("unit.count")
        assert req is None and profiling.current() is None
    finally:
        profiling.recording(was)
    after = profiling.requests()
    assert len(after) == len(before) and all(
        a is b for a, b in zip(after, before))
    assert [profiling.total(n) for n in names] == totals


def test_counters_and_syncs_outside_a_request_reach_the_totals():
    n0, s0 = profiling.total("unit.loose"), profiling.total("host_syncs")
    profiling.count("unit.loose", 3)
    with profiling.blocking("unit", 2):
        pass
    assert profiling.total("unit.loose") == n0 + 3
    assert profiling.total("host_syncs") == s0 + 2


def test_the_ring_is_bounded():
    first = None
    for i in range(profiling.RING + 6):
        with profiling.request("ring") as req:
            profiling.count("ring.i", i)
        first = first or req.id
    reqs = profiling.requests()
    assert len(reqs) == profiling.RING
    assert [r.id for r in reqs] == list(range(req.id - profiling.RING + 1,
                                              req.id + 1))
    assert reqs[-1].counters["ring.i"] == profiling.RING + 5
    assert reqs[0].id > first


def test_program_spans_nest_under_the_request_in_a_trace(tmp_path):
    d16, rays = scenes(H, W, 1)
    seg = pipeline.Segmenter(device="cpu")
    with profiling.trace_to(str(tmp_path)) as path:
        seg.device_forward_stream(d16, torch.from_numpy(rays),
                                  torch.zeros(3))
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append((e["ts"],
                                                  e["ts"] + e["dur"]))

    def inside(child, parent):
        (p0, p1), = by_name[parent]
        return all(p0 <= c0 and c1 <= p1 for c0, c1 in by_name[child])

    for child, parent in STREAM_SPANS.items():
        assert inside(child, parent), (child, parent)
    assert inside("sync:clusters.threshold", "clusters")
    assert inside("sync:input", "request.stream")


def test_stage_outside_a_request_records_nothing_but_its_range():
    n0 = len(profiling.requests())
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.stage("unit.alone"):
            torch.ones(8).sum()
    assert "unit.alone" in {e.key for e in prof.key_averages()}
    assert len(profiling.requests()) in (n0, profiling.RING)


# -- the benchmark's reader ---------------------------------------------------


def ctx_of(requests, profiled=None):
    ctx = harness.Context()
    ctx.requests = requests
    ctx.profile = None if profiled is None else {"requests": profiled}
    return ctx


def test_program_trace_reads_the_median_of_the_window():
    # 2 warm-up requests, 3 in the window, 2 x 1 profiled
    for v in (100, 100, 5, 1, 3, 100, 100):
        with profiling.request("unit.window"):
            profiling.count("unit.v", v)
            with profiling.stage("unit.span"):
                pass
    ctx = ctx_of(3, profiled=1)
    got = program_trace.read({"request": "unit.window", "counter": "unit.v",
                              "scale": 2}, ctx)
    assert got == 6
    assert program_trace.read({"request": "unit.window",
                               "counter": "unit.none"}, ctx) == 0
    span = program_trace.read({"request": "unit.window",
                               "span": "unit.span"}, ctx)
    assert 0 <= span < 1e3
    assert program_trace.read({"request": "unit.window",
                               "counter": "unit.v"}, ctx_of(3)) == 100


def test_program_trace_reads_nothing_without_the_program(monkeypatch):
    with profiling.request("unit.gone"):
        profiling.count("unit.v", 1)
    s = {"request": "unit.gone", "counter": "unit.v"}
    assert program_trace.read(s, ctx_of(1)) == 1
    assert program_trace.read({"request": "unit.never", "counter": "unit.v"},
                              ctx_of(1)) is None
    assert program_trace.read(s, ctx_of(0)) is None
    # a program whose tracing module keeps no recorder (the parent's)
    monkeypatch.setitem(sys.modules, program_trace.RECORDER,
                        types.ModuleType(program_trace.RECORDER))
    assert program_trace.read(s, ctx_of(1)) is None
    # no program loaded (the control's runs)
    monkeypatch.delitem(sys.modules, program_trace.RECORDER)
    assert program_trace.read(s, ctx_of(1)) is None


def test_program_trace_imports_nothing_of_the_program():
    tree = ast.parse(open(program_trace.__file__).read())
    imported = {a.name for n in ast.walk(tree)
                if isinstance(n, (ast.Import, ast.ImportFrom))
                for a in n.names} | {
        n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
    assert imported <= {"statistics", "sys"}


@pytest.mark.parametrize("workload", ["stream_cluttered", "stream_room",
                                      "frame_cluttered"])
def test_traced_metrics_of_a_small_cell_read_the_recorder(workload):
    """``harness.metrics`` with tracing on, over a small cell's requests
    on the CPU, gives every recorder metric of the cell (the harness's
    spans and the profile, which need a card, give nothing here)."""
    cell = small_cell(workload, batch=2 if "stream" in workload else None)
    path = importlib.import_module(
        f"portbench.paths.{cell.config['entry']}").Path(
            torch, cell, 2 ** 31 + 5, "cpu")
    path.setup()
    for i in range(2):
        path.request(i)
    got = harness.metrics(cell, True, (0.0, 1.0, [(0, 1)] * 2),
                          ctx_of(2), 0.0, path.points_per_request)
    kind = "stream" if "stream" in workload else "frame"
    assert set(got) == RECORDER_METRICS[kind]
    declared = {m["name"] for m in spec.benchmark()["per_layer"]
                if spec.applies(m, workload)}
    assert RECORDER_METRICS[kind] <= declared
    assert got[f"grower_epochs.{kind}"]["value"] >= 1
    # a stream request syncs at its input and the cluster threshold alone
    if kind == "stream":
        assert got["host_syncs.stream"]["value"] == 2
    else:
        assert got["host_syncs.frame"]["value"] >= 3
    assert got[f"sync_wait_ms.{kind}"]["value"] > 0
    for part in ("stage_a", "closure", "tail"):
        assert got[f"grower_{part}_ms.{kind}"]["value"] > 0
    # the CPU's stage A and closure run eagerly: no graph
    assert got[f"stage_a_graph_replays.{kind}"]["value"] == 0
    assert got[f"closure_graph_replays.{kind}"]["value"] == 0


# -- on the card -------------------------------------------------------------


def count_sync_warnings(run):
    """Run ``run()`` under ``torch.cuda.set_sync_debug_mode("warn")``:
    (its result, {innermost open span at each sync warning: count},
    stacks of the warnings outside a ``sync:`` span)."""
    seen = collections.Counter()
    outside = []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing CUDA operation" not in str(message):
            return
        req = profiling.current()
        where = req.innermost() if req is not None else None
        seen[where] += 1
        if where is None or not where.startswith("sync:"):
            outside.append(f"{where}:\n" + "".join(
                traceback.format_stack(limit=14)[:-1]))

    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, dict(seen), outside


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["stream", "frame"])
def test_every_host_sync_of_a_vga_request_is_counted(path):
    """One VGA request of each path: the card's sync warnings equal the
    request's ``host_syncs``, site by site, and none falls outside a
    ``sync:`` span; the normals launch their kernel once."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    d16, rays = scenes(480, 640, 2)
    seg = pipeline.Segmenter(device="cuda")
    if path == "stream":
        rays_d = torch.from_numpy(rays).cuda()
        origin = torch.zeros(3, device="cuda")

        def run():
            return seg.device_forward_stream(d16, rays_d, origin)
    else:
        def run():
            return seg.segment_frame_stream(d16[1], rays,
                                            np.zeros(3, np.float32))
    run()  # builds the kernels, caches the ray table
    out, seen, outside = count_sync_warnings(run)
    req = profiling.requests()[-1]
    assert req.kind == path
    assert not outside, "host syncs outside a sync: span:\n" + \
        "\n".join(outside)
    assert seen == sync_sites(req)
    assert sum(seen.values()) == req.counters["host_syncs"]
    # K = 32: one epoch kernel launch per closure epoch
    assert req.counters["grower.epochs"] == \
        req.counters.get("launches.epoch_word", 0) > 0
    # the normals: one support kernel launch per request
    assert req.counters.get("launches.normal_support") == 1
