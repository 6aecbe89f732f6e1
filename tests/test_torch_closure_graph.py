"""The grower's word-step closure with its freeze on the device, replayed
as CUDA graphs between the epoch kernel's calls
(``models/planar_batched._word_closure``, ``_closure_replayed``): on the
CPU, the device freeze against the loop that stops when every frame froze,
on both epoch steps, and the word step's syncs; on the card (marker
``cuda``), the replayed grower against the eager one, bit for bit over its
whole ``PlanarRegions``, its counters, the paths that take no closure
graph, and a stream request's host syncs.

Imports no JAX: on a card machine run
``python3 -m pytest --noconftest tests/test_torch_closure_graph.py``.
"""

import dataclasses
import json
import os

import pytest
import torch

from pcseg_tpu_torch.models import pipeline, planar_batched
from pcseg_tpu_torch.ops import unproject
from pcseg_tpu_torch.parallel import halo, sharded
from pcseg_tpu_torch.utils import profiling
from pcseg_tpu_torch.utils.synthetic import synthetic_room_cloud
from portbench.traffic import generate
from tests.test_torch_stage_a_graph import (CFG, ROOT, assert_identical,
                                            grow, grower_args, mix_points,
                                            small_cloud)

torch.set_num_threads(1)

CAPTURES = "grower.closure_graph_captures"
REPLAYS = "grower.closure_graph_replays"

# frames (seed, plain room) whose closures freeze at different epochs of
# the default schedule, one never ("staggered"), and frames that all
# freeze before its end ("settled")
BATCHES = {
    (48, 64): {"staggered": [(1, False), (2, False), (1, True)],
               "settled": [(5, False), (3, True), (3, False)]},
    (128, 160): {"staggered": [(2, True), (1, False)],
                 "settled": [(2, True), (3, True)]},
}


def counters():
    return profiling.total(CAPTURES), profiling.total(REPLAYS)


def batch_points(h, w, frames):
    """[B, H, W, 3] f32 points of cluttered or plain rooms through the u16
    range encoding."""
    out = []
    for seed, room in frames:
        if room:
            rays = unproject.camera_ray_table(h, w, f=float(h))
            out.append(unproject.unproject_range_np(unproject.encode_range(
                synthetic_room_cloud(h, w, f=float(h), seed=seed)[0]), rays))
        else:
            out.append(small_cloud(h, w, seed))
    return torch.stack([torch.from_numpy(p) for p in out])


def frozen_at(actives):
    """Per frame the first epoch it sat out (None: it never froze), from
    the ``active`` masks of every epoch."""
    a = torch.stack(actives)
    return [int((~a[:, f]).nonzero()[0]) if (~a[:, f]).any() else None
            for f in range(a.shape[1])]


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("k", [32, 40])
@pytest.mark.parametrize("shape,batch", [
    (s, b) for s in BATCHES for b in ("staggered", "settled")])
def test_the_device_freeze_equals_the_early_exit_loop(monkeypatch, shape,
                                                      batch, k):
    """The closure with its freeze on the device (every scheduled epoch,
    frozen frames kept by ``_select_frames``) equals the loop that stops
    when every frame froze, byte for byte, on the word step (32 slots)
    and the flood step (40)."""
    args, rank_grid = grower_args(batch_points(*shape, BATCHES[shape][batch]))
    planar = dataclasses.replace(CFG.planar, max_regions=k)
    real_closure = planar_batched._closure
    real_select = planar_batched._select_frames
    runs = {}
    for host_freeze in (True, False):
        actives = []

        def closure(*a, _hf=host_freeze, **kw):
            return real_closure(*a, **{**kw, "host_freeze": _hf})

        def select(active, new, old, _seen=actives):
            _seen.append(active.clone())
            return real_select(active, new, old)

        monkeypatch.setattr(planar_batched, "_closure", closure)
        monkeypatch.setattr(planar_batched, "_select_frames", select)
        with profiling.request("unit.closure") as req:
            out = grow(args, rank_grid, planar)
        runs[host_freeze] = out, req, actives
    assert_identical(runs[False][0], runs[True][0])

    _, req, actives = runs[False]
    scheduled = req.counters["grower.epochs_scheduled"]
    assert req.counters["grower.epochs"] == len(actives) == scheduled
    assert "sync:grower.freeze" not in {s.name for s in req.spans}
    froze = frozen_at(actives)
    _, early, early_actives = runs[True]
    assert early.counters["grower.epochs"] == len(early_actives)
    if batch == "staggered":
        assert None in froze and len(set(froze)) > 1
        assert early.counters["grower.epochs"] == scheduled
    else:
        assert None not in froze
        assert early.counters["grower.epochs"] == max(froze) < scheduled


def test_the_word_step_syncs_nowhere_and_builds_its_bits_once():
    """The word step's grower on the CPU: no host sync in its first call
    or its second (no ``grower.kbits`` copy, no ``grower.freeze`` test);
    the slot bits are one tensor per device."""
    args, rank_grid = grower_args(batch_points(48, 64, [(1, False)]))
    for _ in range(2):
        with profiling.request("unit.word") as req:
            grow(args, rank_grid)
        assert req.counters.get("host_syncs", 0) == 0
        assert not any(s.name.startswith("sync:") for s in req.spans)
        assert req.counters["grower.epochs"] == \
            req.counters["grower.epochs_scheduled"]
    bits = planar_batched._kbits(torch.device("cpu"))
    assert bits is planar_batched._kbits(torch.device("cpu"))
    assert bits.dtype == torch.int32 and bits.tolist() == [
        (1 << k) - (1 << 32 if k == 31 else 0) for k in range(32)]


def test_a_capture_s_counts_are_diverted():
    """``profiling.diverted()`` (a graph's capture) takes the thread's
    counts into its dict alone, not into the open request or the totals;
    after the block, counts reach both again."""
    name = "unit.diverted"
    with profiling.request("unit.diverted") as req:
        with profiling.diverted() as seen:
            profiling.count(name, 3)
            with profiling.diverted() as inner:
                profiling.count(name)
            profiling.count(name)
        total = profiling.total(name)
        profiling.count(name, 2)
    assert seen == {name: 4} and inner == {name: 1}
    assert req.counters == {name: 2}
    assert profiling.total(name) == total + 2


def test_the_cpu_path_takes_no_closure_graph(monkeypatch):
    """At 128x160 on the CPU the word step runs eagerly: nothing is
    captured or replayed."""
    def refuse(*a, **kw):
        raise AssertionError("a graph on the CPU")

    monkeypatch.setattr(planar_batched, "_closure_replayed", refuse)
    before = counters()
    args, rank_grid = grower_args(batch_points(128, 160, [(4, False)]))
    assert int(grow(args, rank_grid).num_regions) > 0
    assert counters() == before


# -- on the card --------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


SHAPES = {
    "b8_k32": ("vga_stream_b8", "cluttered_cameras"),
    "b1_k32": ("vga_frame", "cluttered_robot"),
}


def grow_eager(monkeypatch, args, rank_grid, planar=CFG.planar):
    """The grower with the word-step closure run eagerly on the card."""
    with monkeypatch.context() as m:
        m.setattr(planar_batched, "_closure_replayed",
                  planar_batched._word_closure)
        before = counters()
        out = grow(args, rank_grid, planar)
        assert counters() == before
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_replayed_closure_is_the_eager_one(card, monkeypatch, shape):
    """The benchmark's K = 32 shapes at VGA on the mixes' first requests:
    the grower whose closure replays its graphs equals the eager grower
    byte for byte, at the capture's call and at a replay."""
    args, rank_grid = grower_args(
        torch.from_numpy(mix_points(*SHAPES[shape])).to(card))
    want = grow_eager(monkeypatch, args, rank_grid)
    for _ in range(2):
        before = counters()
        got = grow(args, rank_grid)
        assert counters()[1] == before[1] + 1
        assert_identical(got, want)
    assert int(want.num_regions.min()) > 0


@pytest.mark.cuda
def test_one_closure_capture_then_one_replay_a_call(card):
    """A shape no other test uses (2 x 96 x 128): the first call captures
    the closure, a host sync of its request, and replays it; each later
    call replays once, syncs nothing in the grower and runs every
    scheduled epoch, one B1 launch each."""
    args, rank_grid = grower_args(torch.stack([
        torch.from_numpy(small_cloud(96, 128, s)) for s in (7, 8)]).to(card))
    before = counters()
    scheduled = []
    for i in range(1, 4):
        with profiling.request("unit.closure_graph") as req:
            grow(args, rank_grid)
        assert counters() == (before[0] + 1, before[1] + i)
        assert req.counters[REPLAYS] == 1
        assert req.counters.get(CAPTURES, 0) == (i == 1)
        sites = {s.name: s.syncs for s in req.spans if s.syncs}
        if i == 1:
            assert sites.pop("sync:grower.closure_capture") == 1
            sites.pop("sync:grower.stage_a_capture", None)
        assert sites == {}
        scheduled.append(req.counters["grower.epochs_scheduled"])
        assert req.counters["grower.epochs"] == scheduled[-1] == \
            req.counters["launches.epoch_word"]
    # the capture's call also ran the warm-up's epochs
    assert scheduled[0] == 2 * scheduled[1] == 2 * scheduled[2] > 0


@pytest.mark.cuda
def test_the_flood_step_the_sharded_step_and_plain_take_no_closure_graph(
        card):
    """64 slots (the flood step), the sharded step (the flood step on a
    column block, one rank here) and ``impl="plain"`` capture and replay
    no closure graph."""
    before = counters()
    args, rank_grid = grower_args(
        torch.from_numpy(small_cloud(96, 128, 9))[None].to(card))
    assert int(grow(args, rank_grid, dataclasses.replace(
        CFG.planar, max_regions=64)).num_regions) > 0
    assert int(planar_batched.grow_planar_regions_batched(
        *args, CFG.planar, seed_rank_grid=rank_grid,
        impl="plain").num_regions) > 0
    step = sharded.build_sharded_segment_step(halo.Comm(device=card))
    step(torch.from_numpy(small_cloud(128, 160, 6)).to(card),
         torch.zeros(3, device=card))
    torch.cuda.synchronize()
    assert counters() == before


@pytest.mark.cuda
def test_a_stream_request_counts_two_host_syncs(card):
    """``device_forward_stream`` on the cluttered mix's first VGA batch of
    8 (u16 depth from host memory), after a warm-up that captures: its
    input and the cluster threshold are the request's only host syncs."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           "vga_stream_b8.json")) as f:
        frame = json.load(f)["frame"]
    with open(os.path.join(ROOT, "portbench", "mixes",
                           "cluttered_cameras.json")) as f:
        mix = json.load(f)
    u16 = generate.pool(mix, frame, 8, 20261018)[0]
    rays, origin = generate.rays_and_origin(frame)
    seg = pipeline.Segmenter(device=card)
    rays_d = torch.from_numpy(rays).to(card)
    origin_d = torch.from_numpy(origin).to(card)
    for _ in range(2):
        seg.device_forward_stream(u16, rays_d, origin_d,
                                  frame["depth_scale"])
    req = profiling.requests()[-1]
    assert req.kind == "stream"
    assert req.counters[REPLAYS] == 1
    assert {s.name: s.syncs for s in req.spans if s.syncs} == {
        "sync:input": 1, "sync:clusters.threshold": 1}
    assert req.counters["host_syncs"] == 2
