"""The grower's patched stage A replayed as a CUDA graph
(``models/planar_batched._stage_a_replayed``): on the CPU, that the CPU
path takes no graph; on the card (marker ``cuda``), the replayed grower
against the eager one, bit for bit over its whole ``PlanarRegions``, the
graph's key and its counters, and the paths that take no graph.

Imports no JAX: on a card machine run
``python3 -m pytest --noconftest tests/test_torch_stage_a_graph.py``.
"""

import dataclasses
import functools
import json
import os

import pytest
import torch

from pcseg_tpu_torch.models import config, planar_batched
from pcseg_tpu_torch.models.config import UNLABELED
from pcseg_tpu_torch.ops import normals as normals_op
from pcseg_tpu_torch.ops import seeds as seeds_op
from pcseg_tpu_torch.ops import unproject
from pcseg_tpu_torch.parallel import halo, sharded
from pcseg_tpu_torch.utils import profiling
from pcseg_tpu_torch.utils.synthetic import synthetic_cluttered_room_cloud
from portbench.traffic import generate, scenes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CAPTURES = "grower.stage_a_graph_captures"
REPLAYS = "grower.stage_a_graph_replays"
CFG = config.SegmenterConfig()


def counters():
    return profiling.total(CAPTURES), profiling.total(REPLAYS)


def small_cloud(h, w, seed):
    """[H, W, 3] f32 points of a cluttered room through the u16 range
    encoding (NaN where the range is 0)."""
    rays = unproject.camera_ray_table(h, w, f=float(h))
    return unproject.unproject_range_np(unproject.encode_range(
        synthetic_cluttered_room_cloud(h, w, f=float(h), seed=seed)[0]),
        rays)


@functools.lru_cache(maxsize=None)
def mix_points(config_name, mix_name, seed=20261018):
    """The first request of a benchmark mix as [B, H, W, 3] f32 points."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           config_name + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "portbench", "mixes",
                           mix_name + ".json")) as f:
        mix = json.load(f)
    frame = cfg["frame"]
    u16 = generate.pool(mix, frame, cfg["batch"], seed)[0]
    rays, _ = generate.rays_and_origin(frame)
    return scenes.unproject_range_np(u16, rays, frame["depth_scale"])


def grower_args(points):
    """The grower's arguments as the ``Segmenter`` makes them from
    [B, H, W, 3] points: (points, normals, labels, seed indices, seed
    valid), and the rank grid."""
    nrm = normals_op.compute_normals_organized(
        points, torch.zeros(3, device=points.device), CFG.normals)
    ranked = seeds_op.seeds_from_plane_support(points, nrm,
                                               CFG.plane_support_seeds)
    labels = torch.full(points.shape[:3], UNLABELED, dtype=torch.int32,
                        device=points.device)
    return (points, nrm, labels, ranked.indices, ranked.valid), \
        ranked.rank_grid


def grow(args, rank_grid, planar=CFG.planar):
    return planar_batched.grow_planar_regions_batched(
        *args, planar, seed_rank_grid=rank_grid)


def grow_eager(monkeypatch, args, rank_grid, planar=CFG.planar):
    """The grower with stage A run eagerly on the card."""
    with monkeypatch.context() as m:
        m.setattr(planar_batched, "_stage_a_replayed",
                  planar_batched._stage_a_patched)
        before = counters()
        out = grow(args, rank_grid, planar)
        assert counters() == before
    return out


def leaves(regions):
    """(name, tensor) of every field of a PlanarRegions, the moments'
    fields included."""
    for name, v in zip(regions._fields, regions):
        if name == "moments":
            yield from ((f"moments.{n}", t) for n, t in zip(v._fields, v))
        else:
            yield name, v


def assert_identical(got, want):
    """Every field equal byte for byte (NaN equal to itself, -0 apart from
    +0)."""
    for (name, a), (_, b) in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), name


# -- the CPU path ------------------------------------------------------------

def test_the_cpu_path_takes_no_graph(monkeypatch):
    """At 128x128 (patched stage A) on the CPU: the eager patched stage
    runs, nothing is captured or replayed."""
    ran = []
    real = planar_batched._stage_a_patched

    def spy(*a, **kw):
        ran.append(kw["k_cap"])
        return real(*a, **kw)

    def refuse(*a, **kw):
        raise AssertionError("a graph on the CPU")

    monkeypatch.setattr(planar_batched, "_stage_a_patched", spy)
    monkeypatch.setattr(planar_batched, "_stage_a_replayed", refuse)
    before = counters()
    args, rank_grid = grower_args(
        torch.from_numpy(small_cloud(128, 128, 4))[None])
    res = grow(args, rank_grid)
    assert ran == [CFG.planar.max_regions]
    assert counters() == before
    assert int(res.num_regions) > 0


# -- on the card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


SHAPES = {
    "b8_k32": ("vga_stream_b8", "cluttered_cameras", 32),
    "b1_k32": ("vga_frame", "cluttered_robot", 32),
    "b8_k64": ("vga_stream_k64", "carton_cameras", 64),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shape", list(SHAPES))
def test_the_replayed_grower_is_the_eager_one(card, monkeypatch, shape):
    """The benchmark's three shapes at VGA: the grower whose stage A
    replays its graph equals the eager grower byte for byte, at the
    capture's call and at a replay."""
    config_name, mix, k = SHAPES[shape]
    planar = dataclasses.replace(CFG.planar, max_regions=k)
    args, rank_grid = grower_args(
        torch.from_numpy(mix_points(config_name, mix)).to(card))
    want = grow_eager(monkeypatch, args, rank_grid, planar)
    for _ in range(2):
        before = counters()
        got = grow(args, rank_grid, planar)
        assert counters()[1] == before[1] + 1
        assert_identical(got, want)
    assert int(want.num_regions.min()) > 0


@pytest.mark.cuda
def test_two_inputs_replayed_in_turn_both_match(card, monkeypatch):
    """Two batches of one shape replayed in turn (A, B, A): each equals
    its eager run, so no static buffer keeps an earlier input."""
    runs = []
    for mix in ("cluttered_cameras", "room_cameras"):
        args, rank_grid = grower_args(
            torch.from_numpy(mix_points("vga_stream_b8", mix)).to(card))
        runs.append((args, rank_grid,
                     grow_eager(monkeypatch, args, rank_grid)))
    assert not torch.equal(runs[0][2].labels, runs[1][2].labels)
    for args, rank_grid, want in (runs[0], runs[1], runs[0]):
        assert_identical(grow(args, rank_grid), want)


@pytest.mark.cuda
def test_a_changed_plane_distance_captures_a_new_graph(card, monkeypatch):
    """``max_plane_distance`` is baked into the capture: another value
    takes its own graph, whose grower equals the eager one at that
    value."""
    args, rank_grid = grower_args(
        torch.from_numpy(mix_points("vga_frame", "cluttered_robot")).to(card))
    base = grow(args, rank_grid)
    planar = dataclasses.replace(CFG.planar, max_plane_distance=0.04)
    before = counters()
    got = grow(args, rank_grid, planar)
    assert counters() == (before[0] + 1, before[1] + 1)
    assert_identical(got, grow_eager(monkeypatch, args, rank_grid, planar))
    assert not torch.equal(got.labels, base.labels)


@pytest.mark.cuda
def test_one_capture_then_one_replay_a_call(card):
    """A shape no other test uses (3 x 128 x 160): its first call
    captures, a host sync of its request (as the closure's capture is),
    and replays; each later call replays once and syncs nothing more."""
    args, rank_grid = grower_args(torch.stack([
        torch.from_numpy(small_cloud(128, 160, s)) for s in (1, 2, 3)])
        .to(card))
    before = counters()
    syncs = []
    for i in range(1, 4):
        with profiling.request("stream") as req:
            grow(args, rank_grid)
        assert counters() == (before[0] + 1, before[1] + i)
        assert req.counters[REPLAYS] == 1
        assert req.counters.get(CAPTURES, 0) == (i == 1)
        capture = [s for s in req.spans
                   if s.name == "sync:grower.stage_a_capture"]
        assert len(capture) == (i == 1)
        # the word-step closure's own graph captures at the first call too
        closure = [s for s in req.spans
                   if s.name == "sync:grower.closure_capture"]
        assert len(closure) == (i == 1)
        syncs.append(req.counters.get("host_syncs", 0) - len(capture)
                     - len(closure))
    assert syncs[0] == syncs[1] == syncs[2]


@pytest.mark.cuda
def test_small_grids_and_the_sharded_step_take_no_graph(card):
    """The full-grid stage A (a 48x64 grid) and the sharded step (stage A
    on the full grid of its column block, one rank here) capture and
    replay nothing."""
    before = counters()
    args, rank_grid = grower_args(
        torch.from_numpy(small_cloud(48, 64, 5))[None].to(card))
    assert int(grow(args, rank_grid).num_regions) > 0
    step = sharded.build_sharded_segment_step(halo.Comm(device=card))
    step(torch.from_numpy(small_cloud(128, 160, 6)).to(card),
         torch.zeros(3, device=card))
    torch.cuda.synchronize()
    assert counters() == before
