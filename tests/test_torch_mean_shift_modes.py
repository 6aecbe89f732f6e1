"""The mean shift on the pipeline's path (``growth="native"``): kernel M1
(``kernels/mean_shift_modes.py``) and the host-ops library split into its
shift (``pcseg_mean_shift_shift``) and its growth
(``pcseg_mean_shift_grow``).

On the CPU: M1's plain version against the library's shift, bit for bit
in every output field; the growth from those modes against the one-call
``pcseg_mean_shift_grid``; the regions read from the labels in one pass;
the spans and counters of a frame; ``segment_frame_stream`` with
``MEAN_SHIFT`` against the benchmark's plain reference; the benchmark's
cost of M1. On the card (marker ``cuda``): M1 against its plain version
and the library at VGA on the benchmark mix's frames, and one M1 launch
and one ``mean_shift.modes`` sync a frame.

Imports no JAX: on a card machine run
``python3 -m pytest --noconftest tests/test_torch_mean_shift_modes.py``.
"""

import dataclasses
import functools
import importlib
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from pcseg_tpu_torch import native
from pcseg_tpu_torch.kernels import mean_shift_modes as m1
from pcseg_tpu_torch.models import config, mean_shift, pipeline
from pcseg_tpu_torch.models.config import UNLABELED
from pcseg_tpu_torch.utils import profiling
from portbench.bench import compare
from portbench.paths import frame, frame_mean_shift
from portbench.paths.common import PROGRAM, REFERENCE
from portbench.tests.helpers import small_cell
from portbench.traffic import generate, scenes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = config.MeanShiftParams()
MS_CONFIG = config.SegmenterConfig(cluster=dataclasses.replace(
    config.ClusterRegionConfig(),
    cluster_method=config.ClusterMethod.MEAN_SHIFT))
SMALL = dict(rows=128, cols=160, f=128.0)
# (scene seed, whether the planar finalize's labels come first)
CASES = [(1, False), (2, False), (3, False), (1, True)]


def load(kind, name):
    with open(os.path.join(ROOT, "portbench", kind, name + ".json")) as f:
        return json.load(f)


MIX = load("mixes", "cluttered_objects_robot")


def mix_points(seed, frame):
    """A room of the mean-shift mix from ``seed`` at ``frame``'s size,
    through the u16 range encoding: [H, W, 3] f32."""
    pts = scenes.cluttered_room(frame["rows"], frame["cols"], f=frame["f"],
                                seed=seed, **MIX["scene"])
    rays, _ = generate.rays_and_origin(dict(frame, depth_scale=0.00025))
    return scenes.unproject_range_np(scenes.encode_range(pts, 0.00025),
                                     rays, 0.00025)


def planar_labels(points, device="cpu"):
    """The planar finalize's labels of one frame: the grid the mean shift
    starts from in the pipeline."""
    seg = pipeline.Segmenter(dataclasses.replace(MS_CONFIG,
                                                 run_clustering=False),
                             device=device)
    return seg.segment_frame(points, np.zeros(3, np.float32)).labels


@functools.lru_cache(maxsize=None)
def case(seed, prelabeled):
    pts = mix_points(seed, SMALL)
    labels = planar_labels(pts) if prelabeled else \
        np.full(pts.shape[:2], UNLABELED, np.int32)
    return pts, np.ascontiguousarray(labels, np.int32)


def host_inputs(pts):
    occ = np.ascontiguousarray(np.isfinite(pts).all(axis=-1)
                               .astype(np.uint8))
    cells = np.ascontiguousarray(np.nan_to_num(pts, nan=0.0), np.float32)
    return cells, occ


def native_shift(pts, labels):
    """The library's shift state as the packed buffer of ``m1.unpack``."""
    lib = native.load_hostops()
    h, w = labels.shape
    cells, occ = host_inputs(pts)
    buf = np.empty(m1.BYTES_PER_PIXEL * h * w, np.uint8)
    lib.pcseg_mean_shift_shift(
        mean_shift._ptr(cells), mean_shift._ptr(occ), h, w, 5,
        PARAMS.half_search_window, PARAMS.square_distance_threshold,
        PARAMS.min_support, UNLABELED, mean_shift._ptr(labels),
        *mean_shift._state_ptrs(m1.unpack(buf, h * w)))
    return buf


def twin_shift(pts, labels, device="cpu", impl=None):
    return m1.mean_shift_modes(
        torch.as_tensor(pts, device=device),
        torch.as_tensor(labels, device=device), 5, PARAMS,
        impl=impl).cpu().numpy()


def assert_same_state(got, want, n):
    a, b = m1.unpack(got, n), m1.unpack(want, n)
    for f in m1.Modes._fields:
        np.testing.assert_array_equal(getattr(a, f).view(np.uint8),
                                      getattr(b, f).view(np.uint8),
                                      err_msg=f)


@pytest.fixture(scope="module")
def hostops():
    lib = native.load_hostops()
    if lib is None:
        pytest.skip("no host compiler for the host-ops library")
    return lib


@pytest.mark.parametrize("seed,prelabeled", CASES)
def test_m1_twin_equals_the_library_shift(hostops, seed, prelabeled):
    """M1's plain version and ``pcseg_mean_shift_shift`` write the same
    bytes in every field, on three rooms of the mix and on one whose
    planar cells are labelled."""
    pts, labels = case(seed, prelabeled)
    want = native_shift(pts, labels)
    got = twin_shift(pts, labels)
    n = labels.size
    assert_same_state(got, want, n)
    state = m1.unpack(got, n)
    assert 0 < int(state.valid.sum()) < n
    seeds = np.isfinite(pts).all(-1) & (labels == UNLABELED)
    assert not state.valid[~seeds.reshape(-1)].any()
    if prelabeled:
        assert (labels != UNLABELED).mean() > 0.3


@pytest.mark.parametrize("seed,prelabeled", CASES)
def test_library_growth_equals_the_one_call_grid(hostops, seed, prelabeled):
    """``pcseg_mean_shift_grow`` on the shift's modes gives the labels and
    the region count of ``pcseg_mean_shift_grid`` (id offset 3)."""
    pts, labels = case(seed, prelabeled)
    h, w = labels.shape
    cells, occ = host_inputs(pts)
    c_sq, n_sq = (PARAMS.squared_centroid_distance_threshold,
                  PARAMS.squared_neighbor_distance_threshold)
    want = labels.copy()
    n_want = hostops.pcseg_mean_shift_grid(
        mean_shift._ptr(cells), mean_shift._ptr(occ), h, w, 5,
        PARAMS.half_search_window, PARAMS.square_distance_threshold,
        PARAMS.min_support, c_sq, n_sq, 7, UNLABELED, 3,
        mean_shift._ptr(want))
    got = labels.copy()
    state = m1.unpack(native_shift(pts, labels), h * w)
    n_got = hostops.pcseg_mean_shift_grow(
        mean_shift._ptr(cells), mean_shift._ptr(occ), h, w,
        *mean_shift._state_ptrs(state), c_sq, n_sq, 7, UNLABELED, 3,
        mean_shift._ptr(got))
    assert n_got == n_want >= 2
    np.testing.assert_array_equal(got, want)


def test_regions_come_from_one_pass_over_the_labels(hostops):
    """The native growth's region list (one pass over the labels) equals
    one scan of the grid per region: the same ids, inliers in col-major
    order and member centroids as seeds."""
    pts, labels = case(1, True)
    lab = labels.copy()
    offset = int(labels.max()) + 1  # ids follow the planar ids
    regions = mean_shift.sliding_mean_shift(
        pts, lab, config.ClusterRegionConfig(), 5, offset, growth="native")
    h = lab.shape[0]
    assert len(regions) >= 2
    for k, r in enumerate(regions):
        rr, cc = np.nonzero(lab == k + offset)
        assert r.label_id == k + offset
        np.testing.assert_array_equal(
            r.inlier_indices, np.sort(cc * h + rr).astype(np.int64))
        np.testing.assert_array_equal(
            r.seed, pts[rr, cc].mean(axis=0).astype(np.float32))
    assert not (lab >= offset + len(regions)).any()


def test_a_frame_records_the_mean_shift(hostops):
    """``segment_frame`` with MEAN_SHIFT on the CPU: the spans
    ``mean_shift``, ``.modes`` and ``.grow`` under ``finalize.recluster``,
    the counters agreeing with the result, and no sync in the shift (the
    library's shift runs on the host)."""
    pts, _ = case(2, False)
    seg = pipeline.Segmenter(MS_CONFIG, device="cpu")
    res = seg.segment_frame(pts, np.zeros(3, np.float32))
    req = [r for r in profiling.requests() if r.kind == "frame"][-1]
    names = [s.name for s in req.spans]
    parent = {s.name: req.spans[s.parent].name for s in req.spans}
    assert parent["mean_shift"] == "finalize.recluster"
    assert parent["mean_shift.modes"] == parent["mean_shift.grow"] \
        == "mean_shift"
    assert "sync:mean_shift.modes" not in names
    assert req.counters["mean_shift.regions"] == res.num_clusters >= 2
    labels = planar_labels(pts)
    assert req.counters["mean_shift.seeds"] == int(np.count_nonzero(
        np.isfinite(pts).all(-1) & (labels == UNLABELED)))
    assert res.num_clusters <= req.counters["mean_shift.valid_modes"] \
        <= req.counters["mean_shift.seeds"]


@pytest.mark.parametrize("request_index", [0, 1])
def test_frame_equals_the_plain_reference(hostops, request_index):
    """The benchmark's mean-shift cell at 128x160 on the CPU: the port's
    ``segment_frame_stream`` against the plain reference's, under the
    check that decides ``correct``, with the configuration's limits."""
    cell = small_cell("frame_objects_mean_shift", pool=2)
    cell.config["frame"].update(SMALL)
    runs = []
    for package in (PROGRAM, REFERENCE):
        path = frame_mean_shift.Path(torch, cell, 2 ** 31 + 11, "cpu",
                                     package)
        path.setup()
        runs.append(path.request(request_index))
    got, want = runs
    t = compare.frame_tally()
    compare.compare_frame(t, frame.arrays(got), frame.arrays(want))
    assert t.compared == 1
    for name, value in t.values.items():
        assert value <= cell.config["limits"][name], name
    assert got.num_clusters >= 2 and got.metrics.num_planar_regions >= 1


def test_the_benchmark_counts_m1_from_shapes(monkeypatch):
    """``portbench/kernels/mean_shift_modes.py``: 41 B a pixel and no
    operations, spying on the program's wrapper; in a program without the
    wrapper it names a function nothing calls."""
    cost = importlib.import_module("portbench.kernels.mean_shift_modes")
    assert cost.WRAPPER == \
        "pcseg_tpu_torch.kernels.mean_shift_modes:mean_shift_modes"
    assert cost.cost({"points": torch.zeros(48, 64, 3)}) == (41 * 48 * 64, 0)
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None
                        if name == cost.PROGRAM_MODULE else real(name))
    try:
        absent = importlib.reload(cost)
        assert absent.WRAPPER == "portbench.kernels.mean_shift_modes:absent"
        assert absent.absent() is None
    finally:
        monkeypatch.undo()
        importlib.reload(cost)


# -- on the card -----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


@functools.lru_cache(maxsize=None)
def vga_frames():
    """Two frames of the cell's mix at the configuration's size, as the
    pipeline sees them: (u16 depth, [H, W, 3] f32 points)."""
    cfg = load("configs", "vga_frame_mean_shift")
    pool = generate.pool(MIX, cfg["frame"], 1, 2 ** 31 + 5)
    rays, _ = generate.rays_and_origin(cfg["frame"])
    return [(p[0], scenes.unproject_range_np(p[0], rays,
                                             cfg["frame"]["depth_scale"]))
            for p in pool[:2]], rays, cfg["frame"]["depth_scale"]


@pytest.mark.cuda
@pytest.mark.parametrize("index", [0, 1])
def test_m1_equals_its_twin_and_the_library_at_vga(cuda_device, index):
    """At 480x640 on a frame of the cell's mix, from its planar labels:
    the kernel's bytes equal the plain version's on the card and the
    library's shift, every field."""
    frames, _, _ = vga_frames()
    pts = frames[index][1]
    labels = np.ascontiguousarray(planar_labels(pts, cuda_device),
                                  np.int32)
    got = twin_shift(pts, labels, cuda_device)
    n = labels.size
    assert_same_state(got, twin_shift(pts, labels, cuda_device, "plain"), n)
    assert_same_state(got, native_shift(pts, labels), n)
    assert int(m1.unpack(got, n).valid.sum()) > 10_000


@pytest.mark.cuda
def test_a_frame_launches_m1_once_and_syncs_once(cuda_device):
    """``segment_frame_stream`` with MEAN_SHIFT on the card: one M1 launch
    and one ``mean_shift.modes`` sync a frame, and the frame's labels,
    counts and cluster sizes equal the ``impl="plain"`` pipeline's."""
    frames, rays, scale = vga_frames()
    seg = pipeline.Segmenter(MS_CONFIG, device=cuda_device)
    plain = pipeline.Segmenter(MS_CONFIG, device=cuda_device, impl="plain")
    origin = np.zeros(3, np.float32)
    seg.segment_frame_stream(frames[0][0], rays, origin, scale)
    for depth, _ in frames:
        before = profiling.total("launches.mean_shift_modes")
        res = seg.segment_frame_stream(depth, rays, origin, scale)
        req = [r for r in profiling.requests() if r.kind == "frame"][-1]
        assert profiling.total("launches.mean_shift_modes") - before == 1
        assert req.counters["launches.mean_shift_modes"] == 1
        assert sum(s.name == "sync:mean_shift.modes"
                   for s in req.spans) == 1
        assert req.counters["mean_shift.seeds"] > 10_000
        want = plain.segment_frame_stream(depth, rays, origin, scale)
        got_a, want_a = (pipeline.frame_arrays(r) for r in (res, want))
        for k in ("labels", "metrics", "cluster_sizes"):
            np.testing.assert_array_equal(got_a[k], want_a[k], err_msg=k)
        assert res.num_clusters >= 2
