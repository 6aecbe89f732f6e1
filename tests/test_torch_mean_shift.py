"""Mean-shift clustering in the port against JAX on the CPU (mirrors
tests/test_mean_shift.py): the shift fixed point ``mean_shift_modes``, the
growths (``host``, the exact FIFO port; ``device`` and ``device_permode``,
the window-closure growth; ``native``, the host-ops library), the
region-table overflow warning, ``segment_frame`` with
``ClusterMethod.MEAN_SHIFT``, and ``segment_clusters(ccl_mode="while")``
(the window CCL with pointer jumping). The device mean shift on the card
against the same call on the CPU when a card is present (marker ``cuda``).

Tolerances: everything exact. The modes are bit-equal to JAX's jitted
shift (the port sums the 121 offsets in JAX's order, dc outer, dr inner,
in f32, and the squared distances in XLA:CPU's fused multiply-add order);
labels, region lists, inlier sets and mode positions equal JAX's.
"""

import dataclasses
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu import native as jnative
from pcseg_tpu.models import cluster as jcluster
from pcseg_tpu.models import mean_shift as jms
from pcseg_tpu.models import pipeline as jpipeline
from pcseg_tpu.models.config import ClusterMethod, ClusterRegionConfig
from pcseg_tpu.ops import unproject as junproject
from pcseg_tpu.utils.synthetic import synthetic_cluttered_room_cloud

from pcseg_tpu_torch import native
from pcseg_tpu_torch.models import cluster, config, mean_shift, pipeline
from tests.test_mean_shift import blob_cloud
from tests.test_torch_frame import assert_arrays_equal
from tests.test_torch_kernels import _t, cuda_device  # noqa: F401

# one intra-op thread per test process (see test_torch_frame.py)
torch.set_num_threads(1)

UNLABELED = config.UNLABELED
FIELDS = ("pos", "idx", "valid", "intensity", "is_seed")


def port_cfg(cfg: ClusterRegionConfig):
    return config.ClusterRegionConfig(**{
        f.name: (getattr(config.ClusterMethod, getattr(cfg, f.name).name)
                 if f.name == "cluster_method" else getattr(cfg, f.name))
        for f in dataclasses.fields(cfg)})


def labels_with_planar_band(h, w):
    labels = np.full((h, w), UNLABELED, np.int32)
    labels[:5, :] = 0  # pre-labeled planar cells are never touched
    return labels


def jax_state(pts, labels, iterations=5):
    return jms._mean_shift_modes_jit(jnp.asarray(pts), jnp.asarray(labels),
                                     iterations, jms.MeanShiftParams())


def as_port_state(js):
    return mean_shift.MeanShiftState(
        *[_t(np.asarray(getattr(js, f)))[None] for f in FIELDS])


def assert_regions_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.label_id == b.label_id
        np.testing.assert_array_equal(a.inlier_indices, b.inlier_indices)
        np.testing.assert_array_equal(a.seed, b.seed)


@pytest.mark.parametrize("seed", [3, 7])
@pytest.mark.parametrize("prelabeled", [False, True])
def test_mean_shift_modes_match_jax(seed, prelabeled):
    pts = blob_cloud(seed=seed)
    h, w = pts.shape[:2]
    labels = labels_with_planar_band(h, w) if prelabeled \
        else np.full((h, w), UNLABELED, np.int32)
    want = jax_state(pts, labels)
    got = mean_shift.mean_shift_modes(_t(pts)[None], _t(labels)[None], 5)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    assert int(got.valid.sum()) > 0


GROWTHS = {
    "host": (mean_shift.grow_mean_shift_regions,
             jms.grow_mean_shift_regions),
    "device": (mean_shift.grow_mean_shift_regions_batched,
               jms.grow_mean_shift_regions_batched),
    "device_permode": (mean_shift.grow_mean_shift_regions_device,
                       jms.grow_mean_shift_regions_device),
}


@pytest.mark.parametrize("growth", sorted(GROWTHS))
@pytest.mark.parametrize("seed", [3, 11])
def test_growth_from_jax_modes_matches_jax(growth, seed):
    """Each growth of the port from JAX's own modes: labels and regions
    equal JAX's same growth (pre-labeled band, id offset 2)."""
    pts = blob_cloud(seed=seed)
    labels0 = labels_with_planar_band(*pts.shape[:2])
    js = jax_state(pts, labels0)
    port_fn, jax_fn = GROWTHS[growth]
    la, lb = labels0.copy(), labels0.copy()
    want = jax_fn(pts, la, js, ClusterRegionConfig(), 2)
    on_cpu = {} if growth == "host" else {"device": "cpu"}
    got = port_fn(pts, lb, as_port_state(js), config.ClusterRegionConfig(), 2,
                  **on_cpu)
    np.testing.assert_array_equal(lb, la)
    assert_regions_equal(got, want)
    assert len(got) >= 2
    np.testing.assert_array_equal(lb[:5], 0)


@pytest.mark.parametrize("growth", ["device", "device_permode", "host",
                                    "native"])
def test_sliding_mean_shift_matches_jax(growth):
    """The whole SlidingMeanShift, each growth against JAX's same growth
    (blob scene, seed 7, id offset 1)."""
    if growth == "native" and (native.load_hostops() is None
                               or jnative.load_hostops() is None):
        pytest.skip("no host compiler for the host-ops library")
    pts = blob_cloud(seed=7)
    h, w = pts.shape[:2]
    la = np.full((h, w), UNLABELED, np.int32)
    lb = la.copy()
    want = jms.sliding_mean_shift(pts, la, ClusterRegionConfig(), 5, 1,
                                  growth=growth)
    got = mean_shift.sliding_mean_shift(pts, lb, config.ClusterRegionConfig(),
                                        5, 1, growth=growth, device="cpu")
    np.testing.assert_array_equal(lb, la)
    assert_regions_equal(got, want)


def test_device_growth_agrees_with_host_growth():
    """tests/test_mean_shift.py::TestDeviceGrowth in the port: the closure
    growth within 1% of the exact FIFO port, the same region count."""
    pts = blob_cloud(seed=7)
    h, w = pts.shape[:2]
    la = np.full((h, w), UNLABELED, np.int32)
    lb = la.copy()
    ra = mean_shift.sliding_mean_shift(pts, la, config.ClusterRegionConfig(),
                                       5, 0, growth="device", device="cpu")
    rb = mean_shift.sliding_mean_shift(pts, lb, config.ClusterRegionConfig(),
                                       5, 0, growth="host", device="cpu")
    assert (la == lb).mean() >= 0.99
    assert len(ra) == len(rb)


def test_region_table_overflow_warns_like_jax():
    """With room for one region, the second blob's mode is not attempted:
    the port warns as JAX does and keeps the same labels."""
    pts = blob_cloud(seed=3)
    h, w = pts.shape[:2]
    cfg = ClusterRegionConfig(max_regions=1)
    la = np.full((h, w), UNLABELED, np.int32)
    lb = la.copy()
    with pytest.warns(UserWarning, match="region table full"):
        want = jms.sliding_mean_shift(pts, la, cfg, 5, 0, growth="device")
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        got = mean_shift.sliding_mean_shift(pts, lb, port_cfg(cfg), 5, 0,
                                            growth="device", device="cpu")
    assert any("region table full" in str(x.message) for x in seen)
    np.testing.assert_array_equal(lb, la)
    assert_regions_equal(got, want)
    assert len(got) == 1


@pytest.mark.parametrize("entry", ["sliding_mean_shift",
                                   "grow_mean_shift_regions_batched",
                                   "grow_mean_shift_regions_device"])
def test_entry_points_take_the_card_unless_told(entry, monkeypatch):
    """Without ``device``, the shift and the device growths run on the card
    and raise where there is none, also when the state lies on the CPU."""
    pts = blob_cloud(seed=3)
    labels = np.full(pts.shape[:2], UNLABELED, np.int32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if entry == "sliding_mean_shift":
        args = (pts, labels, config.ClusterRegionConfig(), 1)
    else:
        state = mean_shift.mean_shift_modes(_t(pts)[None], _t(labels)[None],
                                            1)
        args = (pts, labels, state, config.ClusterRegionConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        getattr(mean_shift, entry)(*args)


@pytest.mark.parametrize("scene", ["blobs", "cluttered"])
def test_segment_frame_mean_shift_matches_jax(scene):
    """segment_frame with ClusterMethod.MEAN_SHIFT (the native growth when
    the host-ops library loads, as in JAX): the frame's fields exact but
    planes, centroids (tolerance) and areas (rtol 1e-5); cluster ids follow
    the planar ids."""
    if scene == "blobs":
        pts, origin = blob_cloud(h=32, w=32, seed=4), np.zeros(3, np.float32)
    else:
        pts, origin = synthetic_cluttered_room_cloud(64, 80, f=64.0, seed=5)
        d16 = junproject.encode_range(pts)
        pts = junproject.unproject_range_np(
            d16, junproject.camera_ray_table(64, 80, f=64.0))
    jcfg = jpipeline.SegmenterConfig(cluster=dataclasses.replace(
        ClusterRegionConfig(), cluster_method=ClusterMethod.MEAN_SHIFT))
    want = jpipeline.Segmenter(jcfg).segment_frame(pts, origin)
    got = pipeline.Segmenter(config.config_from_dict(
        dataclasses.asdict(jcfg)), device="cpu").segment_frame(pts, origin)
    assert_arrays_equal(pipeline.frame_arrays(got),
                        pipeline.frame_arrays(want), pts)
    assert got.metrics.num_clusters >= 2 if scene == "blobs" \
        else got.metrics.num_clusters >= 1
    ids = np.unique(got.labels[got.labels >= 0])
    assert len(ids) == got.metrics.num_planar_regions \
        + got.metrics.num_clusters
    assert len(got.objects) == len(want.objects)


@pytest.mark.parametrize("need_sizes", [True, False])
@pytest.mark.parametrize("half_window", [1, 2])
def test_segment_clusters_while_matches_jax(need_sizes, half_window):
    """segment_clusters with ccl_mode="while" (canonical seeds, as the
    pipeline calls it) on the cluttered scene with its planar cells
    pre-labeled: labels, counts, sizes and roots equal JAX's."""
    pts, _ = synthetic_cluttered_room_cloud(64, 80, f=64.0, seed=5)
    rng = np.random.default_rng(1)
    labels = np.where(rng.random((64, 80)) < 0.3, 0,
                      UNLABELED).astype(np.int32)
    cfg = ClusterRegionConfig(ccl_mode="while",
                              half_search_window=half_window,
                              squared_distance_threshold=0.01)
    hw = 64 * 80
    want = jcluster.segment_clusters(
        jnp.asarray(pts), jnp.asarray(labels),
        jnp.arange(hw - 1, -1, -1, dtype=jnp.int32), cfg,
        canonical_seeds=True, need_sizes=need_sizes)
    got = cluster.segment_clusters(
        _t(pts)[None], _t(labels)[None],
        cluster.canonical_seed_vector(64, 80), port_cfg(cfg),
        canonical_seeds=True, need_sizes=need_sizes)
    for name in ("labels", "num_regions", "region_sizes", "roots"):
        np.testing.assert_array_equal(getattr(got, name)[0].numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.num_regions[0]) > 1


@pytest.mark.cuda
@pytest.mark.parametrize("growth", ["device", "device_permode"])
def test_device_mean_shift_card_matches_cpu(cuda_device, growth):
    pts = blob_cloud(seed=11)
    labels0 = labels_with_planar_band(*pts.shape[:2])
    la, lb = labels0.copy(), labels0.copy()
    ra = mean_shift.sliding_mean_shift(pts, la, config.ClusterRegionConfig(),
                                       5, 2, growth=growth,
                                       device=cuda_device)
    rb = mean_shift.sliding_mean_shift(pts, lb, config.ClusterRegionConfig(),
                                       5, 2, growth=growth, device="cpu")
    np.testing.assert_array_equal(la, lb)
    assert_regions_equal(ra, rb)
