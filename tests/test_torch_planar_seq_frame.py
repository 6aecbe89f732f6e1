"""``Segmenter`` with the sequential grower (``growth_mode="hybrid"`` and
``"wavefront"``) against JAX's on the cluttered scene at 128x160 (seed 5,
tests/test_torch_frame.py's frame).

Two differences remain, each traced to its precision class (ROADMAP
Queue 3):

  * hybrid growth of average-normal seeds: 3 label cells differ. JAX sums
    the refit moments in f32, the port in f64; JAX's pipeline with those
    sums taken in f64 (a host callback) gives the port's frame exactly;
  * plane-support seeds, both modes: labels, records and objects are
    exact, but the classification summary's reasons differ. The default
    floor gate's angle is 0 degrees, so a plane is "rejected for angle"
    unless its normal's up component is exactly 1.0 in f32; the planes
    whose reason differs lie within 2 f32 ulps of 1.0 on both sides.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.models import config as jconfig
from pcseg_tpu.models import pipeline as jpipeline
from pcseg_tpu.ops import plane_fit as jplane_fit
from pcseg_tpu.ops import unproject as junproject

from pcseg_tpu_torch.models import config, pipeline
from tests.test_torch_frame import (assert_arrays_equal, assert_frame_equal,
                                    scene)

torch.set_num_threads(1)
EPS32 = 2.0 ** -23


def configs(mode, seed_method):
    jcfg = jpipeline.SegmenterConfig(
        seed_method=seed_method,
        planar=dataclasses.replace(jconfig.PlanarRegionConfig(),
                                   growth_mode=mode))
    return jcfg, config.config_from_dict(dataclasses.asdict(jcfg))


def frames(mode, seed_method):
    """(port's FrameResult, JAX's, the points) of segment_frame."""
    d16, rays, origin = scene()
    pts = junproject.unproject_range_np(d16, rays)
    jcfg, cfg = configs(mode, seed_method)
    got = pipeline.Segmenter(cfg, device="cpu").segment_frame(pts, origin)
    want = jpipeline.Segmenter(jcfg).segment_frame(pts, origin)
    return got, want, pts


def test_wavefront_average_normals_frame_matches_jax():
    got, want, pts = frames("wavefront", "average_normals")
    assert_frame_equal(got, want, pts)
    assert got.metrics.num_device_planar_regions == 11
    assert got.metrics.num_planar_regions == 7


def f64_moments(points, weights=None):
    """jax plane_fit.moments_of_points with the f32 products summed in f64
    on the host and rounded to f32 (the port's sums)."""
    if weights is None:
        weights = jnp.ones(points.shape[:-1], points.dtype)

    def host(p, w):
        p, w = np.asarray(p, np.float32), np.asarray(w, np.float32)
        x, y, z = p[..., 0], p[..., 1], p[..., 2]
        t = np.stack([x * x * w, x * y * w, x * z * w, y * y * w, y * z * w,
                      z * z * w, x * w, y * w, z * w, w], axis=-1)
        return t.astype(np.float64).sum(axis=-2).astype(np.float32)

    t = jax.pure_callback(host, jax.ShapeDtypeStruct(
        points.shape[:-2] + (10,), jnp.float32), points, weights)
    return t[..., :6], t[..., 6:9], t[..., 9]


def test_hybrid_average_normals_frame_is_jax_with_f64_refit_sums(
        monkeypatch):
    """3 cells differ from JAX's frame; with its refit moment sums in f64,
    JAX gives the port's frame exactly (the precision class of ROADMAP
    Queue 3 item 5)."""
    got, want, pts = frames("hybrid", "average_normals")
    assert int((got.labels != want.labels).sum()) == 3
    assert got.metrics == want.metrics
    d16, rays, origin = scene()
    jcfg, _ = configs("hybrid", "average_normals")
    monkeypatch.setattr(jplane_fit, "moments_of_points", f64_moments)
    want64 = jpipeline.Segmenter(jcfg).segment_frame(pts, origin)
    assert_frame_equal(got, want64, pts)


@pytest.mark.parametrize("mode", ["hybrid", "wavefront"])
def test_plane_support_frame_matches_jax_but_the_unit_normal_edge(mode):
    got, want, pts = frames(mode, "plane_support")
    assert_arrays_equal(pipeline.frame_arrays(got),
                        pipeline.frame_arrays(want), pts)
    assert got.num_clusters == want.num_clusters == 4
    assert len(got.objects) == len(want.objects)
    # the floor gate's reasons, record by record (up = +z, angle 0: the
    # angle test passes only on an up component of exactly 1.0)
    up = np.asarray(config.SegmenterConfig().up_direction, np.float32)
    a = [float(np.dot(r.plane[:3], up)) for r in got.planar_regions]
    b = [float(np.dot(r.plane[:3], up)) for r in want.planar_regions]
    for side, ups in ((got, a), (want, b)):
        rej = side.classification_summary.floor_rejections
        assert rej.rejected_for_angle == sum(u < 1.0 for u in ups)
    flips = [(x, y) for x, y in zip(a, b) if (x < 1.0) != (y < 1.0)]
    assert flips and all(abs(x - 1.0) <= 2 * EPS32 and
                         abs(y - 1.0) <= 2 * EPS32 for x, y in flips)
