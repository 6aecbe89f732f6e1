"""The port's full pipeline, ``segment_frame_stream`` and ``segment_frame``,
against JAX's on the cluttered scene at 128x160 (seed 5) with 32 slots
(word epochs, kernel B1) and 64 slots (flood epochs, kernel B3), and the
committed JAX golden of the 64-slot stream frame.

Rewrite the golden after a deliberate change of the JAX reference with:

    JAX_PLATFORMS=cpu python -m tests.test_torch_frame
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pcseg_tpu.models import config as jconfig
from pcseg_tpu.models import pipeline as jpipeline
from pcseg_tpu.ops import unproject as junproject
from pcseg_tpu.utils.synthetic import synthetic_cluttered_room_cloud

from pcseg_tpu_torch.models import config, pipeline
from tests.test_torch_grower import plane_tolerance, region_bars

# One intra-op thread: the suite runs in parallel worker processes, and
# OpenMP teams spinning across them slow every small op by orders of
# magnitude.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pcseg_tpu_torch", "testdata", "jax_frame_128x160_k64.npz")
AREA_RTOL = 1e-5
EXACT = ("labels", "metrics", "cluster_sizes", "counts", "plane_class",
         "seed_indices", "boundary", "boundary_len", "disc", "disc_len")


def jax_config(k):
    return jpipeline.SegmenterConfig(
        planar=jconfig.PlanarRegionConfig(max_regions=k))


def scene(h=128, w=160, seed=5):
    """(u16 range frame, rays, origin) of the cluttered scene."""
    pts, origin = synthetic_cluttered_room_cloud(h, w, f=float(h), seed=seed)
    return (junproject.encode_range(pts),
            junproject.camera_ray_table(h, w, f=float(h)), origin)


def run(seg, entry, d16, rays, origin):
    if entry == "stream":
        return seg.segment_frame_stream(d16, rays, origin)
    return seg.segment_frame(junproject.unproject_range_np(d16, rays), origin)


def assert_arrays_equal(got, want, points):
    """frame_arrays dicts: exact but for the areas (rtol 1e-5) and the
    planes and centroids (the conditioning-aware tolerance of
    tests/test_torch_grower.py)."""
    for key in EXACT:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_allclose(got["areas"], want["areas"], rtol=AREA_RTOL)
    for r in range(len(want["counts"])):
        tol = plane_tolerance(points[want["labels"] == r])
        for key in ("planes", "centroids"):
            np.testing.assert_allclose(got[key][r], want[key][r], rtol=0,
                                       atol=tol, err_msg=f"{key} {r}")


def polygon_tolerance(points):
    """The in-plane hull of a region's boundary, projected onto its plane:
    a plane within ``plane_tolerance`` moves a projected point by about
    that times (1 + |p|)."""
    return plane_tolerance(points) * (1 + np.linalg.norm(points, axis=-1)
                                      .max())


def assert_polygon_equal(got, want, tol, msg):
    """The same hull within ``tol``, from any start vertex: the hull
    starts at its extreme vertex in the plane's 2-D frame, and on a wall
    whose boundary cells tie there an ulp of the projection picks the
    start (the room's back wall at 128x160)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, msg
    if len(want) == 0:
        return
    shift = int(np.argmin(np.abs(got - want[0]).max(-1)))
    np.testing.assert_allclose(np.roll(got, -shift, axis=0), want, rtol=0,
                               atol=tol, err_msg=msg)


def assert_records_equal(got, want, points, labels):
    """The record fields that ``frame_arrays`` leaves out: the label id
    (exact), the curvature (tests/test_torch_grower.region_bars) and the
    projected hull (:func:`polygon_tolerance`)."""
    assert len(got) == len(want)
    for r, (a, b) in enumerate(zip(got, want)):
        assert a.label_id == b.label_id
        pts = points[labels == b.label_id]
        assert abs(a.curvature - b.curvature) <= \
            region_bars(pts)["curvatures"], f"curvature {r}"
        assert_polygon_equal(a.projected_boundary_points,
                             b.projected_boundary_points,
                             polygon_tolerance(pts), f"polygon {r}")


def assert_frame_equal(got, want, points):
    """Two FrameResults (the port's, JAX's): the flat arrays, the records'
    other fields, the classification summary and every detected object
    (a planar object's plane and centroid to the plane tolerance of its
    points). ``normals`` is None in both (FrameResult's comment)."""
    assert_arrays_equal(pipeline.frame_arrays(got),
                        pipeline.frame_arrays(want), points)
    assert_records_equal(got.planar_regions, want.planar_regions, points,
                         np.asarray(want.labels))
    assert got.normals is None and want.normals is None
    assert dataclasses.asdict(got.classification_summary) == \
        dataclasses.asdict(want.classification_summary)
    assert got.num_clusters == want.num_clusters
    assert len(got.objects) == len(want.objects)
    for a, b in zip(got.objects, want.objects):
        assert a.object_class == b.object_class
        np.testing.assert_array_equal(a.points, b.points)
        if b.plane is not None:
            np.testing.assert_array_equal(
                a.discontinuous_boundary_positions,
                b.discontinuous_boundary_positions)
            tol = plane_tolerance(b.points)
            np.testing.assert_allclose(a.plane, b.plane, rtol=0, atol=tol)
            np.testing.assert_allclose(a.centroid, b.centroid, rtol=0,
                                       atol=tol)
        else:
            assert a.plane is None and a.centroid is None and \
                a.discontinuous_boundary_positions is None


@pytest.fixture(scope="module")
def jax_results():
    """JAX's FrameResults, computed once per (entry, K)."""
    d16, rays, origin = scene()
    cache = {}

    def get(entry, k):
        if (entry, k) not in cache:
            cache[entry, k] = run(jpipeline.Segmenter(jax_config(k)), entry,
                                  d16, rays, origin)
        return cache[entry, k]
    return get


@pytest.mark.parametrize("k", [32, 64])
@pytest.mark.parametrize("entry", ["stream", "frame"])
def test_frame_matches_jax(jax_results, entry, k):
    d16, rays, origin = scene()
    cfg = config.config_from_dict(dataclasses.asdict(jax_config(k)))
    got = run(pipeline.Segmenter(cfg, device="cpu"), entry, d16, rays,
              origin)
    want = jax_results(entry, k)
    assert_frame_equal(got, want, junproject.unproject_range_np(d16, rays))
    assert got.metrics.num_planar_regions == 4
    assert sorted(got.cluster_sizes.tolist()) == [46, 46, 61, 141]
    assert got.labels.dtype == np.int32


def test_committed_golden_is_current(jax_results):
    """The 128x160 fixture the card run may read equals what JAX computes
    now."""
    gold = np.load(GOLDEN)
    want = pipeline.frame_arrays(jax_results("stream", 64))
    assert set(gold.files) == set(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(gold[name], arr, err_msg=name)


if __name__ == "__main__":
    np.savez_compressed(GOLDEN, **pipeline.frame_arrays(run(
        jpipeline.Segmenter(jax_config(64)), "stream", *scene())))
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
