"""The port's serving path, ``Segmenter.device_forward_stream``, against
JAX's on the cluttered scene (B=2), the committed JAX golden that the card
run checks, and the config hand-over between the packages.

Rewrite the golden after a deliberate change of the JAX reference with:

    JAX_PLATFORMS=cpu python -m tests.test_torch_pipeline
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
from tests.test_torch_grower import assert_planes

# One intra-op thread: the suite runs in parallel worker processes, and
# OpenMP teams spinning across them slow every small op by orders of
# magnitude.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pcseg_tpu_torch", "testdata", "jax_stream_128x160.npz")


def stream_input(h, w, seed=5, b=2):
    """([B, H, W] u16 frames of the cluttered scene, [H, W, 3] rays)."""
    pts, _ = synthetic_cluttered_room_cloud(h, w, f=float(h), seed=seed)
    d16 = junproject.encode_range(pts)
    return np.stack([d16] * b), junproject.camera_ray_table(h, w, f=float(h))


def jax_stream(depth, rays):
    """JAX's device_forward_stream outputs as a dict of numpy arrays."""
    out = jpipeline.Segmenter().device_forward_stream(
        depth, rays, np.zeros(3, np.float32), junproject.DEFAULT_DEPTH_SCALE)
    labels, num_planar, num_clusters, planes = (np.asarray(o) for o in out)
    return dict(depth=depth, labels=labels, num_planar=num_planar,
                num_clusters=num_clusters, planes=planes)


@pytest.fixture(scope="module")
def jax_128x160():
    return jax_stream(*stream_input(128, 160))


def check_stream(want, rays, expect_planar, expect_clusters):
    depth = want["depth"]
    seg = pipeline.Segmenter(device="cpu")
    labels, npl, ncl, planes = (o.numpy() for o in seg.device_forward_stream(
        torch.from_numpy(depth), torch.from_numpy(rays), torch.zeros(3)))
    assert labels.dtype == np.uint8
    np.testing.assert_array_equal(npl, want["num_planar"])
    np.testing.assert_array_equal(ncl, want["num_clusters"])
    np.testing.assert_array_equal(labels, want["labels"])
    assert (npl == expect_planar).all() and (ncl == expect_clusters).all()
    points = junproject.unproject_range_np(depth, rays)
    assert_planes(planes, want["planes"], labels, points, npl)


def test_stream_matches_jax_96x128():
    depth, rays = stream_input(96, 128)
    check_stream(jax_stream(depth, rays), rays, 9, 2)


def test_stream_matches_jax_128x160(jax_128x160):
    check_stream(jax_128x160, junproject.camera_ray_table(128, 160, f=128.0),
                 12, 2)


def test_committed_golden_is_current(jax_128x160):
    """The fixture the card run reads must equal what JAX computes now."""
    gold = np.load(GOLDEN)
    assert set(gold.files) == set(jax_128x160)
    for name, want in jax_128x160.items():
        np.testing.assert_array_equal(gold[name], want, err_msg=name)


@pytest.mark.parametrize("which", ["default", "custom"])
def test_config_from_dict(which):
    if which == "default":
        jcfg = jpipeline.SegmenterConfig()
    else:
        jcfg = jpipeline.SegmenterConfig(
            planar=jconfig.PlanarRegionConfig(max_plane_distance=0.03,
                                              max_regions=16),
            cluster=jconfig.ClusterRegionConfig(
                cluster_method=jconfig.ClusterMethod.MEAN_SHIFT,
                scan_rounds=7),
            normals=jconfig.ComputeNormalsParams(max_scan_steps=12),
            up_direction=(0.0, 1.0, 0.0), run_clustering=False)
    cfg = config.config_from_dict(dataclasses.asdict(jcfg))
    assert isinstance(cfg, config.SegmenterConfig)

    def fields(a, b, path=""):
        assert [f.name for f in dataclasses.fields(a)] == \
            [f.name for f in dataclasses.fields(b)], path
        for f in dataclasses.fields(a):
            va, vb = getattr(a, f.name), getattr(b, f.name)
            if dataclasses.is_dataclass(va):
                fields(va, vb, path + f.name + ".")
            elif hasattr(va, "name") and hasattr(vb, "name"):
                assert va.name == vb.name, path + f.name
            else:
                assert va == vb and type(va) is type(vb), path + f.name

    fields(cfg, jcfg)
    assert config.config_from_dict({}) == config.SegmenterConfig()


if __name__ == "__main__":
    np.savez_compressed(GOLDEN, **jax_stream(*stream_input(128, 160)))
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
