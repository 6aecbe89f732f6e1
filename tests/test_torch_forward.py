"""The port's ``device_forward_batched`` (with the cluster size table) and
``device_forward`` on the edge probes of tests/test_pipeline.py, against
JAX's on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pcseg_tpu.models import pipeline as jpipeline
from pcseg_tpu.ops import unproject as junproject
from pcseg_tpu.utils.synthetic import synthetic_cluttered_room_cloud

from pcseg_tpu_torch.models import pipeline
from tests.test_torch_grower import assert_planes

# One intra-op thread: the suite runs in parallel worker processes, and
# OpenMP teams spinning across them slow every small op by orders of
# magnitude.
torch.set_num_threads(1)


def compare(got, want, points, batched):
    """(final, normals, regions, clusters) of the port against JAX's."""
    g_final, g_nrm, g_dev, g_cres = got
    w_final, w_nrm, w_dev, w_cres = want
    np.testing.assert_array_equal(g_final.numpy(), np.asarray(w_final))
    np.testing.assert_array_equal(np.isnan(g_nrm.numpy()),
                                  np.isnan(np.asarray(w_nrm)))
    np.testing.assert_array_equal(g_dev.num_regions.numpy(),
                                  np.asarray(w_dev.num_regions))
    np.testing.assert_array_equal(g_dev.labels.numpy(),
                                  np.asarray(w_dev.labels))
    np.testing.assert_array_equal(g_cres.num_regions.numpy(),
                                  np.asarray(w_cres.num_regions))
    np.testing.assert_array_equal(g_cres.region_sizes.numpy(),
                                  np.asarray(w_cres.region_sizes))
    np.testing.assert_array_equal(g_cres.labels.numpy(),
                                  np.asarray(w_cres.labels))
    if not batched:
        return
    assert_planes(g_dev.planes.numpy(), np.asarray(w_dev.planes),
                  g_dev.labels.numpy(), points,
                  np.asarray(w_dev.num_regions))


def test_forward_batched_with_cluster_sizes():
    h, w = 64, 80
    rays = junproject.camera_ray_table(h, w, f=float(h))
    pts = np.stack([junproject.unproject_range_np(junproject.encode_range(
        synthetic_cluttered_room_cloud(h, w, f=float(h), seed=s)[0]), rays)
        for s in (1, 2)])
    origins = np.zeros((2, 3), np.float32)
    want = jpipeline.Segmenter().device_forward_batched(
        jnp.asarray(pts), jnp.asarray(origins))
    got = pipeline.Segmenter(device="cpu").device_forward_batched(
        pts, origins)
    compare(got, want, pts, batched=True)
    sizes = got[3].region_sizes.numpy()
    assert (got[3].num_regions.numpy() >= 1).all() and sizes.max() >= 7


def _probe(name):
    if name == "all_nan":
        return np.full((24, 32, 3), np.nan, np.float32)
    if name == "tiny":
        p = np.zeros((3, 3, 3), np.float32)
        p[..., 0] = 1.0
        return p
    if name == "single_pixel":
        return np.ones((1, 1, 3), np.float32)
    p = np.zeros((12, 12, 3), np.float32)
    p[..., 0] = np.linspace(1, 1.05, 12)[None, :]
    p[..., 1] = np.linspace(0, 0.05, 12)[:, None]
    p[..., 2] = -0.5
    return p


@pytest.mark.parametrize("name", ["all_nan", "tiny", "single_pixel",
                                  "small_plane"])
def test_device_forward_edge_probes(name):
    pts = _probe(name)
    origin = np.zeros(3, np.float32)
    want = jpipeline.Segmenter().device_forward(jnp.asarray(pts),
                                                jnp.asarray(origin))
    got = pipeline.Segmenter(device="cpu").device_forward(pts, origin)
    compare(got, want, pts, batched=False)
    if name in ("tiny", "small_plane"):
        assert int(got[3].num_regions) == 1
