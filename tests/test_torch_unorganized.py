"""The port's unorganized-cloud path against JAX on the CPU: voxelization,
the general seed-vector path of ``segment_clusters``, euclidean clustering
of unorganized clouds (device and native host paths) and the mean shift on
them (host and device backends). The ``cuda`` twins hold the card's run
to the CPU's.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu import native as jnative
from pcseg_tpu.models import cluster as jcluster
from pcseg_tpu.models import unorganized as junorganized
from pcseg_tpu.models.config import ClusterRegionConfig as JClusterConfig
from pcseg_tpu.ops import voxelize as jvoxelize

from pcseg_tpu_torch.models import cluster, unorganized
from pcseg_tpu_torch.models.config import UNLABELED, ClusterRegionConfig
from pcseg_tpu_torch.ops import voxelize
from pcseg_tpu_torch.utils.synthetic import gaussian_blobs
from tests import fixtures
from tests.test_torch_kernels import _t, cuda_device  # noqa: F401

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def jax_native_private_cache(tmp_path_factory):
    """JAX's host-ops loader (pcseg_tpu/native) builds its library in place
    in a cache that every xdist worker shares, so a worker can load
    another's half-written library ("file too short"); the loader then
    returns None for the rest of the process and JAX's ``backend="host"``
    raises. Before this module's first JAX host call, a worker without a
    loaded library builds its own in a private directory (its
    tmp_path_factory) and retries a failed load there."""
    if jnative._LIB is None:
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PCSEG_NATIVE_CACHE",
                      str(tmp_path_factory.mktemp("jax_native")))
            mp.setattr(jnative, "_TRIED", False)
            assert jnative.load_hostops() is not None, \
                "JAX's host-ops library did not build"


def nan_blobs(n_per=6000, seed=1):
    """tests/test_unorganized.py's host-vs-device cloud: four blobs with 2%
    of the points NaN (24,000 points)."""
    rng = np.random.default_rng(seed)
    pts = np.concatenate([
        c + rng.normal(0, 0.4, (n_per, 3)).astype(np.float32)
        for c in np.array([[0, 0, 0], [30, 0, 0], [0, 35, 0], [40, 40, 0]],
                          np.float32)])
    pts[rng.random(len(pts)) < 0.02] = np.nan
    return pts


# (points, cell size, grid shape, origin)
VOXEL_CASES = {
    # tests/test_unorganized.py::TestVoxelize
    "four_points": (np.array([[0.1, 0.1, 1.0], [0.2, 0.2, 2.0],
                              [3.0, 3.0, 5.0], [np.nan, 0, 0]], np.float32),
                    1.0, (8, 8), (0.0, 0.0)),
    # a point on a cell boundary (x = 1 exactly: cell 1), points on the
    # grid's last edge (off), far off the grid both ways, infinite
    "boundary_and_far": (np.array([[1.0, 0.5, 0.0], [0.5, 2.0, 1.0],
                                   [8.0, 1.0, 0.0], [1.0, 8.0, 0.0],
                                   [7.999, 7.999, 2.0], [1e20, 1.0, 0.0],
                                   [-3e9, 2.0, 0.0], [1.0, np.inf, 0.0],
                                   [0.25, 0.25, 0.5]], np.float32),
                         1.0, (8, 8), (0.0, 0.0)),
    "blobs_nan": (nan_blobs(), 0.5, (256, 256), None),
}


def ulps(a, b):
    """Per-element f32 ulp distance of two arrays with NaN in equal places."""
    assert np.array_equal(np.isnan(a), np.isnan(b))
    m = ~np.isnan(a)
    ia = a[m].view(np.int32).astype(np.int64)
    ib = b[m].view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


@pytest.mark.parametrize("case", sorted(VOXEL_CASES))
def test_voxelize_matches_jax(case):
    pts, cell, shape, origin = VOXEL_CASES[case]
    want = jvoxelize.voxelize_xy(jnp.asarray(pts), cell, shape, origin)
    got = voxelize.voxelize_xy(_t(pts), cell, shape, origin)
    np.testing.assert_array_equal(got.counts.numpy(), np.asarray(want.counts))
    np.testing.assert_array_equal(got.point_cell.numpy(),
                                  np.asarray(want.point_cell))
    np.testing.assert_array_equal(got.origin.numpy(), np.asarray(want.origin))
    np.testing.assert_array_equal(got.cell_size.numpy(),
                                  np.asarray(want.cell_size))
    assert ulps(got.points.numpy(), np.asarray(want.points)).max() <= 2
    # the NumPy copies agree exactly too
    np_got = voxelize.voxelize_xy_np(pts, cell, shape, origin)
    np_want = jvoxelize.voxelize_xy_np(pts, cell, shape, origin)
    for f in ("points", "counts", "point_cell", "origin"):
        np.testing.assert_array_equal(getattr(np_got, f),
                                      np.asarray(getattr(np_want, f)),
                                      err_msg=f)


def test_voxelize_boundary_and_far_points():
    pts, cell, shape, origin = VOXEL_CASES["boundary_and_far"]
    got = voxelize.voxelize_xy(_t(pts), cell, shape, origin)
    assert got.point_cell.tolist() == [8, 2, -1, -1, 63, -1, -1, -1, 0]
    back = voxelize.scatter_labels_to_points(
        torch.arange(64, dtype=torch.int32).reshape(8, 8), got.point_cell)
    assert back.tolist() == [8, 2, -1, -1, 63, -1, -1, -1, 0]


@pytest.mark.parametrize("case", sorted(VOXEL_CASES))
def test_card_order_means_equal_the_host_path(case):
    """The card's reduction (stable sort by cell, pairwise f64 tree, one
    rounding to f32), run here on CPU tensors, gives the f64 host path's
    centroids."""
    pts, cell, shape, origin = VOXEL_CASES[case]
    ids, inb, zeroed, _ = voxelize.cell_ids(_t(pts), cell, shape, origin)
    got = voxelize._cell_means_tree(
        zeroed, ids, inb, torch.bincount(ids, minlength=shape[0] * shape[1]
                                         + 1))
    want = voxelize.voxelize_xy_np(pts, cell, shape, origin).points
    np.testing.assert_array_equal(got.numpy().reshape(want.shape), want)


def test_scatter_labels_matches_jax():
    pts, cell, shape, origin = VOXEL_CASES["blobs_nan"]
    grid = voxelize.voxelize_xy(_t(pts), cell, shape, origin)
    lab = np.random.default_rng(3).integers(-1, 40, shape).astype(np.int32)
    want = jvoxelize.scatter_labels_to_points(
        jnp.asarray(lab), jnp.asarray(grid.point_cell.numpy()), fill=-7)
    got = voxelize.scatter_labels_to_points(_t(lab), grid.point_cell,
                                            fill=-7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the general seed-vector path ---------------------------------------------

def jax_clusters(pts, labels, seeds, cfg, offset, valid=None):
    """JAX's general path, jitted (its eager rounds take tens of seconds)."""
    fn = jax.jit(lambda p, l, s, v: jcluster.segment_clusters(
        p, l, s, cfg, offset, v))
    return fn(jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(seeds),
              None if valid is None else jnp.asarray(valid))


def assert_cluster_equal(got, want, frame=0):
    for name in ("labels", "num_regions", "region_sizes", "roots"):
        np.testing.assert_array_equal(getattr(got, name)[frame].numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_general_path_on_the_golden_fixture():
    pts = fixtures.clustering_fixture_cloud()
    seeds = np.asarray(fixtures.clustering_fixture_seeds(), np.int32)
    labels = np.full((10, 10), UNLABELED, np.int32)
    want = jax_clusters(pts, labels, seeds, JClusterConfig(), 1)
    got = cluster.segment_clusters(_t(pts)[None], _t(labels)[None],
                                   _t(seeds), ClusterRegionConfig(), 1)
    assert_cluster_equal(got, want)
    np.testing.assert_array_equal(got.labels[0].numpy(),
                                  fixtures.CLUSTERING_EXPECTED_LABELS)
    assert got.region_sizes[0, :6].tolist() == \
        fixtures.CLUSTERING_EXPECTED_SIZES


def scene(seed, h=48, w=56):
    """tests/test_cluster.py's canonical-path scene: two dense blobs in
    i.i.d. clutter, 5% NaN, the top rows pre-claimed."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-8, 8, (h, w, 3)).astype(np.float32)
    pts[10:20, 10:25] = rng.normal(0, 0.1, (10, 15, 3)).astype(np.float32)
    pts[30:44, 30:50] = np.float32([4, 4, 0]) + rng.normal(
        0, 0.1, (14, 20, 3)).astype(np.float32)
    pts[rng.random((h, w)) < 0.05] = np.nan
    labels = np.full((h, w), UNLABELED, np.int32)
    labels[0:5, :] = 0
    return pts, labels


def shuffled_seeds(seed, hw, n, pad):
    """A seed vector of ``n`` distinct cells in random order, a few repeated
    later (a cell seeds twice), then ``pad`` padding entries that name real
    cells but are masked out by ``seed_valid``."""
    rng = np.random.default_rng(seed)
    cells = rng.permutation(hw)[:n]
    seeds = np.concatenate([cells, cells[:5], rng.integers(0, hw, pad)])
    valid = np.concatenate([np.ones(n + 5, bool), np.zeros(pad, bool)])
    return seeds.astype(np.int32), valid


@pytest.mark.parametrize("min_inliers", [1, 7])
def test_general_path_shuffled_padded_seeds_match_jax(min_inliers):
    """Two frames of one batch, each with its own shuffled, padded seed
    vector (the padding names cells that would otherwise found clusters
    first), against JAX frame by frame."""
    cfg = ClusterRegionConfig(min_region_inliers=min_inliers, max_regions=16)
    jcfg = JClusterConfig(min_region_inliers=min_inliers, max_regions=16)
    frames = [scene(11), scene(12)]
    hw = 48 * 56
    vecs = [shuffled_seeds(s, hw, 900, 300) for s in (1, 2)]
    got = cluster.segment_clusters(
        _t(np.stack([f[0] for f in frames])),
        _t(np.stack([f[1] for f in frames])),
        _t(np.stack([v[0] for v in vecs])), cfg, 3,
        _t(np.stack([v[1] for v in vecs])))
    for i, ((pts, labels), (seeds, valid)) in enumerate(zip(frames, vecs)):
        want = jax_clusters(pts, labels, seeds, jcfg, 3, valid)
        assert_cluster_equal(got, want, frame=i)
        assert int(got.num_regions[i]) >= 2


def test_general_path_equals_the_canonical_paths():
    """tests/test_cluster.py::TestCanonicalFastPath on the port: the full
    canonical sweep through the general path gives the canonical tails'
    labels (and the sizes tail's table)."""
    pts, labels = scene(11)
    seeds = cluster.canonical_seed_vector(48, 56)
    a = cluster.segment_clusters(_t(pts)[None], _t(labels)[None], seeds,
                                 ClusterRegionConfig(), 3)
    for need_sizes in (True, False):
        b = cluster.segment_clusters(_t(pts)[None], _t(labels)[None], seeds,
                                     ClusterRegionConfig(), 3,
                                     canonical_seeds=True,
                                     need_sizes=need_sizes)
        assert torch.equal(a.labels, b.labels)
        assert torch.equal(a.num_regions, b.num_regions)
        if need_sizes:
            assert torch.equal(a.region_sizes, b.region_sizes)


def test_segment_clusters_signature_matches_jax():
    """JAX's parameters in JAX's order and with its defaults; the port adds
    only ``impl`` at the end."""
    want = inspect.signature(jcluster.segment_clusters).parameters
    got = inspect.signature(cluster.segment_clusters).parameters
    assert list(got)[:-1] == list(want) and list(got)[-1] == "impl"
    for name in ("initial_id_offset", "seed_valid", "canonical_seeds",
                 "need_sizes"):
        assert got[name].default == want[name].default, name


# -- unorganized clouds -------------------------------------------------------

EUCLID = dict(cell_size=0.5, grid_shape=(256, 256))


@pytest.fixture(scope="module")
def jax_euclid():
    pts = nan_blobs()
    fn = jax.jit(lambda p: junorganized.cluster_unorganized(
        p, JClusterConfig(min_region_inliers=500), **EUCLID))
    return pts, fn(jnp.asarray(pts))


def test_cluster_unorganized_matches_jax(jax_euclid):
    pts, want = jax_euclid
    got = unorganized.cluster_unorganized(
        pts, ClusterRegionConfig(min_region_inliers=500), device="cpu",
        **EUCLID)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert int(got.num_regions) == 4


def test_cluster_unorganized_host_matches_device(jax_euclid):
    """tests/test_unorganized.py::test_cluster_unorganized_host_matches_device
    on the port: the native call gives the device path's ids and sizes."""
    pts, want = jax_euclid
    cfg = ClusterRegionConfig(min_region_inliers=500)
    a = unorganized.cluster_unorganized(pts, cfg, device="cpu", **EUCLID)
    b = unorganized.cluster_unorganized_host(pts, cfg, **EUCLID)
    assert int(a.num_regions) == int(b.num_regions)
    for f in ("point_labels", "grid_labels", "region_sizes"):
        np.testing.assert_array_equal(getattr(a, f).numpy(), getattr(b, f),
                                      err_msg=f)


MS = dict(cell_size=0.125, grid_shape=(512, 512), iterations=5)


@pytest.fixture(scope="module")
def ms_cloud():
    """tests/test_unorganized.py's mean-shift cloud (four blobs of 8,000)."""
    return gaussian_blobs(n_per=8000, seed=0)


def test_mean_shift_host_backend_matches_jax(ms_cloud):
    want = junorganized.cluster_unorganized_mean_shift(
        ms_cloud, JClusterConfig(), backend="host", **MS)
    got = unorganized.cluster_unorganized_mean_shift(
        ms_cloud, ClusterRegionConfig(), backend="host", **MS)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(got, f),
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert int(got.num_regions) in (4, 5)


def test_mean_shift_device_backend_agrees_with_host(ms_cloud):
    """JAX's own bound (tests/test_unorganized.py:149-152): >= 99% of the
    points agree; the device closure growth may drop a small satellite."""
    host = unorganized.cluster_unorganized_mean_shift(
        ms_cloud, ClusterRegionConfig(), backend="host", **MS)
    dev = unorganized.cluster_unorganized_mean_shift(
        ms_cloud, ClusterRegionConfig(), backend="device", device="cpu",
        **MS)
    assert (dev.point_labels.numpy() == host.point_labels).mean() > 0.99
    sizes = np.sort(dev.region_sizes.numpy())[::-1]
    assert int(dev.num_regions) >= 4 and (sizes[:4] > 7000).all()


@pytest.mark.parametrize("entry", ["cluster_unorganized",
                                   "cluster_unorganized_mean_shift"])
def test_entry_points_refuse_without_a_card(entry):
    """With their defaults both entry points run on the card (the mean
    shift's default backend is the device one), so here they raise."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        getattr(unorganized, entry)(nan_blobs(100))


@pytest.mark.cuda
def test_cluster_unorganized_card_matches_cpu(cuda_device):
    pts = nan_blobs()
    cfg = ClusterRegionConfig(min_region_inliers=500)
    a = unorganized.cluster_unorganized(pts, cfg, device=cuda_device,
                                        **EUCLID)
    again = unorganized.cluster_unorganized(pts, cfg, device=cuda_device,
                                            **EUCLID)
    b = unorganized.cluster_unorganized(pts, cfg, device="cpu", **EUCLID)
    for f in a._fields:
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
        assert torch.equal(getattr(a, f), getattr(again, f)), f


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(VOXEL_CASES))
def test_voxelize_card_equals_the_host_path(cuda_device, case):
    pts, cell, shape, origin = VOXEL_CASES[case]
    got = voxelize.voxelize_xy(_t(pts).to(cuda_device), cell, shape, origin)
    want = voxelize.voxelize_xy_np(pts, cell, shape, origin)
    for f in ("points", "counts", "point_cell"):
        np.testing.assert_array_equal(getattr(got, f).cpu().numpy(),
                                      getattr(want, f), err_msg=f)
