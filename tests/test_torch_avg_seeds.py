"""Average-normal seeds in the port against JAX on the CPU:
``seeds_from_average_normals`` and ``average_normal_seed_list`` on square
and rectangular grids with NaN holes and on a grid where windows whose
first row has no valid normal are rejected (the reference's 0/0), then the
serving path ``device_forward_stream`` and ``segment_frame`` with
``seed_method="average_normals"``.

Tolerances: masks, seed indices and seed vectors exact, and the scores
bit-exact against JAX's jitted finder (the box sums follow XLA:CPU's
blocked cumsum and the squares its fused multiply-adds); labels, counts
and metrics exact; planes within the conditioning-aware tolerance of the
frame tests.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.models import pipeline as jpipeline
from pcseg_tpu.models.config import SeedsFromAverageNormalsParams
from pcseg_tpu.ops import seeds as jseeds
from pcseg_tpu.ops import unproject as junproject
from pcseg_tpu.utils.synthetic import synthetic_cluttered_room_cloud

from pcseg_tpu_torch.models import config, pipeline
from pcseg_tpu_torch.ops import seeds
from tests.test_torch_frame import assert_arrays_equal
from tests.test_torch_grower import assert_planes
from tests.test_torch_kernels import _t

# one intra-op thread per test process (see test_torch_frame.py)
torch.set_num_threads(1)

AVG_CFG = jpipeline.SegmenterConfig(seed_method="average_normals")


def noisy_normals(h, w, seed, holes=0.05):
    """[H, W, 3] f32 unit normals near +z with NaN holes."""
    rng = np.random.default_rng(seed)
    n = np.float32([0, 0, 1]) + rng.normal(0, 0.15, (h, w, 3))
    n = (n / np.linalg.norm(n, axis=-1, keepdims=True)).astype(np.float32)
    n[rng.random((h, w)) < holes] = np.nan
    return n


def first_row_empty_normals():
    """A 24x24 grid (square: the transposed indexing reads it as is) with
    the columns 6-10 all NaN: windows whose first (transposed) row falls
    there are rejected by the 0/0 even when the rest of the window is
    valid."""
    n = noisy_normals(24, 24, 3, holes=0.0)
    n[:, 6:11] = np.nan
    return n


_jax_finder = jax.jit(jseeds.seeds_from_average_normals,
                      static_argnums=(1,))


@pytest.mark.parametrize("shape,params", [
    ((32, 32), SeedsFromAverageNormalsParams()),
    ((40, 56), SeedsFromAverageNormalsParams()),
    ((56, 40), SeedsFromAverageNormalsParams(neighborhood_size=7,
                                             min_avg_normal_length=0.9)),
    ((200, 24), SeedsFromAverageNormalsParams()),
    ("first_row_empty", SeedsFromAverageNormalsParams()),
])
def test_average_normal_seeds_match_jax(shape, params):
    nrm = first_row_empty_normals() if shape == "first_row_empty" \
        else noisy_normals(*shape, seed=sum(shape))
    want = _jax_finder(jnp.asarray(nrm), params)
    got = seeds.seeds_from_average_normals(
        _t(nrm)[None], config.SeedsFromAverageNormalsParams(
            **dataclasses.asdict(params)))
    np.testing.assert_array_equal(got.mask[0].numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.seed_index[0].numpy(),
                                  np.asarray(want.seed_index))
    np.testing.assert_array_equal(got.score[0].numpy(),
                                  np.asarray(want.score))
    assert 0 < int(got.mask.sum()) < nrm.shape[0] * nrm.shape[1]
    for max_seeds in (16, 4096):
        j_idx, j_valid = jseeds.average_normal_seed_list(want, max_seeds)
        p_idx, p_valid = seeds.average_normal_seed_list(got, max_seeds)
        np.testing.assert_array_equal(p_idx[0].numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(p_valid[0].numpy(),
                                      np.asarray(j_valid))
    if shape == "first_row_empty":
        # rows 6-10 of the transposed grid: a valid window there is rejected
        # only by the empty first row
        assert not got.mask[0, 6 + 2:11 + 2].any()


def test_stream_with_average_normal_seeds_matches_jax():
    """device_forward_stream at 96x128, B = 2 (two jittered frames of the
    cluttered scene): labels, counts exact, planes within tolerance."""
    pts, _ = synthetic_cluttered_room_cloud(96, 128, f=96.0, seed=5)
    d16 = junproject.encode_range(pts)
    depth = np.stack([d16, np.where(d16 > 0, d16 + 3, 0).astype(np.uint16)])
    rays = junproject.camera_ray_table(96, 128, f=96.0)
    want = [np.asarray(o) for o in jpipeline.Segmenter(AVG_CFG)
            .device_forward_stream(depth, rays, np.zeros(3, np.float32),
                                   junproject.DEFAULT_DEPTH_SCALE)]
    seg = pipeline.Segmenter(
        config.config_from_dict(dataclasses.asdict(AVG_CFG)), device="cpu")
    labels, npl, ncl, planes = (o.numpy() for o in seg.device_forward_stream(
        _t(depth), _t(rays), torch.zeros(3)))
    np.testing.assert_array_equal(labels, want[0])
    np.testing.assert_array_equal(npl, want[1])
    np.testing.assert_array_equal(ncl, want[2])
    assert (npl > 0).all()
    assert_planes(planes, want[3], labels,
                  junproject.unproject_range_np(depth, rays), npl)


@pytest.mark.parametrize("entry", ["frame", "stream"])
def test_frame_with_average_normal_seeds_matches_jax(entry):
    """segment_frame and segment_frame_stream at 96x128 on the cluttered
    scene: every field of the frame exact but planes, centroids (the frame
    tests' tolerance) and areas (rtol 1e-5); seed counts exact."""
    pts, origin = synthetic_cluttered_room_cloud(96, 128, f=96.0, seed=6)
    d16 = junproject.encode_range(pts)
    rays = junproject.camera_ray_table(96, 128, f=96.0)
    p32 = junproject.unproject_range_np(d16, rays)
    port = pipeline.Segmenter(
        config.config_from_dict(dataclasses.asdict(AVG_CFG)), device="cpu")
    jseg = jpipeline.Segmenter(AVG_CFG)
    if entry == "frame":
        got, want = (s.segment_frame(p32, origin) for s in (port, jseg))
    else:
        got, want = (s.segment_frame_stream(d16, rays, origin)
                     for s in (port, jseg))
    assert_arrays_equal(pipeline.frame_arrays(got),
                        pipeline.frame_arrays(want), p32)
    assert got.metrics.num_planar_regions > 0
    assert len(got.objects) == len(want.objects)


def test_stream_golden_128x160_differs_only_as_known():
    """The committed average-normal stream golden (128x160, B = 2), which
    the card run reads: frame 0 exact (labels, counts, planes within
    tolerance); frame 1 differs as chip_smoke.AVG_STREAM_KNOWN records (the
    port's closure epochs end with 13 device regions, JAX's with 12; see
    test_f64_refit_sums_give_the_port_s_frame)."""
    import chip_smoke
    from tests.test_torch_golden_options import STREAM_GOLDEN
    gold = np.load(STREAM_GOLDEN)
    rays = junproject.camera_ray_table(128, 160, f=128.0)
    seg = pipeline.Segmenter(
        config.config_from_dict(dataclasses.asdict(AVG_CFG)), device="cpu")
    labels, npl, ncl, planes = (o.numpy() for o in seg.device_forward_stream(
        _t(gold["depth"]), _t(rays), torch.zeros(3)))
    np.testing.assert_array_equal(ncl, gold["num_clusters"])
    np.testing.assert_array_equal(labels[0], gold["labels"][0])
    assert npl[0] == gold["num_planar"][0]
    points = junproject.unproject_range_np(gold["depth"], rays)
    assert_planes(planes[:1], gold["planes"][:1], labels[:1], points[:1],
                  npl[:1])
    for b, known in chip_smoke.AVG_STREAM_KNOWN.items():
        assert dict(num_planar=int(npl[b]),
                    golden_num_planar=int(gold["num_planar"][b]),
                    cells=int((labels[b] != gold["labels"][b]).sum())) == known


def test_f64_refit_sums_give_the_port_s_frame():
    """Where frame 1 of the stream golden differs, the difference is the
    precision of JAX's refit moment sums (f32; the port's are f64): JAX's
    grower with those sums taken in f64 (a host callback) gives the port's
    grower labels exactly at 32 slots, from the same normals and rank
    grid, where its own f32 sums give other labels."""
    import jax.numpy as jnp_
    from pcseg_tpu.models import planar_batched as jpb
    from pcseg_tpu.models.config import PlanarRegionConfig
    from pcseg_tpu.ops import normals as jnormals
    from pcseg_tpu_torch.models import planar_batched
    from tests.test_torch_golden_options import STREAM_GOLDEN

    gold = np.load(STREAM_GOLDEN)
    rays = junproject.camera_ray_table(128, 160, f=128.0)
    pts = junproject.unproject_range_np(gold["depth"][1], rays)
    nrm = jax.jit(jnormals.compute_normals_organized)(
        jnp.asarray(pts), jnp.zeros(3))
    idx, valid = jseeds.average_normal_seed_list(
        jseeds.seeds_from_average_normals(nrm), 4096)
    rank = jpb.rank_grid_from_seed_vector(idx, valid, 128, 160)
    labels0 = jnp.full((128, 160), config.UNLABELED, jnp.int32)

    def f64_sums(a, b):
        shape = jax.ShapeDtypeStruct(a.shape[:-1] + b.shape[-1:],
                                     jnp.float32)
        return jax.pure_callback(
            lambda x, y: np.matmul(np.asarray(x, np.float64),
                                   np.asarray(y, np.float64))
            .astype(np.float32), shape, a, b)

    class F64Sums:  # jax.numpy with the [.., 10]-moment products in f64
        def __getattr__(self, name):
            return getattr(jnp_, name)

        @staticmethod
        def dot(a, b, **kw):
            return f64_sums(a, b) if b.shape[-1] == 10 else \
                jnp_.dot(a, b, **kw)

        @staticmethod
        def matmul(a, b, **kw):
            return f64_sums(a, b) if b.shape[-1] == 10 else \
                jnp_.matmul(a, b, **kw)

    def jax_grow():
        grow = jax.jit(lambda p, n, l, r: jpb.grow_planar_regions_batched(
            p, n, l, None, None, PlanarRegionConfig(),
            seed_rank_grid=r).labels)
        return np.asarray(grow(jnp.asarray(pts), nrm, labels0, rank))

    want32 = jax_grow()
    real = jpb.jnp
    jpb.jnp = F64Sums()
    try:
        want64 = jax_grow()
    finally:
        jpb.jnp = real
    got = planar_batched.grow_planar_regions_batched(
        _t(pts)[None], _t(np.asarray(nrm))[None],
        torch.full((1, 128, 160), config.UNLABELED, dtype=torch.int32),
        _t(np.asarray(rank))[None], config.PlanarRegionConfig())
    np.testing.assert_array_equal(got.labels[0].numpy(), want64)
    assert int(got.num_regions[0]) == len(np.unique(want64[want64 >= 0]))
    assert (want32 != want64).sum() > 0
