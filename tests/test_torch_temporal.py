"""Temporal seeds in the port against JAX on the CPU: the quaternion helpers
and Pose, ``seeds_from_last_regions`` and ``append_temporal_to_rank_grid``,
the two-frame ``segment_frame(prev_regions=..., pose_cur_prev=...)`` at 32
slots (word epochs, kernel B1) and 40 slots (flood epochs, kernel B3), and
the epoch kernel's plain version on negative seed ranks (the temporal
seeds rank -1, -2, ...) against JAX's epoch kernel in interpret mode. The
CUDA epoch kernel against its plain version on the epoch inputs of a
temporal frame when a card is present (marker ``cuda``).

Tolerances: seed indices, found flags, rank grids, labels, counts and seed
metrics exact; the pose helpers within 2e-6 (f32 values of order 1; JAX's
rsqrt and its fused multiply-adds may differ from torch's by an ulp);
planes within the conditioning-aware tolerance of the frame tests. The
frames are compared field by field (``frame_arrays``: labels, metrics,
counts, classes, seeds, boundaries) and object by object, but not by the
classification's debug counters: on these axis-aligned scenes JAX's f32
moment sums tilt the floor plane by ~3e-6, which moves one rejection
between the angle and the distance counters (the port before temporal
seeds shows the same on frame 1).
"""

import dataclasses
import inspect
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.models import config as jconfig
from pcseg_tpu.models import pipeline as jpipeline
from pcseg_tpu.models import planar_batched as jpb
from pcseg_tpu.ops import geom as jgeom
from pcseg_tpu.ops import seeds as jseeds
from pcseg_tpu.utils.synthetic import synthetic_room_cloud

from pcseg_tpu_torch.kernels import epoch_word
from pcseg_tpu_torch.models import config, pipeline
from pcseg_tpu_torch.ops import geom, normals, seeds
from tests import fixtures
from tests.test_torch_frame import assert_arrays_equal
from tests.test_torch_kernels import (  # noqa: F401
    _t, cuda_device, epoch_inputs, run_port_epoch)

# one intra-op thread per test process (see test_torch_frame.py)
torch.set_num_threads(1)

POSE_ATOL = 2e-6


def random_quat(rng, spread=1.0):
    q = np.float32([1, 0, 0, 0]) + spread * rng.normal(size=4)
    return (q / np.linalg.norm(q)).astype(np.float32)


def yaw_pose(deg, trans):
    """(quat wxyz, trans) f32 of a rotation by ``deg`` about z."""
    half = math.radians(deg) / 2
    return (np.float32([math.cos(half), 0, 0, math.sin(half)]),
            np.float32(trans))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quaternion_helpers_match_jax(seed):
    rng = np.random.default_rng(seed)
    q_raw = rng.normal(size=(6, 4)).astype(np.float32)
    q = np.stack([random_quat(rng) for _ in range(6)])
    q2 = np.stack([random_quat(rng) for _ in range(6)])
    v = rng.normal(size=(6, 3)).astype(np.float32)
    m = np.asarray(jgeom.quat_to_matrix(jnp.asarray(q)))
    cases = [
        (geom.quat_normalize, jgeom.quat_normalize, (q_raw,)),
        (geom.quat_multiply, jgeom.quat_multiply, (q, q2)),
        (geom.quat_rotate, jgeom.quat_rotate, (q, v)),
        (geom.quat_to_matrix, jgeom.quat_to_matrix, (q,)),
        (geom.matrix_to_quat, jgeom.matrix_to_quat, (m,)),
    ]
    for port_fn, jax_fn, args in cases:
        got = port_fn(*[_t(a) for a in args]).numpy()
        want = np.asarray(jax_fn(*[jnp.asarray(a) for a in args]))
        np.testing.assert_allclose(got, want, rtol=0, atol=POSE_ATOL,
                                   err_msg=port_fn.__name__)
    np.testing.assert_array_equal(geom.quat_identity().numpy(),
                                  np.asarray(jgeom.quat_identity()))


@pytest.mark.parametrize("seed", [5, 6])
def test_pose_matches_jax(seed):
    """Pose against pcseg_tpu.ops.geom.Pose (mirrors tests/test_geom.py::
    TestPose), and the port's own round trips."""
    rng = np.random.default_rng(seed)
    qa, qb = random_quat(rng), random_quat(rng)
    ta, tb = rng.normal(size=(2, 3)).astype(np.float32)
    pts = rng.normal(size=(10, 3)).astype(np.float32)
    ja, jb = jgeom.Pose(jnp.asarray(qa), jnp.asarray(ta)), \
        jgeom.Pose(jnp.asarray(qb), jnp.asarray(tb))
    pa, pb = geom.Pose.from_arrays(ja.quat, ja.trans), \
        geom.Pose.from_arrays(jb.quat, jb.trans)

    def close(got, want):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                                   atol=POSE_ATOL)

    close(pa.apply(_t(pts)), ja.apply(jnp.asarray(pts)))
    close(pa.rotate(_t(pts)), ja.rotate(jnp.asarray(pts)))
    close(pa.rotation_matrix(), ja.rotation_matrix())
    for got, want in ((pa.compose(pb), ja.compose(jb)),
                      (pa.inverse(), ja.inverse())):
        close(got.quat, want.quat)
        close(got.trans, want.trans)
    m = np.asarray(ja.rotation_matrix())
    jm = jgeom.Pose.from_matrix(jnp.asarray(m), jnp.asarray(ta))
    pm = geom.Pose.from_matrix(_t(m), _t(ta))
    close(pm.quat, jm.quat)
    close(pm.trans, jm.trans)
    # the port's own round trips
    back = pa.inverse().apply(pa.apply(_t(pts)))
    np.testing.assert_allclose(back.numpy(), pts, atol=1e-5)
    q2 = geom.matrix_to_quat(geom.quat_to_matrix(_t(qa))).numpy()
    assert np.allclose(q2, qa, atol=1e-5) or np.allclose(q2, -qa, atol=1e-5)
    ident = geom.Pose.identity()
    np.testing.assert_array_equal(ident.apply(_t(pts)).numpy(), pts)


_jax_last_regions = jax.jit(jseeds.seeds_from_last_regions,
                            static_argnums=(7, 8))


def last_regions_both(pts, nrm, cents, norms, counts, valid, quat, trans,
                      max_distance, angle):
    """(JAX's indices, found), (the port's): JAX jitted, as its pipeline
    runs it."""
    ji, jf = _jax_last_regions(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(cents),
        jnp.asarray(norms), jnp.asarray(counts), jnp.asarray(valid),
        jgeom.Pose(jnp.asarray(quat), jnp.asarray(trans)), max_distance,
        angle)
    pi, pf = seeds.seeds_from_last_regions(
        _t(pts)[None], _t(nrm)[None], _t(cents)[None], _t(norms)[None],
        _t(counts)[None], _t(valid)[None], geom.Pose.from_arrays(quat, trans),
        max_distance, angle)
    return (np.asarray(ji), np.asarray(jf)), (pi[0].numpy(), pf[0].numpy())


def port_normals(pts, origin):
    """Normals as the seeds' input (the same array goes to both
    packages; tests/test_torch_ops.py holds the port's normals to
    JAX's)."""
    return normals.compute_normals_organized(
        _t(pts)[None], _t(origin)).numpy()[0]


def last_regions_case(name):
    ident = (np.float32([1, 0, 0, 0]), np.zeros(3, np.float32))
    if name == "two_regions":  # tests/test_cloud.py::TestTemporalSeeds
        pts, origin = fixtures.synthetic_room_cloud(32, 40, f=32.0, seed=4)
        return (pts, port_normals(pts, origin),
                np.float32([[2.0, 0.0, -1.0], [4.0, 0.0, 0.5]]),
                np.float32([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0]]),
                np.int32([500, 100]), np.array([True, True])) + ident \
            + (1.0, 0.3)
    if name == "out_of_range":
        pts, origin = fixtures.synthetic_room_cloud(24, 24, f=24.0, seed=4)
        return (pts, port_normals(pts, origin), np.float32([[100, 100, 100]]),
                np.float32([[0, 0, 1]]), np.int32([10]),
                np.array([True])) + ident + (1.0, 0.3)
    # six previous regions in pairs of equal count (the region index
    # breaks the tie), one of them invalid, moved by a non-identity pose
    pts, origin = synthetic_room_cloud(48, 64, f=48.0, seed=3)
    nrm = port_normals(pts, origin)
    rng = np.random.default_rng(4)
    ok = np.argwhere(np.isfinite(nrm).all(-1))
    sel = ok[rng.choice(len(ok), 6, replace=False)]
    quat, trans = yaw_pose(3.0, [0.05, 0.02, 0.0])
    inv = jgeom.Pose(jnp.asarray(quat), jnp.asarray(trans)).inverse()
    cents = np.asarray(inv.apply(jnp.asarray(pts[sel[:, 0], sel[:, 1]]
                                             + np.float32(0.03))))
    norms = np.asarray(inv.rotate(jnp.asarray(nrm[sel[:, 0], sel[:, 1]])))
    return (pts, nrm, cents.astype(np.float32), norms.astype(np.float32),
            np.int32([200, 200, 100, 100, 300, 300]),
            np.array([True, True, True, False, True, True]), quat, trans,
            0.5, 0.2)


@pytest.mark.parametrize("case", ["two_regions", "out_of_range",
                                  "posed_equal_counts"])
def test_seeds_from_last_regions_matches_jax(case):
    """Indices and found flags exact against JAX (the [R, H*W] distance
    and normal dots are evaluated in JAX's fused multiply-add order, so no
    near-tie flips the argmin on these scenes), in the multimap order."""
    args = last_regions_case(case)
    (ji, jf), (pi, pf) = last_regions_both(*args)
    np.testing.assert_array_equal(pf, jf)
    np.testing.assert_array_equal(pi[pf], ji[jf])
    np.testing.assert_array_equal(pi, ji)
    if case == "two_regions":
        assert pf.all()
        h = 32
        # ascending count: the wall region (100) first
        for k, (c, n) in enumerate([([4.0, 0.0, 0.5], [-1, 0, 0]),
                                    ([2.0, 0.0, -1.0], [0, 0, 1])]):
            r, col = int(pi[k]) % h, int(pi[k]) // h
            assert np.linalg.norm(args[0][r, col] - np.asarray(c)) < 1.0
            assert args[1][r, col] @ np.asarray(n) > np.cos(0.3)
    elif case == "out_of_range":
        assert not pf[0]
    else:
        # counts 100 (index 2; index 3 invalid), 200, 200, 300, 300
        assert pf.tolist() == [True, False, True, True, True, True]


def test_append_temporal_to_rank_grid_matches_jax():
    rng = np.random.default_rng(2)
    h, w = 20, 24
    grid = rng.integers(0, 5000, (h, w)).astype(np.int32)
    grid[rng.random((h, w)) < 0.5] = seeds.SEED_RANK_INF
    t_idx = np.int32([5, h * w + 3, 17, -2, 5, 400])
    t_found = np.array([True, True, False, True, True, True])
    want = np.asarray(jseeds.append_temporal_to_rank_grid(
        jnp.asarray(grid), jnp.asarray(t_idx), jnp.asarray(t_found)))
    got = seeds.append_temporal_to_rank_grid(
        _t(grid)[None], _t(t_idx)[None], _t(t_found)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    # cell 5 (col-major) twice: the later append (rank -5) pops first
    assert got.T.reshape(-1)[5] == -5 and got.min() == -6


def test_segment_frame_takes_jax_parameters():
    """JAX's parameter order, the sixth positional argument being the
    input mask, and the pose_cur_prev keyword."""
    names = list(inspect.signature(
        pipeline.Segmenter.segment_frame).parameters)
    assert names == list(inspect.signature(
        jpipeline.Segmenter.segment_frame).parameters)
    pts, origin = fixtures.synthetic_room_cloud(24, 24, f=24.0, seed=2)
    mask = np.full((24, 24), config.UNLABELED, np.int32)
    mask[:4, :4] = config.MASKED_EGO
    seg = pipeline.Segmenter(device="cpu")
    first = seg.segment_frame(pts, origin)
    pose = geom.Pose.identity()
    a = seg.segment_frame(pts, origin, None, first.planar_regions, pose, mask)
    b = seg.segment_frame(pts, origin, prev_regions=first.planar_regions,
                          pose_cur_prev=pose, input_mask=mask)
    np.testing.assert_array_equal(a.labels, b.labels)
    assert (a.labels[:4, :4] == config.MASKED_EGO).all()


def assert_same_frame(got, want, points):
    """FrameResults of the port and JAX: the flat arrays (exact but for
    planes, centroids and areas, see test_torch_frame.assert_arrays_equal)
    and every detected object's class and points."""
    assert_arrays_equal(pipeline.frame_arrays(got),
                        pipeline.frame_arrays(want), points)
    assert len(got.objects) == len(want.objects)
    for a, b in zip(got.objects, want.objects):
        assert a.object_class == b.object_class
        np.testing.assert_array_equal(a.points, b.points)


def temporal_configs(k, only_transferred):
    """(frame-1 config, frame-2 config) of JAX; frame 2 seeds from the
    previous regions within 0.5 m and 0.2 rad. With ``only_transferred``
    the per-frame finder needs an impossible support (as
    tests/test_pipeline.py::TestTemporalSeeds)."""
    planar = jconfig.PlanarRegionConfig(max_regions=k)
    cfg1 = jpipeline.SegmenterConfig(run_clustering=False, planar=planar)
    cfg2 = jpipeline.SegmenterConfig(
        run_clustering=False,
        plane_support_seeds=dataclasses.replace(
            jconfig.SeedsFromPlaneSupportParams(),
            min_num_support_points=10 ** 6 if only_transferred else 10),
        planar=dataclasses.replace(
            planar, max_distance_for_seed_point=0.5,
            max_normal_difference_angle_for_seed_point=0.2))
    return cfg1, cfg2


def port_segmenter(jax_cfg, impl=None):
    return pipeline.Segmenter(
        config.config_from_dict(dataclasses.asdict(jax_cfg)), device="cpu",
        impl=impl)


@pytest.mark.parametrize("k", [32, 40])
def test_transferred_seeds_found_regions_like_jax(k):
    """tests/test_pipeline.py::TestTemporalSeeds at 32 and 40 slots: frame 2
    has no per-frame seeds, so only the transferred ones found regions.
    Frame 1 and frame 2 equal JAX's, frame 2 with JAX's frame-1 records
    and with the port's."""
    pts, origin = fixtures.synthetic_room_cloud(40, 40, f=40.0, seed=2)
    cfg1, cfg2 = temporal_configs(k, only_transferred=True)
    j1 = jpipeline.Segmenter(cfg1).segment_frame(pts, origin)
    p1 = port_segmenter(cfg1).segment_frame(pts, origin)
    assert_same_frame(p1, j1, pts)
    assert j1.metrics.num_planar_regions >= 2
    jseg2, pseg2 = jpipeline.Segmenter(cfg2), port_segmenter(cfg2)
    assert pseg2.segment_frame(pts, origin).metrics.num_planar_regions == 0
    j2 = jseg2.segment_frame(pts, origin, prev_regions=j1.planar_regions)
    for prev in (j1.planar_regions, p1.planar_regions):
        p2 = pseg2.segment_frame(pts, origin, prev_regions=prev)
        assert_same_frame(p2, j2, pts)
    assert p2.metrics.num_planar_regions == j1.metrics.num_planar_regions
    assert p2.metrics.num_seeds == j2.metrics.num_seeds


def moved_frame(pts, quat, trans):
    """The f32 points of ``pts`` seen after the sensor moved: p' = R p + t
    (NaN cells stay NaN), computed in NumPy so that both packages read the
    same input."""
    rot = np.asarray(jgeom.quat_to_matrix(jnp.asarray(quat)), np.float32)
    return (pts @ rot.T + trans).astype(np.float32), rot


@pytest.mark.parametrize("seed_method", ["plane_support",
                                         "average_normals"])
def test_posed_temporal_frame_matches_jax(seed_method):
    """Frame 2 is frame 1 under a known pose (3 degrees about z, (0.05,
    0.02, 0) m), with the per-frame seeds and the transferred ones, 32
    slots: equal to JAX's. With plane-support seeds the transferred seeds
    join the rank grid at ranks -1, -2, ...; with average-normal seeds they
    are appended to the seed vector (and the seed count is JAX's, which
    counts the found temporal seeds twice)."""
    pts, origin = synthetic_room_cloud(48, 64, f=48.0, seed=3)
    quat, trans = yaw_pose(3.0, [0.05, 0.02, 0.0])
    pts2, rot = moved_frame(pts, quat, trans)
    origin2 = (rot @ origin + trans).astype(np.float32)
    cfg1, cfg2 = (dataclasses.replace(c, seed_method=seed_method)
                  for c in temporal_configs(32, only_transferred=False))
    j1 = jpipeline.Segmenter(cfg1).segment_frame(pts, origin)
    jpose = jgeom.Pose(jnp.asarray(quat), jnp.asarray(trans))
    j2 = jpipeline.Segmenter(cfg2).segment_frame(
        pts2, origin2, None, j1.planar_regions, jpose)
    pseg2 = port_segmenter(cfg2)
    p2 = pseg2.segment_frame(pts2, origin2, None, j1.planar_regions,
                             geom.Pose.from_arrays(quat, trans))
    assert_same_frame(p2, j2, pts2)
    # a JAX pose object is taken as it is
    p2j = pseg2.segment_frame(pts2, origin2, prev_regions=j1.planar_regions,
                              pose_cur_prev=jpose)
    np.testing.assert_array_equal(p2j.labels, p2.labels)


def negative_rank_epoch(k_cap, seed=0):
    """epoch_inputs with the rank grid and the slot ranks shifted so that
    about a quarter are negative (as the temporal seeds' -1, -2, ...)."""
    inp = epoch_inputs(2, 32, 48, k_cap, seed)
    inf = seeds.SEED_RANK_INF
    for name in ("rank", "srank"):
        a = inp[name].astype(np.int64)
        inp[name] = np.where(a < inf, a - (inf // 8), a).astype(np.int32)
    assert (inp["rank"] < 0).any() and (inp["srank"] < 0).any()
    return inp


def test_epoch_plain_on_negative_ranks_matches_pallas_interpret():
    """The epoch's plain version against JAX's epoch kernel (interpret
    mode) on negative seed and slot ranks: words, counts, member ranks and
    anchors exact (K = 8, as test_torch_kernels.py)."""
    k_cap, rounds = 8, 64
    inp = negative_rank_epoch(k_cap)
    b, h, w = inp["rank"].shape
    call = jpb._epoch_kernel_batched(h, w, k_cap, 0.05, rounds, True, b)
    j = call(jnp.asarray(inp["radius"]).reshape(b, 1, 1),
             *[jnp.asarray(inp[n]) for n in ("px", "py", "pz", "rank",
                                              "elig")],
             jnp.asarray(inp["word"].view(np.uint32)),
             *[jnp.asarray(inp[n])[:, None] for n in
               ("srank", "alive", "plane", "anchor_r", "anchor_c")])
    j_word, j_cnt, j_mrank, j_alin, _ = (np.asarray(x) for x in j)
    word, cnt, mrank, alin, _ = run_port_epoch(inp, rounds=rounds)
    np.testing.assert_array_equal(word, j_word.view(np.int32))
    np.testing.assert_array_equal(cnt, j_cnt[:, 0])
    np.testing.assert_array_equal(mrank, j_mrank[:, 0])
    np.testing.assert_array_equal(alin, j_alin[:, 0])
    assert (mrank < 0).any()


@pytest.mark.cuda
def test_epoch_kernel_on_temporal_frame_matches_plain(cuda_device):
    """B1 on the epoch inputs of a temporal frame (captured from a plain
    run; its rank grid holds the transferred seeds' negative ranks):
    exact but for the moments (f64 sums in two orders, 1e-6)."""
    pts, origin = synthetic_room_cloud(96, 128, f=96.0, seed=3)
    quat, trans = yaw_pose(3.0, [0.05, 0.02, 0.0])
    pts2, rot = moved_frame(pts, quat, trans)
    cfg1, cfg2 = temporal_configs(32, only_transferred=False)
    prev = port_segmenter(cfg1).segment_frame(pts, origin).planar_regions
    seen = []
    real = epoch_word.epoch_word

    def spy(*args, **kw):
        seen.append(args)
        return real(*args, **kw)

    epoch_word.epoch_word = spy
    try:
        pipeline.Segmenter(
            config.config_from_dict(dataclasses.asdict(cfg2)),
            device=cuda_device, impl="plain").segment_frame(
                pts2, (rot @ origin + trans).astype(np.float32), None, prev,
                geom.Pose.from_arrays(quat, trans))
    finally:
        epoch_word.epoch_word = real
    args = seen[0]
    assert bool((args[3] < 0).any()), "the rank grid has no temporal seeds"
    got = epoch_word.epoch_word(*args)
    want = epoch_word.epoch_word(*args, impl="plain")
    for g, w_ in zip(got[:4], want[:4]):
        assert torch.equal(g, w_)
    torch.testing.assert_close(got[4], want[4], rtol=1e-6, atol=1e-5)
