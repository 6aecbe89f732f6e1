"""The port's public functions at JAX's calling conventions, against JAX on
the CPU: JAX's single-frame shapes in ([H, W, 3] points and normals, [H, W]
grids and masks, [S] seed vectors), JAX's shapes out, and JAX's parameter
lists, with the port's leading batch axis still taken (frame 0 of the
batched call equals the single frame).

Inputs are made from numpy seeds: the 40x56 room scene of JAX's own tests
(``synthetic_room_cloud(40, 56, f=40.0, seed=1)``), the cluttered scene at
40x56 and 128x160, and small fixtures. Labels, ranks, indices, counts and
grids are exact; normals hold to test_torch_ops.py's 1e-5 and planes to
test_torch_grower.py's tolerance.

The grower runs with JAX's full signature at a non-default schedule, a
binding ``flood_rounds`` and an id offset: on the 40x56 cluttered scene
at 32 slots against JAX's grower called as is (its stage-A and epoch
loops compiled, the rest op by op), and on the 128x160 cluttered scene
(patched stage A) at 32 and 64 slots against
``jax_conventions_128x160.npz``, JAX's jitted grower (rewrite with
``JAX_PLATFORMS=cpu python -m tests.test_torch_jax_conventions``). Jitted
whole on the 40x56 cluttered scene at 32 slots, JAX's grower keeps one
more one-cell slot: XLA:CPU fuses the moment solve of a single point into
an f32 cancellation that passes the validity test
(``test_jitted_solve_of_one_point_is_valid``), so that slot never dissolves
into its neighbour; the port, JAX's unjitted grower and JAX's eager solve
reject the one-point fit.
"""

import dataclasses
import functools
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcseg_tpu.models import cluster as jcluster
from pcseg_tpu.models import mean_shift as jms
from pcseg_tpu.models import planar as jplanar
from pcseg_tpu.models import planar_batched as jpb
from pcseg_tpu.models import config as jconfig
from pcseg_tpu.ops import connectivity as jconn
from pcseg_tpu.ops import discontinuity as jdisc
from pcseg_tpu.ops import geom as jgeom
from pcseg_tpu.ops import normals as jnormals
from pcseg_tpu.ops import plane_fit as jplane_fit
from pcseg_tpu.ops import seeds as jseeds
from pcseg_tpu.ops import unproject as junproject
from pcseg_tpu.utils.synthetic import (analytic_plane_cloud,
                                       synthetic_cluttered_room_cloud,
                                       synthetic_room_cloud)

from pcseg_tpu_torch.models import (cluster, config, mean_shift, planar,
                                    planar_batched)
from pcseg_tpu_torch.ops import (connectivity, discontinuity, geom, normals,
                                 plane_fit, seeds)
from pcseg_tpu_torch.parallel import halo, sharded
from tests.test_mean_shift import blob_cloud
from tests.test_torch_grower import (assert_planes, assert_region_table,
                                     region_table)

# One intra-op thread: the suite runs in parallel worker processes, and
# OpenMP teams spinning across them slow every small op by orders of
# magnitude.
torch.set_num_threads(1)

UNLABELED = config.UNLABELED
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pcseg_tpu_torch", "testdata", "jax_conventions_128x160.npz")
# the region table of the same JAX runs (centroids, curvatures, moments)
GOLDEN_TABLE = GOLDEN.replace("128x160", "table_128x160")
# the non-default schedules: a binding flood cap (2 rounds; the flood needs
# more on both scenes), an id offset, other stage-A splits and closure
# counts; (26, 1) and (9, 3) both leave room for the 64x64 patches
SCHEDULE_40X56 = dict(initial_id_offset=7, stage_a_gens=26, stage_a_rings=1,
                      closure_epochs=0, flood_rounds=2)
SCHEDULE_128X160 = dict(initial_id_offset=5, stage_a_gens=9, stage_a_rings=3,
                        closure_epochs=1, flood_rounds=2)
GROWER_FIELDS = ("labels", "num_regions", "counts", "seed_indices",
                 "overflow")
# the region table against JAX: tests/test_torch_grower.region_bars
TABLE_FIELDS = ("centroids", "curvatures", "s2", "s1", "w", "normal_hint")


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable, contiguous copy


def _np(x):
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def scene(name, h, w):
    """(points [H, W, 3] f32, origin [3], JAX's normals [H, W, 3])."""
    if name == "room":
        pts, origin = synthetic_room_cloud(h, w, f=float(h), seed=1)
    else:
        pts, origin = synthetic_cluttered_room_cloud(h, w, f=float(h),
                                                     seed=5)
        rays = junproject.camera_ray_table(h, w, f=float(h))
        pts = junproject.unproject_range_np(junproject.encode_range(pts),
                                            rays)
    pts = pts.astype(np.float32)
    nrm = _np(jax.jit(jnormals.compute_normals_organized)(
        jnp.asarray(pts), jnp.asarray(origin)))
    return pts, np.asarray(origin, np.float32), nrm


def assert_tuple_equal(got, want, fields, batched=None):
    """Exact equality of NamedTuple fields; ``batched`` (the port's batched
    result) must hold the single frame as its frame 0."""
    for f in fields:
        g = getattr(got, f).numpy()
        np.testing.assert_array_equal(g, _np(getattr(want, f)), err_msg=f)
        if batched is not None:
            np.testing.assert_array_equal(getattr(batched, f)[0].numpy(), g,
                                          err_msg=f)


# -- seeds -------------------------------------------------------------------


@pytest.mark.parametrize("transposed_parity", [True, False])
def test_plane_support_seeds_single_frame(transposed_parity):
    """The repaired silent fault: [H, W] rank grid and counts (not
    [H, W, 3]), the [S] seed vector, JAX's values."""
    pts, _, nrm = scene("room", 40, 56)
    want = jax.jit(jseeds.seeds_from_plane_support, static_argnums=(2, 3))(
        jnp.asarray(pts), jnp.asarray(nrm),
        jseeds.SeedsFromPlaneSupportParams(), transposed_parity)
    got = seeds.seeds_from_plane_support(
        _t(pts), _t(nrm), config.SeedsFromPlaneSupportParams(),
        transposed_parity, seed_vector=True)
    batched = seeds.seeds_from_plane_support(
        _t(pts)[None], _t(nrm)[None],
        transposed_parity=transposed_parity, seed_vector=True)
    assert got.rank_grid.shape == (40, 56) and got.count.shape == (40, 56)
    assert got.indices.shape == want.indices.shape
    assert_tuple_equal(got, want, seeds.RankedSeeds._fields, batched)
    assert (got.rank_grid < seeds.SEED_RANK_INF).sum() > 100
    assert seeds.seeds_from_plane_support(
        _t(pts), _t(nrm)).indices is None  # ranked only on request


def test_average_normal_seeds_single_frame():
    """The second silent fault: mask, seed index and score [H, W]; the
    seed list [S]."""
    _, _, nrm = scene("room", 40, 56)
    want = jax.jit(jseeds.seeds_from_average_normals)(jnp.asarray(nrm))
    got = seeds.seeds_from_average_normals(_t(nrm))
    batched = seeds.seeds_from_average_normals(_t(nrm)[None])
    assert got.mask.shape == (40, 56)
    assert_tuple_equal(got, want, seeds.SeedMask._fields, batched)
    assert int(got.mask.sum()) > 100
    want_idx, want_valid = jseeds.average_normal_seed_list(want, 600)
    got_idx, got_valid = seeds.average_normal_seed_list(got, 600)
    np.testing.assert_array_equal(got_idx.numpy(), _np(want_idx))
    np.testing.assert_array_equal(got_valid.numpy(), _np(want_valid))


def test_temporal_seeds_single_frame():
    pts, _, nrm = scene("room", 40, 56)
    rng = np.random.default_rng(3)
    cells = rng.integers(0, 40 * 56, 6)
    cents = pts.reshape(-1, 3)[cells] + rng.normal(0, 0.02, (6, 3))
    cents = np.nan_to_num(cents).astype(np.float32)
    norms = np.nan_to_num(nrm.reshape(-1, 3)[cells],
                          nan=1.0).astype(np.float32)
    counts = rng.integers(10, 500, 6).astype(np.int32)
    valid = np.array([1, 1, 0, 1, 1, 1], bool)
    quat = np.float32([0.999, 0.02, -0.01, 0.03])
    quat /= np.linalg.norm(quat)
    trans = np.float32([0.05, -0.02, 0.01])
    args = (0.3, np.deg2rad(20.0))
    want = jax.jit(jseeds.seeds_from_last_regions, static_argnums=(7, 8))(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(cents),
        jnp.asarray(norms), jnp.asarray(counts), jnp.asarray(valid),
        jgeom.Pose(jnp.asarray(quat), jnp.asarray(trans)), *args)
    got = seeds.seeds_from_last_regions(
        _t(pts), _t(nrm), _t(cents), _t(norms), _t(counts), _t(valid),
        geom.Pose.from_arrays(quat, trans), *args)
    for g, w in zip(got, want):
        assert g.shape == (6,)
        np.testing.assert_array_equal(g.numpy(), _np(w))
    assert int(got[1].sum()) >= 3
    grid = jax_ranked("room", 40, 56).rank_grid
    want_grid = jseeds.append_temporal_to_rank_grid(
        jnp.asarray(grid), want[0], want[1])
    got_grid = seeds.append_temporal_to_rank_grid(_t(grid), *got)
    assert got_grid.shape == (40, 56)
    np.testing.assert_array_equal(got_grid.numpy(), _np(want_grid))


# -- normals ---------------------------------------------------------------


def test_normals_single_frame():
    """The room scene at JAX's own bar for it (tests/test_normals.py::
    test_room_scene: 0.5 degrees), as its corner fits sit near the
    eigensolve's knife edges, where JAX's fused f32 and the port's
    unfused f32 part by up to ~0.1 degree; test_torch_ops.py holds the
    u16 cluttered scene to 1e-5."""
    pts, origin, want = scene("room", 40, 56)
    got = normals.compute_normals_organized(_t(pts), _t(origin)).numpy()
    assert got.shape == (40, 56, 3)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want).all(-1)
    cos = np.clip((got[ok] * want[ok]).sum(-1), -1.0, 1.0)
    assert np.degrees(np.arccos(cos)).max() <= 0.5
    batched = normals.compute_normals_organized(_t(pts)[None], _t(origin))
    np.testing.assert_array_equal(batched[0].numpy(), got)
    params = config.ComputeNormalsParams()
    support = normals.find_normal_support(_t(pts), params)
    j_support = jnormals.find_normal_support(
        jnp.asarray(pts), jnormals.ComputeNormalsParams())
    for f in ("count", "center_valid"):  # and every moment field, exact
        np.testing.assert_array_equal(getattr(support, f).numpy(),
                                      _np(getattr(j_support, f)), err_msg=f)
    for f in plane_fit.PlaneMoments._fields:
        np.testing.assert_array_equal(getattr(support.moments, f).numpy(),
                                      _np(getattr(j_support.moments, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(normals.normals_from_support(
        support, _t(pts), _t(origin), params).numpy(), got)


@pytest.mark.parametrize("out", ["nan", "buffer"])
def test_normals_on_a_sub_rectangle(out):
    """tests/test_normals.py's ROI case: JAX's normals, the full normals
    inside the rectangle and ``out_normals`` (or NaN) outside it, for one
    frame and for a batch."""
    pts = analytic_plane_cloud(24, 24, step=0.15).astype(np.float32)
    origin = np.float32([0, 0, 5.0])
    buf = np.random.default_rng(2).normal(size=(24, 24, 3)) \
        .astype(np.float32) if out == "buffer" else None
    want = _np(jax.jit(functools.partial(
        jnormals.compute_normals_organized, row_range=(5, 15),
        col_range=(3, 20)))(
        jnp.asarray(pts), jnp.asarray(origin),
        out_normals=None if buf is None else jnp.asarray(buf)))
    got = normals.compute_normals_organized(
        _t(pts), _t(origin), row_range=(5, 15), col_range=(3, 20),
        out_normals=None if buf is None else _t(buf)).numpy()
    full = normals.compute_normals_organized(_t(pts), _t(origin)).numpy()
    inside = np.zeros((24, 24), bool)
    inside[5:15, 3:20] = True
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[inside], full[inside])
    assert np.isfinite(got[5:15, 3:20][2:-2, 2:-2]).all()
    if buf is None:
        assert np.isnan(got[~inside]).all()
    else:
        np.testing.assert_array_equal(got[~inside], buf[~inside])
    batched = normals.compute_normals_organized(
        _t(pts)[None], _t(origin), row_range=(5, 15), col_range=(3, 20),
        out_normals=None if buf is None else _t(buf)[None])
    np.testing.assert_array_equal(batched[0].numpy(), got)


# -- connectivity, discontinuity, geometry ----------------------------------


@pytest.mark.parametrize("init", ["local", "global"])
def test_ccl_scan_single_frame(init):
    """connected_components_scan at JAX's parameter order (``impl`` last),
    also from global labels with a global sentinel."""
    pts, _, _ = scene("room", 40, 56)
    elig = np.isfinite(pts).all(-1)
    kw = {}
    if init == "global":
        labels = (np.arange(56)[None, :] + 3 * 56) * 40 \
            + np.arange(40)[:, None]
        kw = dict(init_labels=labels.astype(np.int32), big_value=40 * 56 * 4)
    want = _np(jax.jit(jconn.connected_components_scan,
                       static_argnums=(2, 3, 4, 6))(
        jnp.asarray(pts), jnp.asarray(elig), 0.01, 1, 24,
        *[jnp.asarray(v) if k == "init_labels" else v
          for k, v in kw.items()]))
    got = connectivity.connected_components_scan(
        _t(pts), _t(elig), 0.01, 1, 24,
        *[_t(v) if k == "init_labels" else v for k, v in kw.items()])
    assert got.shape == (40, 56)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want[elig])) > 3


def test_ccl_window_single_frame():
    pts, _, _ = scene("cluttered", 40, 56)
    elig = np.isfinite(pts).all(-1)
    want = _np(jax.jit(jconn.connected_components_window,
                       static_argnums=(2, 3))(
        jnp.asarray(pts), jnp.asarray(elig), 0.01, 2))
    got = connectivity.connected_components_window(_t(pts), _t(elig), 0.01,
                                                   2)
    assert got.shape == (40, 56)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("reduce,dtype", [("sum", np.int32),
                                          ("min", np.int32),
                                          ("min", np.float32)])
def test_segment_field_single_frame(reduce, dtype):
    """JAX's (values, roots, eligible, h, w, reduce); a float min has
    +inf where a root holds no cell, as jax.ops.segment_min."""
    pts, _, _ = scene("room", 40, 56)
    elig = np.isfinite(pts).all(-1)
    roots = _np(jax.jit(jconn.connected_components_scan,
                        static_argnums=(2, 3))(
        jnp.asarray(pts), jnp.asarray(elig), 0.01, 1))
    rng = np.random.default_rng(5)
    values = (rng.normal(size=(40, 56)) * 100).astype(dtype)
    want = _np(jconn.segment_field(jnp.asarray(values), jnp.asarray(roots),
                                   jnp.asarray(elig), 40, 56, reduce))
    got = connectivity.segment_field(_t(values), _t(roots), _t(elig), 40, 56,
                                     reduce)
    assert got.shape == (40 * 56,) and got.dtype == _t(values).dtype
    np.testing.assert_array_equal(got.numpy(), want)
    if dtype == np.float32:
        assert np.isposinf(want).sum() > 0
    batched = connectivity.segment_field(_t(values)[None], _t(roots)[None],
                                         _t(elig)[None], 40, 56, reduce)
    np.testing.assert_array_equal(batched[0].numpy(), got.numpy())


def test_discontinuity_flags_single_frame():
    pts, _, nrm = scene("cluttered", 40, 56)
    labels = np.where(np.isfinite(pts).all(-1),
                      np.arange(56)[None, :] // 14, UNLABELED) \
        .astype(np.int32)
    rot = np.eye(3, dtype=np.float32)
    want = _np(jdisc.discontinuity_flags(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(labels),
        jnp.asarray(rot), jconfig.PlanarRegionConfig()))
    got = discontinuity.discontinuity_flags(
        _t(pts), _t(nrm), _t(labels), _t(rot), config.PlanarRegionConfig())
    assert got.shape == (40, 56)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 0


def test_pose_astype():
    quat = np.float32([0.9, 0.1, -0.3, 0.2])
    trans = np.float32([1.0, -2.0, 0.5])
    got = geom.Pose(_t(quat), _t(trans)).astype(torch.float64)
    want = jgeom.Pose(jnp.asarray(quat), jnp.asarray(trans)).astype(
        jnp.float16)
    assert got.quat.dtype == torch.float64 and got.trans.dtype == \
        torch.float64
    assert want.quat.dtype == jnp.float16
    np.testing.assert_array_equal(got.quat.numpy(), quat.astype(np.float64))
    np.testing.assert_array_equal(got.trans.numpy(), trans.astype(np.float64))


# -- the batched grower ------------------------------------------------------


def test_rank_grid_from_seed_vector_single_frame():
    rng = np.random.default_rng(4)
    idx = rng.integers(-5, 12 * 17 + 5, 300).astype(np.int32)
    valid = rng.random(300) < 0.8
    want = _np(jpb.rank_grid_from_seed_vector(jnp.asarray(idx),
                                              jnp.asarray(valid), 12, 17))
    got = planar_batched.rank_grid_from_seed_vector(_t(idx), _t(valid), 12,
                                                    17)
    assert got.shape == (12, 17)
    np.testing.assert_array_equal(got.numpy(), want)


@functools.lru_cache(maxsize=None)
def jax_ranked(name, h, w):
    """JAX's jitted plane-support seeds of a scene, as numpy arrays."""
    pts, _, nrm = scene(name, h, w)
    ranked = jax.jit(jseeds.seeds_from_plane_support)(jnp.asarray(pts),
                                                      jnp.asarray(nrm))
    return type(ranked)(*[_np(x) for x in ranked])


def port_grow(pts, nrm, idx, valid, k, **kw):
    return planar_batched.grow_planar_regions_batched(
        _t(pts), _t(nrm), torch.full(pts.shape[:2], UNLABELED,
                                     dtype=torch.int32),
        _t(idx), _t(valid), config.PlanarRegionConfig(max_regions=k), **kw)


def assert_grower_equal(got, want, pts, offset):
    """Exact labels, counts, seeds and overflow; planes to the grower
    tests' tolerance; centroids, curvatures and moments to their bars
    (tests/test_torch_grower.region_bars; region r holds the cells
    labelled r + ``offset``)."""
    for f in GROWER_FIELDS:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)
    labels = got["labels"][None] - offset
    num = want["num_regions"][None]
    assert_planes(got["planes"][None], want["planes"][None], labels,
                  pts[None], num)
    assert_region_table({f: got[f][None] for f in TABLE_FIELDS},
                        {f: want[f][None] for f in TABLE_FIELDS}, labels,
                        pts[None], num)


def as_dict(res):
    return dict({f: _np(getattr(res, f)) for f in GROWER_FIELDS
                 + ("planes",)}, **region_table(res))


def assert_same_regions(got, want, batched=None):
    """Two port results equal in every field (frame 0 of ``batched``
    equal to ``got``)."""
    a, b = as_dict(got), as_dict(want)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)
        if batched is not None:
            np.testing.assert_array_equal(as_dict(batched)[f][0], a[f],
                                          err_msg=f)


def test_grower_schedule_matches_jax():
    """JAX's full signature, positionally, at a non-default schedule with
    a binding flood cap and an id offset, at 32 slots (B1's plain
    version; the 128x160 golden holds 64 slots, B3's). See the module
    docstring for why JAX is called unjitted."""
    k = 32
    pts, _, nrm = scene("cluttered", 40, 56)
    idx, valid = jax_ranked("cluttered", 40, 56)[:2]
    s = SCHEDULE_40X56
    args = (s["initial_id_offset"], s["stage_a_gens"], s["stage_a_rings"],
            s["closure_epochs"], None, s["flood_rounds"])
    want = jpb.grow_planar_regions_batched(
        jnp.asarray(pts), jnp.asarray(nrm),
        jnp.full((40, 56), UNLABELED, jnp.int32), jnp.asarray(idx),
        jnp.asarray(valid), jconfig.PlanarRegionConfig(max_regions=k), *args)
    got = planar_batched.grow_planar_regions_batched(
        _t(pts), _t(nrm), torch.full((40, 56), UNLABELED, dtype=torch.int32),
        _t(idx), _t(valid), config.PlanarRegionConfig(max_regions=k), *args)
    assert got.labels.shape == (40, 56) and got.planes.shape == (k, 4)
    assert_grower_equal(as_dict(got), as_dict(want), pts,
                        s["initial_id_offset"])
    assert int(got.labels.min()) == UNLABELED
    assert int(got.labels[got.labels >= 0].min()) == s["initial_id_offset"]
    # the cap binds: without it the regions differ
    free = port_grow(pts, nrm, idx, valid, k,
                     **dict(SCHEDULE_40X56, flood_rounds=64))
    assert (free.labels != got.labels).sum() > 0


@pytest.mark.parametrize("k", [32, 64])
def test_grower_seed_vector_equals_rank_grid(k):
    """Default arguments: the grower ranks the seed vector itself (JAX's
    path without ``seed_rank_grid``) and gives the rank-grid call's
    regions; one frame equals frame 0 of the batch."""
    pts, _, nrm = scene("cluttered", 40, 56)
    idx, valid = jax_ranked("cluttered", 40, 56)[:2]
    got = port_grow(pts, nrm, idx, valid, k)
    grid = planar_batched.rank_grid_from_seed_vector(_t(idx), _t(valid), 40,
                                                     56)
    by_grid = planar_batched.grow_planar_regions_batched(
        _t(pts), _t(nrm), torch.full((40, 56), UNLABELED, dtype=torch.int32),
        None, None, config.PlanarRegionConfig(max_regions=k),
        seed_rank_grid=grid)
    batched = planar_batched.grow_planar_regions_batched(
        _t(pts)[None], _t(nrm)[None],
        torch.full((1, 40, 56), UNLABELED, dtype=torch.int32),
        _t(idx)[None], _t(valid)[None],
        config.PlanarRegionConfig(max_regions=k))
    assert_same_regions(got, by_grid, batched)
    assert int(got.num_regions) >= 5


def test_jitted_solve_of_one_point_is_valid():
    """The 40x56 cluttered scene at 32 slots leaves a slot holding one
    cell before the tail. Jitted, JAX's moment solve of that one point
    passes the validity test (XLA:CPU's fused f32 cancellation), so JAX's
    jitted grower keeps the slot; eagerly JAX rejects the fit, as the
    port does."""
    pts, _, _ = scene("cluttered", 40, 56)
    p = pts[33, 24]
    s2 = np.float32([p[0] * p[0], p[0] * p[1], p[0] * p[2], p[1] * p[1],
                     p[1] * p[2], p[2] * p[2]])
    hint = np.float32([1, 0, 0])
    jm = jplane_fit.PlaneMoments(jnp.asarray(s2), jnp.asarray(p),
                                 jnp.float32(1), jnp.asarray(hint))
    assert bool(jax.jit(jplane_fit.solve)(jm).valid)
    assert not bool(jplane_fit.solve(jm).valid)
    port = plane_fit.solve(plane_fit.PlaneMoments(
        _t(s2), _t(p), torch.tensor(1.0), _t(hint)))
    assert not bool(port.valid)


def golden_input():
    pts, _, nrm = scene("cluttered", 128, 160)
    idx, valid = jax_ranked("cluttered", 128, 160)[:2]
    return pts, nrm, idx, valid


def jax_golden():
    """JAX's jitted grower at 128x160 (patched stage A) with
    SCHEDULE_128X160, at 32 and 64 slots."""
    out = {}
    pts, nrm, idx, valid = golden_input()
    for k in (32, 64):
        cfg = jconfig.PlanarRegionConfig(max_regions=k)
        res = jax.jit(lambda p, n, l, i, v: jpb.grow_planar_regions_batched(
            p, n, l, i, v, cfg, **SCHEDULE_128X160))(
            jnp.asarray(pts), jnp.asarray(nrm),
            jnp.full((128, 160), UNLABELED, jnp.int32), jnp.asarray(idx),
            jnp.asarray(valid))
        out.update({f"k{k}_{f}": v for f, v in as_dict(res).items()})
    return out


def golden_files():
    """The committed goldens as one dict (the table in its own file)."""
    out = {}
    for path in (GOLDEN, GOLDEN_TABLE):
        with np.load(path) as gold:
            out.update({name: gold[name] for name in gold.files})
    return out


@pytest.mark.parametrize("k", [32, 64])
def test_grower_schedule_matches_jax_golden_128x160(k):
    gold = golden_files()
    pts, nrm, idx, valid = golden_input()
    got = as_dict(port_grow(pts, nrm, idx, valid, k, **SCHEDULE_128X160))
    want = {f: gold[f"k{k}_{f}"] for f in got}
    assert_grower_equal(got, want, pts, SCHEDULE_128X160["initial_id_offset"])
    assert int(want["num_regions"]) >= 6
    free = port_grow(pts, nrm, idx, valid, k,
                     **dict(SCHEDULE_128X160, flood_rounds=64))
    assert (free.labels.numpy() != got["labels"]).sum() > 0  # the cap binds


def test_committed_golden_is_current():
    gold = golden_files()
    want = jax_golden()
    assert set(gold) == set(want)
    for name, value in want.items():
        np.testing.assert_array_equal(gold[name], value, err_msg=name)


def test_sharded_grower_passes_grower_kwargs():
    """The sharded wrapper hands JAX's ``**grower_kwargs`` to the grower:
    one rank of a CPU Comm grows the seed vector with the schedule as the
    single-device grower does. The floods run to their fixed points: a
    shard's ``flood_rounds`` caps each local flood between halo exchanges,
    as in JAX's sharded flood, not the flood as a whole."""
    pts, _, nrm = scene("cluttered", 40, 56)
    idx, valid = jax_ranked("cluttered", 40, 56)[:2]
    cfg = config.PlanarRegionConfig()
    schedule = dict(SCHEDULE_40X56, flood_rounds=64)
    offset = schedule.pop("initial_id_offset")
    got = sharded.sharded_grow_planar_regions_batched(
        _t(pts), _t(nrm), torch.full((40, 56), UNLABELED, dtype=torch.int32),
        _t(idx), _t(valid), cfg, 40, 56, halo.Comm(device="cpu"), offset,
        **schedule)
    want = port_grow(pts, nrm, idx, valid, cfg.max_regions,
                     initial_id_offset=offset, **schedule)
    assert int(got.labels.max()) >= offset
    assert_same_regions(got, want)


# -- clusters, mean shift, the sequential grower ------------------------------


@pytest.mark.parametrize("canonical", [True, False])
def test_segment_clusters_single_frame(canonical):
    pts, _, _ = scene("cluttered", 40, 56)
    labels = np.where(np.random.default_rng(1).random((40, 56)) < 0.3, 0,
                      UNLABELED).astype(np.int32)
    cfg = jconfig.ClusterRegionConfig(squared_distance_threshold=0.01)
    if canonical:
        seed_idx = np.arange(40 * 56 - 1, -1, -1).astype(np.int32)
    else:
        seed_idx = np.random.default_rng(2).permutation(40 * 56)[:900] \
            .astype(np.int32)
    want = jax.jit(functools.partial(
        jcluster.segment_clusters, config=cfg, initial_id_offset=3,
        canonical_seeds=canonical))(
        jnp.asarray(pts), jnp.asarray(labels), jnp.asarray(seed_idx))
    got = cluster.segment_clusters(
        _t(pts), _t(labels), _t(seed_idx),
        config.ClusterRegionConfig(squared_distance_threshold=0.01), 3,
        canonical_seeds=canonical)
    assert got.labels.shape == (40, 56) and got.num_regions.shape == ()
    assert_tuple_equal(got, want, cluster.ClusterResult._fields)
    assert int(got.num_regions) > 1


def test_mean_shift_single_frame():
    """mean_shift_modes at [H, W, 3] gives JAX's [N, ...] state, and each
    growth takes that state as it takes a batched one."""
    pts = blob_cloud(seed=3)
    h, w = pts.shape[:2]
    labels = np.full((h, w), UNLABELED, np.int32)
    labels[:5] = 0
    want = jms._mean_shift_modes_jit(jnp.asarray(pts), jnp.asarray(labels),
                                     5, jms.MeanShiftParams())
    got = mean_shift.mean_shift_modes(_t(pts), _t(labels), 5)
    for f in mean_shift.MeanShiftState._fields:
        assert getattr(got, f).shape == _np(getattr(want, f)).shape
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(want, f)), err_msg=f)
    batched = mean_shift.mean_shift_modes(_t(pts)[None], _t(labels)[None], 5)
    cfg = config.ClusterRegionConfig()
    for grow in (mean_shift.grow_mean_shift_regions,
                 functools.partial(mean_shift.grow_mean_shift_regions_batched,
                                   device="cpu")):
        la, lb = labels.copy(), labels.copy()
        ra = grow(pts, la, got, cfg, 2)
        rb = grow(pts, lb, batched, cfg, 2)
        np.testing.assert_array_equal(la, lb)
        assert [r.label_id for r in ra] == [r.label_id for r in rb]
        assert len(ra) >= 2


def test_sequential_grower_single_frame():
    pts, _, nrm = scene("room", 40, 56)
    idx, valid = jax_ranked("room", 40, 56)[:2]
    cfg = jconfig.PlanarRegionConfig(growth_mode="wavefront")
    labels0 = np.full((40, 56), UNLABELED, np.int32)
    want = jax.jit(lambda p, n, l, si, sv: jplanar.grow_planar_regions(
        p, n, l, si, sv, cfg, 4, 64))(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(labels0),
        jnp.asarray(idx), jnp.asarray(valid))
    got = planar.grow_planar_regions(
        _t(pts), _t(nrm), _t(labels0), _t(idx), _t(valid),
        config.PlanarRegionConfig(**dataclasses.asdict(cfg)), 4, 64)
    assert got.labels.shape == (40, 56)
    for f in GROWER_FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      _np(getattr(want, f)), err_msg=f)
    num = _np(want.num_regions)[None]
    assert_region_table({f: v[None] for f, v in region_table(got).items()},
                        {f: v[None] for f, v in region_table(want).items()},
                        got.labels.numpy()[None] - 4, pts[None], num)
    assert int(got.num_regions) >= 2


if __name__ == "__main__":
    gold = jax_golden()
    table = {f"k{k}_{f}" for k in (32, 64) for f in TABLE_FIELDS}
    for path, names in ((GOLDEN, set(gold) - table), (GOLDEN_TABLE, table)):
        np.savez_compressed(path, **{n: gold[n] for n in sorted(names)})
        print("wrote", path, os.path.getsize(path), "bytes")
