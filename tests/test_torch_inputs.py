"""The input rule of the port's public ops (pcseg_tpu_torch/ops/frames.py),
function by function, on the 40x56 room scene of JAX's own tests
(``synthetic_room_cloud(40, 56, f=40.0, seed=1)``) and the cluttered scene
at 40x56 (seed 5, through the u16 range encoding):

- a NumPy array in place of any tensor argument raises the TypeError that
  names the function and the argument (JAX places such an array on its
  default device; the port's ops have no device to place it on);
- float64 and int64 tensors give the float32 and int32 call's result bit
  for bit (narrowed as JAX narrows with x64 off);
- that result holds to JAX's, called with the same single frame given as
  float64/int64 NumPy arrays and converted by ``jnp.asarray`` (to 32 bits,
  as at a jit boundary), at the bars of
  tests/test_torch_jax_conventions.py: exact, but the normals (0.5 degrees,
  its room-scene bar) and the grower's planes and region table
  (tests/test_torch_grower.py's tolerances); voxel centroids within 2 f32
  ulps (tests/test_torch_unorganized.py).

Every input is the port's own, made from numpy seeds (the normals, seeds,
CCL roots and temporal seeds below are the port's f32 results, which
those tests hold to JAX). JAX's results are the committed golden
``jax_inputs_40x56.npz``, so this module compiles no JAX (rewrite with
``JAX_PLATFORMS=cpu python -m tests.test_torch_inputs``, ~60 s).
"""

import functools
import os
import re
import types

import numpy as np
import pytest
import torch

from pcseg_tpu_torch.models import (cluster, config, mean_shift, planar,
                                    planar_batched)
from pcseg_tpu_torch.ops import (connectivity, discontinuity, geom, normals,
                                 plane_fit, seeds, unproject, voxelize)
from pcseg_tpu_torch.utils.synthetic import (synthetic_cluttered_room_cloud,
                                             synthetic_room_cloud)
from tests.test_torch_grower import assert_planes, assert_region_table

# One intra-op thread: the suite runs in parallel worker processes, and
# OpenMP teams spinning across them slow every small op by orders of
# magnitude.
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pcseg_tpu_torch", "testdata", "jax_inputs_40x56.npz")
H, W = 40, 56
SCENES = ("room", "cluttered")
WIDE = {np.dtype(np.float32): np.float64, np.dtype(np.int32): np.int64}
GROWER_EXACT = ("labels", "num_regions", "counts", "seed_indices",
                "overflow")
NORMALS_DEG = 0.5


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tree(x):
    """A result as nested lists of numpy leaves (NamedTuples by field)."""
    if isinstance(x, tuple):
        fields = getattr(x, "_fields", None)
        if fields is None:
            return [_tree(v) for v in x]
        return {f: _tree(v) for f, v in zip(fields, x)}
    return _np(x)


def leaves(x, prefix=""):
    """{path: numpy array} of a result's leaves (None leaves skipped)."""
    t = x if isinstance(x, (dict, list)) else _tree(x)
    items = t.items() if isinstance(t, dict) else enumerate(t) \
        if isinstance(t, list) else None
    if items is None:
        return {} if t is None or t.dtype == object else {prefix: t}
    out = {}
    for k, v in items:
        out.update(leaves(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


@functools.lru_cache(maxsize=None)
def scene(name):
    """The scene's inputs as numpy arrays, from the port's f32 ops."""
    if name == "room":
        pts, origin = synthetic_room_cloud(H, W, f=float(H), seed=1)
    else:
        pts, origin = synthetic_cluttered_room_cloud(H, W, f=float(H),
                                                     seed=5)
        pts = unproject.unproject_range_np(
            unproject.encode_range(pts),
            unproject.camera_ray_table(H, W, f=float(H)))
    pts = np.asarray(pts, np.float32)
    origin = np.asarray(origin, np.float32)
    t = torch.from_numpy
    nrm = normals.compute_normals_organized(t(pts), t(origin))
    support = normals.find_normal_support(t(pts),
                                          config.ComputeNormalsParams())
    count, ok = seeds.plane_support_counts(
        t(pts), nrm, config.SeedsFromPlaneSupportParams())
    ranked = seeds.seeds_from_plane_support(t(pts), nrm, seed_vector=True)
    avg = seeds.seeds_from_average_normals(nrm)
    elig = np.isfinite(pts).all(-1)
    roots = connectivity.connected_components_scan(t(pts), t(elig), 0.01, 1)
    rng = np.random.default_rng(3)
    cells = rng.integers(0, H * W, 6)
    prev_c = np.nan_to_num(pts.reshape(-1, 3)[cells]
                           + rng.normal(0, 0.02, (6, 3))).astype(np.float32)
    prev_n = np.nan_to_num(nrm.numpy().reshape(-1, 3)[cells],
                           nan=1.0).astype(np.float32)
    prev_counts = rng.integers(10, 500, 6).astype(np.int32)
    prev_valid = np.array([1, 1, 0, 1, 1, 1], bool)
    quat = np.float32([0.999, 0.02, -0.01, 0.03])
    quat /= np.linalg.norm(quat)
    trans = np.float32([0.05, -0.02, 0.01])
    t_idx, t_found = seeds.seeds_from_last_regions(
        t(pts), nrm, t(prev_c), t(prev_n), t(prev_counts), t(prev_valid),
        geom.Pose(t(quat), t(trans)), 0.3, np.deg2rad(20.0))
    gate = rng.random((3, H, W)) < 0.6
    vox = pts.reshape(-1, 3)
    grid = voxelize.voxelize_xy(t(vox), 0.5, (16, 16))
    return dict(
        pts=pts, origin=origin, nrm=nrm.numpy(), elig=elig,
        support=_tree(support), count=count.numpy(),
        qualifies=(ok & (count >= config.SeedsFromPlaneSupportParams()
                         .min_num_support_points)).numpy(),
        idx=ranked.indices.numpy(), valid=ranked.valid.numpy(),
        rank_grid=ranked.rank_grid.numpy(), avg=_tree(avg),
        roots=roots.numpy(),
        values=rng.integers(-50, 50, (H, W)).astype(np.int32),
        disc_labels=np.where(elig, np.arange(W)[None, :] // 14, -1)
        .astype(np.int32),
        cl_labels=np.where(rng.random((H, W)) < 0.3, 0, -1).astype(np.int32),
        canonical=np.arange(H * W - 1, -1, -1).astype(np.int32),
        prev_c=prev_c, prev_n=prev_n, prev_counts=prev_counts,
        prev_valid=prev_valid, quat=quat, trans=trans,
        t_idx=t_idx.numpy(), t_found=t_found.numpy(),
        gate=gate, sources=gate & (rng.random(gate.shape) < 0.02),
        labels0=np.full((H, W), -1, np.int32), rot=np.eye(3,
                                                          dtype=np.float32),
        vox=vox, grid_labels=rng.integers(-1, 9, (16, 16)).astype(np.int32),
        point_cell=grid.point_cell.numpy())


def blob_scene():
    from tests.test_mean_shift import blob_cloud
    pts = blob_cloud(seed=3)
    labels = np.full(pts.shape[:2], -1, np.int32)
    labels[:5] = 0
    return pts, labels


# -- the cases ----------------------------------------------------------------
#
# (module.function, the names of its array arguments in the order the call
# reads them, the call, the bar). A call takes ``lib`` (the port's modules
# or JAX's, and how each jits), ``a`` (an array argument in the form under
# test; ``a(x, array=False)`` for a tensor inside a record the port builds
# itself, a geom.Pose) and the scene.


def _support(lib, a, s):
    c, m, v = s["support"]["count"], s["support"]["moments"], \
        s["support"]["center_valid"]
    return lib.normals.NormalSupport(
        a(c), lib.plane_fit.PlaneMoments(a(m["s2"]), a(m["s1"]), a(m["w"]),
                                         a(m["normal_hint"])), a(v))


def _seed_mask(lib, a, s):
    return lib.seeds.SeedMask(*(a(s["avg"][f]) for f in ("mask",
                                                         "seed_index",
                                                         "score")))


SUPPORT = tuple(f"support.{f}" for f in (
    "count", "moments.s2", "moments.s1", "moments.w", "moments.normal_hint",
    "center_valid"))
CASES = {
    "compute_normals_organized": (
        "normals.compute_normals_organized", ("points", "sensor_origin"),
        lambda lib, a, s: lib.jit(lib.normals.compute_normals_organized)(
            a(s["pts"]), a(s["origin"])), "normals"),
    "find_normal_support": (
        "normals.find_normal_support", ("points",),
        lambda lib, a, s: lib.normals.find_normal_support(
            a(s["pts"]), lib.config.ComputeNormalsParams()), "exact"),
    "normals_from_support": (
        "normals.normals_from_support", SUPPORT + ("points",
                                                   "sensor_origin"),
        lambda lib, a, s: lib.normals.normals_from_support(
            _support(lib, a, s), a(s["pts"]), a(s["origin"]),
            lib.config.ComputeNormalsParams()), "normals"),
    "plane_support_counts": (
        "seeds.plane_support_counts", ("points", "normals"),
        lambda lib, a, s: lib.seeds.plane_support_counts(
            a(s["pts"]), a(s["nrm"]),
            lib.config.SeedsFromPlaneSupportParams()), "exact"),
    "plane_support_rank_grid": (
        "seeds.plane_support_rank_grid", ("count", "qualifies"),
        lambda lib, a, s: lib.seeds.plane_support_rank_grid(
            a(s["count"]), a(s["qualifies"]), H, W, 82), "exact"),
    "rank_plane_support_seeds": (
        "seeds.rank_plane_support_seeds", ("count", "qualifies"),
        lambda lib, a, s: lib.seeds.rank_plane_support_seeds(
            a(s["count"]), a(s["qualifies"]), H, W, 600), "exact"),
    "seeds_from_plane_support": (
        "seeds.seeds_from_plane_support", ("points", "normals"),
        lambda lib, a, s: lib.jit(lib.seeds.seeds_from_plane_support,
                                  **lib.seed_vector)(a(s["pts"]),
                                                     a(s["nrm"])), "exact"),
    "seeds_from_average_normals": (
        "seeds.seeds_from_average_normals", ("normals",),
        lambda lib, a, s: lib.jit(lib.seeds.seeds_from_average_normals)(
            a(s["nrm"])), "exact"),
    "average_normal_seed_list": (
        "seeds.average_normal_seed_list",
        ("seed_mask.mask", "seed_mask.seed_index", "seed_mask.score"),
        lambda lib, a, s: lib.seeds.average_normal_seed_list(
            _seed_mask(lib, a, s), 600), "exact"),
    "append_temporal_to_rank_grid": (
        "seeds.append_temporal_to_rank_grid",
        ("rank_grid", "t_idx", "t_found"),
        lambda lib, a, s: lib.seeds.append_temporal_to_rank_grid(
            a(s["rank_grid"]), a(s["t_idx"]), a(s["t_found"])), "exact"),
    "seeds_from_last_regions": (
        "seeds.seeds_from_last_regions",
        ("points", "normals", "prev_centroids", "prev_normals",
         "prev_counts", "prev_valid"),
        lambda lib, a, s: lib.jit(
            lib.seeds.seeds_from_last_regions, max_distance=0.3,
            max_normal_difference_angle=np.deg2rad(20.0))(
            a(s["pts"]), a(s["nrm"]), a(s["prev_c"]), a(s["prev_n"]),
            a(s["prev_counts"]), a(s["prev_valid"]),
            lib.geom.Pose(a(s["quat"], array=False),
                          a(s["trans"], array=False))), "exact"),
    "connected_components_scan": (
        "connectivity.connected_components_scan", ("points", "eligible"),
        lambda lib, a, s: lib.jit(
            lib.connectivity.connected_components_scan,
            squared_threshold=0.01, half_window=1)(a(s["pts"]),
                                                   a(s["elig"])), "exact"),
    "connected_components_window": (
        "connectivity.connected_components_window", ("points", "eligible"),
        lambda lib, a, s: lib.jit(
            lib.connectivity.connected_components_window,
            squared_threshold=0.01, half_window=2)(a(s["pts"]),
                                                   a(s["elig"])), "exact"),
    "connected_components_mask": (
        "connectivity.connected_components_mask", ("mask",),
        lambda lib, a, s: lib.connectivity.connected_components_mask(
            a(s["elig"])), "exact"),
    "segment_field": (
        "connectivity.segment_field", ("values", "roots", "eligible"),
        lambda lib, a, s: lib.connectivity.segment_field(
            a(s["values"]), a(s["roots"]), a(s["elig"]), H, W), "exact"),
    "reachable_from": (
        "connectivity.reachable_from", ("mask", "sources"),
        lambda lib, a, s: lib.jit(lib.connectivity.reachable_from,
                                  max_rounds=64)(a(s["gate"][0]),
                                                 a(s["sources"][0])),
        "exact"),
    "discontinuity_flags": (
        "discontinuity.discontinuity_flags",
        ("points", "normals", "labels", "rot_robot"),
        lambda lib, a, s: lib.discontinuity.discontinuity_flags(
            a(s["pts"]), a(s["nrm"]), a(s["disc_labels"]), a(s["rot"]),
            lib.config.PlanarRegionConfig()), "exact"),
    "segment_clusters": (
        "cluster.segment_clusters", ("points", "labels", "seed_indices"),
        lambda lib, a, s: lib.jit(
            lib.cluster.segment_clusters,
            config=lib.config.ClusterRegionConfig(
                squared_distance_threshold=0.01),
            initial_id_offset=3, canonical_seeds=True)(
            a(s["pts"]), a(s["cl_labels"]), a(s["canonical"])), "exact"),
    "rank_grid_from_seed_vector": (
        "planar_batched.rank_grid_from_seed_vector",
        ("seed_indices", "seed_valid"),
        lambda lib, a, s: lib.planar_batched.rank_grid_from_seed_vector(
            a(s["idx"]), a(s["valid"]), H, W), "exact"),
    "flood_fill_static": (
        "planar_batched.flood_fill_static", ("gate", "sources"),
        lambda lib, a, s: lib.planar_batched.flood_fill_static(
            a(s["gate"]), a(s["sources"]), 2), "exact"),
    "grow_planar_regions_batched": (
        "planar_batched.grow_planar_regions_batched",
        ("points", "normals", "labels", "seed_indices", "seed_valid"),
        lambda lib, a, s: lib.planar_batched.grow_planar_regions_batched(
            a(s["pts"]), a(s["nrm"]), a(s["labels0"]), a(s["idx"]),
            a(s["valid"]), lib.config.PlanarRegionConfig(max_regions=32),
            flood_rounds=2), "grower"),
    "grow_planar_regions": (
        "planar.grow_planar_regions",
        ("points", "normals", "labels", "seed_indices", "seed_valid"),
        lambda lib, a, s: lib.jit(
            lib.planar.grow_planar_regions,
            config=lib.config.PlanarRegionConfig(growth_mode="wavefront"),
            initial_id_offset=0, max_attempts=64)(
            a(s["pts"]), a(s["nrm"]), a(s["labels0"]), a(s["idx"]),
            a(s["valid"])), "grower"),
    "voxelize_xy": (
        "voxelize.voxelize_xy", ("points",),
        lambda lib, a, s: lib.voxelize.voxelize_xy(a(s["vox"]), 0.5,
                                                   (16, 16)), "voxel"),
    "scatter_labels_to_points": (
        "voxelize.scatter_labels_to_points", ("grid_labels", "point_cell"),
        lambda lib, a, s: lib.voxelize.scatter_labels_to_points(
            a(s["grid_labels"]), a(s["point_cell"])), "exact"),
}
# scene-independent, run with the room: the port's own voxel helper (no JAX
# counterpart) and the mean-shift modes on tests/test_mean_shift.py's blobs
# (test_torch_jax_conventions.py::test_mean_shift_single_frame's input)
PORT_ONLY = {
    "cell_ids": ("voxelize.cell_ids", ("points",),
                 lambda lib, a, s: lib.voxelize.cell_ids(a(s["vox"]), 0.5,
                                                         (16, 16))),
}
MEAN_SHIFT = ("mean_shift.mean_shift_modes", ("points", "labels"))

PORT = types.SimpleNamespace(
    normals=normals, seeds=seeds, connectivity=connectivity,
    discontinuity=discontinuity, cluster=cluster, planar=planar,
    planar_batched=planar_batched, voxelize=voxelize, geom=geom,
    plane_fit=plane_fit, config=config,
    jit=lambda fn, **kw: functools.partial(fn, **kw),
    seed_vector=dict(seed_vector=True))


def converter(mode, numpy_at=None):
    """The ``a`` of a call: tensors of the scene's dtypes ("f32"), widened
    to 64 bits ("f64"), or the f32 tensors but the ``numpy_at``-th array
    argument left a NumPy array. Returns (a, calls seen)."""
    seen = []

    def a(x, array=True):
        x = np.asarray(x)
        if array:
            seen.append(x)
            if len(seen) - 1 == numpy_at:
                return x
        if mode == "f64" and x.dtype in WIDE:
            x = x.astype(WIDE[x.dtype])
        return torch.from_numpy(np.array(x))
    return a, seen


def port_call(call, s, mode):
    a, _ = converter(mode)
    return call(PORT, a, s)


def all_cases():
    """(scene, case id, qualified name, argument names, call, bar)."""
    out = [(name, cid, *case) for name in SCENES
           for cid, case in CASES.items()]
    out += [("room", cid, qual, names, call, "exact")
            for cid, (qual, names, call) in PORT_ONLY.items()]
    return out


def check_numpy_refused(qual, names, call, s):
    """Each array argument in turn as a NumPy array: the TypeError names
    the function and that argument, before any work."""
    fn = qual.split(".")[-1]
    for k, name in enumerate(names):
        a, _ = converter("f32", numpy_at=k)
        with pytest.raises(TypeError, match="^" + re.escape(
                f"{fn}: {name} must be a torch.Tensor on the device to run "
                f"on, got numpy.ndarray") + "$"):
            call(PORT, a, s)


def check_narrowed(got64, got32):
    """The 64-bit call's leaves equal the 32-bit call's, dtype and bits."""
    a, b = leaves(got64), leaves(got32)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


def check_jax(got, gold, prefix, bar, s):
    """The port's result against JAX's leaves in the golden."""
    want = {k[len(prefix):]: gold[k] for k in gold.files
            if k.startswith(prefix)}
    got = leaves(got)
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape and got[k].dtype == w.dtype, k
    if bar == "normals":
        g, w = got[""], want[""]  # a bare [H, W, 3] tensor
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        ok = np.isfinite(w).all(-1)
        cos = np.clip((g[ok] * w[ok]).sum(-1), -1.0, 1.0)
        assert np.degrees(np.arccos(cos)).max() <= NORMALS_DEG
        return
    if bar == "grower":
        for f in GROWER_EXACT:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        labels, num = got["labels"][None], want["num_regions"][None]
        assert_planes(got["planes"][None], want["planes"][None], labels,
                      s["pts"][None], num)
        table = {"centroids": "centroids", "curvatures": "curvatures",
                 "s2": "moments.s2", "s1": "moments.s1", "w": "moments.w",
                 "normal_hint": "moments.normal_hint"}
        assert_region_table({f: got[k][None] for f, k in table.items()},
                            {f: want[k][None] for f, k in table.items()},
                            labels, s["pts"][None], num)
        return
    for k, w in want.items():
        if bar == "voxel" and k == "points":
            m = ~np.isnan(w)
            np.testing.assert_array_equal(np.isnan(got[k]), ~m)
            ulps = np.abs(got[k][m].view(np.int32).astype(np.int64)
                          - w[m].view(np.int32).astype(np.int64))
            assert ulps.max(initial=0) <= 2
        else:
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.fixture(scope="module")
def gold():
    with np.load(GOLDEN) as g:
        yield g


def test_every_public_op_refuses_numpy_and_narrows_64_bits(gold):
    """One loop over every decorated public function (and the undecorated
    ones that take tensors, ``reachable_from`` and ``voxelize.*``), on
    both scenes: NumPy refused by name, 64-bit inputs giving the 32-bit
    result bit for bit, and that result at JAX's (the golden)."""
    done = set()
    for name, cid, qual, names, call, bar in all_cases():
        s = scene(name)
        check_numpy_refused(qual, names, call, s)
        got32 = port_call(call, s, "f32")
        got64 = port_call(call, s, "f64")
        check_narrowed(got64, got32)
        if cid not in PORT_ONLY:
            check_jax(got64, gold, f"{name}__{cid}__", bar, s)
        done.add(qual)
    assert done == {c[0] for c in CASES.values()} | {
        c[0] for c in PORT_ONLY.values()}


def test_mean_shift_modes_refuse_numpy_and_narrow_64_bits(gold):
    pts, labels = blob_scene()
    s = dict(pts=pts, labels=labels)

    def call(lib, a, s):
        return lib.mean_shift_modes(a(s["pts"]), a(s["labels"]), 5)

    port = types.SimpleNamespace(mean_shift_modes=mean_shift.mean_shift_modes)
    fn = MEAN_SHIFT[0].split(".")[-1]
    for k, name in enumerate(MEAN_SHIFT[1]):
        a, _ = converter("f32", numpy_at=k)
        with pytest.raises(TypeError, match=f"^{fn}: {name} must be"):
            call(port, a, s)
    got32 = call(port, converter("f32")[0], s)
    got64 = call(port, converter("f64")[0], s)
    check_narrowed(got64, got32)
    check_jax(got64, gold, "blobs__mean_shift_modes__", "exact", s)


def test_numpy_room_frame_never_seeds_nothing():
    """The repaired silent fault: seeds_from_plane_support on the NumPy
    room frame read it as a batch of 40 frames of width 3 and returned
    empty [40, 56, 3] grids. It now refuses it by name; its tensor call
    ranks the room's seeds on [40, 56] grids."""
    s = scene("room")
    with pytest.raises(TypeError, match="^seeds_from_plane_support: points "
                                        "must be a torch.Tensor"):
        seeds.seeds_from_plane_support(s["pts"], s["nrm"])
    with pytest.raises(TypeError, match="normals must be a torch.Tensor"):
        seeds.seeds_from_plane_support(torch.from_numpy(s["pts"]), s["nrm"])
    ranked = seeds.seeds_from_plane_support(torch.from_numpy(s["pts"]),
                                            torch.from_numpy(s["nrm"]))
    assert ranked.rank_grid.shape == (H, W)
    assert int((ranked.rank_grid < seeds.SEED_RANK_INF).sum()) > 100


@pytest.mark.parametrize("bad", ["list", "scalar", "rank2"])
def test_the_rank_decides_always(bad):
    """A first argument of no tensor, or of neither a frame's rank nor a
    batch's, raises; it is never taken for a batch."""
    pts = torch.from_numpy(scene("room")["pts"])
    arg = {"list": pts.tolist(), "scalar": 1.0, "rank2": pts[0]}[bad]
    err = TypeError if bad == "list" else ValueError
    with pytest.raises(err, match="^compute_normals_organized: points"):
        normals.compute_normals_organized(arg, torch.zeros(3))


def jax_golden():
    """JAX's results of every case, called with the scenes' arrays as
    float64/int64 NumPy (JAX narrows them, x64 being off)."""
    import jax
    import jax.numpy as jnp
    from pcseg_tpu.models import cluster as jcluster
    from pcseg_tpu.models import config as jconfig
    from pcseg_tpu.models import mean_shift as jms
    from pcseg_tpu.models import planar as jplanar
    from pcseg_tpu.models import planar_batched as jpb
    from pcseg_tpu.ops import connectivity as jconn
    from pcseg_tpu.ops import discontinuity as jdisc
    from pcseg_tpu.ops import geom as jgeom
    from pcseg_tpu.ops import normals as jnormals
    from pcseg_tpu.ops import plane_fit as jplane_fit
    from pcseg_tpu.ops import seeds as jseeds
    from pcseg_tpu.ops import voxelize as jvoxelize

    jpb.FLOOD_IMPL = "xla"  # tests/test_torch_surface.py's flood reference
    lib = types.SimpleNamespace(
        normals=jnormals, seeds=jseeds, connectivity=jconn,
        discontinuity=jdisc, cluster=jcluster, planar=jplanar,
        planar_batched=jpb, voxelize=jvoxelize, geom=jgeom,
        plane_fit=jplane_fit, config=jconfig,
        jit=lambda fn, **kw: jax.jit(functools.partial(fn, **kw)),
        seed_vector={})

    def wide(x, array=True):
        """JAX's conversion of a 64-bit NumPy array (to 32 bits, x64 being
        off), as at a jit boundary: JAX's eager ops do not all take 64-bit
        NumPy (``nansafe.isfinite`` reads f32 bit patterns)."""
        x = np.asarray(x)
        return jnp.asarray(x.astype(WIDE[x.dtype]) if x.dtype in WIDE else x)

    out = {}
    for name, cid, _, _, call, _ in all_cases():
        if cid in PORT_ONLY:
            continue
        res = call(lib, wide, scene(name))
        out.update({f"{name}__{cid}__{k}": v
                    for k, v in leaves(res).items()})
    pts, labels = blob_scene()
    res = jms._mean_shift_modes_jit(wide(pts), wide(labels), 5,
                                    jms.MeanShiftParams())
    out.update({f"blobs__mean_shift_modes__{k}": v
                for k, v in leaves(res).items()})
    return out


if __name__ == "__main__":
    np.savez_compressed(GOLDEN, **jax_golden())
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
