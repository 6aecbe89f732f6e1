"""The port's utilities against JAX on the CPU: the plane estimator's state
(``ops/plane_fit``: empty, moments, merge, transform, the dict form JAX
writes), the plane helpers of ``ops/geom``, ``ops/polygon``,
``ops/registration``, the triangulation of ``utils/hostgeom``,
``utils/metrics`` and the tensor ``PointCloud`` (``utils/cloud``), on the
cases of tests/test_{geom,algorithms,cloud}.py.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pcseg_tpu
import pcseg_tpu_torch
from pcseg_tpu.ops import geom as jgeom
from pcseg_tpu.ops import plane_fit as jplane_fit
from pcseg_tpu.ops import polygon as jpolygon
from pcseg_tpu.ops import registration as jregistration
from pcseg_tpu.utils import cloud as jcloud
from pcseg_tpu.utils import hostgeom as jhostgeom
from pcseg_tpu.utils import metrics as jmetrics

from pcseg_tpu_torch.ops import geom, plane_fit, polygon, registration
from pcseg_tpu_torch.utils import cloud, hostgeom, metrics
from tests import fixtures
from tests.test_algorithms import ZIGZAG, ZIGZAG_POLY
from tests.test_torch_kernels import _t

torch.set_num_threads(1)


def jax_moments(pts, hint, weights=None):
    m = jplane_fit.set_normal_orientation(jplane_fit.empty(()),
                                          jnp.asarray(hint, jnp.float32))
    return jplane_fit.add_points(
        m, jnp.asarray(pts), None if weights is None else jnp.asarray(weights))


def port_moments(pts, hint, weights=None):
    m = plane_fit.set_normal_orientation(
        plane_fit.empty(()), torch.tensor(hint, dtype=torch.float32))
    return plane_fit.add_points(m, _t(pts),
                                None if weights is None else _t(weights))


def assert_solutions_close(got, want, atol):
    for f in ("plane", "centroid", "normal"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=0,
                                   atol=atol, err_msg=f)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))


# -- ops/plane_fit ------------------------------------------------------------

def test_empty_matches_jax():
    got = plane_fit.empty((2, 3))
    want = jplane_fit.empty((2, 3))
    for f in plane_fit.PlaneMoments._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


@pytest.mark.parametrize("case", ["analytic", "flat_noise", "weighted"])
def test_moments_and_solve_match_jax(case):
    """tests/test_geom.py's estimator cases: the moments within f32
    rounding of JAX's (the port sums in f64), the solve within 1e-5."""
    rng = np.random.default_rng(7)
    weights = None
    if case == "analytic":
        pts = fixtures.analytic_plane_cloud(60, 60, normal=(1, 2, 3),
                                            d=-2.0).reshape(-1, 3)
        hint = [1.0, 2.0, 3.0]
    elif case == "flat_noise":
        pts = rng.normal(size=(50, 3)).astype(np.float32)
        pts[:, 2] *= 0.01
        hint = [0.0, 0.0, 1.0]
    else:
        pts = np.array([[0, 0, 1.1], [0, 0, 0.9], [1, 0, 1.2], [1, 0, 0.8],
                        [1, 1, 1.1], [1, 1, 0.9], [0, 1, 1.1], [0, 1, 0.9],
                        [4, 6, 7], [-6, 5, 8]], np.float32)
        weights = np.array([1.0] * 8 + [0.001, 0.001], np.float32)
        hint = [0.1, 0.1, 0.98]
    got = port_moments(pts, hint, weights)
    want = jax_moments(pts, hint, weights)
    for f in ("s2", "s1", "w"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=2e-6,
                                   atol=1e-6, err_msg=f)
    assert_solutions_close(plane_fit.solve(got), jplane_fit.solve(want),
                           1e-5)


def test_merge_matches_jax_and_is_addition():
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    a, b = port_moments(pts[:20], [1, 0, 0]), port_moments(pts[20:],
                                                           [0, 1, 0])
    merged = plane_fit.merge(a, b)
    want = jplane_fit.merge(jax_moments(pts[:20], [1, 0, 0]),
                            jax_moments(pts[20:], [0, 1, 0]))
    np.testing.assert_array_equal(merged.normal_hint.numpy(), [1, 0, 0])
    np.testing.assert_allclose(merged.s2.numpy(), np.asarray(want.s2),
                               rtol=1e-5)
    joint = port_moments(pts, [1, 0, 0])
    assert_solutions_close(plane_fit.solve(merged), plane_fit.solve(joint),
                           1e-5)


def test_transform_merge_cross_frame_matches_jax():
    """AdvancedPlaneMerging (plane_estimator_test.cc:193-254, the case of
    tests/test_geom.py): an estimator built in frame 2 moved back into
    frame 1 and merged."""
    pts = np.array([[0, 0, 1.1], [0, 0, 0.9], [1, 0, 1.2], [1, 0, 0.8],
                    [1, 1, 1.1], [1, 1, 0.9], [0, 1, 1.1], [0, 1, 0.9]],
                   np.float32)
    angle = np.pi / 2
    quat = np.array([np.cos(angle / 2), np.sin(angle / 2), 0.0, 0.0],
                    np.float32)
    trans = np.ones(3, np.float32)
    jpose = jgeom.Pose(jnp.asarray(quat), jnp.asarray(trans))
    pose = geom.Pose.from_arrays(quat, trans)
    pts2 = np.asarray(jpose.apply(jnp.asarray(pts)))

    want = jplane_fit.solve(jplane_fit.merge(
        jax_moments(pts, [0.1, 0.1, 0.98]),
        jplane_fit.transform(jax_moments(pts2, [0.1, -0.98, 0.1]),
                             jpose.inverse())))
    moved = plane_fit.transform(port_moments(pts2, [0.1, -0.98, 0.1]),
                                pose.inverse())
    got = plane_fit.solve(plane_fit.merge(port_moments(pts, [0.1, 0.1, 0.98]),
                                          moved))
    assert_solutions_close(got, want, 1e-5)
    np.testing.assert_allclose(got.normal.numpy(), [0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(got.centroid.numpy(), [0.5, 0.5, 1.0],
                               atol=1e-5)


def test_state_written_by_jax_loads_into_the_port():
    """JAX's to_dict (batched, 4 estimators) through NumPy into the port's
    from_dict: the same accumulators, the same fits; the port's to_dict
    round-trips."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(4, 30, 3)).astype(np.float32)
    pts[..., 2] *= 0.05
    m = jplane_fit.set_normal_orientation(
        jplane_fit.empty((4,)), jnp.tile(jnp.asarray([0.0, 0.0, 1.0]),
                                         (4, 1)))
    m = jplane_fit.add_points(m, jnp.asarray(pts))
    d = {k: np.asarray(v) for k, v in jplane_fit.to_dict(m).items()}
    got = plane_fit.from_dict(d)
    for f, key in zip(("s2", "s1", "w", "normal_hint"),
                      ("covariance_accumulator", "cumulative_centroid",
                       "cumulative_weights", "normal")):
        np.testing.assert_array_equal(getattr(got, f).numpy(), d[key])
    assert_solutions_close(plane_fit.solve(got), jplane_fit.solve(m), 1e-6)
    back = plane_fit.from_dict(plane_fit.to_dict(got))
    for f in plane_fit.PlaneMoments._fields:
        assert torch.equal(getattr(back, f), getattr(got, f))


# -- ops/geom -----------------------------------------------------------------

def test_plane_helpers_match_jax():
    rng = np.random.default_rng(3)
    n = rng.normal(size=(5, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    n[0] = (0, 0, 1)
    n[1] = (0, -1, 0)
    planes = np.concatenate([n, rng.normal(size=(5, 1)).astype(np.float32)],
                            axis=-1)
    x = rng.normal(size=(5, 3)).astype(np.float32)
    for name in ("plane_signed_distance", "plane_abs_distance",
                 "plane_project"):
        np.testing.assert_allclose(
            getattr(geom, name)(_t(planes), _t(x)).numpy(),
            np.asarray(getattr(jgeom, name)(jnp.asarray(planes),
                                            jnp.asarray(x))),
            rtol=0, atol=1e-6, err_msg=name)
    rot, t = geom.pose_from_plane(_t(planes))
    jrot, jt = jgeom.pose_from_plane(jnp.asarray(planes))
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), atol=1e-6)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=1e-6)
    # an orthonormal frame whose z is the normal and whose origin is on
    # the plane
    np.testing.assert_allclose((rot.transpose(-1, -2) @ rot).numpy(),
                               np.broadcast_to(np.eye(3), (5, 3, 3)),
                               atol=1e-6)
    np.testing.assert_allclose(geom.plane_signed_distance(
        _t(planes), t).numpy(), 0, atol=1e-6)


# -- ops/polygon, utils/hostgeom ----------------------------------------------

def test_point_in_triangle_both_windings_match_jax():
    """algorithms_test.cc:41-81 through the batched op (both windings)."""
    p = np.array([[0.2, 0.1, 0.0], [0.2, 0.1, 1.0], [0.2, 0.1, -1.0],
                  [0.2, -0.1, -1.0], [1.1, 0.1, -1.0], [0.1, 0.2, -1.0],
                  [0.2, -0.1, 0.0]], np.float32)
    for w in ([1.0, 1.0, 0.0], [1.0, -1.0, 0.0]):
        args = (np.zeros((7, 3), np.float32),
                np.tile(np.float32([1, 0, 0]), (7, 1)),
                np.tile(np.float32(w), (7, 1)), p)
        got = polygon.is_inside_triangle(*map(_t, args)).numpy()
        want = np.asarray(jpolygon.is_inside_triangle(*map(jnp.asarray,
                                                           args)))
        np.testing.assert_array_equal(got, want)
        assert got.any() and not got.all()
    assert not bool(polygon.is_inside_triangle(
        torch.zeros(3), torch.zeros(3), torch.ones(3), torch.zeros(3)))


def test_polygon_normal_and_area_match_jax():
    """Batched polygons with trailing padding against JAX's op and the
    host's."""
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(3, 12, 3)).astype(np.float32)
    valid = np.arange(12)[None] < np.array([[12], [7], [3]])
    for v in (None, valid):
        args = (_t(verts),) if v is None else (_t(verts), _t(v))
        jargs = (jnp.asarray(verts),) if v is None else \
            (jnp.asarray(verts), jnp.asarray(v))
        for name in ("cumulative_polygon_normal", "polygon_area",
                     "polygon_normal"):
            np.testing.assert_allclose(
                getattr(polygon, name)(*args).numpy(),
                np.asarray(getattr(jpolygon, name)(*jargs)), rtol=1e-5,
                atol=1e-6, err_msg=name)
    host = hostgeom.polygon_area(verts[1, :7])
    assert abs(host - float(polygon.polygon_area(_t(verts),
                                                 _t(valid))[1])) < 1e-4
    plane = _t(np.float32([0, 0, 1, -2]))
    proj = polygon.project_points_to_plane(_t(verts[0]), plane)
    np.testing.assert_allclose(proj[:, 2].numpy(), 2.0, atol=1e-6)


EAR_CASES = [((0, 1, 2), True), ((1, 2, 3), False), ((2, 3, 4), False),
             ((3, 4, 5), True), ((4, 5, 0), False), ((5, 0, 1), False),
             ((0, 2, 3), True), ((2, 3, 0), True), ((2, 3, 5), True),
             ((5, 0, 2), True)]
REAL_14 = np.array([
    [1.77995, 5.67707, 0.00866], [1.71035, 5.36595, 0.00898],
    [1.64175, 5.06695, 0.00933], [2.11661, 5.73814, -0.00001],
    [2.02174, 5.40343, 0.00087], [1.94777, 5.13560, 0.00151],
    [1.86870, 4.85730, 0.00225], [1.45473, 4.22188, 0.01014],
    [1.49240, 4.39640, 0.01000], [1.54583, 4.62679, 0.00971],
    [1.59422, 4.84672, 0.00951], [1.64174, 5.06695, 0.00933],
    [1.71034, 5.36595, 0.00898], [1.33166, 4.81384, 0.01635]], np.float32)


def test_ears_match_jax():
    """algorithms_test.cc:83-115 on the zigzag."""
    normal = hostgeom.cumulative_polygon_normal(
        ZIGZAG[ZIGZAG_POLY]).astype(np.float64)
    for (u, v, w), expect in EAR_CASES:
        assert hostgeom._is_ear(ZIGZAG, u, v, w, ZIGZAG_POLY, normal) \
            == jhostgeom._is_ear(ZIGZAG, u, v, w, ZIGZAG_POLY, normal) \
            == expect, (u, v, w)


@pytest.mark.parametrize("fn,pts,poly", [
    ("triangulate_loopy_polygon", ZIGZAG, ZIGZAG_POLY),
    ("triangulate_loopy_polygon", ZIGZAG, [0, 3, 2, 1, 4, 5, 4, 1, 4, 5]),
    ("triangulate_polygon", REAL_14, list(range(14))),
    ("triangulate_polygon", ZIGZAG, ZIGZAG_POLY + [0]),
])
def test_triangulation_matches_jax(fn, pts, poly):
    """algorithms_test.cc:142-215: the same triangles as JAX's host
    triangulation, covering the polygon's area."""
    ok, tris = getattr(hostgeom, fn)(pts, poly)
    want_ok, want_tris = getattr(jhostgeom, fn)(pts, poly)
    assert ok and ok == want_ok and tris == want_tris
    area = sum(hostgeom.polygon_area(pts[tris[i:i + 3]])
               for i in range(0, len(tris), 3))
    assert abs(area - hostgeom.polygon_area(pts[poly])) < 1e-5
    assert hostgeom.is_polygon_area_zero(pts[[0, 1, 0]])
    assert not hostgeom.is_polygon_area_zero(pts[poly])


# -- ops/registration ---------------------------------------------------------

def cloud_pts(n=60, seed=4):
    return np.random.default_rng(seed).uniform(-2, 2, (n, 3)) \
        .astype(np.float32)


def test_nearest_neighbors_match_jax_ties_to_the_first():
    src = cloud_pts(40)
    dest = cloud_pts(50, seed=5)
    dest = np.concatenate([dest, dest[:10]])   # exact ties
    want = np.asarray(jregistration.nearest_neighbors(jnp.asarray(src),
                                                      jnp.asarray(dest)))
    for tile in (None, 16):
        got = registration.nearest_neighbors(_t(src), _t(dest), tile)
        np.testing.assert_array_equal(got.numpy(), want)
    d2 = np.sum((src[:, None] - dest[None]) ** 2, axis=-1)
    np.testing.assert_array_equal(want, d2.argmin(axis=1))


def rotation(angle=0.4):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


@pytest.mark.parametrize("weighted", [False, True])
def test_rigid_transform_matches_jax(weighted):
    """Transforms, not SVD factors (their signs are free)."""
    src = cloud_pts()
    dest = src @ rotation().T + np.float32([0.5, 0.25, -1.0])
    dest[:3] += 0.3   # outliers, down-weighted when weighted
    w = np.where(np.arange(60) < 3, 1e-3, 1.0).astype(np.float32) \
        if weighted else None
    got = registration.compute_rigid_transform(
        _t(src), _t(dest), None if w is None else _t(w))
    want = jregistration.compute_rigid_transform(
        jnp.asarray(src), jnp.asarray(dest),
        None if w is None else jnp.asarray(w))
    np.testing.assert_allclose(got.rotation.numpy(),
                               np.asarray(want.rotation), atol=2e-6)
    np.testing.assert_allclose(got.translation.numpy(),
                               np.asarray(want.translation), atol=2e-6)
    np.testing.assert_allclose(got.apply(_t(src)).numpy(),
                               np.asarray(want.apply(jnp.asarray(src))),
                               atol=1e-5)
    assert abs(float(torch.linalg.det(got.rotation)) - 1.0) < 1e-5


@pytest.mark.parametrize("case", ["identity", "shuffled_translated"])
def test_icp_matches_jax(case):
    src = cloud_pts(80)
    if case == "identity":
        dest = src
    else:
        rng = np.random.default_rng(8)
        dest = (src + np.float32([0.05, -0.04, 0.06]))[rng.permutation(80)]
    got = registration.iterative_closest_point(_t(src), _t(dest))
    want = jregistration.iterative_closest_point(jnp.asarray(src),
                                                 jnp.asarray(dest))
    assert got.iterations == int(want.iterations)
    np.testing.assert_allclose(got.transform.rotation.numpy(),
                               np.asarray(want.transform.rotation),
                               atol=1e-5)
    np.testing.assert_allclose(got.transform.translation.numpy(),
                               np.asarray(want.transform.translation),
                               atol=1e-5)
    assert abs(float(got.mean_error) - float(want.mean_error)) < 1e-5


# -- utils/metrics, utils/cloud -----------------------------------------------

def test_label_agreement_and_normal_error_match_jax():
    rng = np.random.default_rng(5)
    a = rng.integers(-1, 6, (30, 40)).astype(np.int32)
    b = np.where(a >= 0, (a + 2) % 6, a)      # permuted ids
    b[rng.random(a.shape) < 0.1] = -1
    assert metrics.label_agreement(a, b) == jmetrics.label_agreement(a, b)
    n1 = rng.normal(size=(30, 40, 3)).astype(np.float32)
    n2 = n1 + rng.normal(0, 0.01, n1.shape).astype(np.float32)
    n2[0, 0] = np.nan
    assert metrics.normal_angle_error_deg(n1, n2) == \
        jmetrics.normal_angle_error_deg(n1, n2)


def test_linearization_matches_jax():
    """cloud_test.cc:82-113 and the flatten round trip."""
    for order in (cloud.COL_MAJOR, cloud.ROW_MAJOR):
        for idx in range(35):
            rc = cloud.index_to_row_col(idx, 5, 7, order)
            assert rc == jcloud.index_to_row_col(idx, 5, 7, order)
            assert cloud.linearize_index(*rc, 5, 7, order) == idx
        grid = np.random.default_rng(0).normal(size=(3, 4, 2)) \
            .astype(np.float32)
        flat = cloud.flatten_grid(_t(grid), order)
        np.testing.assert_array_equal(
            flat.numpy(), np.asarray(jcloud.flatten_grid(jnp.asarray(grid),
                                                         order)))
        assert torch.equal(cloud.unflatten_grid(flat, 3, 4, order),
                           _t(grid))


def test_point_cloud_matches_jax(tmp_path):
    """Special values survive, the valid mask, transform, resize and the
    npz files of either package."""
    rng = np.random.default_rng(6)
    pts = rng.normal(size=(4, 5, 3)).astype(np.float32)
    pts[0, 0] = (np.nan, np.inf, -np.inf)
    nrm = rng.normal(size=(4, 5, 3)).astype(np.float32)
    quat = np.float32([np.cos(0.2), 0, 0, np.sin(0.2)])
    trans = np.float32([1, -2, 0.5])
    jc = jcloud.PointCloud(points=jnp.asarray(pts), normals=jnp.asarray(nrm))
    c = pcseg_tpu_torch.PointCloud(points=_t(pts), normals=_t(nrm))
    assert (c.rows, c.cols, c.size, c.organized) == \
        (jc.rows, jc.cols, jc.size, jc.organized)
    np.testing.assert_array_equal(c.valid_mask().numpy(),
                                  np.asarray(jc.valid_mask()))
    moved = c.transform(geom.Pose.from_arrays(quat, trans))
    jmoved = jc.transform(jgeom.Pose(jnp.asarray(quat), jnp.asarray(trans)))
    for name in ("points", "normals"):
        np.testing.assert_allclose(getattr(moved, name).numpy(),
                                   np.asarray(getattr(jmoved, name)),
                                   atol=1e-6, err_msg=name)
    for rows, cols in ((2, 7), (6, 3)):
        got = c.resize(rows, cols)
        want = jc.resize(rows, cols)
        np.testing.assert_array_equal(got.points.numpy(),
                                      np.asarray(want.points))
        assert got.intensities is None
    jc.to_npz(str(tmp_path / "jax.npz"))
    back = cloud.PointCloud.from_npz(str(tmp_path / "jax.npz"))
    np.testing.assert_array_equal(back.points.numpy(), pts)
    moved.to_npz(str(tmp_path / "port.npz"))
    jback = jcloud.PointCloud.from_npz(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(jback.points),
                                  moved.points.numpy())
    assert torch.isnan(cloud.make_invalid_points(2, 3)).all()


def test_package_exports_match_jax():
    """pcseg_tpu_torch exports the names pcseg_tpu does (PointCloud among
    them)."""
    names = ("UNLABELED", "MASKED_OUT", "MASKED_EGO", "ClusterRegionConfig",
             "ComputeNormalsParams", "MeanShiftParams", "PlanarRegionConfig",
             "PlaneClass", "PlaneClassificationConfig", "Segmenter",
             "SegmenterConfig", "PointCloud")
    for name in names:
        assert hasattr(pcseg_tpu, name) and hasattr(pcseg_tpu_torch, name)
    assert pcseg_tpu_torch.MASKED_EGO == pcseg_tpu.MASKED_EGO
    assert [f.name for f in dataclasses.fields(
        pcseg_tpu_torch.PlanarRegionConfig)] == \
        [f.name for f in dataclasses.fields(pcseg_tpu.PlanarRegionConfig)]
