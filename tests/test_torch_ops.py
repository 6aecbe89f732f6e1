"""The PyTorch port's ops against their JAX counterparts, on the CPU.

Inputs are made from numpy seeds and handed to both packages as numpy
arrays; the port runs on CPU tensors (plain versions everywhere).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcseg_tpu.ops import geom as jgeom
from pcseg_tpu.ops import nansafe as jnansafe
from pcseg_tpu.ops import normals as jnormals
from pcseg_tpu.ops import plane_fit as jplane_fit
from pcseg_tpu.ops import seeds as jseeds
from pcseg_tpu.ops import unproject as junproject
from pcseg_tpu.utils.synthetic import synthetic_cluttered_room_cloud

from pcseg_tpu_torch.ops import geom, nansafe, normals, plane_fit, seeds
from pcseg_tpu_torch.ops import unproject

# One intra-op thread: the suite runs in parallel worker processes, and
# OpenMP teams spinning across them slow every small op by orders of
# magnitude.
torch.set_num_threads(1)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable, contiguous copy


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.float16])
def test_nansafe_isfinite(dtype):
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1e3, 4096).astype(dtype)
    x[rng.random(4096) < 0.1] = np.nan
    x[rng.random(4096) < 0.05] = np.inf
    x[rng.random(4096) < 0.05] = -np.inf
    x[:4] = [np.finfo(dtype).tiny / 4, -0.0, np.finfo(dtype).max, 0.0]
    got = nansafe.isfinite(_t(x)).numpy()
    np.testing.assert_array_equal(got, np.isfinite(x))
    if dtype != np.float64:  # JAX runs without x64 here
        np.testing.assert_array_equal(
            got, np.asarray(jnansafe.isfinite(jnp.asarray(x))))
    pts = x[:4095].reshape(-1, 3)
    np.testing.assert_array_equal(nansafe.all_finite(_t(pts)).numpy(),
                                  np.isfinite(pts).all(-1))
    np.testing.assert_array_equal(nansafe.sanitize(_t(x)).numpy(),
                                  np.where(np.isfinite(x), x, 0))


def _covariances(kind, n=512, seed=1):
    """Six component arrays of symmetric 3x3 covariances."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        pts = rng.normal(size=(n, 12, 3)) * rng.uniform(
            1e-3, 3, (n, 1, 3))
        pts = pts @ rng.normal(size=(n, 3, 3))
    else:
        base = rng.normal(size=(n, 12, 3))
        modes = n // 4
        # collinear, exactly planar, isotropic, single point
        d = rng.normal(size=(modes, 1, 3))
        base[:modes] = rng.normal(size=(modes, 12, 1)) * d
        base[modes:2 * modes, :, 2] = 0.0
        base[2 * modes:3 * modes] = np.eye(3)[np.arange(12) % 3] * 2.0
        base[3 * modes:] = base[3 * modes:, :1]
        pts = base + rng.normal(size=(n, 1, 3)) * 3
    pts = pts.astype(np.float32)
    c = pts - pts.mean(1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", c, c).astype(np.float32) / 12
    return [cov[:, i, j] for i, j in
            ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))], pts


@pytest.mark.parametrize("kind", ["random", "degenerate"])
def test_eigh3x3_smallest_c(kind):
    """Same f32 operation order as JAX. XLA:CPU's atan2/cos/sin/sqrt/rsqrt
    are not correctly rounded and differ from PyTorch's in the last ulp on
    a few percent of inputs; an eigenvector inherits that amplified by
    trace/gap. So: atol 1e-6 where the smallest eigenvalue is separated
    (gap >= 1e-2 of the trace), and 1e-4 everywhere."""
    comps, _ = _covariances(kind)
    rng = np.random.default_rng(2)
    hint = rng.normal(size=(comps[0].shape[0], 3)).astype(np.float32)
    ev, vec = geom.eigh3x3_smallest_c(*[_t(c) for c in comps],
                                      prev_normal=_t(hint))
    jev, jvec = jgeom.eigh3x3_smallest_c(*[jnp.asarray(c) for c in comps],
                                         prev_normal=jnp.asarray(hint))
    jev, jvec = np.asarray(jev), np.asarray(jvec)
    np.testing.assert_allclose(ev.numpy(), jev, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(jev).max())))
    trace = np.abs(jev).sum(-1) + 1e-30
    separated = (jev[:, 1] - jev[:, 0]) >= 1e-2 * trace
    assert separated.sum() >= 64
    np.testing.assert_allclose(vec.numpy()[separated], jvec[separated],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(vec.numpy(), jvec, rtol=0, atol=1e-4)


@pytest.mark.parametrize("kind", ["random", "degenerate"])
def test_plane_fit_solve(kind):
    _, pts = _covariances(kind, n=256, seed=4)
    x, y, z = pts[..., 0], pts[..., 1], pts[..., 2]
    s2 = np.stack([(x * x).sum(1), (x * y).sum(1), (x * z).sum(1),
                   (y * y).sum(1), (y * z).sum(1), (z * z).sum(1)], -1)
    s1 = pts.sum(1)
    w = np.full(pts.shape[0], 12.0, np.float32)
    w[:8] = 0.0  # empty estimators take the invalid branch
    hint = np.tile(np.float32([0.0, 0.0, 1.0]), (pts.shape[0], 1))
    arrays = [a.astype(np.float32) for a in (s2, s1, w, hint)]
    got = plane_fit.solve(plane_fit.PlaneMoments(*[_t(a) for a in arrays]))
    want = jplane_fit.solve(jplane_fit.PlaneMoments(
        *[jnp.asarray(a) for a in arrays]))
    # the FLT_MIN validity gate sits inside f32 rounding noise for
    # collinear sets (pcseg_tpu.ops.plane_fit.PlaneSolution): exact
    # agreement off that knife edge (middle eigenvalue above 1e-4 of the
    # trace in both, or no points)
    off_edge = ((np.minimum(got.mid_ratio.numpy(),
                            np.asarray(want.mid_ratio)) > 1e-4)
                | (arrays[2] == 0))
    assert off_edge.mean() > 0.4
    np.testing.assert_array_equal(got.valid.numpy()[off_edge],
                                  np.asarray(want.valid)[off_edge])
    ok = off_edge[:, None]
    np.testing.assert_allclose(got.centroid.numpy(),
                               np.asarray(want.centroid), rtol=1e-6,
                               atol=1e-6)
    for name in ("plane", "normal"):
        np.testing.assert_allclose(
            np.where(ok, getattr(got, name).numpy(), 0),
            np.where(ok, np.asarray(getattr(want, name)), 0),
            rtol=1e-6, atol=1e-5, err_msg=name)
    for name in ("curvature", "mid_ratio"):
        np.testing.assert_allclose(
            np.where(off_edge, getattr(got, name).numpy(), 0),
            np.where(off_edge, np.asarray(getattr(want, name)), 0),
            rtol=1e-4, atol=1e-6, err_msg=name)


def test_unproject_bit_exact():
    rng = np.random.default_rng(3)
    h, w = 24, 40
    rays = unproject.camera_ray_table(h, w, f=30.0)
    np.testing.assert_array_equal(rays, junproject.camera_ray_table(
        h, w, f=30.0))
    d16 = rng.integers(0, 65536, (2, h, w)).astype(np.uint16)
    d16[:, ::5] = 0
    got = unproject.unproject_range(_t(d16), _t(rays)).numpy()
    np.testing.assert_array_equal(got,
                                  unproject.unproject_range_np(d16, rays))
    np.testing.assert_array_equal(
        got, np.asarray(junproject.unproject_range(jnp.asarray(d16),
                                                   jnp.asarray(rays))))
    pts, _ = synthetic_cluttered_room_cloud(h, w, f=30.0, seed=1)
    np.testing.assert_array_equal(unproject.encode_range(pts),
                                  junproject.encode_range(pts))


def _cloud(h, w, seed):
    pts, origin = synthetic_cluttered_room_cloud(h, w, f=float(h), seed=seed)
    rays = junproject.camera_ray_table(h, w, f=float(h))
    return junproject.unproject_range_np(junproject.encode_range(pts),
                                         rays), origin


def test_normals_match_jax():
    pts, origin = _cloud(40, 48, seed=2)
    assert np.isnan(pts).any()
    want = np.asarray(jnormals.compute_normals_organized(
        jnp.asarray(pts), jnp.asarray(origin)))
    got = normals.compute_normals_organized(_t(pts[None]),
                                            _t(origin)).numpy()[0]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("shape", [(40, 40), (128, 160)])
def test_plane_support_rank_grid(shape):
    """Exact ranks; 128x160 takes the transposed-parity min-fold branch."""
    h, w = shape
    pts, origin = _cloud(h, w, seed=5)
    nrm = np.asarray(jnormals.compute_normals_organized(
        jnp.asarray(pts), jnp.asarray(origin)))
    want = jseeds.seeds_from_plane_support(jnp.asarray(pts), jnp.asarray(nrm))
    got = seeds.seeds_from_plane_support(_t(pts[None]), _t(nrm[None]))
    np.testing.assert_array_equal(got.count.numpy()[0],
                                  np.asarray(want.count))
    np.testing.assert_array_equal(got.rank_grid.numpy()[0],
                                  np.asarray(want.rank_grid))
    assert (got.rank_grid < seeds.SEED_RANK_INF).sum() > 0
