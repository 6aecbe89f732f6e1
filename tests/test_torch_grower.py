"""The port's batched planar grower against JAX's
grow_planar_regions_batched, in both stage-A regimes: 96x128 runs the
full-grid generations, 128x160 the 64x64 patches. Two different frames
per batch, so frames converge at different epochs (per-frame freezing).
The port runs its plain epoch version on the CPU; JAX runs its XLA epochs.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcseg_tpu.models import planar_batched as jpb
from pcseg_tpu.models.config import UNLABELED, PlanarRegionConfig
from pcseg_tpu.ops import normals as jnormals
from pcseg_tpu.ops import seeds as jseeds
from pcseg_tpu.ops import unproject as junproject
from pcseg_tpu.utils.synthetic import synthetic_cluttered_room_cloud

from pcseg_tpu_torch.models import planar_batched
from pcseg_tpu_torch.ops import geom, plane_fit

# One intra-op thread: the suite runs in parallel worker processes, and
# OpenMP teams spinning across them slow every small op by orders of
# magnitude.
torch.set_num_threads(1)

# Planes: JAX's XLA:CPU dot sums each region's moments in f32, in an order
# no other implementation reproduces; the port sums them in f64. The plane
# of a poorly conditioned fit (a few dozen cells of a noisy clutter patch,
# or a thin strip) moves with that f32 rounding by about
# eps32 * mean|p|^2 / (lambda1 - lambda0) * (1 + |centroid|). Each region
# is held to PLANE_ATOL or to 4x that bound, whichever is larger; the large
# surfaces get PLANE_ATOL.
PLANE_ATOL = 1e-4
EPS32 = 2.0 ** -23


def plane_tolerance(points):
    """Tolerance for the plane fitted to ``points`` [N, 3] (see above)."""
    p = points.astype(np.float64)
    c = p.mean(0)
    ev = np.linalg.eigvalsh(np.cov((p - c).T, bias=True))
    gap = max(ev[1] - ev[0], 1e-30)
    bound = EPS32 * (p * p).sum(1).mean() / gap * (1 + np.linalg.norm(c))
    return max(PLANE_ATOL, 4 * bound)


def region_bars(points):
    """The bars of one region's table entries (points [N, 3], the region's
    cells), from the same f32 rounding as the planes' (see above):

    - moment sums: JAX's f32 sums are off the exact sums by about
      eps32 * log2(N) * sum|term| (blocked summation); 4x that, per
      component. The weight (a count below 2**24) is exact.
    - centroid: the point sum's bound over N, plus an ulp of the mean:
      4 * eps32 * (log2(N) + 1) * mean|p|.
    - curvature, lambda0 / trace: the covariance is the mean second
      moments less the centroid's square, each off by the sums' bound
      (eps32 * log2(N) * mean|p|^2) and a rounding (eps32 * mean|p|^2),
      and lambda0 moves by as much as the covariance does (Weyl), against
      a trace that can be far smaller: 4 * eps32 * (log2(N) + 1) *
      mean|p|^2 / trace. This covers the FLT_MIN gate's knife edge too: a
      lambda0 within that noise of zero comes out 0 on one side and a few
      1e-7 of the trace on the other.
    - normal hint: a unit normal of an earlier fit of the region, held to
      the plane tolerance.
    """
    p = points.astype(np.float64)
    n = len(p)
    lg = max(np.log2(n), 1.0)
    c = p.mean(0)
    trace = max(np.trace(np.cov((p - c).T, bias=True)), 1e-30)
    sq = (p * p).sum(1)
    x, y, z = np.abs(p).T
    s2_abs = np.array([(x * x).sum(), (x * y).sum(), (x * z).sum(),
                       (y * y).sum(), (y * z).sum(), (z * z).sum()])
    return dict(
        s2=4 * EPS32 * lg * s2_abs,
        s1=4 * EPS32 * lg * np.abs(p).sum(0),
        w=0.0,
        centroids=4 * EPS32 * (lg + 1) * np.sqrt(sq).mean(),
        curvatures=4 * EPS32 * (lg + 1) * sq.mean() / trace,
        normal_hint=plane_tolerance(points))


def region_table_misses(got, want, labels, points, num):
    """[(frame, region, field)] of the region table entries (centroids,
    curvatures, moments) of the first num[b] regions of each frame that
    miss their bar (:func:`region_bars`). ``got``/``want``: dicts of
    batched [B, K, ...] arrays keyed by field ("s2", "s1", "w",
    "normal_hint" for the moments)."""
    misses = []
    for b in range(len(num)):
        for r in range(int(num[b])):
            bars = region_bars(points[b][labels[b] == r])
            for f, bar in bars.items():
                if not np.all(np.abs(got[f][b, r].astype(np.float64)
                                     - want[f][b, r]) <= bar):
                    misses.append((b, r, f))
    return misses


def region_table(res):
    """A grower result's region table as a dict of numpy arrays."""
    m = res.moments
    return {f: np.asarray(v) for f, v in dict(
        centroids=res.centroids, curvatures=res.curvatures, s2=m.s2,
        s1=m.s1, w=m.w, normal_hint=m.normal_hint).items()}


def assert_region_table(got, want, labels, points, num):
    """Centroids, curvatures and moments [B, K, ...] of the first num[b]
    regions of each frame within :func:`region_bars`."""
    assert region_table_misses(got, want, labels, points, num) == []


def assert_planes(got, want, labels, points, num):
    """Planes [B, K, 4] of the first num[b] regions of each frame."""
    strict = 0
    for b in range(len(num)):
        for r in range(int(num[b])):
            tol = plane_tolerance(points[b][labels[b] == r])
            strict += tol == PLANE_ATOL
            np.testing.assert_allclose(got[b, r], want[b, r], rtol=0,
                                       atol=tol,
                                       err_msg=f"frame {b} region {r}")
    assert strict >= 2 * len(num)  # the main surfaces held to PLANE_ATOL


def frames(h, w, seeds=(5, 6)):
    rays = junproject.camera_ray_table(h, w, f=float(h))
    pts = []
    for s in seeds:
        p, origin = synthetic_cluttered_room_cloud(h, w, f=float(h), seed=s)
        pts.append(junproject.unproject_range_np(
            junproject.encode_range(p), rays))
    return np.stack(pts), origin


@functools.lru_cache(maxsize=None)
def jax_and_port(shape):
    """(points, JAX's grower result, the port's) on :func:`frames`: JAX
    jitted and vmapped over its normals and plane-support rank grid, the
    port from the same normals and grid. Computed once per shape."""
    h, w = shape
    pts, origin = frames(h, w)

    def jax_one(p):
        n = jnormals.compute_normals_organized(p, jnp.asarray(origin))
        ranked = jseeds.seeds_from_plane_support(p, n)
        labels0 = jnp.full(p.shape[:2], UNLABELED, jnp.int32)
        dev = jpb.grow_planar_regions_batched(
            p, n, labels0, ranked.indices, ranked.valid,
            PlanarRegionConfig(), 0, seed_rank_grid=ranked.rank_grid)
        return n, ranked.rank_grid, dev

    nrm, rank_grid, want = jax.jit(jax.vmap(jax_one))(jnp.asarray(pts))
    got = planar_batched.grow_planar_regions_batched(
        torch.from_numpy(pts), torch.from_numpy(np.array(nrm)),
        torch.full(pts.shape[:3], UNLABELED, dtype=torch.int32), None, None,
        seed_rank_grid=torch.from_numpy(np.array(rank_grid)))
    return pts, want, got


@pytest.mark.parametrize("shape", [(96, 128), (128, 160)])
def test_grower_matches_jax(shape):
    """Labels, counts, overflow exact; planes to :func:`plane_tolerance`;
    centroids, curvatures and moments to :func:`region_bars`. JAX sums
    the region moments in f32 and the port in f64; with its sums taken in
    f64 JAX gives the port's moments and centroids bit for bit, and its
    unjitted solve of those moments the port's curvatures but for
    last-ulp eigensolve rounding (ROADMAP Queue 3, "Known and kept")."""
    pts, want, got = jax_and_port(shape)
    want_n = np.asarray(want.num_regions)
    np.testing.assert_array_equal(got.num_regions.numpy(), want_n)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    assert_planes(got.planes.numpy(), np.asarray(want.planes),
                  got.labels.numpy(), pts, want_n)
    assert_region_table(region_table(got), region_table(want),
                        got.labels.numpy(), pts, want_n)
    assert (want_n >= 8).all()


def test_curvature_bar_rejects_a_wrong_formula():
    """The curvature bar holds lambda0 / trace, not a neighbouring formula:
    lambda1 / trace or lambda0 / lambda2 computed from the port's own
    moments miss it against JAX on the 96x128 frames. (JAX's abs() of
    lambda0 / trace cannot be told apart from its absence: the gate
    passes lambda0 > FLT_MIN and trace > lambda0 only.)"""
    pts, want, got = jax_and_port((96, 128))
    (c00, c01, c02, c11, c12, c22), _ = plane_fit._covariance_c(got.moments)
    evals, _ = geom.eigh3x3_smallest_c(c00, c01, c02, c11, c12, c22)
    trace = c00 + c11 + c22
    ok = got.curvatures > 0
    labels, num = got.labels.numpy(), np.asarray(want.num_regions)
    table = region_table(got)
    for wrong in (evals[..., 1] / trace, evals[..., 0] / evals[..., 2]):
        bad = dict(table, curvatures=torch.where(ok, wrong, 0.0).numpy())
        misses = region_table_misses(bad, region_table(want), labels, pts,
                                     num)
        assert len(misses) >= 4
        assert {f for _, _, f in misses} == {"curvatures"}
    assert region_table_misses(table, region_table(want), labels, pts,
                               num) == []


def test_rank_grid_from_seed_vector():
    """Duplicate, invalid and out-of-range entries included; the last
    entry of the vector gets the best rank."""
    rng = np.random.default_rng(4)
    h, w, s = 12, 17, 300
    idx = rng.integers(-5, h * w + 5, (2, s)).astype(np.int32)
    valid = rng.random((2, s)) < 0.8
    got = planar_batched.rank_grid_from_seed_vector(
        torch.from_numpy(idx), torch.from_numpy(valid), h, w).numpy()
    for b in range(2):
        want = jpb.rank_grid_from_seed_vector(jnp.asarray(idx[b]),
                                              jnp.asarray(valid[b]), h, w)
        np.testing.assert_array_equal(got[b], np.asarray(want))


def f64_sum_trace(shape=(96, 128)):
    """The trace of the region-table differences (ROADMAP Queue 3, item 6;
    not a test: it compiles JAX's grower twice). JAX's jitted grower with
    its [K, 10] moment products summed in f64 (a host callback, as in
    tests/test_torch_avg_seeds.py::test_f64_refit_sums_give_the_port_s_frame)
    against the port on :func:`frames`; then JAX's unjitted solve of those
    moments against the port's curvatures. Prints one line per frame."""
    import jax.numpy as jnp_
    from pcseg_tpu.ops import plane_fit as jplane_fit

    def f64_sums(a, b):
        out = jax.ShapeDtypeStruct(a.shape[:-1] + b.shape[-1:], jnp.float32)
        return jax.pure_callback(
            lambda x, y: np.matmul(np.asarray(x, np.float64),
                                   np.asarray(y, np.float64))
            .astype(np.float32), out, a, b)

    class F64Sums:  # jax.numpy with the [.., 10]-moment products in f64
        def __getattr__(self, name):
            return getattr(jnp_, name)

        @staticmethod
        def dot(a, b, **kw):
            return f64_sums(a, b) if b.shape[-1] == 10 else \
                jnp_.dot(a, b, **kw)

    pts, want, got = jax_and_port(shape)
    h, w = shape
    _, origin = frames(h, w)
    jpb.jnp = F64Sums()
    try:
        for b in range(len(pts)):
            p = jnp.asarray(pts[b])
            n = jnormals.compute_normals_organized(p, jnp.asarray(origin))
            grid = jseeds.seeds_from_plane_support(p, n).rank_grid
            res = jax.jit(lambda p, n, g: jpb.grow_planar_regions_batched(
                p, n, jnp.full((h, w), UNLABELED, jnp.int32), None, None,
                PlanarRegionConfig(), seed_rank_grid=g))(p, n, grid)
            k = int(got.num_regions[b])
            table = {f: np.array_equal(np.asarray(v)[:k],
                                       region_table(got)[f][b, :k])
                     for f, v in region_table(res).items()}
            eager = np.asarray(jplane_fit.solve(res.moments).curvature)[:k]
            same = int((eager == got.curvatures[b, :k].numpy()).sum())
            print(f"frame {b}: f64-sum JAX equals the port: {table}; "
                  f"unjitted solve gives the port's curvature in {same} of "
                  f"{k} slots", flush=True)
    finally:
        jpb.jnp = jnp_


if __name__ == "__main__":
    f64_sum_trace()
