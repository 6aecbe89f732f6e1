"""The port's batched planar grower against JAX's
grow_planar_regions_batched, in both stage-A regimes: 96x128 runs the
full-grid generations, 128x160 the 64x64 patches. Two different frames
per batch, so frames converge at different epochs (per-frame freezing).
The port runs its plain epoch version on the CPU; JAX runs its XLA epochs.
"""

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


@pytest.mark.parametrize("shape", [(96, 128), (128, 160)])
def test_grower_matches_jax(shape):
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
        torch.full(pts.shape[:3], UNLABELED, dtype=torch.int32),
        torch.from_numpy(np.array(rank_grid)))
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
    assert (want_n >= 8).all()


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
