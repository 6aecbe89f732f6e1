"""The port's sequential grower (``growth_mode="wavefront"`` and
``"hybrid"``, models/planar.py) and its pieces against JAX on the CPU: the
plane-support seed vector, ``reachable_from`` (cap binding or not), the
grower on tests/test_planar.py's scenes (tests/test_torch_planar_seq_frame.py
holds ``Segmenter`` frames in both modes). The ``cuda`` twin holds the
card's grower to the CPU's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu import oracle
from pcseg_tpu.models import config as jconfig
from pcseg_tpu.models import planar as jplanar
from pcseg_tpu.ops import connectivity as jconn
from pcseg_tpu.ops import seeds as jseeds

from pcseg_tpu_torch.models import config, pipeline, planar
from pcseg_tpu_torch.ops import connectivity, seeds
from tests import fixtures
from tests.test_torch_grower import (assert_region_table, plane_tolerance,
                                     region_table)
from tests.test_torch_kernels import _t, cuda_device  # noqa: F401

torch.set_num_threads(1)

MODES = ["hybrid", "wavefront"]


def serpentine(h, w, step=3):
    """A one-cell-wide path winding down the columns: its flood needs a
    round per turn."""
    mask = np.zeros((h, w), bool)
    for k, c in enumerate(range(0, w, step)):
        mask[:, c] = True
        if c + step < w:
            r = h - 1 if k % 2 == 0 else 0
            mask[r, c:c + step + 1] = True
    return mask


@pytest.mark.parametrize("max_rounds", [1, 2, 64])
def test_reachable_from_matches_jax(max_rounds):
    """A batch of a serpentine (17 turns: the cap binds at 1 and 2) and a
    random mask with scattered sources."""
    rng = np.random.default_rng(4)
    masks = np.stack([serpentine(24, 50), rng.random((24, 50)) < 0.6])
    sources = np.zeros_like(masks)
    sources[0, 0, 0] = True
    sources[1] = rng.random((24, 50)) < 0.02
    got = connectivity.reachable_from(_t(masks), _t(sources), max_rounds)
    for i in range(2):
        want = jax.jit(lambda m, s: jconn.reachable_from(m, s, max_rounds))(
            jnp.asarray(masks[i]), jnp.asarray(sources[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    full = connectivity.reachable_from(_t(masks[:1]), _t(sources[:1]), 64)
    assert bool(full[0, 0, 48]) and (max_rounds == 64) == bool(got[0, 0, 48])


@pytest.mark.parametrize("shape,max_seeds", [((40, 40), 8192), ((24, 36), 60)])
def test_plane_support_seed_vector_matches_jax(shape, max_seeds):
    """The top-``max_seeds`` vector, in the reference's (transposed) order,
    on a square grid and on a non-square one where ``max_seeds`` binds."""
    h, w = shape
    pts, origin = fixtures.synthetic_room_cloud(h, w, f=float(h), seed=2)
    nrm = oracle.compute_normals_organized(pts, origin)
    params = dataclasses.replace(jconfig.SeedsFromPlaneSupportParams(),
                                 max_seeds=max_seeds)
    want = jax.jit(lambda p, n: jseeds.seeds_from_plane_support(
        p, n, params))(jnp.asarray(pts), jnp.asarray(nrm))
    got = seeds.seeds_from_plane_support(
        _t(pts)[None], _t(nrm)[None],
        config.SeedsFromPlaneSupportParams(**dataclasses.asdict(params)),
        seed_vector=True)
    np.testing.assert_array_equal(got.indices[0].numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.valid[0].numpy(),
                                  np.asarray(want.valid))
    assert got.valid.any()


def room(n=40, seed=2):
    """tests/test_planar.py's scene: the room cloud with oracle normals."""
    pts, origin = fixtures.synthetic_room_cloud(n, n, f=float(n), seed=seed)
    return pts, oracle.compute_normals_organized(pts, origin)


def bordered_plane():
    pts = np.full((24, 24, 3), np.nan, np.float32)
    pts[2:22, 2:22] = fixtures.analytic_plane_cloud(
        20, 20, normal=(0, 0, 1), d=1.0, step=0.1)
    return pts, oracle.compute_normals_organized(
        pts, np.array([0, 0, 5.0], np.float32))


def small_patch():
    rng = np.random.default_rng(4)
    pts = rng.uniform(-20, 20, (24, 24, 3)).astype(np.float32)
    pts[4:10, 4:10] = fixtures.analytic_plane_cloud(
        6, 6, normal=(0, 0, 1), d=-1.0, step=0.02)
    return pts, oracle.compute_normals_organized(
        pts, np.array([0, 0, 5.0], np.float32))


SCENES = {"room": room, "bordered_plane": bordered_plane,
          "small_patch": small_patch}
# device regions (before the host finalize's area gate)
SCENE_REGIONS = {"room": 6, "bordered_plane": 1, "small_patch": 0}


def run_both(pts, nrm, cfg, seed_idx=None, seed_valid=None, offset=0,
             max_attempts=256):
    """(port's regions, JAX's jitted regions) on the same seed vector (the
    plane-support finder's unless given)."""
    if seed_idx is None:
        ranked = jax.jit(lambda p, n: jseeds.seeds_from_plane_support(
            p, n, jconfig.SeedsFromPlaneSupportParams()))(
            jnp.asarray(pts), jnp.asarray(nrm))
        seed_idx, seed_valid = (np.asarray(ranked.indices),
                                np.asarray(ranked.valid))
    labels0 = np.full(pts.shape[:2], jconfig.UNLABELED, np.int32)
    want = jax.jit(lambda p, n, l, si, sv: jplanar.grow_planar_regions(
        p, n, l, si, sv, cfg, offset, max_attempts))(
        jnp.asarray(pts), jnp.asarray(nrm), jnp.asarray(labels0),
        jnp.asarray(seed_idx), jnp.asarray(seed_valid))
    tcfg = config.PlanarRegionConfig(**dataclasses.asdict(cfg))
    got = planar.grow_planar_regions(
        _t(pts)[None], _t(nrm)[None], _t(labels0)[None],
        _t(seed_idx)[None], _t(seed_valid)[None], tcfg, offset, max_attempts)
    return got, want


def assert_regions_equal(got, want, pts, offset=0):
    for f in ("labels", "num_regions", "counts", "seed_indices", "overflow"):
        np.testing.assert_array_equal(getattr(got, f)[0].numpy(),
                                      np.asarray(getattr(want, f)),
                                      err_msg=f)
    labels = np.asarray(want.labels)
    for r in range(int(want.num_regions)):
        tol = plane_tolerance(pts[labels == r + offset])
        for f in ("planes", "centroids"):
            np.testing.assert_allclose(getattr(got, f)[0, r].numpy(),
                                       np.asarray(getattr(want, f))[r],
                                       rtol=0, atol=tol, err_msg=f"{f} {r}")
    np.testing.assert_allclose(got.moments.w[0].numpy(),
                               np.asarray(want.moments.w), rtol=0, atol=0)
    # curvatures and moments (and the centroids again) to the batched
    # grower's bars, tests/test_torch_grower.region_bars
    assert_region_table(region_table(got),
                        {f: v[None] for f, v in region_table(want).items()},
                        labels[None] - offset, pts[None],
                        np.asarray(want.num_regions)[None])


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("mode", MODES)
def test_grower_matches_jax(mode, scene):
    pts, nrm = SCENES[scene]()
    cfg = dataclasses.replace(jconfig.PlanarRegionConfig(), growth_mode=mode)
    got, want = run_both(pts, nrm, cfg, offset=2)
    assert_regions_equal(got, want, pts, offset=2)
    assert int(got.num_regions[0]) == SCENE_REGIONS[scene]


@pytest.mark.parametrize("mode", MODES)
def test_grower_empty_seed_list(mode):
    """tests/test_planar.py::test_empty_seed_list: no valid seed, no
    region, every cell unlabeled."""
    pts, nrm = room()
    cfg = dataclasses.replace(jconfig.PlanarRegionConfig(), growth_mode=mode)
    got, want = run_both(pts, nrm, cfg, np.zeros(8, np.int32),
                         np.zeros(8, bool))
    assert_regions_equal(got, want, pts)
    assert int(got.num_regions[0]) == 0
    assert (got.labels == jconfig.UNLABELED).all()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("max_regions,max_attempts", [(2, 256), (32, 3)])
def test_grower_capacity_overflow_matches_jax(mode, max_regions,
                                              max_attempts):
    """The region table or the attempts run out: the same regions and the
    overflow flag."""
    pts, nrm = room()
    cfg = dataclasses.replace(jconfig.PlanarRegionConfig(), growth_mode=mode,
                              max_regions=max_regions)
    got, want = run_both(pts, nrm, cfg, max_attempts=max_attempts)
    assert_regions_equal(got, want, pts)
    assert bool(got.overflow[0])


def test_grower_refuses_batched_mode():
    with pytest.raises(ValueError, match="sequential"):
        planar.grow_planar_regions(
            torch.zeros(1, 4, 4, 3), torch.zeros(1, 4, 4, 3),
            torch.full((1, 4, 4), -1, dtype=torch.int32),
            torch.zeros(1, 2, dtype=torch.int32),
            torch.zeros(1, 2, dtype=torch.bool), config.PlanarRegionConfig())


def test_segmenter_refuses_unknown_growth_mode():
    cfg = config.SegmenterConfig(planar=config.PlanarRegionConfig(
        growth_mode="bfs"))
    with pytest.raises(ValueError, match="growth_mode"):
        pipeline.Segmenter(cfg, device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", MODES)
def test_grower_card_matches_cpu(cuda_device, mode):
    pts, nrm = room()
    ranked = seeds.seeds_from_plane_support(
        _t(pts)[None], _t(nrm)[None], config.SeedsFromPlaneSupportParams(),
        seed_vector=True)
    cfg = config.PlanarRegionConfig(growth_mode=mode)
    labels0 = torch.full((1, 40, 40), -1, dtype=torch.int32)
    args = (_t(pts)[None], _t(nrm)[None], labels0, ranked.indices,
            ranked.valid)
    a = planar.grow_planar_regions(*[x.to(cuda_device) for x in args], cfg)
    b = planar.grow_planar_regions(*args, cfg)
    for f in ("labels", "num_regions", "counts", "seed_indices", "overflow"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert float((a.planes.cpu() - b.planes).abs().max()) <= 1e-4
