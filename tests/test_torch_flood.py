"""The packed flood (kernel B3) and the grower's K > 32 closure epochs.

The flood's plain version is held exactly against JAX's Pallas kernel
(interpret mode on the CPU) and its XLA flood on the recipes of
tests/test_planar_batched.py; the grower at K = 40 against JAX's
grow_planar_regions_batched in both stage-A regimes (96x128 full-grid
generations, 128x160 patches). The CUDA kernel is held against the plain
version when a card is present (marker ``cuda``).
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

from pcseg_tpu_torch.kernels import flood_packed
from pcseg_tpu_torch.models import config, planar_batched
from pcseg_tpu_torch.utils import profiling
from tests.test_torch_grower import assert_planes, frames

# One intra-op thread: the suite runs in parallel worker processes, and
# OpenMP teams spinning across them slow every small op by orders of
# magnitude.
torch.set_num_threads(1)


def recipe(name):
    """(gate, sources, max_run) bool [K, H, W] of the JAX flood tests."""
    if name == "k40":
        rng = np.random.default_rng(5)
        gate = rng.random((40, 48, 64)) < 0.55
        return gate, gate & (rng.random(gate.shape) < 0.02), None
    rng = np.random.default_rng(8)
    gate = rng.random((8, 32, 32)) < 0.5
    # runs capped at 9 by construction: every 9th row and column severed
    gate[:, ::9, :] = False
    gate[:, :, ::9] = False
    return gate, gate & (rng.random(gate.shape) < 0.05), 9


def port_flood(gate, src, rounds=64, device="cpu", impl=None,
               with_rounds=False):
    """Port flood of [B, K, H, W] bool masks -> [B, K, H, W] bool (and the
    rounds each of the B * ceil(K / 32) word planes ran)."""
    b, k, h, w = gate.shape
    g = flood_packed.pack_bits(torch.from_numpy(gate)).reshape(-1, h, w)
    r = flood_packed.pack_bits(torch.from_numpy(src & gate)).reshape(-1, h, w)
    ran = torch.zeros(g.shape[0], dtype=torch.int32, device=device)
    out = flood_packed.flood_packed(g.to(device), r.to(device), rounds,
                                    impl=impl, rounds_out=ran).cpu()
    out = flood_packed.unpack_bits(out.reshape(b, -1, h, w), k).numpy()
    return (out, ran.cpu().numpy()) if with_rounds else out


def staircase(n, mirror=False):
    """[n, n] bool one-cell staircase (i, i) -> (i, i + 1) -> (i + 1, i + 1)
    (columns mirrored if asked). A flood from its first cell gains one
    step a round (a row pass, then a column pass), so it reaches the last
    cell after n - 1 rounds and runs n with the confirming round."""
    g = np.zeros((n, n), bool)
    i = np.arange(n)
    g[i, i] = True
    g[i[:-1], i[:-1] + 1] = True
    return g[:, ::-1] if mirror else g


def stair_frames(lengths, k=40, size=96):
    """[B, K, size, size] gate and sources: frame f's slot 0 (word plane 0)
    and slot 33 (word plane 1) carry staircases of lengths[f] diagonal
    cells, sourced at their first cell; every other slot is empty."""
    gate = np.zeros((len(lengths), k, size, size), bool)
    src = np.zeros_like(gate)
    for f, (l0, l1) in enumerate(lengths):
        gate[f, 0, :l0, :l0] = staircase(l0)
        gate[f, 33, :l1, size - l1:] = staircase(l1, mirror=True)
        src[f, 0, 0, 0] = src[f, 33, 0, size - 1] = True
    return gate, src


def jax_flood(gate, src, rounds):
    return np.stack([np.asarray(jpb.flood_fill_static(
        jnp.asarray(g), jnp.asarray(s), rounds)) for g, s in zip(gate, src)])


@pytest.mark.parametrize("name", ["k40", "max_run9"])
def test_flood_plain_matches_jax(name):
    """JAX floods with the recipe's ``max_run`` bound, the port over whole
    runs: equal wherever no run is longer than the bound."""
    gate, src, max_run = recipe(name)
    k = gate.shape[0]
    g = jpb._pack_bits(jnp.asarray(gate))
    r0 = jpb._pack_bits(jnp.asarray(src & gate))
    want_pallas = np.asarray(jpb._unpack_bits(jax.jit(
        lambda g, r: jpb._flood_pallas(g, r, 64, max_run=max_run,
                                       interpret=True))(g, r0), k))
    want_xla = np.asarray(jpb.flood_fill_static(
        jnp.asarray(gate), jnp.asarray(src), 64, max_run=max_run))
    np.testing.assert_array_equal(want_pallas, want_xla)
    got = port_flood(gate[None], src[None])[0]
    np.testing.assert_array_equal(got, want_xla)
    assert got.sum() > 5 * src.sum()  # the flood spread


@pytest.mark.parametrize("rounds", [2, 64])
def test_flood_batched_planes(rounds):
    """Three frames of K = 40 slots flood as one stack of N = B * NW = 6
    word planes; each frame equals JAX's flood of that frame alone (rounds
    past a plane's fixed point change nothing, so the stack's common stop
    gives the same words, also when the 2-round cap binds)."""
    rng = np.random.default_rng(11)
    gate = rng.random((3, 40, 24, 40)) < 0.6
    src = gate & (rng.random(gate.shape) < 0.01)
    got = port_flood(gate, src, rounds)
    for f in range(3):
        want = np.asarray(jpb.flood_fill_static(
            jnp.asarray(gate[f]), jnp.asarray(src[f]), rounds))
        np.testing.assert_array_equal(got[f], want, err_msg=f"frame {f}")
    if rounds == 2:
        assert (got != port_flood(gate, src, 64)).any(), "cap should bind"


@pytest.mark.parametrize("rounds", [64, 128])
def test_flood_staircase_matches_jax(rounds):
    """A 96x96 staircase needs 95 rounds: exact against JAX where the
    64-round cap binds and where the flood reaches its fixed point; the
    rounds run are the cap, or 95 plus the confirming round."""
    gate, src = stair_frames([(96, 96)])
    rng = np.random.default_rng(4)
    gate[0, 5:30] = rng.random((25, 96, 96)) < 0.6  # busy slots beside
    src[0, 5:30] = gate[0, 5:30] & (rng.random((25, 96, 96)) < 0.01)
    got, ran = port_flood(gate, src, rounds, with_rounds=True)
    np.testing.assert_array_equal(got, jax_flood(gate, src, rounds))
    np.testing.assert_array_equal(ran, [min(rounds, 96)] * 2)
    if rounds == 64:
        assert (got != port_flood(gate, src, 128)).any(), "cap should bind"
        assert got[0, 0].sum() == 2 * 64 + 1  # 64 steps down the stairs


@pytest.mark.parametrize("rounds", [40, 128])
def test_flood_planes_stop_on_their_own(rounds):
    """Six word planes whose staircases reach their fixed points after 95,
    9, 49, 2, 0 and 69 rounds: each frame equals JAX's flood of that frame
    alone, and each plane ran its own rounds (the cap, or its rounds to the
    fixed point plus the confirming one)."""
    lengths = [(96, 10), (50, 3), (1, 70)]
    gate, src = stair_frames(lengths)
    got, ran = port_flood(gate, src, rounds, with_rounds=True)
    np.testing.assert_array_equal(got, jax_flood(gate, src, rounds))
    np.testing.assert_array_equal(
        ran, np.minimum(np.ravel(lengths), rounds))


# Planes past the kernel's shared memory on an H100: strips taller than
# ~870 rows, rows wider than ~27,000 columns (csrc/seg_flood.cuh scans
# them in place).
BIG_SHAPES = [(1100, 24), (4, 28800)]


def big_frames(shape):
    """[1, 34, H, W] random gate and sparse sources (two word planes)."""
    rng = np.random.default_rng(shape[0])
    gate = rng.random((1, 34) + shape) < 0.6
    return gate, gate & (rng.random(gate.shape) < 0.002)


@pytest.mark.parametrize("shape", BIG_SHAPES)
def test_flood_tall_and_wide_matches_jax(shape):
    """The shapes the kernel scans in place: the plain version, which the
    kernel is held to, equals JAX's flood there too."""
    gate, src = big_frames(shape)
    got = port_flood(gate, src)
    np.testing.assert_array_equal(got, jax_flood(gate, src, 64))
    assert got.sum() > 5 * src.sum()  # the flood spread


@pytest.mark.parametrize("k", [33, 40, 64])
def test_pack_bits_round_trip(k):
    rng = np.random.default_rng(k)
    masks = rng.random((2, k, 5, 7)) < 0.5
    words = flood_packed.pack_bits(torch.from_numpy(masks))
    assert words.dtype == torch.int32 and words.shape == (2, -(-k // 32),
                                                           5, 7)
    for f in range(2):
        want = np.asarray(jpb._pack_bits(jnp.asarray(masks[f])))
        np.testing.assert_array_equal(words[f].numpy(), want.view(np.int32))
    np.testing.assert_array_equal(
        flood_packed.unpack_bits(words, k).numpy(), masks)


@pytest.mark.parametrize("shape", [(96, 128), (128, 160)])
def test_grower_k40_matches_jax(shape):
    """K = 40 takes the flood epochs in both packages (JAX's XLA epochs,
    the port's packed flood): labels, counts, num_regions exact."""
    h, w = shape
    pts, origin = frames(h, w)
    jcfg = PlanarRegionConfig(max_regions=40)

    def jax_one(p):
        n = jnormals.compute_normals_organized(p, jnp.asarray(origin))
        ranked = jseeds.seeds_from_plane_support(p, n)
        labels0 = jnp.full(p.shape[:2], UNLABELED, jnp.int32)
        dev = jpb.grow_planar_regions_batched(
            p, n, labels0, ranked.indices, ranked.valid, jcfg, 0,
            seed_rank_grid=ranked.rank_grid)
        return n, ranked.rank_grid, dev

    nrm, rank_grid, want = jax.jit(jax.vmap(jax_one))(jnp.asarray(pts))
    launches = profiling.total("launches.flood_packed")
    got = planar_batched.grow_planar_regions_batched(
        torch.from_numpy(pts), torch.from_numpy(np.array(nrm)),
        torch.full(pts.shape[:3], UNLABELED, dtype=torch.int32), None, None,
        config.PlanarRegionConfig(max_regions=40),
        seed_rank_grid=torch.from_numpy(np.array(rank_grid)))
    # CPU tensors: the plain version
    assert profiling.total("launches.flood_packed") == launches
    want_n = np.asarray(want.num_regions)
    np.testing.assert_array_equal(got.num_regions.numpy(), want_n)
    np.testing.assert_array_equal(got.labels.numpy(),
                                  np.asarray(want.labels))
    np.testing.assert_array_equal(got.counts.numpy(),
                                  np.asarray(want.counts))
    np.testing.assert_array_equal(got.overflow.numpy(),
                                  np.asarray(want.overflow))
    assert got.planes.shape == (2, 40, 4)
    assert_planes(got.planes.numpy(), np.asarray(want.planes),
                  got.labels.numpy(), pts, want_n)
    assert (want_n >= 8).all()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [2, 64])
def test_flood_kernel_matches_plain(cuda_device, rounds):
    gate, src, _ = recipe("k40")
    gate = np.stack([gate, gate[:, ::-1]])
    src = np.stack([src, src[:, ::-1]])
    got = port_flood(gate, src, rounds, device=cuda_device)
    want = port_flood(gate, src, rounds, device=cuda_device, impl="plain")
    np.testing.assert_array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [64, 128])
def test_flood_kernel_staircase_matches_plain(cuda_device, rounds):
    gate, src = stair_frames([(96, 96)])
    got = port_flood(gate, src, rounds, device=cuda_device, with_rounds=True)
    want = port_flood(gate, src, rounds, device=cuda_device, impl="plain",
                      with_rounds=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [40, 128])
def test_flood_kernel_planes_stop_on_their_own(cuda_device, rounds):
    lengths = [(96, 10), (50, 3), (1, 70)]
    gate, src = stair_frames(lengths)
    got, ran = port_flood(gate, src, rounds, device=cuda_device,
                          with_rounds=True)
    want = port_flood(gate, src, rounds, device=cuda_device, impl="plain")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ran,
                                  np.minimum(np.ravel(lengths), rounds))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", BIG_SHAPES)
def test_flood_kernel_tall_and_wide_matches_plain(cuda_device, shape):
    gate, src = big_frames(shape)
    got = port_flood(gate, src, device=cuda_device, with_rounds=True)
    want = port_flood(gate, src, device=cuda_device, impl="plain",
                      with_rounds=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
