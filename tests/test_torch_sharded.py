"""The port's column-sharded building blocks against JAX's on the CPU.

Each check runs the port on 2 and 4 ranks (processes on a gloo group,
tests/torch_sharded_worker.py) and JAX's function on a mesh of as many
virtual CPU devices (tests/conftest.py gives 8), on the 48x64 room of
tests/test_sharded.py and the scenes of tests/fixtures.py: the halo
exchange (single and multi-hop), normals (JAX's own sharded-vs-single
tolerance, atol 2e-4), the seed vector and the rank grid (exact), the
sharded flood at a binding and a free cap (exact) and the sharded CCL
(exact). The single-device additions the sharded path needs
(``transposed_parity=False`` seeds, the scan CCL on global labels) are
held against JAX directly. The ``cuda`` twins hold B2 on a column block's
global labels and B3 on a block's words to their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pcseg_tpu import oracle
from pcseg_tpu.models.config import ComputeNormalsParams as JNormalsParams
from pcseg_tpu.models.config import (
    SeedsFromPlaneSupportParams as JSeedParams)
from pcseg_tpu.ops import connectivity as jconnectivity
from pcseg_tpu.ops import seeds as jseeds
from pcseg_tpu.parallel import halo as jhalo
from pcseg_tpu.parallel import sharded as jsharded
from pcseg_tpu.utils.synthetic import synthetic_cluttered_room_cloud

from pcseg_tpu_torch.kernels import ccl_gated, flood_packed
from pcseg_tpu_torch.models.config import SeedsFromPlaneSupportParams
from pcseg_tpu_torch.ops import connectivity, seeds
from pcseg_tpu_torch.parallel import halo
from tests import fixtures
from tests.test_torch_kernels import _t, cuda_device  # noqa: F401
from tests.torch_sharded_worker import run_ranks

torch.set_num_threads(1)

H, W = 48, 64
FLOOD_CAPS = (2, 64)   # the local cap binds at 2, not at 64
FLOOD_K = 40           # two word planes
RANKS = (2, 4)


def room():
    """tests/test_sharded.py's room and the oracle normals."""
    pts, origin = fixtures.synthetic_room_cloud(H, W, f=float(H), seed=9)
    return pts, origin, oracle.compute_normals_organized(pts, origin)


def inputs(n):
    pts, origin, nrm = room()
    rng = np.random.default_rng(3)
    gate = rng.random((FLOOD_K, H, W)) < 0.62
    src = gate & (rng.random((FLOOD_K, H, W)) < 0.002)
    clut = synthetic_cluttered_room_cloud(H, W, f=float(H), seed=3)[0]
    return dict(
        halo_src=np.arange(H * W * 2, dtype=np.float32).reshape(H, W, 2),
        halo_ks=np.array([1, 3, W // n + 3]),  # the last one multi-hop
        room_pts=pts, room_origin=origin, room_nrm=nrm.astype(np.float32),
        flood_gate=gate, flood_src=src, flood_caps=np.array(FLOOD_CAPS),
        ccl16_pts=fixtures.clustering_fixture_cloud(16),
        ccl16_elig=np.ones((16, 16), bool),
        ccl_clut_pts=clut, ccl_clut_elig=np.isfinite(clut).all(-1))


_CACHE = {}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """The blocks suite's results on 2 and 4 ranks, with its inputs."""
    def get(n):
        if n not in _CACHE:
            inp = inputs(n)
            _CACHE[n] = (run_ranks("blocks", n, inp,
                                   tmp_path_factory.mktemp(f"blocks{n}")),
                         inp)
        return _CACHE[n]
    return get


def shard_map(fn, n, in_specs, out_specs, *args):
    return jax.jit(jax.shard_map(
        fn, mesh=jsharded.make_mesh(n), in_specs=in_specs,
        out_specs=out_specs, check_vma=False))(*args)


@pytest.mark.parametrize("n", RANKS)
def test_exchange_halo_matches_jax(port, n):
    got, inp = port(n)
    for k in inp["halo_ks"].tolist():
        want = shard_map(lambda b: jhalo.exchange_halo(b, k, "space"), n,
                         (P(None, "space", None),), P(None, "space", None),
                         jnp.asarray(inp["halo_src"]))
        np.testing.assert_array_equal(got[f"L:halo_k{k}"], np.asarray(want),
                                      err_msg=f"k={k}")


def test_exchange_halo_single_rank_and_crop():
    """One rank: the grid edges on both sides; crop_halo undoes it."""
    comm = halo.Comm(device="cpu")
    x = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4)
    out = halo.exchange_halo(x, 2, comm, fill=-1, dim=2)
    assert out.shape == (2, 3, 8)
    assert (out[..., :2] == -1).all() and (out[..., -2:] == -1).all()
    assert torch.equal(halo.crop_halo(out, 2, dim=2), x)
    assert torch.equal(comm.psum(x), x) and comm.transport == "none"


@pytest.mark.parametrize("n", RANKS)
def test_sharded_normals_match_jax(port, n):
    got, inp = port(n)
    params = JNormalsParams(max_scan_steps=8)
    want = np.asarray(shard_map(
        lambda p, o: jsharded.sharded_normals(p, o, params, "space"), n,
        (P(None, "space", None), P()), P(None, "space", None),
        jnp.asarray(inp["room_pts"]), jnp.asarray(inp["room_origin"])))
    g = got["L:normals"]
    assert (np.isfinite(g) == np.isfinite(want)).all()
    both = np.isfinite(g) & np.isfinite(want)
    # JAX's sharded-vs-single tolerance (tests/test_sharded.py)
    np.testing.assert_allclose(g[both], want[both], atol=2e-4)


@pytest.mark.parametrize("n", RANKS)
def test_sharded_seeds_and_rank_grid_match_jax(port, n):
    got, inp = port(n)
    params = JSeedParams()
    pts, nrm = jnp.asarray(inp["room_pts"]), jnp.asarray(inp["room_nrm"])
    idx, valid = shard_map(
        lambda p, q: jsharded.sharded_plane_support_seeds(
            p, q, params, H, W, "space"), n,
        (P(None, "space", None), P(None, "space", None)), (P(), P()),
        pts, nrm)
    np.testing.assert_array_equal(got["R:seed_idx"], np.asarray(idx))
    np.testing.assert_array_equal(got["R:seed_valid"], np.asarray(valid))
    assert got["R:seed_valid"].sum() > 100
    grid = shard_map(
        lambda p, q: jsharded.sharded_plane_support_rank_grid(
            p, q, params, H, W, "space"), n,
        (P(None, "space", None), P(None, "space", None)), P(None, "space"),
        pts, nrm)
    np.testing.assert_array_equal(got["L:rank_grid"], np.asarray(grid))


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("cap", FLOOD_CAPS)
def test_sharded_flood_matches_jax(port, n, cap):
    got, inp = port(n)
    want = np.asarray(shard_map(
        lambda g, s: jsharded._sharded_flood_packed(g, s, "space", cap), n,
        (P(None, None, "space"), P(None, None, "space")),
        P(None, None, "space"),
        jnp.asarray(inp["flood_gate"]), jnp.asarray(inp["flood_src"])))
    np.testing.assert_array_equal(got[f"L:flood_cap{cap}@2"].astype(bool),
                                  want)
    assert want.sum() > inp["flood_src"].sum()


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("scene", ["ccl16", "ccl_clut"])
def test_sharded_ccl_matches_jax(port, n, scene):
    got, inp = port(n)
    pts = inp[scene + "_pts"]
    h, w = pts.shape[:2]
    want = np.asarray(shard_map(
        lambda p, e: jsharded.sharded_connected_components(
            p, e, 1.0, 1, h, w, "space"), n,
        (P(None, "space", None), P(None, "space")), P(None, "space"),
        jnp.asarray(pts), jnp.asarray(inp[scene + "_elig"])))
    np.testing.assert_array_equal(got["L:" + scene], want)
    # and the single-device window CCL (JAX's own check)
    single = np.asarray(jconnectivity.connected_components_window(
        jnp.asarray(pts), jnp.asarray(inp[scene + "_elig"]), 1.0, 1))
    np.testing.assert_array_equal(got["L:" + scene], single)


def test_seeds_natural_orientation_match_jax():
    pts, _, nrm = room()
    want = jseeds.seeds_from_plane_support(jnp.asarray(pts),
                                           jnp.asarray(nrm),
                                           transposed_parity=False)
    got = seeds.seeds_from_plane_support(
        _t(pts[None]), _t(nrm[None].astype(np.float32)),
        SeedsFromPlaneSupportParams(), seed_vector=True,
        transposed_parity=False)
    np.testing.assert_array_equal(got.rank_grid[0].numpy(),
                                  np.asarray(want.rank_grid))
    np.testing.assert_array_equal(got.count[0].numpy(),
                                  np.asarray(want.count))
    np.testing.assert_array_equal(got.indices[0].numpy(),
                                  np.asarray(want.indices))
    np.testing.assert_array_equal(got.valid[0].numpy(),
                                  np.asarray(want.valid))


@pytest.mark.parametrize("rounds", [2, 24])
def test_ccl_scan_on_global_labels_matches_jax(rounds):
    """A 16-column block of a 64-column grid: labels start at col0 * H,
    the sentinel is H * W_total (the cap binds at 2)."""
    clut = synthetic_cluttered_room_cloud(H, W, f=float(H), seed=3)[0]
    blk = np.ascontiguousarray(clut[:, 32:48])
    elig = np.isfinite(blk).all(-1)
    init = (np.arange(16)[None, :] + 32) * H + np.arange(H)[:, None]
    want = np.asarray(jconnectivity.connected_components_scan(
        jnp.asarray(blk), jnp.asarray(elig), jnp.float32(1.0), 1,
        rounds=rounds, init_labels=jnp.asarray(init, jnp.int32),
        big_value=H * W))
    got = connectivity.connected_components_scan(
        _t(blk[None]), _t(elig[None]), 1.0, 1, rounds=rounds,
        init_labels=_t(init.astype(np.int32)), big_value=H * W)
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert want.min() >= 32 * H and (want == H * W).any()


@pytest.mark.cuda
def test_ccl_kernel_on_global_labels_matches_plain(cuda_device):
    """B2 on a VGA column block (the 3rd of 4) whose labels start at
    col0 * H, with big = H * W_total."""
    h, w_total, wl = 480, 640, 160
    clut = synthetic_cluttered_room_cloud(h, w_total, f=float(h),
                                                   seed=1)[0]
    blk = torch.from_numpy(np.ascontiguousarray(clut[:, 2 * wl:3 * wl]))
    elig = torch.isfinite(blk).all(-1)
    offs = connectivity.window_offsets(1)
    gate = connectivity._gate_bits(blk[None], elig[None], 1.0, offs)
    init = connectivity.colmajor_index_grid(h, wl) + 2 * wl * h
    lab0 = torch.where(elig, init, h * w_total).to(torch.int32)[None]
    want, ran = ccl_gated.ccl_gated_plain(gate, lab0, offs, 64, h * w_total)
    got = ccl_gated.ccl_gated(gate.to(cuda_device), lab0.to(cuda_device),
                              offs, 64, h * w_total)
    assert torch.equal(got.cpu(), want)
    assert int(want[want < h * w_total].min()) >= 2 * wl * h


@pytest.mark.cuda
def test_flood_kernel_on_block_words_matches_plain(cuda_device):
    """B3 on the words of a column block, as the sharded flood's local
    rounds give them."""
    rng = np.random.default_rng(5)
    gate = rng.random((FLOOD_K, 480, 160)) < 0.62
    src = gate & (rng.random(gate.shape) < 0.002)
    g = flood_packed.pack_bits(torch.from_numpy(gate)[None])[0]
    r0 = flood_packed.pack_bits(torch.from_numpy(src)[None])[0]
    for cap in FLOOD_CAPS:
        want, _ = flood_packed.flood_packed_plain(g, r0, cap)
        got = flood_packed.flood_packed(g.to(cuda_device),
                                        r0.to(cuda_device), cap)
        assert torch.equal(got.cpu(), want), cap
