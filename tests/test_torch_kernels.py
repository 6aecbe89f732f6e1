"""The port's two kernels: plain versions against the JAX Pallas kernels
(interpret mode on the CPU) and against JAX's XLA CCL; the CUDA kernels
against their plain versions when a card is present (marker ``cuda``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcseg_tpu.models import planar_batched as jpb
from pcseg_tpu.ops import connectivity as jconn
from pcseg_tpu.ops import unproject as junproject
from pcseg_tpu.utils.synthetic import synthetic_room_cloud

from pcseg_tpu_torch.kernels import ccl_gated, epoch_word
from pcseg_tpu_torch.ops import connectivity

# One intra-op thread: the suite runs in parallel worker processes, and
# OpenMP teams spinning across them slow every small op by orders of
# magnitude.
torch.set_num_threads(1)

INF = 2 ** 30
# moments: the port sums the f32 terms in f64 and rounds once, so it holds
# the f64 sum of the same terms to 1e-6; JAX accumulates ~1500 terms in f32,
# which leaves it up to a few 1e-5 (relative) off that sum.
MOM_RTOL, MOM_ATOL = 1e-6, 1e-6
JAX_MOM_RTOL, JAX_MOM_ATOL = 5e-5, 1e-4


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable, contiguous copy


def epoch_inputs(b, h, w, k_cap, seed=0):
    """A closure-epoch state on room scenes: disjoint 3x3 member boxes
    around distinct anchors, unique slot ranks, a few dead slots, floor
    and wall planes through the anchors, one boxed and one unboxed frame.
    """
    rng = np.random.default_rng(seed)
    rays = junproject.camera_ray_table(h, w, f=float(h))
    pts = np.stack([junproject.unproject_range_np(junproject.encode_range(
        synthetic_room_cloud(h, w, f=float(h), seed=seed + i)[0]), rays)
        for i in range(b)])
    elig = np.isfinite(pts).all(-1)
    rank = rng.permutation(b * h * w).reshape(b, h, w).astype(np.int32)
    rank[rng.random((b, h, w)) < 0.4] = INF
    word = np.zeros((b, h, w), np.int64)
    srank = np.full((b, k_cap), INF, np.int32)
    alive = np.zeros((b, k_cap), np.int32)
    plane = np.zeros((b, k_cap, 4), np.float32)
    ar = np.zeros((b, k_cap), np.int32)
    ac = np.zeros((b, k_cap), np.int32)
    for f in range(b):
        cells = rng.permutation(np.argwhere(elig[f]))
        for k in range(k_cap):
            if k % 7 == 3:  # dead slot
                continue
            r, c = cells[k]
            box = (slice(max(r - 1, 0), r + 2), slice(max(c - 1, 0), c + 2))
            free = (word[f][box] == 0) & elig[f][box]
            word[f][box] |= np.where(free, 1 << k, 0)
            word[f, r, c] |= 1 << k
            srank[f, k] = rng.integers(0, INF // 2)
            alive[f, k] = 1
            ar[f, k], ac[f, k] = r, c
            n = np.float32([0, 0, 1]) if k % 2 else np.float32([1, 0, 0])
            plane[f, k, :3] = n
            plane[f, k, 3] = -n @ pts[f, r, c]
    word = np.where(word >= 2 ** 31, word - 2 ** 32, word).astype(np.int32)
    radius = np.array([6, max(h, w)] * b, np.int32)[:b]
    return dict(px=pts[..., 0], py=pts[..., 1], pz=pts[..., 2], rank=rank,
                elig=elig.astype(np.int32), word=word, srank=srank,
                alive=alive, plane=plane, anchor_r=ar, anchor_c=ac,
                radius=radius)


ORDER = ("px", "py", "pz", "rank", "elig", "word", "srank", "alive",
         "plane", "anchor_r", "anchor_c", "radius")


def run_port_epoch(inp, device="cpu", impl=None, tau=0.05, rounds=64):
    args = [_t(inp[n]).to(device) for n in ORDER]
    return [o.cpu().numpy() for o in
            epoch_word.epoch_word(*args, tau, rounds, impl=impl)]


@pytest.mark.parametrize("k_cap,rounds", [(8, 64), (32, 64), (8, 1), (8, 2)])
def test_epoch_plain_matches_pallas_interpret(k_cap, rounds):
    """Exact against JAX's epoch kernel; at 1 and 2 rounds the cap binds,
    so the round structure itself is held (K = 8 there: JAX's interpret
    mode traces every slot, and K = 32 takes half a minute a case)."""
    b, h, w = 2, 32, 48
    inp = epoch_inputs(b, h, w, k_cap)
    call = jpb._epoch_kernel_batched(h, w, k_cap, 0.05, rounds, True, b)
    j = call(jnp.asarray(inp["radius"]).reshape(b, 1, 1),
             *[jnp.asarray(inp[n]) for n in ("px", "py", "pz", "rank",
                                              "elig")],
             jnp.asarray(inp["word"].view(np.uint32)),
             *[jnp.asarray(inp[n])[:, None] for n in
               ("srank", "alive", "plane", "anchor_r", "anchor_c")])
    j_word, j_cnt, j_mrank, j_alin, j_mom = (np.asarray(x) for x in j)
    word, cnt, mrank, alin, mom = run_port_epoch(inp, rounds=rounds)
    np.testing.assert_array_equal(word, j_word.view(np.int32))
    np.testing.assert_array_equal(cnt, j_cnt[:, 0])
    np.testing.assert_array_equal(mrank, j_mrank[:, 0])
    np.testing.assert_array_equal(alin, j_alin[:, 0])
    np.testing.assert_allclose(mom, j_mom[:, 0], rtol=JAX_MOM_RTOL,
                               atol=JAX_MOM_ATOL)
    np.testing.assert_allclose(mom, f64_moments(inp, word, k_cap),
                               rtol=MOM_RTOL, atol=MOM_ATOL)
    if rounds < 64:
        assert (word != run_port_epoch(inp)[0]).any(), "cap should bind"
    else:  # the flood really spread beyond the seeded boxes
        assert (word != 0).sum() > 4 * (inp["word"] != 0).sum()


def f64_moments(inp, word, k_cap):
    """The 10 moment sums of each slot's members, f32 terms summed in f64."""
    x, y, z = inp["px"], inp["py"], inp["pz"]
    terms = np.stack([x * x, x * y, x * z, y * y, y * z, z * z, x, y, z,
                      np.ones_like(x)], -1).astype(np.float64)
    out = np.zeros(word.shape[:1] + (k_cap, 10))
    for k in range(k_cap):
        bit = ((word >> k) & 1) == 1
        out[:, k] = np.where(bit[..., None], terms, 0).sum((1, 2))
    return out


def ccl_scene(seed=13):
    """tests/test_cluster.py's Pallas-CCL recipe: a dense blob on i.i.d.
    clutter with NaN holes and ineligible cells."""
    rng = np.random.default_rng(seed)
    h, w = 48, 64
    pts = rng.uniform(-4, 4, (h, w, 3)).astype(np.float32)
    pts[8:20, 8:30] = rng.normal(0, 0.08, (12, 22, 3)).astype(np.float32)
    pts[rng.random((h, w)) < 0.04] = np.nan
    elig = np.isfinite(pts).all(-1) & (rng.random((h, w)) < 0.9)
    return pts, elig


def test_ccl_gate_bits_match_jax():
    pts, elig = ccl_scene()
    offsets = connectivity.window_offsets(1)
    assert offsets == [(dr, dc) for dc in (-1, 0, 1) for dr in (-1, 0, 1)
                       if (dr, dc) != (0, 0)]
    want = jconn._gate_bits(jnp.asarray(pts), jnp.asarray(elig),
                            np.float32(1.0), offsets)
    got = connectivity._gate_bits(_t(pts[None]), _t(elig[None]), 1.0,
                                  offsets)
    np.testing.assert_array_equal(got.numpy()[0], np.asarray(want))


@pytest.mark.parametrize("rounds", [1, 2, 64])
def test_ccl_plain_matches_jax(rounds):
    """Exact against both JAX CCLs; the rounds cap binds at 1 and 2 on
    this scene, so the round structure itself is checked."""
    pts, elig = ccl_scene()
    h, w = elig.shape
    offsets = connectivity.window_offsets(1)
    thr = np.float32(1.0)
    want_xla = np.asarray(jconn.connected_components_scan(
        jnp.asarray(pts), jnp.asarray(elig), thr, 1, rounds=rounds))
    gate = jconn._gate_bits(jnp.asarray(pts), jnp.asarray(elig), thr,
                            offsets)
    labels0 = jnp.where(jnp.asarray(elig), jconn.colmajor_index_grid(h, w),
                        jnp.int32(h * w))
    want_pallas = np.asarray(jax.jit(lambda g, l: jconn._ccl_pallas(
        g, l, offsets, rounds, h * w, interpret=True))(gate, labels0))
    want_pallas = np.where(elig, want_pallas, h * w)
    np.testing.assert_array_equal(want_xla, want_pallas)
    got = connectivity.connected_components_scan(
        _t(pts[None]), _t(elig[None]), 1.0, 1, rounds=rounds).numpy()[0]
    np.testing.assert_array_equal(got, want_xla)
    full = connectivity.connected_components_scan(
        _t(pts[None]), _t(elig[None]), 1.0, 1, rounds=64).numpy()[0]
    if rounds < 64:
        assert (got != full).any(), "the cap should bind on this scene"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 32, 48, 8), (3, 57, 131, 32)])
def test_epoch_kernel_matches_plain(cuda_device, shape):
    b, h, w, k_cap = shape
    inp = epoch_inputs(b, h, w, k_cap, seed=1)
    got = run_port_epoch(inp, cuda_device)
    want = run_port_epoch(inp, cuda_device, impl="plain")
    for g, p in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, p)
    np.testing.assert_allclose(got[4], want[4], rtol=MOM_RTOL,
                               atol=MOM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [1, 2])
def test_epoch_kernel_cap_matches_plain(cuda_device, rounds):
    """The cap-binding cases of test_epoch_plain_matches_pallas_interpret:
    the kernel's words, tables and rounds run equal the plain version's."""
    inp = epoch_inputs(2, 32, 48, 8)
    args = [_t(inp[n]).to(cuda_device) for n in ORDER]
    ran = [torch.zeros(2, dtype=torch.int32, device=cuda_device)
           for _ in range(2)]
    got = epoch_word.epoch_word(*args, 0.05, rounds, rounds_out=ran[0])
    want = epoch_word.epoch_word(*args, 0.05, rounds, impl="plain",
                                 rounds_out=ran[1])
    for g, p in zip(got[:4], want[:4]):
        assert torch.equal(g, p)
    torch.testing.assert_close(got[4], want[4], rtol=MOM_RTOL,
                               atol=MOM_ATOL)
    assert torch.equal(ran[0], ran[1]) and int(ran[0].max()) == rounds


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1152, 100), (4, 28800)])
def test_epoch_kernel_tall_and_wide_matches_plain(cuda_device, shape):
    """Frames past shared memory on an H100 (strips taller than ~870 rows;
    rows wider than ~27,000 columns, with no prelude tables): a 240x480
    epoch state laid out as [1, *shape], anchors moved with their pixels."""
    inp = epoch_inputs(1, 240, 480, 8)
    lin = inp["anchor_r"] * 480 + inp["anchor_c"]
    inp = dict(inp, anchor_r=lin // shape[1], anchor_c=lin % shape[1])
    for n in ("px", "py", "pz", "rank", "elig", "word"):
        inp[n] = inp[n].reshape((1,) + shape)
    got = run_port_epoch(inp, cuda_device)
    want = run_port_epoch(inp, cuda_device, impl="plain")
    for g, p in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(g, p)
    np.testing.assert_allclose(got[4], want[4], rtol=MOM_RTOL,
                               atol=MOM_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [1, 2, 24])
def test_ccl_kernel_matches_plain(cuda_device, rounds):
    pts, elig = ccl_scene()
    h, w = elig.shape
    offsets = connectivity.window_offsets(1)
    p = _t(np.stack([pts, pts[::-1]])).to(cuda_device)
    e = _t(np.stack([elig, elig[::-1]])).to(cuda_device)
    gate = connectivity._gate_bits(p, e, 1.0, offsets)
    labels0 = torch.where(e, connectivity.colmajor_index_grid(
        h, w, cuda_device), h * w).to(torch.int32).contiguous()
    got = ccl_gated.ccl_gated(gate, labels0, offsets, rounds, h * w)
    want = ccl_gated.ccl_gated(gate, labels0, offsets, rounds, h * w,
                               impl="plain")
    assert torch.equal(got, want)
