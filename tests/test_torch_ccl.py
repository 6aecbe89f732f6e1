"""The CCL kernel (B2) beyond the scene of test_torch_kernels.py: a
serpentine whose fixed point needs more rounds than the default cap, frames
of one batch that stop at different rounds, and the 5x5 window, each held
against JAX's XLA CCL and its Pallas kernel (interpret mode) on the CPU;
the CUDA kernel against its plain version when a card is present (marker
``cuda``), also on frames past shared memory.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pcseg_tpu.ops import connectivity as jconn

from pcseg_tpu_torch.kernels import ccl_gated
from pcseg_tpu_torch.ops import connectivity
from tests.test_torch_kernels import _t, ccl_scene, cuda_device  # noqa: F401

# one intra-op thread per test process (see test_torch_kernels.py)
torch.set_num_threads(1)


def jax_ccl(pts, elig, half_window, rounds):
    """JAX's labels of one frame: its XLA CCL (connected_components_scan)
    and its Pallas kernel (_ccl_pallas, interpret mode), asserted equal."""
    h, w = elig.shape
    offsets = connectivity.window_offsets(half_window)
    thr = np.float32(1.0)
    want_xla = np.asarray(jconn.connected_components_scan(
        jnp.asarray(pts), jnp.asarray(elig), thr, half_window,
        rounds=rounds))
    gate = jconn._gate_bits(jnp.asarray(pts), jnp.asarray(elig), thr,
                            offsets)
    labels0 = jnp.where(jnp.asarray(elig), jconn.colmajor_index_grid(h, w),
                        jnp.int32(h * w))
    want_pallas = np.asarray(jax.jit(lambda g, l: jconn._ccl_pallas(
        g, l, offsets, rounds, h * w, interpret=True))(gate, labels0))
    want_pallas = np.where(elig, want_pallas, h * w)
    np.testing.assert_array_equal(want_xla, want_pallas)
    return want_xla


def port_ccl(pts, elig, half_window, rounds, device="cpu", impl=None):
    """The port's CCL of [B, H, W] frames through the kernel wrapper:
    (labels as connected_components_scan returns them, rounds run per
    frame)."""
    b, h, w = elig.shape
    offsets = connectivity.window_offsets(half_window)
    p, e = _t(pts).to(device), _t(elig).to(device)
    gate = connectivity._gate_bits(p, e, 1.0, offsets)
    labels0 = torch.where(e, connectivity.colmajor_index_grid(
        h, w, device), h * w).to(torch.int32).contiguous()
    ran = torch.zeros(b, dtype=torch.int32, device=device)
    out = ccl_gated.ccl_gated(gate, labels0, offsets, rounds, h * w,
                              impl=impl, rounds_out=ran)
    return torch.where(e, out, h * w).cpu().numpy(), ran.cpu().numpy()


def serpentine(h, w, step=3):
    """Eligible vertical runs at columns 0, step, 2 * step, ..., joined
    alternately along the top and the bottom row; the step - 1 ineligible
    columns between runs keep the 3x3 window from cutting corners. All
    points are equal, so every edge between eligible cells passes, and the
    minimum label crosses about one run a round."""
    elig = np.zeros((h, w), bool)
    elig[:, ::step] = True
    for k, c in enumerate(range(0, w - step, step)):
        elig[0 if k % 2 == 0 else h - 1, c:c + step + 1] = True
    return np.zeros((h, w, 3), np.float32), elig


@pytest.mark.parametrize("rounds", [24, 64])
def test_ccl_serpentine_matches_jax(rounds):
    """A 32x128 serpentine whose fixed point takes 42 rounds: at cap 24
    the cap binds (20 labels left), at 64 the fixed point is reached and
    confirmed by round 43."""
    pts, elig = serpentine(32, 128)
    want = jax_ccl(pts, elig, 1, rounds)
    got, ran = port_ccl(pts[None], elig[None], 1, rounds)
    np.testing.assert_array_equal(got[0], want)
    if rounds == 24:
        full, _ = port_ccl(pts[None], elig[None], 1, 64)
        assert (got != full).any(), "the cap should bind"
        assert ran.tolist() == [24]
    else:
        assert ran.tolist() == [43]
        assert len(np.unique(got[0][elig])) == 1


def test_ccl_frames_stop_on_their_own():
    """A batch of a 48x64 serpentine and ccl_scene(), which reach their
    fixed points at different rounds: each frame's labels equal JAX's run
    of that frame alone, and its rounds run r are its rounds to the fixed
    point plus the confirming one: JAX at cap r - 1 gives its labels, at
    cap r - 2 it does not yet."""
    frames = [serpentine(48, 64), ccl_scene()]
    pts = np.stack([f[0] for f in frames])
    elig = np.stack([f[1] for f in frames])
    got, ran = port_ccl(pts, elig, 1, 24)
    assert len(set(ran.tolist())) == 2 and ran.max() < 24
    # the cap as a traced argument: one compile for every call
    jax_at = jax.jit(lambda p, e, cap: jconn.connected_components_scan(
        p, e, np.float32(1.0), 1, rounds=cap))
    for f, r in enumerate(ran.tolist()):
        assert r - 2 >= 1
        fp = jax_at(pts[f], elig[f], r - 1)
        np.testing.assert_array_equal(got[f], np.asarray(fp))
        early = jax_at(pts[f], elig[f], r - 2)
        assert (got[f] != np.asarray(early)).any()


@pytest.mark.parametrize("rounds", [1, 2, 24])
def test_ccl_5x5_matches_jax(rounds):
    """The 5x5 window (half_window=2, 24 offsets, 15 halo columns a side
    in the kernel) against both JAX CCLs; the cap binds at 1."""
    pts, elig = ccl_scene()
    want = jax_ccl(pts, elig, 2, rounds)
    got, ran = port_ccl(pts[None], elig[None], 2, rounds)
    np.testing.assert_array_equal(got[0], want)
    if rounds == 1:
        full, _ = port_ccl(pts[None], elig[None], 2, 64)
        assert (got != full).any(), "the cap should bind"
    assert ran[0] == min(rounds, 3)


def assert_ccl_kernel_matches_plain(device, pts, elig, half_window, rounds):
    got = port_ccl(pts, elig, half_window, rounds, device)
    want = port_ccl(pts, elig, half_window, rounds, device, impl="plain")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [24, 64])
def test_ccl_kernel_serpentine_matches_plain(cuda_device, rounds):
    pts, elig = serpentine(32, 128)
    _, ran = assert_ccl_kernel_matches_plain(cuda_device, pts[None],
                                             elig[None], 1, rounds)
    assert ran.tolist() == [min(rounds, 43)]


@pytest.mark.cuda
def test_ccl_kernel_frames_stop_on_their_own(cuda_device):
    frames = [serpentine(48, 64), ccl_scene()]
    _, ran = assert_ccl_kernel_matches_plain(
        cuda_device, np.stack([f[0] for f in frames]),
        np.stack([f[1] for f in frames]), 1, 24)
    assert ran[0] != ran[1]


@pytest.mark.cuda
@pytest.mark.parametrize("rounds", [1, 2, 24])
def test_ccl_kernel_5x5_matches_plain(cuda_device, rounds):
    pts, elig = ccl_scene()
    assert_ccl_kernel_matches_plain(cuda_device, pts[None], elig[None], 2,
                                    rounds)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1200, 96), (4, 28800)])
def test_ccl_kernel_tall_and_wide_matches_plain(cuda_device, shape):
    """Frames past shared memory on an H100 (strips taller than ~700 rows
    with their halo columns; rows wider than ~27,000 columns): a 240x480
    blob-and-clutter scene laid out as [1, *shape]."""
    rng = np.random.default_rng(4)
    pts = rng.uniform(-4, 4, (240, 480, 3)).astype(np.float32)
    pts[40:200, 60:400] = rng.normal(0, 0.2, (160, 340, 3))
    elig = rng.random((240, 480)) < 0.9
    for hw in (1, 2):
        assert_ccl_kernel_matches_plain(
            cuda_device, pts.reshape((1,) + shape + (3,)),
            elig.reshape((1,) + shape), hw, 24)
