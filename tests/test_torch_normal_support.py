"""The normals' support kernel (``kernels/normal_support``): its dispatch on
the CPU, the paths that hand it their ``impl``, and (on the card, marker
``cuda``) the kernel against its plain version bit for bit: counts, moment
sums, the center mask and the normals solved from them.

Imports no JAX: on a card machine run
``python3 -m pytest --noconftest tests/test_torch_normal_support.py``.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

from pcseg_tpu_torch.kernels import common, normal_support
from pcseg_tpu_torch.models import config, pipeline
from pcseg_tpu_torch.ops import normals, unproject
from pcseg_tpu_torch.parallel import halo, sharded
from pcseg_tpu_torch.utils import profiling
from pcseg_tpu_torch.utils.synthetic import synthetic_cluttered_room_cloud
from portbench.traffic import generate, scenes

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARAMS = config.ComputeNormalsParams()
LAUNCHES = "launches.normal_support"


def small_cloud(h, w, seed):
    """[H, W, 3] f32 points of a cluttered room through the u16 range
    encoding (NaN where the range is 0)."""
    rays = unproject.camera_ray_table(h, w, f=float(h))
    return unproject.unproject_range_np(unproject.encode_range(
        synthetic_cluttered_room_cloud(h, w, f=float(h), seed=seed)[0]),
        rays)


def bits(t):
    """A float tensor's bit pattern (NaN equal to itself, -0 apart from
    +0); other tensors as they are."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(got, want):
    """(count, PlaneMoments, center_valid) equal bit for bit."""
    names = ("count", *(f"moments.{f}" for f in got[1]._fields),
             "center_valid")
    for name, a, b in zip(names, (got[0], *got[1], got[2]),
                          (want[0], *want[1], want[2])):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(bits(a), bits(b)), name


# -- dispatch, on the CPU -----------------------------------------------------

@pytest.mark.parametrize("device, impl, expect", [
    ("cuda", None, True),
    ("cuda", "plain", False),
    ("cpu", None, False),
    ("cpu", "plain", False),
    ("cuda", "kernel", ValueError),
    ("cpu", "cuda", ValueError),
])
def test_dispatch(device, impl, expect):
    """The kernel runs for CUDA points and no impl; CPU points and
    ``impl="plain"`` take the plain version; an unknown impl raises."""
    dev = torch.device(device)
    if expect is ValueError:
        with pytest.raises(ValueError, match="impl"):
            common.use_kernel(dev, impl)
    else:
        assert common.use_kernel(dev, impl) is expect


@pytest.fixture
def no_kernel(monkeypatch):
    """Fails any attempt to load the kernel's library."""
    def refuse():
        raise AssertionError("the kernel's library was loaded")
    monkeypatch.setattr(normal_support, "_lib", refuse)


@pytest.mark.parametrize("impl", [None, "plain"])
def test_cpu_points_take_the_plain_version(no_kernel, impl):
    pts = torch.from_numpy(small_cloud(24, 32, seed=1))
    before = profiling.total(LAUNCHES)
    support = normals.find_normal_support(pts, PARAMS, impl=impl)
    assert profiling.total(LAUNCHES) == before
    want = normal_support.normal_support_plain(pts[None], PARAMS)
    assert_same((support.count[None], type(support.moments)(
        *[t[None] for t in support.moments]), support.center_valid[None]),
        want)
    assert int(support.count.max()) >= 4
    got = normals.compute_normals_organized(pts, torch.zeros(3), impl=impl)
    assert torch.equal(bits(got), bits(normals.normals_from_support(
        support, pts, torch.zeros(3), PARAMS)))


@pytest.mark.parametrize("fn", ["find_normal_support",
                                "compute_normals_organized"])
def test_other_impl_raises(no_kernel, fn):
    pts = torch.from_numpy(small_cloud(8, 12, seed=1))
    args = (pts, PARAMS) if fn == "find_normal_support" else (
        pts, torch.zeros(3), PARAMS)
    with pytest.raises(ValueError, match="impl"):
        getattr(normals, fn)(*args, impl="triton")


def test_other_dtypes_take_the_plain_version(no_kernel):
    """On the CPU, f16 points reach the plain version in their own dtype;
    f64 points are narrowed to f32 at the public op (the input rule) and
    give the f32 call's result bit for bit."""
    pts = torch.from_numpy(small_cloud(16, 20, seed=2))
    half = normal_support.normal_support(pts[None].half(), PARAMS)
    assert half[1].s2.dtype == torch.float16
    assert_same(half, normal_support.normal_support_plain(pts[None].half(),
                                                          PARAMS))
    wide = normals.find_normal_support(pts.double(), PARAMS)
    narrow = normals.find_normal_support(pts, PARAMS)
    assert wide.moments.s2.dtype == torch.float32
    assert_same((wide.count, wide.moments, wide.center_valid),
                (narrow.count, narrow.moments, narrow.center_valid))


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float64])
def test_kernel_path_refuses_points_other_than_f32(no_kernel, monkeypatch,
                                                   dtype):
    """Points bound for the kernel that are not f32 raise a TypeError that
    names the function, before the library is loaded; nothing falls back
    to the plain version. (The kernel path is taken here with CPU points,
    the dispatch told that they are on a card.)"""
    monkeypatch.setattr(common, "use_kernel", lambda device, impl: True)
    pts = torch.from_numpy(small_cloud(8, 12, seed=1))[None].to(dtype)
    before = profiling.total(LAUNCHES)
    with pytest.raises(TypeError, match="normal_support.*float32"):
        normal_support.normal_support(pts, PARAMS)
    assert profiling.total(LAUNCHES) == before


def test_the_entry_points_hand_their_impl_to_the_normals(monkeypatch):
    """``Segmenter`` and the sharded step pass their ``impl`` down to the
    support scan."""
    seen = []
    real = normal_support.normal_support

    def spy(points, params, impl=None):
        seen.append(impl)
        return real(points, params, impl)

    monkeypatch.setattr(normal_support, "normal_support", spy)
    h, w = 24, 32
    rays = unproject.camera_ray_table(h, w, f=float(h))
    d16 = np.stack([unproject.encode_range(synthetic_cluttered_room_cloud(
        h, w, f=float(h), seed=s)[0]) for s in (1, 2)])
    seg = pipeline.Segmenter(device="cpu", impl="plain")
    seg.device_forward_stream(torch.from_numpy(d16), torch.from_numpy(rays),
                              torch.zeros(3))
    step = sharded.build_sharded_segment_step(halo.Comm(device="cpu"),
                                              impl="plain")
    step(torch.from_numpy(small_cloud(h, w, seed=3)), torch.zeros(3))
    assert seen == ["plain", "plain"]


# -- the kernel against its plain version, on the card ------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def kernel_and_plain(points, params=PARAMS, origin=None):
    """Runs both on ``points`` ([B, H, W, 3] on the card); asserts one
    launch for the kernel, equal supports bit for bit and equal normals.
    Returns the kernel's count."""
    origin = torch.zeros(3, device=points.device) if origin is None \
        else origin
    before = profiling.total(LAUNCHES)
    got = normals.find_normal_support(points, params)
    assert profiling.total(LAUNCHES) == before + 1
    want = normals.find_normal_support(points, params, impl="plain")
    torch.cuda.synchronize()
    assert_same((got.count, got.moments, got.center_valid),
                (want.count, want.moments, want.center_valid))
    n_got = normals.normals_from_support(got, points, origin, params)
    n_want = normals.normals_from_support(want, points, origin, params)
    assert torch.equal(bits(n_got), bits(n_want))
    assert torch.equal(bits(normals.compute_normals_organized(
        points, origin, params)), bits(n_want))
    return got.count


@functools.lru_cache(maxsize=None)
def mix_points(config_name, mix_name, seed=20261018):
    """The first request of a benchmark mix as [B, H, W, 3] f32 points."""
    with open(os.path.join(ROOT, "portbench", "configs",
                           config_name + ".json")) as f:
        cfg = json.load(f)
    with open(os.path.join(ROOT, "portbench", "mixes",
                           mix_name + ".json")) as f:
        mix = json.load(f)
    frame = cfg["frame"]
    u16 = generate.pool(mix, frame, cfg["batch"], seed)[0]
    rays, _ = generate.rays_and_origin(frame)
    return scenes.unproject_range_np(u16, rays, frame["depth_scale"])


@pytest.mark.cuda
@pytest.mark.parametrize("mix", ["cluttered_cameras", "room_cameras"])
def test_kernel_matches_plain_on_a_stream_batch(card, mix):
    """A VGA batch of 8 of each stream mix."""
    pts = torch.from_numpy(mix_points("vga_stream_b8", mix)).to(card)
    assert pts.shape == (8, 480, 640, 3)
    count = kernel_and_plain(pts)
    assert int((count >= PARAMS.min_num_support_neighbors).sum()) \
        > pts[..., 0].numel() // 2


@pytest.mark.cuda
def test_kernel_matches_plain_on_one_frame(card):
    """B = 1, as a batch of one and as JAX's single frame."""
    pts = torch.from_numpy(mix_points("vga_frame", "cluttered_robot")) \
        .to(card)
    assert pts.shape == (1, 480, 640, 3)
    kernel_and_plain(pts)
    single = normals.find_normal_support(pts[0], PARAMS)
    plain = normals.find_normal_support(pts[0], PARAMS, impl="plain")
    assert single.count.shape == (480, 640)
    assert_same((single.count, single.moments, single.center_valid),
                (plain.count, plain.moments, plain.center_valid))


@pytest.mark.cuda
def test_kernel_matches_plain_with_holes_and_a_nan_border(card):
    """NaN holes, a NaN border three pixels wide, points with one NaN or
    one infinite coordinate (an infinite center walks on, a NaN one
    does not)."""
    pts = mix_points("vga_stream_b8", "cluttered_cameras")[:2].copy()
    rng = np.random.default_rng(7)
    pts[rng.random(pts.shape[:3]) < 0.1] = np.nan
    pts[:, :3] = pts[:, -3:] = np.nan
    pts[:, :, :3] = pts[:, :, -3:] = np.nan
    for value in (np.nan, np.inf, -np.inf):
        cells = rng.random(pts.shape[:3]) < 0.01
        pts[cells, rng.integers(0, 3)] = value
    kernel_and_plain(torch.from_numpy(pts).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(40, 50), (3, 70, 33), (1, 1, 1),
                                   (2, 65, 1)])
def test_kernel_matches_plain_on_small_grids(card, shape):
    """Grids narrower or shorter than the scan's reach, down to one
    pixel."""
    shape = shape if len(shape) == 3 else (2,) + shape
    b, h, w = shape
    pts = np.stack([small_cloud(max(h, 8), max(w, 8), seed=s)[:h, :w]
                    for s in range(b)])
    kernel_and_plain(torch.from_numpy(pts).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("rank", [0, 1, 3])
def test_kernel_matches_plain_on_a_haloed_column_block(card, rank):
    """A rank's block of a VGA frame over 4 ranks, padded as
    ``sharded_normals`` pads it: the neighbours' columns, NaN past the
    grid edge; then ``sharded_normals`` itself on one rank."""
    pts = torch.from_numpy(mix_points("vga_frame", "cluttered_robot")[0]) \
        .to(card)
    k, w_local = PARAMS.max_scan_steps, 160
    lo, hi = rank * w_local - k, (rank + 1) * w_local + k
    nan = torch.full((480, k, 3), float("nan"), device=card)
    padded = torch.cat([nan, pts, nan], dim=1)[:, lo + k:hi + k]
    assert padded.shape == (480, w_local + 2 * k, 3)
    kernel_and_plain(padded[None].contiguous())
    comm = halo.Comm(device=card)
    block = pts[:, :w_local].contiguous()
    before = profiling.total(LAUNCHES)
    got = sharded.sharded_normals(block, torch.zeros(3, device=card),
                                  PARAMS, comm)
    assert profiling.total(LAUNCHES) == before + 1
    want = sharded.sharded_normals(block, torch.zeros(3, device=card),
                                   PARAMS, comm, impl="plain")
    assert torch.equal(bits(got), bits(want))


@pytest.mark.cuda
@pytest.mark.parametrize("fields", [
    {"include_diagonal_neighbors": False},
    {"min_neighbor_distance": 0.05, "max_neighbor_distance": 0.5},
    {"max_scan_steps": 8},
], ids=["no_diagonals", "band_0.05_0.5", "steps_8"])
def test_kernel_matches_plain_at_other_parameters(card, fields):
    pts = mix_points("vga_stream_b8", "cluttered_cameras")[:2]
    kernel_and_plain(torch.from_numpy(pts).to(card),
                     config.ComputeNormalsParams(**fields))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_points_other_than_f32_on_the_card_are_refused(card, dtype):
    """No plain version runs on the card: the public op keeps f16 and
    bf16 as given (the input rule), and the kernel refuses them."""
    pts = torch.from_numpy(small_cloud(40, 50, seed=4)).to(card).to(dtype)
    before = profiling.total(LAUNCHES)
    with pytest.raises(TypeError, match="normal_support.*float32"):
        normals.find_normal_support(pts, PARAMS)
    with pytest.raises(TypeError, match="normal_support.*float32"):
        normals.compute_normals_organized(pts, torch.zeros(3, device=card))
    assert profiling.total(LAUNCHES) == before
