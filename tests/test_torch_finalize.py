"""The device discontinuity stencil and ``segment_frame`` on the edge cases
of tests/test_pipeline.py (degenerate probes, input masks, a frame with
more than 128 clusters), against JAX on the CPU; the default device and
the parts that are not ported yet.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from pcseg_tpu.models import pipeline as jpipeline
from pcseg_tpu.models.config import UNLABELED, PlanarRegionConfig
from pcseg_tpu.ops import discontinuity as jdiscontinuity
from pcseg_tpu.utils.synthetic import synthetic_cluttered_room_cloud
from tests import fixtures
from tests.test_pipeline import room_classification_config

from pcseg_tpu_torch import native
from pcseg_tpu_torch.models import boundary, config, pipeline
from pcseg_tpu_torch.ops import discontinuity
from tests.test_torch_frame import assert_frame_equal

# One intra-op thread: the suite runs in parallel worker processes, and
# OpenMP teams spinning across them slow every small op by orders of
# magnitude.
torch.set_num_threads(1)


def rotation(axis, ang):
    c, s = np.cos(ang), np.sin(ang)
    if axis == "z":
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)


def stencil_inputs(name):
    """(points, normals, labels, rot). "scene": the cluttered room at 64x80
    with the port's own normals and planar labels (both stencils read the
    same inputs), under the robot rotations of tests/test_pipeline.py's
    two recipes; "random": that file's random cloud, which reaches every
    gate branch."""
    if name.startswith("scene"):
        pts, origin = synthetic_cluttered_room_cloud(64, 80, f=64.0, seed=4)
        nrm, _, dev = pipeline.Segmenter(device="cpu")._planar(
            torch.from_numpy(pts)[None], torch.from_numpy(origin))
        rot = rotation("z", 0.3) if name == "scene_z" else \
            rotation("x", 0.7)
        return pts, nrm[0].numpy(), dev.labels[0].numpy(), rot
    rng = np.random.default_rng(3)
    h, w = 32, 40
    r = rng.uniform(0.8, 4.5, (h, w)).astype(np.float32)
    dirs = rng.normal(size=(h, w, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    pts = r[..., None] * dirs
    pts[rng.random((h, w)) < 0.08] = np.nan
    nrm = rng.normal(size=(h, w, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm[rng.random((h, w)) < 0.05] = np.nan
    return pts, nrm, np.zeros((h, w), np.int32), rotation("x", 0.7)


@pytest.mark.parametrize("name", ["scene_z", "scene_x", "random"])
def test_discontinuity_flags_match_jax(name):
    """Exact flags with a non-identity robot rotation, on a batch of the
    frame and its upside-down copy."""
    pts, nrm, labels, rot = stencil_inputs(name)
    frames = [(pts, nrm, labels),
              tuple(a[::-1].copy() for a in (pts, nrm, labels))]
    got = discontinuity.discontinuity_flags(
        *[torch.from_numpy(np.stack(a)) for a in zip(*frames)],
        torch.from_numpy(rot), config.PlanarRegionConfig()).numpy()
    for f, (p, n, lab) in enumerate(frames):
        want = np.asarray(jdiscontinuity.discontinuity_flags(
            jnp.asarray(p), jnp.asarray(n), jnp.asarray(lab),
            jnp.asarray(rot), PlanarRegionConfig()))
        np.testing.assert_array_equal(got[f], want, err_msg=f"frame {f}")
        assert want.sum() > 20


def test_host_stencil_matches_device_flags():
    """The host finalize's own stencil (used without device flags) flags
    the same pixels as the device stencil: every pixel is on the boundary
    of the one label of the random cloud."""
    pts, nrm, labels, rot = stencil_inputs("random")
    h, w = labels.shape
    flags = discontinuity.discontinuity_flags(
        torch.from_numpy(pts[None]), torch.from_numpy(nrm[None]),
        torch.from_numpy(labels[None]), torch.from_numpy(rot),
        config.PlanarRegionConfig())[0].numpy()
    all_idx = [c * h + r for c in range(w) for r in range(h)]
    host = boundary.discontinuous_boundary(all_idx, pts, nrm, labels, 0, rot,
                                           config.PlanarRegionConfig())
    assert host == {c * h + r for r, c in np.argwhere(flags)}
    assert len(host) > 100


def test_numpy_fallbacks_match_native(monkeypatch):
    """Without the host-ops library the finalize takes its NumPy Moore
    trace, outside flood and hull, with the same result."""
    pts, origin = synthetic_cluttered_room_cloud(64, 80, f=64.0, seed=4)
    seg = pipeline.Segmenter(device="cpu")
    native_run = pipeline.frame_arrays(seg.segment_frame(pts, origin))
    monkeypatch.setattr(native, "load_hostops", lambda: None)
    numpy_run = pipeline.frame_arrays(seg.segment_frame(pts, origin))
    assert native_run["metrics"][2] >= 3
    for key, want in native_run.items():
        np.testing.assert_array_equal(numpy_run[key], want, err_msg=key)


def probe(name):
    """The degenerate inputs of tests/test_pipeline.py's
    TestDegenerateInputs."""
    if name == "all_nan":
        return np.full((24, 32, 3), np.nan, np.float32)
    if name == "tiny":
        p = np.zeros((3, 3, 3), np.float32)
        p[..., 0] = 1.0
        return p
    if name == "single_pixel":
        return np.ones((1, 1, 3), np.float32)
    p = np.zeros((12, 12, 3), np.float32)
    p[..., 0] = np.linspace(1, 1.05, 12)[None, :]
    p[..., 1] = np.linspace(0, 0.05, 12)[:, None]
    p[..., 2] = -0.5
    return p


@pytest.mark.parametrize("name, planar, clusters", [
    ("all_nan", 0, 0), ("tiny", 0, 1), ("single_pixel", 0, 0),
    ("small_plane", 0, 1)])
def test_segment_frame_probes(name, planar, clusters):
    pts = probe(name)
    origin = np.zeros(3, np.float32)
    want = jpipeline.Segmenter().segment_frame(pts, origin)
    got = pipeline.Segmenter(device="cpu").segment_frame(pts, origin)
    assert_frame_equal(got, want, pts)
    assert got.metrics.num_planar_regions == planar
    assert got.metrics.num_clusters == clusters


def test_segment_frame_input_mask():
    """MASKED_EGO / MASKED_OUT cells survive, as in JAX. The classification
    gates of tests/test_pipeline.py (10 degrees): the default config's 0
    degree gate accepts a normal only at n.up == 1.0 exactly, and this
    scene's floor fit lands within one ulp of that in both packages, on
    either side depending on the moment sums' precision (f32 in JAX, f64
    in the port)."""
    pts, origin = fixtures.synthetic_room_cloud(40, 40, f=40.0, seed=2)
    mask = np.full((40, 40), UNLABELED, np.int32)
    mask[5:15, 5:15] = config.MASKED_EGO
    mask[30:34, 20:28] = config.MASKED_OUT
    jcfg = jpipeline.SegmenterConfig(
        classification=room_classification_config())
    want = jpipeline.Segmenter(jcfg).segment_frame(pts, origin,
                                                   input_mask=mask)
    got = pipeline.Segmenter(
        config.config_from_dict(dataclasses.asdict(jcfg)),
        device="cpu").segment_frame(pts, origin, input_mask=mask)
    assert_frame_equal(got, want, pts)
    assert (got.labels[5:15, 5:15] == config.MASKED_EGO).all()
    assert (got.labels[30:34, 20:28] == config.MASKED_OUT).all()
    assert {int(r.plane_class) for r in got.planar_regions} >= {
        int(config.PlaneClass.FLOOR), int(config.PlaneClass.WALL)}


def many_clusters(h=48, w=64, seed=0):
    """3x3 patches of jittered points at stride 4 (NaN between them), each
    at its own depth: 192 separate clusters, no planar region survives
    the finalize."""
    rng = np.random.default_rng(seed)
    pts = np.full((h, w, 3), np.nan, np.float32)
    for r0 in range(0, h, 4):
        for c0 in range(0, w, 4):
            depth = rng.uniform(2.0, 3.5)
            r, c = np.mgrid[r0:r0 + 3, c0:c0 + 3]
            pts[r0:r0 + 3, c0:c0 + 3] = np.stack(
                [np.full(r.shape, depth), (c - w / 2) * 0.02,
                 (h / 2 - r) * 0.02], -1) + rng.normal(0, 0.003, (3, 3, 3))
    return pts


def test_cluster_ids_past_128_do_not_wrap():
    """The port keeps int32 labels from the device to the host: its 192
    cluster ids are dense and distinct. JAX narrows them to int8 for its
    host link, so ids >= 128 wrap negative and its finalize drops them
    (ROADMAP Queue 3 fault (a)); below 128 the two agree."""
    pts = many_clusters()
    origin = np.zeros(3, np.float32)
    want = jpipeline.Segmenter().segment_frame(pts, origin)
    got = pipeline.Segmenter(device="cpu").segment_frame(pts, origin)
    assert got.metrics == want.metrics
    n = got.metrics.num_clusters
    assert n == 192 and got.metrics.num_planar_regions == 0
    ids, sizes = np.unique(got.labels[got.labels >= 0], return_counts=True)
    np.testing.assert_array_equal(ids, np.arange(n))
    assert (sizes == 9).all()
    low = (got.labels >= 0) & (got.labels < 128)
    np.testing.assert_array_equal(want.labels[low], got.labels[low])
    np.testing.assert_array_equal(want.labels[got.labels >= 128], UNLABELED)
    np.testing.assert_array_equal(want.labels[got.labels < 0],
                                  got.labels[got.labels < 0])
    # both carry the size table of the first max_regions clusters
    np.testing.assert_array_equal(got.cluster_sizes, want.cluster_sizes)
    assert len(got.objects) == n
    assert all(len(o.points) == 9 for o in got.objects)


def test_default_device_is_the_card():
    """With no device the pipeline takes the card, and refuses to run
    without one; the CPU only on request."""
    if torch.cuda.is_available():
        assert pipeline.Segmenter().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pipeline.Segmenter()
    assert pipeline.Segmenter(device="cpu").device.type == "cpu"


def test_not_ported_yet_raises():
    pts = probe("small_plane")
    origin = np.zeros(3, np.float32)
    seg = pipeline.Segmenter(device="cpu")
    with pytest.raises(NotImplementedError, match="prev_regions"):
        seg.segment_frame(pts, origin, prev_regions=[object()])
    ms = pipeline.Segmenter(config.SegmenterConfig(
        cluster=config.ClusterRegionConfig(
            cluster_method=config.ClusterMethod.MEAN_SHIFT)), device="cpu")
    with pytest.raises(NotImplementedError, match="mean-shift"):
        ms.segment_frame(pts, origin)


def test_hostops_loads():
    """The host compiler builds the native finalize ops; without it the
    NumPy paths would take over."""
    assert native.load_hostops() is not None
