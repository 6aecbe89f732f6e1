"""The committed JAX goldens of the pipeline's other options, which the
card run (chip_smoke.py) holds the port to:

  * ``jax_options_vga.npz``: ``segment_frame_stream`` on the cluttered
    scene (480x640, seed 1) with ``seed_method="average_normals"``
    (``avg__``) and with ``ClusterMethod.MEAN_SHIFT`` (``ms__``), 32 slots;
    ``jax_options_128x160.npz`` the same cases at 128x160;
  * ``jax_avg_stream_128x160.npz``: ``device_forward_stream`` with
    average-normal seeds on the cluttered scene at 128x160 (seed 5, B = 2,
    the second frame jittered by 3 mm).

Each must equal what JAX computes now. The VGA checks are marked slow
(a VGA frame of JAX on the CPU each), so tier-1 checks the 128x160
golden. Rewrite them after a deliberate change of the JAX reference with:

    JAX_PLATFORMS=cpu python -m tests.test_torch_golden_options
"""

import dataclasses
import hashlib
import os

import numpy as np
import pytest

from pcseg_tpu.models import config as jconfig
from pcseg_tpu.models import pipeline as jpipeline
from pcseg_tpu.ops import unproject as junproject
from pcseg_tpu.utils.synthetic import synthetic_cluttered_room_cloud

from pcseg_tpu_torch.models import pipeline

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pcseg_tpu_torch", "testdata")
STREAM_GOLDEN = os.path.join(TESTDATA, "jax_avg_stream_128x160.npz")
SIZES = {"vga": (480, 640), "128x160": (128, 160)}
CONFIGS = {
    "avg": jpipeline.SegmenterConfig(seed_method="average_normals"),
    "ms": jpipeline.SegmenterConfig(cluster=dataclasses.replace(
        jconfig.ClusterRegionConfig(),
        cluster_method=jconfig.ClusterMethod.MEAN_SHIFT)),
}


def cluttered(h, w, seed):
    return junproject.encode_range(synthetic_cluttered_room_cloud(
        h, w, f=float(h), seed=seed)[0])


def golden_path(size):
    return os.path.join(TESTDATA, f"jax_options_{size}.npz")


def frame_case(name, size):
    h, w = SIZES[size]
    d16 = cluttered(h, w, 1)
    out = pipeline.frame_arrays(
        jpipeline.Segmenter(CONFIGS[name]).segment_frame_stream(
            d16, junproject.camera_ray_table(h, w, f=float(h)),
            np.zeros(3, np.float32)))
    out["depth_sha256"] = np.frombuffer(
        hashlib.sha256(d16.tobytes()).digest(), np.uint8)
    return {f"{name}__{k}": v for k, v in out.items()}


def stream_case():
    d16 = cluttered(128, 160, 5)
    depth = np.stack([d16, np.where(d16 > 0, d16 + 3, 0).astype(np.uint16)])
    out = jpipeline.Segmenter(CONFIGS["avg"]).device_forward_stream(
        depth, junproject.camera_ray_table(128, 160, f=128.0),
        np.zeros(3, np.float32), junproject.DEFAULT_DEPTH_SCALE)
    labels, num_planar, num_clusters, planes = (np.asarray(o) for o in out)
    return dict(depth=depth, labels=labels, num_planar=num_planar,
                num_clusters=num_clusters, planes=planes)


@pytest.mark.parametrize("size", [
    pytest.param("vga", marks=pytest.mark.slow), "128x160"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_committed_option_golden_is_current(name, size):
    want = frame_case(name, size)
    gold = np.load(golden_path(size))
    assert {f for f in gold.files if f.startswith(name + "__")} == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(gold[key], arr, err_msg=key)


def test_committed_avg_stream_golden_is_current():
    want = stream_case()
    gold = np.load(STREAM_GOLDEN)
    assert set(gold.files) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(gold[key], arr, err_msg=key)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_port_meets_the_128x160_option_golden(name):
    """The port on the CPU gives the 128x160 golden's frame exactly but for
    planes, centroids and areas (chip_smoke.golden_mismatches, no
    differing cell)."""
    import chip_smoke
    import torch
    from pcseg_tpu_torch.models import config

    torch.set_num_threads(1)
    h, w = SIZES["128x160"]
    d16 = cluttered(h, w, 1)
    rays = junproject.camera_ray_table(h, w, f=float(h))
    cfg = config.config_from_dict(dataclasses.asdict(CONFIGS[name]))
    got = pipeline.frame_arrays(pipeline.Segmenter(cfg, device="cpu")
                                .segment_frame_stream(
                                    d16, rays, np.zeros(3, np.float32)))
    want = chip_smoke.golden_arrays(np.load(golden_path("128x160")),
                                    name + "__")
    assert chip_smoke.golden_mismatches(
        got, want, junproject.unproject_range_np(d16, rays), []) == \
        ([], [], [])


if __name__ == "__main__":
    for size in SIZES:
        arrays = {}
        for case in sorted(CONFIGS):
            arrays.update(frame_case(case, size))
        np.savez_compressed(golden_path(size), **arrays)
    np.savez_compressed(STREAM_GOLDEN, **stream_case())
    for path in [golden_path(size) for size in SIZES] + [STREAM_GOLDEN]:
        print("wrote", path, os.path.getsize(path), "bytes")
