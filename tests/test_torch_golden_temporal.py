"""The committed JAX goldens of the temporal frame: frame 1 is the room
scene (seed 1) through ``segment_frame_stream`` with 32 slots; frame 2 is
the same points seen after the sensor moved by 3 degrees about z and (0.05,
0.02, 0) m, through ``segment_frame`` with frame 1's planar records as
temporal seeds (within 0.5 m and 0.2 rad) and the pose, at 32 and 64
slots. The motion and the configuration are chip_smoke.py's own
(``moved_frame``, ``temporal_config``); the golden keeps the sha256 of
frame 2's points, so a change there shows as a stale golden. The card run (chip_smoke.py) holds the port to the VGA golden
(``jax_temporal_vga.npz``); the 128x160 one holds the same cases small.
Each must equal what JAX computes now. The VGA check (three VGA frames of
JAX on the CPU) is marked slow, so tier-1 checks the 128x160 golden.

Rewrite the golden after a deliberate change of the JAX reference with:

    JAX_PLATFORMS=cpu python -m tests.test_torch_golden_temporal
"""

import hashlib
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from pcseg_tpu.models import config as jconfig
from pcseg_tpu.models import pipeline as jpipeline
from pcseg_tpu.ops import geom as jgeom
from pcseg_tpu.ops import unproject as junproject
from pcseg_tpu.utils.synthetic import synthetic_room_cloud

from pcseg_tpu_torch.models import pipeline

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pcseg_tpu_torch", "testdata")
SIZES = {"vga": (480, 640), "128x160": (128, 160)}
SLOTS = (32, 64)
# JAX's config classes where chip_smoke.temporal_config looks for them
JAX_CONFIG = types.SimpleNamespace(
    SegmenterConfig=jpipeline.SegmenterConfig,
    PlanarRegionConfig=jconfig.PlanarRegionConfig)


def golden_path(size):
    return os.path.join(TESTDATA, f"jax_temporal_{size}.npz")


def frame1_input(h, w):
    d16 = junproject.encode_range(synthetic_room_cloud(h, w, f=float(h),
                                                       seed=1)[0])
    return d16, junproject.camera_ray_table(h, w, f=float(h))


def sha(a):
    return np.frombuffer(hashlib.sha256(a.tobytes()).digest(), np.uint8)


def jax_cases(size):
    """The golden's arrays: frame 1 (``frame1__``) and frame 2 at each slot
    count (``k32__``, ``k64__``), with the sha256 of the u16 input and of
    frame 2's points."""
    d16, rays = frame1_input(*SIZES[size])
    origin = np.zeros(3, np.float32)
    f1 = jpipeline.Segmenter(chip_smoke.temporal_config(
        JAX_CONFIG, 32)).segment_frame_stream(d16, rays, origin)
    pts2, origin2, quat, trans = chip_smoke.moved_frame(
        junproject.unproject_range_np(d16, rays))
    out = {f"frame1__{k}": v for k, v in pipeline.frame_arrays(f1).items()}
    out["depth_sha256"] = sha(d16)
    out["points2_sha256"] = sha(pts2)
    pose = jgeom.Pose(jnp.asarray(quat), jnp.asarray(trans))
    for k in SLOTS:
        f2 = jpipeline.Segmenter(chip_smoke.temporal_config(
            JAX_CONFIG, k)).segment_frame(
            pts2, origin2, None, f1.planar_regions, pose)
        out.update({f"k{k}__{name}": v
                    for name, v in pipeline.frame_arrays(f2).items()})
    return out


@pytest.mark.parametrize("size", [
    pytest.param("vga", marks=pytest.mark.slow), "128x160"])
def test_committed_temporal_golden_is_current(size):
    """Equal to what JAX computes now; frame 2, seeded from frame 1's
    records, finds as many planar regions as frame 1 at 32 and 64 slots."""
    want = jax_cases(size)
    gold = np.load(golden_path(size))
    assert set(gold.files) == set(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(gold[name], arr, err_msg=name)
    for k in SLOTS:
        assert want[f"k{k}__metrics"][2] == want["frame1__metrics"][2]


def test_port_meets_the_128x160_temporal_golden():
    """The port on the CPU, driven as the card run drives it (frame 2 from
    chip_smoke.moved_frame, whose points must hash to the golden's), gives
    the 128x160 golden's frames exactly but for planes, centroids and
    areas (chip_smoke.golden_mismatches with no differing cell)."""
    import torch
    from pcseg_tpu_torch.models import config
    from pcseg_tpu_torch.ops import geom

    torch.set_num_threads(1)
    gold = np.load(golden_path("128x160"))
    d16, rays = frame1_input(*SIZES["128x160"])
    pts1 = junproject.unproject_range_np(d16, rays)
    pts2, origin2, quat, trans = chip_smoke.moved_frame(pts1)
    assert sha(pts2).tobytes() == gold["points2_sha256"].tobytes()

    def seg(k):
        return pipeline.Segmenter(chip_smoke.temporal_config(config, k),
                                  device="cpu")

    def check(res, prefix, points):
        got = pipeline.frame_arrays(res)
        want = chip_smoke.golden_arrays(gold, prefix)
        assert chip_smoke.golden_mismatches(got, want, points, []) == \
            ([], [], [])

    f1 = seg(32).segment_frame_stream(d16, rays, np.zeros(3, np.float32))
    check(f1, "frame1__", pts1)
    pose = geom.Pose.from_arrays(quat, trans)
    for k in SLOTS:
        check(seg(k).segment_frame(pts2, origin2, None, f1.planar_regions,
                                   pose), f"k{k}__", pts2)


if __name__ == "__main__":
    for size in SIZES:
        np.savez_compressed(golden_path(size), **jax_cases(size))
        print("wrote", golden_path(size),
              os.path.getsize(golden_path(size)), "bytes")
