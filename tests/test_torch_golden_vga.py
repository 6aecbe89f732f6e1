"""The committed JAX golden of the full pipeline at VGA, which the card run
(chip_smoke.py) holds the port's ``segment_frame_stream`` to: the room and
the cluttered scene (480x640, seed 1) with 64 slots, and the cluttered
scene with the default 32. Each case must equal what JAX computes now.

Rewrite the golden after a deliberate change of the JAX reference with:

    JAX_PLATFORMS=cpu python -m tests.test_torch_golden_vga
"""

import hashlib
import os

import numpy as np
import pytest

from pcseg_tpu.models import config as jconfig
from pcseg_tpu.models import pipeline as jpipeline
from pcseg_tpu.ops import unproject as junproject
from pcseg_tpu.utils.synthetic import (synthetic_cluttered_room_cloud,
                                       synthetic_room_cloud)

from pcseg_tpu_torch.models import pipeline
from pcseg_tpu_torch.utils import synthetic

GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pcseg_tpu_torch", "testdata", "jax_frame_vga.npz")
H, W = 480, 640
# (scene, slots): the keys of the golden are f"{scene}_k{slots}__{field}"
CASES = [("room", 64), ("cluttered", 64), ("cluttered", 32)]
SCENES = {"room": synthetic_room_cloud,
          "cluttered": synthetic_cluttered_room_cloud}


def depth(scene):
    return junproject.encode_range(SCENES[scene](H, W, f=float(H),
                                                 seed=1)[0])


def jax_case(scene, k):
    """The golden's arrays of one case, with the sha256 of its u16 input
    (the card run rebuilds the input with the port's copy of the scene
    generator and checks the hash)."""
    d16 = depth(scene)
    seg = jpipeline.Segmenter(jpipeline.SegmenterConfig(
        planar=jconfig.PlanarRegionConfig(max_regions=k)))
    out = pipeline.frame_arrays(seg.segment_frame_stream(
        d16, junproject.camera_ray_table(H, W, f=float(H)),
        np.zeros(3, np.float32)))
    out["depth_sha256"] = np.frombuffer(
        hashlib.sha256(d16.tobytes()).digest(), np.uint8)
    return {f"{scene}_k{k}__{name}": v for name, v in out.items()}


@pytest.mark.parametrize("scene, k", CASES)
def test_committed_vga_golden_is_current(scene, k):
    gold = np.load(GOLDEN)
    want = jax_case(scene, k)
    prefix = f"{scene}_k{k}__"
    assert {f for f in gold.files if f.startswith(prefix)} == set(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(gold[name], arr, err_msg=name)


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_port_scene_generator_is_jax_s(scene):
    """The card run builds its inputs with the port's copy of the
    generator; it must give JAX's u16 frame."""
    port = junproject.encode_range(
        getattr(synthetic, SCENES[scene].__name__)(H, W, f=float(H),
                                                   seed=1)[0])
    np.testing.assert_array_equal(port, depth(scene))


if __name__ == "__main__":
    arrays = {}
    for case in CASES:
        arrays.update(jax_case(*case))
    np.savez_compressed(GOLDEN, **arrays)
    print("wrote", GOLDEN, os.path.getsize(GOLDEN), "bytes")
