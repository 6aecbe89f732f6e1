"""The port's whole sharded step against JAX's on the CPU, at 2 and 4
ranks (processes on a gloo group, tests/torch_sharded_worker.py) against
JAX's step on meshes of as many virtual CPU devices (the growers alone:
tests/test_torch_sharded_grow.py).

Labels, region counts and cluster counts are exact; planes are held to the port's plane tolerance
(tests/test_torch_grower.py: 1e-4, or 4x the f32-rounding bound of a
poorly conditioned fit), since JAX sums the moments of each shard in f32
and the port in f64. ``distributed.initialize()`` also joins from
torchrun's environment variables (2 processes, the mirror of
tests/test_multihost.py). The golden ``jax_sharded_128x160.npz`` holds
JAX's sharded step at 2 and 4 shards on the two 128x160 scenes of
``chip_smoke.SHARDED_GOLDEN_SCENES`` (one with a cluster); the port
holds to it on 2 ranks here (4 ranks, and both on the card, in
chip_smoke.py). Regenerate it with ``JAX_PLATFORMS=cpu python -m
tests.test_torch_sharded_step`` (~60 s of JAX).
"""

import hashlib
import os

if __name__ == "__main__":  # the golden's generator: 4 virtual CPU devices
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + (
        " --xla_force_host_platform_device_count=8")).strip()

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.models.config import (
    ComputeNormalsParams, PlanarRegionConfig,
    SeedsFromPlaneSupportParams)
from pcseg_tpu.ops import normals as jnormals
from pcseg_tpu.parallel import sharded as jsharded
from pcseg_tpu.utils.synthetic import (synthetic_cluttered_room_cloud,
                                       synthetic_room_cloud)

import chip_smoke
from tests.test_torch_grower import plane_tolerance
from tests.torch_sharded_worker import run_ranks

torch.set_num_threads(1)

H, W = 48, 64
RANKS = (2, 4)
GOLDEN = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "pcseg_tpu_torch", "testdata",
    "jax_sharded_128x160.npz")
# the 48x64 step: JAX's test_sharded.py parameters
STEP_KW = dict(normals_params=ComputeNormalsParams(max_scan_steps=8),
               seed_params=SeedsFromPlaneSupportParams(max_seeds=4096),
               planar_config=PlanarRegionConfig(max_regions=16),
               max_attempts=32)


def step_scenes(h=H, w=W):
    room = synthetic_room_cloud(h, w, f=float(h), seed=9)
    clut = synthetic_cluttered_room_cloud(h, w, f=float(h), seed=1)
    return {"room": room, "cluttered": clut}


def scene_inputs(scenes):
    out = {"scenes": np.array(list(scenes))}
    for name, (pts, origin) in scenes.items():
        out[name + "_pts"] = pts
        out[name + "_origin"] = origin
    return out


def jax_step(n, pts, origin, **kw):
    step = jsharded.build_sharded_segment_step(jsharded.make_mesh(n), **kw)
    out = step(jnp.asarray(pts), jnp.asarray(origin))
    return dict(labels=np.asarray(out.labels),
                normals=np.asarray(out.normals),
                num_regions=int(out.planar.num_regions),
                num_clusters=int(out.num_clusters),
                planes=np.asarray(out.planar.planes))


def assert_planes(got, want, labels, pts, num):
    for r in range(num):
        np.testing.assert_allclose(
            got[r], want[r], rtol=0,
            atol=plane_tolerance(pts[labels == r]), err_msg=f"region {r}")


_CACHE = {}


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """Results of a suite on ``n`` ranks (run once per module)."""
    def get(suite, n, make_inputs):
        if (suite, n) not in _CACHE:
            _CACHE[suite, n] = run_ranks(
                suite, n, make_inputs(),
                tmp_path_factory.mktemp(f"{suite}{n}"))
        return _CACHE[suite, n]
    return get


@pytest.mark.parametrize("n", RANKS)
def test_sharded_step_matches_jax(port, n):
    scenes = step_scenes()
    got = port("step", n, lambda: scene_inputs(scenes))
    clusters = 0
    for name, (pts, origin) in scenes.items():
        want = jax_step(n, pts, origin, **STEP_KW)
        np.testing.assert_array_equal(got[f"L:{name}_labels"],
                                      want["labels"], err_msg=name)
        assert int(got[f"R:{name}_num_regions"]) == want["num_regions"]
        assert int(got[f"R:{name}_num_clusters"]) == want["num_clusters"]
        clusters += want["num_clusters"]
        # normals against JAX's single-device ones at the port's own
        # tolerance (tests/test_torch_ops.py): JAX's sharded normals carry
        # f32 fusion differences, up to ~1e-3 on the blobs' ill-conditioned
        # fits, that its own test bounds (2e-4) on the room only
        single = np.asarray(jnormals.compute_normals_organized(
            jnp.asarray(pts), jnp.asarray(origin), STEP_KW["normals_params"]))
        np.testing.assert_allclose(got[f"L:{name}_normals"], single, rtol=0,
                                   atol=1e-5)
        assert_planes(got[f"R:{name}_planes"], want["planes"],
                      want["labels"], pts, want["num_regions"])
    assert clusters >= 1


def test_initialize_from_torchrun_environment(port):
    """tests/test_multihost.py's mirror: 2 processes join from
    MASTER_ADDR/MASTER_PORT/WORLD_SIZE/RANK, run the step on their column
    halves and gather the grid; equal to JAX's step on a 2-device mesh."""
    pts, origin = synthetic_room_cloud(H, W, f=float(H), seed=2)
    got = port("env", 2, lambda: scene_inputs({"room": (pts, origin)}))
    want = jax_step(2, pts, origin, **STEP_KW)
    np.testing.assert_array_equal(got["R:room_labels"], want["labels"])
    assert int(got["R:room_num_regions"]) == want["num_regions"] >= 3
    assert int(got["R:room_num_clusters"]) == want["num_clusters"]


def test_port_holds_the_sharded_golden(port):
    """The golden is current (its inputs are what the scenes' generators
    give) and the port on 2 ranks gives its labels and counts exactly, its
    planes within the plane tolerance."""
    scenes = chip_smoke.sharded_golden_points()
    gold = np.load(GOLDEN)
    for name, (pts, _) in scenes.items():
        assert hashlib.sha256(pts.tobytes()).digest() == \
            gold[f"{name}__points_sha256"].tobytes(), name
    got = port("golden", 2, lambda: scene_inputs(scenes))
    for name, (pts, _) in scenes.items():
        pre = f"n2_{name}__"
        np.testing.assert_array_equal(got[f"L:{name}_labels"],
                                      gold[pre + "labels"], err_msg=name)
        num = int(gold[pre + "num_regions"])
        assert int(got[f"R:{name}_num_regions"]) == num
        assert int(got[f"R:{name}_num_clusters"]) == \
            int(gold[pre + "num_clusters"])
        assert_planes(got[f"R:{name}_planes"], gold[pre + "planes"],
                      gold[pre + "labels"], pts, num)


def write_golden():
    out = {}
    for name, (pts, origin) in chip_smoke.sharded_golden_points().items():
        out[f"{name}__points_sha256"] = np.frombuffer(
            hashlib.sha256(pts.tobytes()).digest(), np.uint8)
        for n in RANKS:
            res = jax_step(n, pts, origin)
            for k in ("labels", "num_regions", "num_clusters", "planes"):
                out[f"n{n}_{name}__{k}"] = np.asarray(res[k])
            print(name, n, res["num_regions"], res["num_clusters"])
    np.savez_compressed(GOLDEN, **out)
    print("wrote", GOLDEN)


if __name__ == "__main__":
    write_golden()
