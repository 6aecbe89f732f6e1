"""The traffic: deterministic in the seed, different across seeds, the
frozen generators equal to the port's at the commit they were copied
from."""

import numpy as np
import pytest

from portbench.bench import spec
from portbench.traffic import generate, scenes

FRAME = dict(rows=48, cols=64, f=48.0, depth_scale=0.00025)
BIG_SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("mix", ["cluttered_cameras", "room_cameras",
                                 "cluttered_robot", "carton_cameras"])
def test_pool_is_a_function_of_the_seed(mix):
    m = spec.Cell(next(w["name"] for w in spec.benchmark()["workloads"]
                       if w["traffic"] == mix)).mix
    m = dict(m, pool=3)
    a = generate.pool(m, FRAME, 4, BIG_SEED)
    b = generate.pool(m, FRAME, 4, BIG_SEED)
    c = generate.pool(m, FRAME, 4, BIG_SEED + 1)
    assert len(a) == 3 and a[0].shape == (4, 48, 64)
    assert a[0].dtype == np.uint16
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    assert any(not np.array_equal(x, y) for x, y in zip(a, c))
    # every frame of the pool is distinct
    frames = [f.tobytes() for req in a for f in req]
    assert len(set(frames)) == len(frames)


def test_noise_is_at_most_the_mix_units():
    m = spec.Cell("frame_cluttered").mix
    base = generate.camera_scenes(m, FRAME, 7)[0]
    pool = generate.pool(dict(m, pool=4), FRAME, 1, 7)
    for req in pool:
        d = req[0].astype(np.int64) - base
        assert d.min() >= 0 and d.max() <= m["noise_units"]
        np.testing.assert_array_equal(req[0] == 0, base == 0)


def test_cameras_see_their_own_scenes():
    m = spec.Cell("stream_cluttered").mix
    cams = generate.camera_scenes(m, FRAME, 11)
    assert len(cams) == m["cameras"]
    assert len({c.tobytes() for c in cams}) == m["cameras"]


def test_cartons_that_touch_differ_in_depth():
    """No two cartons that share an edge or a corner share a front plane,
    whatever the seed's order of depths: each front is a plane of its
    own, and every camera sees the same set of boxes."""
    m = spec.load_json(f"{spec.BENCH_DIR}/mixes/carton_cameras.json")
    s = m["scene"]
    for dl, dc in ((0, 1), (1, 0), (1, 1), (1, -1)):
        assert (dl + 2 * dc) % s["depths"] != 0
    fronts = []
    for seed in (BIG_SEED, BIG_SEED + 1):
        pts = scenes.carton_wall(96, 128, f=96.0, seed=seed, **s)
        x = pts[..., 0][np.isfinite(pts[..., 0])]
        fronts.append(sorted({round(float(v), 3) for v in x
                              if abs(v - round(v / 0.2) * 0.2) < 1e-4
                              and 3.0 - 1e-4 <= v <= 3.8 + 1e-4}))
    assert fronts[0] == fronts[1] == [3.0, 3.2, 3.4, 3.6, 3.8]


def test_frozen_copies_equal_the_port():
    from pcseg_tpu_torch.ops import unproject
    from pcseg_tpu_torch.utils import synthetic
    for seed in (0, 5):
        np.testing.assert_array_equal(
            scenes.room(48, 64, f=48.0, seed=seed),
            synthetic.synthetic_room_cloud(48, 64, f=48.0, seed=seed)[0])
        pts = scenes.cluttered_room(48, 64, f=48.0, seed=seed)
        np.testing.assert_array_equal(
            pts, synthetic.synthetic_cluttered_room_cloud(
                48, 64, f=48.0, seed=seed)[0])
    rays = scenes.camera_ray_table(48, 64, 48.0)
    np.testing.assert_array_equal(rays, unproject.camera_ray_table(48, 64,
                                                                   f=48.0))
    u16 = scenes.encode_range(pts)
    np.testing.assert_array_equal(u16, unproject.encode_range(pts))
    np.testing.assert_array_equal(scenes.unproject_range_np(u16, rays),
                                  unproject.unproject_range_np(u16, rays))
