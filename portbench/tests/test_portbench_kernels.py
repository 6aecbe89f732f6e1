"""Each kernel's bytes and operations against its shapes, the spies on
the program's wrappers, and the trace's reduction to busy time, idle gaps
and device time by name."""

import pytest
import torch

from portbench.bench import roofline, trace
from portbench.kernels import (ccl_gated, epoch_word, flood_packed,
                               normal_support)

B, K, H, W = 8, 32, 480, 640


def t(*shape, dtype=torch.int32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_epoch_word_counts_its_logical_arguments():
    grid = t(B, H, W)
    a = dict(px=t(B, H, W, dtype=torch.float32), srank=t(B, K),
             rounds_out=None)
    a["py"] = a["pz"] = a["px"]
    a["rank"] = a["elig"] = a["word"] = grid
    n_bytes, ops = epoch_word.cost(a)
    hw = B * H * W
    assert n_bytes == 7 * 4 * hw + (4 * 4 + 16) * B * K + 4 * B \
        + (3 * 4 + 40) * B * K
    assert ops == 7 * K * hw
    # bytes bound it: 20.5 us at 3.35 TB/s (chip_smoke's bound at 9e5028f)
    assert roofline.least_seconds(n_bytes, ops) == pytest.approx(
        n_bytes / roofline.HBM_BYTES_PER_S)
    assert 20e-6 < roofline.least_seconds(n_bytes, ops) < 21e-6
    a["rounds_out"] = t(B)
    assert epoch_word.cost(a)[0] == n_bytes + 4 * B


@pytest.mark.parametrize("mod,key", [(ccl_gated, "gate"),
                                     (flood_packed, "gate_words")])
def test_ccl_and_flood_read_two_planes_and_write_one(mod, key):
    n_bytes, ops = mod.cost({key: t(16, H, W), "rounds_out": None})
    assert (n_bytes, ops) == (3 * 4 * 16 * H * W, 0)


def test_normal_support_reads_12_and_writes_57_bytes_a_pixel():
    n_bytes, ops = normal_support.cost({"points": t(B, H, W, 3,
                                                  dtype=torch.float32)})
    assert (n_bytes, ops) == (69 * B * H * W, 0)
    # 50.6 us at B = 8, 6.3 us at B = 1 (chip_smoke's bound at 485681c)
    assert 50.5e-6 < roofline.least_seconds(n_bytes) < 50.7e-6
    one = normal_support.cost({"points": t(1, H, W, 3)})[0]
    assert 6.3e-6 < roofline.least_seconds(one) < 6.4e-6


def test_spies_see_the_programs_calls():
    """On the CPU the wrappers run their plain versions; the spies still
    record one cost per call, from the bound arguments."""
    from pcseg_tpu_torch.models import planar_batched
    from pcseg_tpu_torch.ops import normals, seeds
    from portbench.traffic import scenes
    pts = torch.from_numpy(scenes.cluttered_room(40, 56, f=40.0, seed=1))
    nrm = normals.compute_normals_organized(pts, torch.zeros(3))
    ranked = seeds.seeds_from_plane_support(pts, nrm, seed_vector=True)
    costs = {"epoch_word": epoch_word, "flood_packed": flood_packed,
             "normal_support": normal_support}
    with trace.KernelSpies(costs) as spies:
        normals.compute_normals_organized(pts, torch.zeros(3))
        planar_batched.grow_planar_regions_batched(
            pts, nrm, torch.full((40, 56), -1, dtype=torch.int32),
            ranked.indices, ranked.valid, flood_rounds=8)
    calls = spies.calls["epoch_word"]
    assert calls and all(b == epoch_word.cost(dict(
        px=t(1, 40, 56, dtype=torch.float32), srank=t(1, 32),
        rounds_out=None))[0] for b, _ in calls)
    assert spies.calls["normal_support"] == [(69 * 40 * 56, 0)]


def test_reduce_trace_names_gaps_by_the_open_span():
    ev = [dict(ph="X", cat="user_annotation", name="grower", ts=0, dur=100),
          dict(ph="X", cat="kernel", name="k1", ts=10, dur=20),
          dict(ph="X", cat="kernel", name="k2", ts=25, dur=10),   # overlaps
          dict(ph="X", cat="gpu_memcpy", name="copy", ts=60, dur=10),
          dict(ph="X", cat="kernel", name="k1", ts=200, dur=50),
          dict(ph="X", cat="gpu_user_annotation", name="grower", ts=0,
               dur=300)]
    r = trace.reduce_trace(ev, 1e-3)
    assert r["busy_s"] == pytest.approx((25 + 10 + 50) * 1e-6)
    assert r["device_events"] == 4
    assert r["by_name"]["k1"] == pytest.approx(70e-6)
    assert r["idle_gaps"] == [("harness", pytest.approx(130e-6)),
                              ("grower", pytest.approx(25e-6))]
    assert r["device_ops"][0][0] == "k1"
