"""The port's full pipeline on the cluttered VGA frame against the committed
JAX golden (tests/test_torch_golden_vga.py), under the rule chip_smoke.py
holds the card run to, and the trace of the cells where the two differ to
the precision of the refit moment sums.

JAX sums each slot's plane-fit moments in f32, the port in f64. The floor's
fit then differs in its last digits, and a few cells at the edge of its
tau band change owner between the floor and a cluster. With its moment
sums taken in f32 instead, the port reproduces the 64-slot golden exactly:
the difference is the sums' precision, not the port's logic. (At 32 slots
the golden also comes from JAX's CPU-only epoch path;
tests/test_torch_vga_epoch_path.py traces those cells.)
"""

import numpy as np
import pytest
import torch

import chip_smoke
from pcseg_tpu_torch.models import config, pipeline, planar_batched
from pcseg_tpu_torch.ops import unproject
from tests.test_torch_golden_vga import GOLDEN, H, W, depth

# One intra-op thread: the suite runs in parallel worker processes, and
# OpenMP teams spinning across them slow every small op by orders of
# magnitude.
torch.set_num_threads(1)


def port_frame(k):
    """(the port's frame_arrays of the cluttered frame at ``k`` slots, the
    golden's, the f32 points)."""
    d16 = depth("cluttered")
    rays = unproject.camera_ray_table(H, W, f=float(H))
    seg = pipeline.Segmenter(config.SegmenterConfig(
        planar=config.PlanarRegionConfig(max_regions=k)), device="cpu")
    got = pipeline.frame_arrays(seg.segment_frame_stream(
        d16, rays, np.zeros(3, np.float32)))
    gold = np.load(GOLDEN)
    prefix = f"cluttered_k{k}__"
    want = {f[len(prefix):]: gold[f] for f in gold.files
            if f.startswith(prefix) and not f.endswith("sha256")}
    return got, want, unproject.unproject_range_np(d16, rays)


def assert_golden_rule(k, frame):
    """The port's ``frame`` (port_frame(k)) meets golden_mismatches' rule
    with the cells of GOLDEN_CELLS, as on the card."""
    got, want, points = frame
    known = chip_smoke.GOLDEN_CELLS[f"cluttered_k{k}"]
    bad, cells, fits = chip_smoke.golden_mismatches(got, want, points, known)
    assert not bad, (bad, cells, fits)
    assert cells == known and len(cells) > 0
    assert got["metrics"][2] == 4 and got["metrics"][3] == 4
    assert all(max(f["plane_err"], f["centroid_err"]) <= f["tolerance"]
               for f in fits)


def test_vga_frame_meets_the_golden_rule():
    assert_golden_rule(64, port_frame(64))


def test_f32_moment_sums_reproduce_the_golden(monkeypatch):
    def f32_moments(mask, feat):
        m = mask.to(torch.float32)
        if feat.dim() == 3:
            return torch.bmm(m, feat)
        return torch.einsum("bkn,bknf->bkf", m, feat)

    monkeypatch.setattr(planar_batched, "_masked_moments", f32_moments)
    got, want, points = port_frame(64)
    assert chip_smoke.compare_frames(
        got, want, lambda r: chip_smoke.plane_tolerance(
            points[want["labels"] == r])) == []


if __name__ == "__main__":
    pytest.main([__file__, "-q"])
