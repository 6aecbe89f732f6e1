"""Where the port's 32-slot VGA frame differs from the committed JAX golden,
JAX's two epoch paths differ the same way.

JAX built jax_frame_vga.npz on the CPU, where its grower takes the XLA
closure epochs at every slot budget. On a TPU, at 32 slots or fewer, it
takes the epoch megakernel on the packed member word (``_epoch_kernel_
batched``), which the port ports (kernel B1, and its plain version on the
CPU). Run through that kernel in interpret mode, JAX gives the port's frame:
every label, record and cluster size, so each cell of
chip_smoke.GOLDEN_CELLS["cluttered_k32"] is a cell where JAX's own paths
disagree. Only the count of device-accepted regions, which the host
finalize reduces to the same 4 planar regions, differs (the port 8, JAX 7:
the small clutter fits split differently). The same port frame meets the
golden rule that chip_smoke.py holds the card run to.
"""

import jax
import numpy as np
import pytest
import torch

import chip_smoke
from pcseg_tpu.models import planar_batched as jpb
from tests.test_torch_golden_vga import jax_case
from tests.test_torch_vga_fits import assert_golden_rule, port_frame

# One intra-op thread: the suite runs in parallel worker processes, and
# OpenMP teams spinning across them slow every small op by orders of
# magnitude.
torch.set_num_threads(1)

PREFIX = "cluttered_k32__"


@pytest.fixture(scope="module")
def frame32():
    return port_frame(32)


def test_vga_frame_meets_the_golden_rule_at_32_slots(frame32):
    assert_golden_rule(32, frame32)


def test_jax_word_epochs_give_the_port_frame(monkeypatch, frame32):
    monkeypatch.setattr(jpb, "EPOCH_IMPL", "pallas_interpret")
    jax.clear_caches()
    try:
        word = {f[len(PREFIX):]: v
                for f, v in jax_case("cluttered", 32).items()
                if not f.endswith("sha256")}
    finally:
        jax.clear_caches()
    got, gold, points = frame32
    assert got["metrics"][[0, 2, 3]].tolist() == \
        word["metrics"][[0, 2, 3]].tolist()
    assert (got["metrics"][1], word["metrics"][1]) == (8, 7)
    assert chip_smoke.compare_frames(
        dict(got, metrics=word["metrics"]), word,
        lambda r: chip_smoke.plane_tolerance(
            points[word["labels"] == r])) == []
    # the golden (XLA epochs) differs from JAX's word epochs at the known
    # cells, with the same labels on both sides as the port has
    cells = np.argwhere(word["labels"] != gold["labels"])
    assert [[c.tolist(), int(word["labels"][tuple(c)]),
             int(gold["labels"][tuple(c)])] for c in cells] == \
        chip_smoke.GOLDEN_CELLS["cluttered_k32"]
