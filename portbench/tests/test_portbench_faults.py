"""A run with the timed path broken underneath comes out not correct,
once for each fault a cell can have: an answer altered where it is
produced, half of the batch left out (the rest standing in for it), the
exchange between chips left out. The harness's look for a card is
skipped: these runs drive the rest of a run on the CPU at a small size.
(No cell trains, so a step that returns its state unchanged does not
apply.)"""

import argparse
import os
import sys
import time

import pytest
import torch

from portbench.bench import ranks
from portbench.tests.helpers import SHARDED, run_small, small_cell

HERE = os.path.dirname(os.path.abspath(__file__))


def altered_stream(real):
    def run(self, *a, **kw):
        labels, n_planar, n_clusters, planes = real(self, *a, **kw)
        labels = labels.clone()
        labels[0, 5, 5] ^= 1
        return labels, n_planar, n_clusters, planes
    return run


def half_batch(real):
    def run(self, depth, *a, **kw):
        depth = torch.as_tensor(depth)
        half = depth.shape[0] // 2
        out = real(self, depth[:half], *a, **kw)
        return tuple(torch.cat([x, x[:depth.shape[0] - half]]) for x in out)
    return run


@pytest.mark.parametrize("fault", [altered_stream, half_batch])
@pytest.mark.parametrize("workload", ["stream_cluttered", "stream_room",
                                      "stream_cartons_k64"])
def test_stream_faults_are_caught(monkeypatch, fault, workload):
    from pcseg_tpu_torch.models import pipeline
    monkeypatch.setattr(pipeline.Segmenter, "device_forward_stream",
                        fault(pipeline.Segmenter.device_forward_stream))
    res = run_small(small_cell(workload, batch=2))
    assert res["attempted"] > 0 and not res["correct"]


def test_a_sound_stream_run_is_correct():
    res = run_small(small_cell("stream_cluttered", batch=2))
    assert res["correct"] and list(res["check"])[-1] == "plane_gap"
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("field", ["labels", "plane"])
def test_frame_faults_are_caught(monkeypatch, field):
    from pcseg_tpu_torch.models import pipeline
    real = pipeline.Segmenter._host_finalize

    def altered(self, *a, **kw):
        res = real(self, *a, **kw)
        if field == "labels":
            res.labels[3, 3] += 1
        else:
            res.planar_regions[0].plane[3] += 1e-4
        return res
    monkeypatch.setattr(pipeline.Segmenter, "_host_finalize", altered)
    res = run_small(small_cell("frame_cluttered", pool=2), seconds=1.5)
    assert res["attempted"] > 0 and not res["correct"]


def sharded_run(fault, control=False, trace=0):
    cell = small_cell(SHARDED["name"], ranks=2, pool=2)
    args = argparse.Namespace(workload=cell.name, seed=2 ** 31 + 9,
                              seconds=1.0, trace=trace, control=control)
    return ranks.launch(cell, args, time.perf_counter(), backend="gloo",
                        command=[sys.executable,
                                 os.path.join(HERE, "fault_rank.py"), fault])


@pytest.mark.parametrize("fault", ["no_exchange", "altered_answer"])
def test_sharded_faults_are_caught(fault):
    res = sharded_run(fault)
    assert res["attempted"] > 0 and not res["correct"]
