"""The control, the reference in the program's place with its moment
sums in float32 (the precision below the stated float64), comes out not
correct; at this size it fails ``plane_gap``. On the card it is run at
the cells' own sizes (``run.py --control``)."""

import pytest

from portbench.paths.common import REFERENCE
from portbench.reference.control import Control
from portbench.tests.helpers import run_small, small_cell
from portbench.tests.test_portbench_faults import sharded_run


@pytest.mark.parametrize("workload,kw", [
    ("stream_cluttered", dict(batch=2)), ("stream_room", dict(batch=2)),
    ("stream_cartons_k64", dict(batch=2)),
    ("frame_cluttered", dict(pool=2))])
def test_control_is_not_correct(workload, kw):
    res = run_small(small_cell(workload, **kw), seed=1, seconds=1.5,
                    program=REFERENCE, wrap=Control)
    assert res["attempted"] > 0 and not res["correct"]
    assert res["check"]["plane_gap"]["value"] > \
        res["check"]["plane_gap"]["limit"]


def test_sharded_control_is_not_correct():
    res = sharded_run("none", control=True)
    assert not res["correct"]
