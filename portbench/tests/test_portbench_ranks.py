"""The rank launcher: rank 0's readings of the program's recorder reach
the result of a multi-rank run, each rank gets CPUs of its own, and the
one-card cells read what they read before the launcher carried rank 0's
readings."""

import pytest

from portbench.bench import harness, ranks, spec
from portbench.tests.helpers import sharded_cell
from portbench.tests.test_portbench_faults import sharded_run

# each one-card cell's per-layer metrics and their readers, as the
# benchmark had them before normal_support_roofline
ONE_CARD = dict(
    normals_ms="span_ms", seeds_ms="span_ms", grower_ms="span_ms",
    clusters_ms="span_ms", kernels_roofline="roofline_pct",
    epoch_word_roofline="roofline_pct", ccl_gated_roofline="roofline_pct",
    device_idle_pct="idle_pct", device_events="device_events",
    host_syncs="program_trace", sync_wait_ms="program_trace",
    grower_epochs="program_trace", grower_stage_a_ms="program_trace",
    grower_closure_ms="program_trace", grower_tail_ms="program_trace")


def test_a_traced_two_rank_run_carries_rank_0s_readings():
    """gloo, both ranks on the CPU: nothing is profiled, so the device
    readers find nothing; the program's spans and counters read on
    rank 0 are in the result."""
    res = sharded_run("none", trace=1)
    assert res["correct"] and res["attempted"] > 0
    got = {k: v["value"] for k, v in res["metrics"].items()}
    for name in ("grower_ms.sharded", "comm_ms.sharded",
                 "host_syncs.sharded", "normals_ms.sharded",
                 "grower_closure_ms.sharded", "grower_epochs.sharded"):
        assert got[name] > 0, name
    assert got["comm_gathers.sharded"] == int(got["comm_gathers.sharded"])
    assert got["comm_gathers.sharded"] > 0
    cell = sharded_cell()
    assert set(got) == {m["name"] for m, _ in cell.per_layer
                        if harness.in_process(m)}
    assert list(got) == [m["name"] for m, _ in cell.per_layer
                         if m["name"] in got]


def test_cpulists_parse():
    assert ranks.parse_cpulist("0-3,8,10-11\n") == [0, 1, 2, 3, 8, 10, 11]
    assert ranks.parse_cpulist("") == []


@pytest.mark.parametrize("local,want", [
    # two cards on each of two nodes
    ([range(0, 16)] * 2 + [range(16, 32)] * 2,
     [range(0, 8), range(8, 16), range(16, 24), range(24, 32)]),
    # one node holds every card
    ([range(32)] * 4, [range(0, 8), range(8, 16), range(16, 24),
                       range(24, 32)]),
    # no card's list known: an even split of the allowed CPUs
    ([None] * 4, [range(0, 8), range(8, 16), range(16, 24),
                  range(24, 32)]),
    # lists that overlap without matching: the even split
    ([range(0, 20), range(0, 20), range(12, 32), range(12, 32)],
     [range(0, 8), range(8, 16), range(16, 24), range(24, 32)]),
])
def test_rank_cpus_are_disjoint_and_near_the_card(local, want):
    got = ranks.rank_cpus(4, local, range(32))
    assert got == [set(w) for w in want]
    assert all(got) and len(set().union(*got)) == sum(map(len, got))


def test_rank_cpus_keep_to_the_allowed_cpus():
    # the node's CPUs that the launcher may not use are left out
    got = ranks.rank_cpus(2, [range(0, 16)] * 2, range(4, 12))
    assert got == [set(range(4, 8)), set(range(8, 12))]
    # a node whose allowed CPUs are fewer than its ranks: the even split
    got = ranks.rank_cpus(4, [[0], [0], [1], [1]], range(8))
    assert got == [{0, 1}, {2, 3}, {4, 5}, {6, 7}]
    assert ranks.rank_cpus(4, [None] * 4, range(3)) is None


def test_without_a_card_sysfs_gives_nothing():
    """No card here: the PCI address cannot be read, so the launcher
    falls back to the even split."""
    assert ranks.card_cpus(0) is None
    assert ranks.rank_cpus(2, [ranks.card_cpus(r) for r in range(2)],
                           range(4)) == [{0, 1}, {2, 3}]


@pytest.mark.parametrize("workload", ["stream_cluttered", "frame_cluttered",
                                      "stream_room"])
def test_one_card_cells_keep_their_readers(workload):
    cell = spec.Cell(workload)
    suffix = cell.per_layer[0][0]["name"].split(".")[1]
    want = {f"{k}.{suffix}": r for k, r in ONE_CARD.items()}
    if suffix == "frame":
        want["host_finalize_ms.frame"] = "span_ms"
    want[f"normal_support_roofline.{suffix}"] = "roofline_pct"
    assert {m["name"]: s["reader"] for m, s in cell.per_layer} == want
    for m, s in cell.per_layer:
        assert harness.in_process(m) == (s["reader"] in ("span_ms",
                                                         "program_trace"))
