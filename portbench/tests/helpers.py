"""Small cells for the CPU tests: the real cells' files at a size the CPU
runs in seconds."""

import json
import os
import time

import torch

from portbench.bench import harness, spec

SMALL = dict(rows=48, cols=64, f=48.0)
# the four-card cell is left out of BENCHMARK.json (PERF.md section 7):
# its entries are in sharded_cluttered_4.json beside this file
ENTRIES = spec.load_json(os.path.join(os.path.dirname(__file__),
                                      "sharded_cluttered_4.json"))
SHARDED = ENTRIES["workload"]


def sharded_cell() -> spec.Cell:
    """The sharded cell from its entries and files, as BENCHMARK.json
    would name them."""
    here = spec.BENCH_DIR
    bench = spec.benchmark()
    return spec.Cell.from_json(dict(
        name=SHARDED["name"], workload=SHARDED, chips=SHARDED["chips"],
        config=spec.load_json(os.path.join(spec.ROOT,
                                           ENTRIES["config"]["file"])),
        mix=spec.load_json(os.path.join(here, "mixes",
                                        SHARDED["traffic"] + ".json")),
        end_to_end=[m for m in bench["end_to_end"]
                    if m["name"] in ENTRIES["end_to_end"]],
        per_layer=[(m, spec.load_json(os.path.join(
            here, "layer_metrics", m["name"] + ".json")))
            for m in ENTRIES["per_layer"]]))


def with_sharded(bench: dict) -> dict:
    """A copy of ``bench`` with the sharded cell's entries added."""
    out = json.loads(json.dumps(bench))
    out["configs"].append(ENTRIES["config"])
    out["workloads"].append(SHARDED)
    for m in out["end_to_end"]:
        if m["name"] in ENTRIES["end_to_end"] and "workloads" in m:
            m["workloads"].append(SHARDED["name"])
    out["per_layer"] += ENTRIES["per_layer"]
    return out


def small_cell(workload, batch=None, pool_items=2, pool=None, ranks=None):
    cell = sharded_cell() if workload == SHARDED["name"] \
        else spec.Cell(workload)
    cell.config["frame"] = dict(cell.config["frame"], **SMALL)
    if batch is not None:
        cell.config["batch"] = batch
    if ranks is not None:
        cell.config["ranks"] = ranks
    if pool is not None:
        cell.mix["pool"] = pool
    cell.config["check"]["pool_items"] = pool_items
    return cell


def run_small(cell, seed=2 ** 31 + 3, seconds=1.0, **kw):
    return harness.run(torch, cell, seed, seconds, False, "cpu",
                       time.perf_counter(), **kw)
