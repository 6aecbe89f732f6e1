"""Small cells for the CPU tests: the real cells' files at a size the CPU
runs in seconds."""

import glob
import os
import time

import torch

from portbench.bench import harness, spec

SMALL = dict(rows=48, cols=64, f=48.0)
# the four-card cell measured in PR 17 and left out of BENCHMARK.json
# (PERF.md §7): its files stay, its entry is here
SHARDED = dict(name="sharded_cluttered_4", config="vga_sharded_4",
               traffic="cluttered_robot", chips=4)


def sharded_cell() -> spec.Cell:
    """The sharded cell built from its files, as a BENCHMARK.json entry
    would name them."""
    here = spec.BENCH_DIR
    bench = spec.benchmark()
    per_layer = []
    for f in sorted(glob.glob(os.path.join(here, "layer_metrics",
                                           "*.sharded.json"))):
        name = os.path.basename(f)[:-len(".json")]
        per_layer.append(({"name": name, "unit": ""}, spec.load_json(f)))
    return spec.Cell.from_json(dict(
        name=SHARDED["name"], workload=SHARDED, chips=SHARDED["chips"],
        config=spec.load_json(os.path.join(here, "configs",
                                           "vga_sharded_4.json")),
        mix=spec.load_json(os.path.join(here, "mixes",
                                        "cluttered_robot.json")),
        end_to_end=[m for m in bench["end_to_end"]
                    if m["name"].startswith(("latency", "setup"))],
        per_layer=per_layer))


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
