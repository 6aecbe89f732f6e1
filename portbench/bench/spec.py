"""``BENCHMARK.json`` and the files it names, found by name.

A cell (``workloads`` entry) names a configuration and a traffic mix. The
configuration's ``file`` holds its sizes and entry
(``portbench/configs/<name>.json``), the mix is
``portbench/mixes/<traffic>.json``, and every per-layer metric is
``portbench/layer_metrics/<metric>.json``. Adding a file and an entry adds
a cell or a metric; nothing here changes.

A configuration runs the port's defaults (``SegmenterConfig()``) except
in the keys its optional ``"changed"`` object declares: each key a dotted
path into ``segmenter`` (``"planar.max_regions"``) that names a field of
the port's configuration and differs from that field's default, each
value the reason. Every other key of ``segmenter`` holds its default, and
``reduced`` stays empty: nothing is cut.
"""

from __future__ import annotations

import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """Everything one run of ``workload`` needs, read from the files."""

    FIELDS = ("name", "workload", "config", "mix", "chips", "end_to_end",
              "per_layer")

    def __init__(self, workload: str, root: str = ROOT):
        bench = benchmark(root)
        self.root = root
        self.workload = named(bench["workloads"], workload, "workload")
        self.name = workload
        entry = named(bench["configs"], self.workload["config"], "config")
        self.config = load_json(os.path.join(root, entry["file"]))
        here = os.path.join(root, os.path.basename(BENCH_DIR))
        self.mix = load_json(os.path.join(
            here, "mixes", self.workload["traffic"] + ".json"))
        self.chips = int(self.workload["chips"])
        self.end_to_end = [m for m in bench["end_to_end"]
                           if applies(m, workload)]
        self.per_layer = []
        for m in bench["per_layer"]:
            if applies(m, workload):
                spec = load_json(os.path.join(here, "layer_metrics",
                                              m["name"] + ".json"))
                self.per_layer.append((m, spec))

    def to_json(self) -> dict:
        return {k: getattr(self, k) for k in self.FIELDS}

    @classmethod
    def from_json(cls, d: dict) -> "Cell":
        """The cell the rank launcher hands its ranks."""
        cell = cls.__new__(cls)
        for k in cls.FIELDS:
            setattr(cell, k, d[k])
        cell.per_layer = [tuple(x) for x in cell.per_layer]
        return cell
