"""BENCHMARK.json against the contract's shape, and every cell, metric
and configuration found by name, so that one more file and entry make one
more cell with no edit."""

import dataclasses
import importlib
import json
import os
import re
import shutil

import pytest

from portbench.bench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells fits into 43,200 s
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_units_and_keys(kind):
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}[kind]
    names = [e["name"] for e in BENCH[kind]]
    assert len(names) == len(set(names))
    for e in BENCH[kind]:
        assert NAME.match(e["name"]), e["name"]
        assert set(e) - {"workloads"} == keys, e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower",
                                                              "higher")
        for k in ("why", "layer", "source"):
            if k in e:
                assert 1 <= len(e[k]) <= 200 and "\n" not in e[k]


def test_cells_and_metrics_cover_each_other():
    wl = {w["name"]: w for w in BENCH["workloads"]}
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert {c["name"] for c in BENCH["configs"]} == \
        {w["config"] for w in BENCH["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in wl.values()}) == len(wl)
    four = [w for w in wl.values() if w["chips"] == 4]
    assert len(four) <= max(1, len(wl) // 4)
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for name in wl:
        reports = [m for m in e2e.values() if spec.applies(m, name)]
        assert len(reports) >= 2 and e2e["setup_s"] in reports
        assert any(spec.applies(m, name) for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            assert spec.applies(e2e[m["moves"]], w), (m["name"], w)
        if m["unit"] == "%" and "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline")


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves(workload):
    cell = spec.Cell(workload)
    cfg = cell.config
    importlib.import_module(f"portbench.paths.{cfg['entry']}")
    assert cfg["ranks"] == cell.chips
    assert set(cfg["limits"]) == set(importlib.import_module(
        f"portbench.paths.{cfg['entry']}").Path.tally().values)
    for _, s in cell.per_layer:
        importlib.import_module(f"portbench.readers.{s['reader']}")
        for k in s.get("kernels", ()):
            mod = importlib.import_module(f"portbench.kernels.{k}")
            assert mod.WRAPPER.startswith("pcseg_tpu_torch.")


def test_every_file_resolves():
    """Every configuration, mix and metric file parses and names what
    exists, and every metric file is a per-layer entry's, those of the
    sharded cell, which no BENCHMARK.json entry names yet, included."""
    from portbench.tests.helpers import ENTRIES, sharded_cell
    entries = {m["name"] for m in BENCH["per_layer"] + ENTRIES["per_layer"]}
    for f in os.listdir(os.path.join(spec.BENCH_DIR, "layer_metrics")):
        s = spec.load_json(os.path.join(spec.BENCH_DIR, "layer_metrics", f))
        importlib.import_module(f"portbench.readers.{s['reader']}")
        assert f[:-len(".json")] in entries, f
    for f in os.listdir(os.path.join(spec.BENCH_DIR, "mixes")):
        m = spec.load_json(os.path.join(spec.BENCH_DIR, "mixes", f))
        assert m["loop"] == "closed" and m["pool"] > 0
    cell = sharded_cell()
    assert cell.config["ranks"] == cell.chips == 4
    assert set(cell.config["limits"]) == set(importlib.import_module(
        "portbench.paths.sharded").Path.tally().values)


def field(obj, path):
    for part in path:
        assert dataclasses.is_dataclass(obj) and part in {
            f.name for f in dataclasses.fields(obj)}, ".".join(path)
        obj = getattr(obj, part)
    return obj


def replaced(obj, path, value):
    head, *rest = path
    return dataclasses.replace(obj, **{
        head: replaced(getattr(obj, head), rest, value) if rest else value})


def check_config_files(bench_dir, bench):
    """Every configuration file runs the port's defaults except exactly
    in the keys its ``changed`` declares (``spec.py``'s rule), each a
    field of the port's configuration that differs from its default;
    nothing is cut."""
    from pcseg_tpu_torch.models import config
    files = {c["file"]: c for c in bench["configs"]}
    for f in os.listdir(os.path.join(bench_dir, "configs")):
        d = spec.load_json(os.path.join(bench_dir, "configs", f))
        c = files.get(f"portbench/configs/{f}", {"reduced": []})
        assert d["reduced"] == c["reduced"] == []
        run = config.config_from_dict(d["segmenter"])
        want = config.SegmenterConfig()
        for key, why in d.get("changed", {}).items():
            path = key.split(".")
            assert isinstance(why, str) and why, key
            assert field(run, path) != field(want, path), (f, key)
            want = replaced(want, path, field(run, path))
        assert run == want, f


def test_config_files_state_the_run():
    check_config_files(spec.BENCH_DIR, BENCH)
    for f in ("vga_stream_b8", "vga_frame", "vga_sharded_4"):
        assert "changed" not in spec.load_json(os.path.join(
            spec.BENCH_DIR, "configs", f + ".json"))


@pytest.mark.parametrize("slots,changed,holds", [
    (64, None, False),
    (64, {"planar.max_regions": "64 slots"}, True),
    (32, {"planar.max_regions": "32 slots"}, False),
    (32, {"planar.max_slots": "64 slots"}, False)],
    ids=["undeclared", "declared", "equal_to_default", "names_no_field"])
def test_a_config_changes_only_what_it_declares(tmp_path, slots, changed,
                                                holds):
    """A copy of the benchmark whose stream configuration is edited: a
    difference from the port's defaults holds only where ``changed``
    declares it, on a real field and away from its default."""
    bench_dir = tmp_path / "portbench"
    shutil.copytree(spec.BENCH_DIR, bench_dir,
                    ignore=shutil.ignore_patterns("__pycache__"))
    f = bench_dir / "configs" / "vga_stream_b8.json"
    d = spec.load_json(str(f))
    d["segmenter"]["planar"]["max_regions"] = slots
    if changed is not None:
        d["changed"] = changed
    f.write_text(json.dumps(d))
    if holds:
        check_config_files(str(bench_dir), BENCH)
    else:
        with pytest.raises(AssertionError):
            check_config_files(str(bench_dir), BENCH)


def test_a_new_mix_file_is_a_new_cell(tmp_path):
    """A later change adds a mix file and a workloads entry; the harness
    finds both without an edit."""
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    mix = spec.load_json(os.path.join(spec.BENCH_DIR, "mixes",
                                      "cluttered_cameras.json"))
    mix["cameras"] = 2
    (root / "portbench" / "mixes" / "two_cameras.json").write_text(
        json.dumps(mix))
    bench["workloads"].append(dict(name="stream_two", config="vga_stream_b8",
                                   traffic="two_cameras", chips=1, why="x"))
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m and "stream_cluttered" in m["workloads"]:
            m["workloads"].append("stream_two")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell("stream_two", root=str(root))
    assert cell.mix["cameras"] == 2
    assert {m["name"] for m, _ in cell.per_layer} == \
        {m["name"] for m, _ in spec.Cell("stream_cluttered").per_layer}


def test_the_sharded_entries_make_a_cell(tmp_path):
    """The sharded cell's entries, added to BENCHMARK.json, make the cell
    that the tests build from them, and each per-layer metric's cells
    report the end-to-end metric it moves."""
    from portbench.tests.helpers import SHARDED, sharded_cell, with_sharded
    bench = with_sharded(BENCH)
    for kind in ("configs", "workloads", "per_layer"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names)) and all(map(NAME.match, names))
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        for w in m["workloads"]:
            assert spec.applies(e2e[m["moves"]], w), (m["name"], w)
    root = tmp_path / "checkout"
    shutil.copytree(spec.BENCH_DIR, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.Cell(SHARDED["name"], root=str(root))
    want = sharded_cell()
    assert cell.config == want.config and cell.chips == 4
    assert [m["name"] for m in cell.end_to_end] == \
        [m["name"] for m in want.end_to_end]
    assert cell.per_layer == want.per_layer
