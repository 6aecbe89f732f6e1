"""The command itself: no result without a card (no fallback to the
CPU), nor in a directory that holds only the benchmark's files; on a card
(marked ``cuda``) one short run of each one-card cell is correct and
names the card."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.bench import spec

RUN = os.path.join(spec.BENCH_DIR, "run.py")


def run(root, *args, timeout=600):
    return subprocess.run(
        [sys.executable, os.path.join(root, "portbench", "run.py"), *args],
        cwd=root, capture_output=True, text=True, timeout=timeout)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = run(spec.ROOT, "--workload", "stream_cluttered", "--seed",
            str(2 ** 31 + 1), "--seconds", "1", "--trace", "0")
    assert p.returncode == 2 and p.stdout == ""
    assert "needs NVIDIA cards" in p.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = run(str(tmp_path), "--workload", "frame_cluttered", "--seed", "7",
            "--seconds", "1", "--trace", "0")
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [
    w["name"] for w in spec.benchmark()["workloads"] if w["chips"] == 1])
def test_a_short_run_on_the_card(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    p = run(spec.ROOT, "--workload", workload, "--seed", str(2 ** 31 + 21),
            "--seconds", "3", "--trace", "1")
    assert p.returncode == 0, p.stderr[-4000:]
    res = json.loads(p.stdout.splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert res["device"]["kind"] == torch.cuda.get_device_name(0)
    assert res["device"]["busy_s"] > 0 and res["metrics"]
    assert list(res)[-1] == "check"
