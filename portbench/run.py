#!/usr/bin/env python3
"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell is the ``workloads`` entry NAME of ``BENCHMARK.json``; its
configuration, traffic mix and per-layer metrics are files under
``portbench/`` found by name. The run makes its inputs from the seed,
builds and warms up the program (``pcseg_tpu_torch``), measures a closed
loop for S seconds, checks every output of the sampled pool requests
against the plain reference (``portbench/reference``) and prints one JSON
line last: the end-to-end metrics with ``--trace 0``, the per-layer
metrics and the device's busy and window seconds with ``--trace 1``. Each
number compared is printed beside its limit as the last lines on standard
error and under ``check`` in the line. A cell on more than one card starts
one rank per card from this command.

Needs NVIDIA cards, as many as the cell asks for: without them it exits 2
and prints no result. ``--control`` puts the reference, in the precision
below the one the configuration states, in the program's place (the
control's runs, never the benchmark's).
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    p.add_argument("--rank", type=int, default=None,
                   help=argparse.SUPPRESS)  # set by the rank launcher
    p.add_argument("--rank-dir", default=None, help=argparse.SUPPRESS)
    p.add_argument("--rank-backend", default="nccl", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def fail(msg, code=2):
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def finish(res: dict):
    """Fail if JAX or the JAX package was loaded; else print each number
    compared beside its limit on stderr and the result line last."""
    from portbench.bench.guard import forbidden_modules
    found = forbidden_modules()
    if found:
        fail(f"forbidden modules loaded in this process: {found}", 3)
    for name, j in res["check"].items():
        print(f"check {name}: {j['value']} (limit {j['limit']})",
              file=sys.stderr, flush=True)
    print(json.dumps(res), flush=True)


def main(argv=None):
    args = parse(argv)
    if args.rank is not None:
        from portbench.bench import ranks
        ranks.rank_main(args)
        return
    from portbench.bench import spec
    cell = spec.Cell(args.workload)
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: the benchmark needs "
             "NVIDIA cards")
    if torch.cuda.device_count() < cell.chips:
        fail(f"the cell needs {cell.chips} cards, "
             f"{torch.cuda.device_count()} found")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cell.chips > 1:
        from portbench.bench import ranks
        finish(ranks.launch(cell, args, STARTED))
        return
    from portbench.bench import harness
    from portbench.paths.common import PROGRAM, REFERENCE
    from pcseg_tpu_torch import native
    from pcseg_tpu_torch.kernels import build
    build.build_all()
    native.load_hostops()
    wrap = None
    if args.control:
        from portbench.reference.control import Control
        wrap = Control
    finish(harness.run(torch, cell, args.seed, args.seconds,
                       bool(args.trace), "cuda:0", STARTED,
                       REFERENCE if args.control else PROGRAM, wrap))


if __name__ == "__main__":
    main()
