"""Cells on more than one card: one rank per card, all started from the
one command.

``launch`` (the parent) builds the program's libraries once and starts
``run.py --rank R`` for every rank as torchrun starts its processes: the
environment RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT, and
``OMP_NUM_THREADS=1`` unless the caller set it. Each rank is bound to
CPUs of its own among those local to its card (``rank_cpus``). The
parent waits for each rank within ``RANK_TIMEOUT_S`` and merges what
they wrote into one result; a rank that fails ends the run with every
rank's log on standard error. Rank r runs on ``cuda:r``; rank 0 times
the requests and reads the per-layer metrics that need its process (the
program's recorder, the harness's spans); all ranks check their own
blocks against the reference. Every file goes to a directory under
``TMPDIR``, removed at the end.
"""

from __future__ import annotations

import importlib
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

from portbench.bench import harness

RANK_TIMEOUT_S = 330
LOG_TAIL = 6000


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_argv(args, rank: int, rank_dir: str, backend: str) -> list:
    argv = ["--workload", args.workload, "--seed", str(args.seed),
            "--seconds", str(args.seconds), "--trace", str(args.trace),
            "--rank", str(rank), "--rank-dir", rank_dir,
            "--rank-backend", backend]
    return argv + (["--control"] if args.control else [])


def parse_cpulist(text: str) -> list:
    """CPU numbers of a sysfs cpulist such as ``"0-7,16-23"``."""
    out = []
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def card_cpus(index: int):
    """The CPUs that sysfs lists as local to card ``index``, found by the
    card's PCI address; None where the address or the list cannot be
    read."""
    try:
        import torch
        p = torch.cuda.get_device_properties(index)
        addr = (f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:"
                f"{p.pci_device_id:02x}.0")
        with open(f"/sys/bus/pci/devices/{addr}/local_cpulist") as f:
            return parse_cpulist(f.read()) or None
    except (AssertionError, AttributeError, OSError, RuntimeError,
            ValueError):
        return None


def split(cpus: list, n: int) -> list:
    """``cpus`` in ``n`` contiguous runs of near-equal length."""
    return [cpus[j * len(cpus) // n:(j + 1) * len(cpus) // n]
            for j in range(n)]


def rank_cpus(n: int, local: list, allowed) -> list:
    """Disjoint, non-empty CPU sets for ranks 0..n-1, or None where the
    CPUs allowed are fewer than the ranks. ``local[r]`` lists the CPUs
    local to rank r's card (None if unknown): the ranks whose cards list
    the same CPUs share them out. Where a list is unknown, or the shares
    would overlap or leave a rank none, the allowed CPUs are split
    evenly instead."""
    allowed = set(allowed)
    if len(allowed) < n:
        return None
    if all(local):
        nodes = {}
        for r in range(n):
            key = tuple(sorted(set(local[r]) & allowed))
            nodes.setdefault(key, []).append(r)
        out = [None] * n
        for cpus, ranks in nodes.items():
            for r, share in zip(ranks, split(list(cpus), len(ranks))):
                out[r] = set(share)
        if all(out) and sum(map(len, out)) == len(set().union(*out)):
            return out
    return [set(c) for c in split(sorted(allowed), n)]


def launch(cell, args, started, backend="nccl", command=None) -> dict:
    """Run the cell's ranks and return the merged result dict.
    ``command`` is the program that runs one rank (default: this
    checkout's ``portbench/run.py``)."""
    n = cell.config["ranks"]
    started_wall = time.time() - (time.perf_counter() - started)
    if backend == "nccl":
        from pcseg_tpu_torch import native
        from pcseg_tpu_torch.kernels import build
        build.build_all()
        native.load_hostops()
    command = command or [sys.executable, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "run.py")]
    rank_dir = tempfile.mkdtemp(prefix="portbench-ranks-")
    with open(os.path.join(rank_dir, "cell.json"), "w") as f:
        json.dump(cell.to_json(), f)
    # NCCL_SHM_DISABLE: no segments under /dev/shm (the cards talk over
    # NVLink peer to peer)
    env = dict(os.environ, WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               NCCL_SHM_DISABLE="1")
    env.setdefault("OMP_NUM_THREADS", "1")
    mine = os.sched_getaffinity(0)
    cpus = rank_cpus(n, [card_cpus(r) if backend == "nccl" else None
                         for r in range(n)], mine)
    harness.log(f"ranks' CPUs: {[sorted(c) for c in cpus or ()]}")
    logs = [os.path.join(rank_dir, f"rank{r}.log") for r in range(n)]
    procs = []
    try:
        for r in range(n):
            # the child inherits this thread's CPUs from its first
            # instruction on
            if cpus:
                os.sched_setaffinity(0, cpus[r])
            try:
                with open(logs[r], "w") as log:
                    procs.append(subprocess.Popen(
                        command + rank_argv(args, r, rank_dir, backend),
                        env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                        stdout=log, stderr=subprocess.STDOUT))
            finally:
                os.sched_setaffinity(0, mine)
        deadline = time.monotonic() + RANK_TIMEOUT_S
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    try:
        bad = [r for r, p in enumerate(procs) if p.returncode != 0]
        if bad:
            for r, path in enumerate(logs):
                with open(path) as f:
                    print(f"--- rank {r} (exit {procs[r].returncode}) ---\n"
                          + f.read()[-LOG_TAIL:], file=sys.stderr,
                          flush=True)
            raise SystemExit(f"portbench: ranks {bad} of {n} failed")
        with open(logs[0]) as f:
            sys.stderr.write(f.read()[-LOG_TAIL:])
        outs = []
        for r in range(n):
            with open(os.path.join(rank_dir, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    finally:
        shutil.rmtree(rank_dir, ignore_errors=True)
    return merge(cell, outs, started_wall)


def merge(cell, outs: list, started_wall: float) -> dict:
    """The result of the ranks' reports: times from rank 0, set-up from
    the launch to rank 0's window, the check over every rank's blocks,
    the memory peak of the fullest card; the per-layer metrics that
    need rank 0's process as it read them, the others from its
    profile."""
    found = sorted({m for o in outs for m in o["forbidden"]})
    if found:
        raise SystemExit(f"portbench: forbidden modules loaded in a rank: "
                         f"{found}")
    lead = outs[0]
    setup_s = lead["window_opened_wall"] - started_wall
    values = {}
    for o in outs:
        for k, v in o["values"].items():
            values[k] = max(values.get(k, v), v) if k in o["gaps"] \
                else values.get(k, 0) + v
    # every rank must have compared its blocks
    compared = sum(o["compared"] for o in outs) \
        if all(o["compared"] for o in outs) else 0
    correct, judged = harness.judge(values, compared, cell.config["limits"])
    win = (lead["opened"], lead["closed"], [tuple(r) for r in
                                            lead["records"]])
    if lead["layer"] is None:
        values_out = harness.metrics(cell, False, win, None, setup_s,
                                     lead["points_per_request"])
    else:
        ctx = harness.Context()
        ctx.profile = lead["profile"]
        got = dict(lead["layer"], **harness.per_layer(
            cell, ctx, lambda m: not harness.in_process(m)))
        values_out = {m["name"]: got[m["name"]] for m, _ in cell.per_layer
                      if m["name"] in got}
    # the parent holds no CUDA context: rank 0 names the card
    return harness.result(cell, lead["kind"], correct, len(win[2]),
                          values_out, max(o["peak"] for o in outs),
                          lead["profile"], judged)


def rank_main(args):
    """One rank: join the group, set up, measure in step with the other
    ranks (rank 0 decides when the window closes), check this rank's
    blocks, write ``rank<R>.json``. The cell is the launcher's
    ``cell.json``."""
    import torch
    from portbench.bench.spec import Cell
    from portbench.bench.guard import forbidden_modules
    from portbench.paths.common import PROGRAM, REFERENCE
    from portbench.paths.sharded import Path

    with open(os.path.join(args.rank_dir, "cell.json")) as f:
        cell = Cell.from_json(json.load(f))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    program = REFERENCE if args.control else PROGRAM
    dist_mod = importlib.import_module(
        f"{PROGRAM}.parallel.distributed")
    backend = args.rank_backend
    dist_mod.initialize(backend, timeout_s=RANK_TIMEOUT_S)
    device = "cpu" if backend == "gloo" else None
    comm = dist_mod.make_group(device=device)
    if program != PROGRAM:
        halo = importlib.import_module(f"{program}.parallel.halo")
        comm = halo.Comm(None, device=comm.device)
    path = Path(torch, cell, args.seed, comm.device, program, comm)
    if args.control:
        from portbench.reference.control import Control
        path = Control(path)
    path.setup()
    harness.sync(torch, comm.device)
    torch.distributed.barrier()
    opened_wall = time.time()
    flag = torch.zeros(1, dtype=torch.int32, device=comm.device)

    def keep_going(go):
        flag.fill_(int(go))
        torch.distributed.broadcast(flag, src=0)
        return bool(flag.item())

    win, kept, ctx, peak = harness.measure(
        torch, path, cell, args.seconds, bool(args.trace), comm.device,
        keep_going, profile_here=comm.rank == 0)
    layer = None
    if comm.rank == 0:
        harness.log(f"window: {len(win[2])} steps in "
                    f"{win[1] - win[0]:.3f} s on rank 0")
        if args.trace:
            layer = harness.per_layer(cell, ctx, harness.in_process)
    t = harness.check(torch, path, kept)
    out = dict(
        forbidden=forbidden_modules(), window_opened_wall=opened_wall,
        opened=win[0], closed=win[1], records=win[2],
        points_per_request=path.points_per_request, layer=layer,
        profile=ctx.profile, values=t.values, gaps=sorted(t.gaps),
        compared=t.compared, peak=peak,
        kind=harness.device_kind(torch, comm.device))
    torch.distributed.barrier()
    with open(os.path.join(args.rank_dir, f"rank{comm.rank}.json"),
              "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()
