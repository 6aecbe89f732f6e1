#!/usr/bin/env python3
"""Time the grower's patched stage A and its word-step closure on the
card, eager and replayed.

    python3 tools/stage_a_time.py [--calls N]

For the benchmark's grower shapes (the first request of
``stream_cluttered``, ``stream_room``, ``frame_cluttered`` and
``stream_cartons_k64``: B = 8 and 1 at 32 slots, B = 8 at 64; VGA), builds
the grower's inputs as ``grow_planar_regions_batched`` does and times N
calls of stage A:

  * ``eager_host_ms``: the eager stage A (``_stage_a_patched``) on the
    host clock, synchronised after each call;
  * ``eager_device_ms``: CUDA events around the eager stage A launched
    behind a 0.5 s ``torch.cuda._sleep``, so the host runs ahead while
    the card sleeps (as far as the launch queue lets it: where it fills,
    this reads the host's pace, not the card's);
  * ``replay_device_ms``: CUDA events around the graph's ``run()`` alone,
    the stage's device time;
  * ``replay_host_ms``: the host's time to enqueue a replayed stage A
    (``_stage_a_replayed``: copies in, replay, copies out), unsynchronised.

At 32 slots the same four for the closure (``closure_*``: the eager
``_word_closure`` and the replayed ``_closure_replayed`` on stage A's
table; its ``run()`` holds the graphs and the B1 launches between them).
At 64 slots the closure takes the flood step and no graph.

Prints one JSON line per cell with medians and quartiles, beside the
card's name and power limit. Needs a CUDA card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELLS = ("stream_cluttered", "stream_room", "frame_cluttered",
         "stream_cartons_k64")


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2]}


def time_calls(torch, calls, eager, replayed, graph):
    """{eager_host_ms, eager_device_ms, replay_device_ms, replay_host_ms}:
    lists of ``calls`` readings (see the module docstring)."""
    times = {k: [] for k in ("eager_host_ms", "eager_device_ms",
                             "replay_device_ms", "replay_host_ms")}
    for _ in range(calls):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eager()
        torch.cuda.synchronize()
        times["eager_host_ms"].append((time.perf_counter() - t0) * 1e3)
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in "ab")
        torch.cuda._sleep(int(0.5 * 1.98e9))
        e0.record()
        eager()
        e1.record()
        torch.cuda.synchronize()
        times["eager_device_ms"].append(e0.elapsed_time(e1))
        e0.record()
        graph.run()
        e1.record()
        torch.cuda.synchronize()
        times["replay_device_ms"].append(e0.elapsed_time(e1))
        t0 = time.perf_counter()
        replayed()
        times["replay_host_ms"].append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    return {k: quartiles(v) for k, v in times.items()}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=9)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        sys.exit("stage_a_time: no CUDA card")
    from pcseg_tpu_torch.models import config
    from pcseg_tpu_torch.models import planar_batched as pb
    from pcseg_tpu_torch.ops import nansafe, normals, seeds
    from portbench.bench import spec
    from portbench.traffic import generate, scenes

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")

    def graph_of(stage, inputs):
        return next(g for k, g in pb._GRAPHS.items() if k[0] == stage
                    and k[2:2 + len(inputs)] == tuple(
                        (x.shape, x.dtype) for x in inputs))

    for name in CELLS:
        cell = spec.Cell(name)
        frame = cell.config["frame"]
        cfg = config.config_from_dict(cell.config["segmenter"])
        u16 = generate.pool(cell.mix, frame, cell.config["batch"],
                            20261018)[0]
        rays, _ = generate.rays_and_origin(frame)
        pts = torch.from_numpy(scenes.unproject_range_np(
            u16, rays, frame["depth_scale"])).to(dev)
        nrm = normals.compute_normals_organized(
            pts, torch.zeros(3, device=dev), cfg.normals)
        ranked = seeds.seeds_from_plane_support(pts, nrm,
                                                cfg.plane_support_seeds)
        # the grower's inputs with every cell unlabeled
        eligible0 = nansafe.all_finite(pts)
        rank_grid = torch.where(eligible0 & nansafe.all_finite(nrm),
                                ranked.rank_grid, pb.INF_RANK) \
            .to(torch.int32)
        inputs = (pts, nrm, eligible0, rank_grid)
        k_cap = cfg.planar.max_regions
        params = dict(k_cap=k_cap, tau=cfg.planar.max_plane_distance,
                      period=int(cfg.planar.plane_model_reestimation_period),
                      gens=13, rings=2)
        out = dict(card=card, cell=name, batch=pts.shape[0], k=k_cap,
                   calls=args.calls)
        pb._stage_a_patched(*inputs, **params)
        pb._stage_a_replayed(*inputs, **params)
        out.update(time_calls(
            torch, args.calls, lambda: pb._stage_a_patched(*inputs, **params),
            lambda: pb._stage_a_replayed(*inputs, **params),
            graph_of("stage_a", inputs)))
        if k_cap <= 32:
            table = tuple(pb._stage_a_patched(*inputs, **params))
            c_inputs = (*inputs, *table)
            c_params = dict(tau=params["tau"], period=params["period"],
                            flood_rounds=64, span=26,
                            size=max(pts.shape[1:3]), closure_epochs=2,
                            impl=None)
            pb._word_closure(*c_inputs, **c_params)
            pb._closure_replayed(*c_inputs, **c_params)
            closure = time_calls(
                torch, args.calls,
                lambda: pb._word_closure(*c_inputs, **c_params),
                lambda: pb._closure_replayed(*c_inputs, **c_params),
                graph_of("closure", c_inputs))
            out.update({"closure_" + k: v for k, v in closure.items()})
        out["memory_allocated_gb"] = torch.cuda.memory_allocated() / 1e9
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
