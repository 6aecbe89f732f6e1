#!/usr/bin/env python3
"""Time the mean shift's fixed point on the card (kernel M1) beside its
plain version and the host-ops library's shift, and the library's growth.

    python3 tools/mean_shift_time.py [--calls N] [--seed S]

On the first frames of the ``frame_objects_mean_shift`` cell's mix (VGA,
from ``--seed``), from the planar finalize's labels (the grid the
pipeline's mean shift starts from), times N calls of:

  * ``m1_ms``: CUDA events around one call of the kernel's wrapper;
  * ``m1_of_10_ms``: CUDA events around 10 calls back to back, over 10;
  * ``plain_ms``: the plain version on the card, synchronised;
  * ``host_shift_ms``: the library's ``pcseg_mean_shift_shift``;
  * ``grow_ms``: the library's ``pcseg_mean_shift_grow`` on those modes;
  * ``modes_ms``: the pipeline's whole shift on the card as the finalize
    runs it (labels up, one launch, the state back to the host);

checks that the three shifts write the same bytes, and prints one JSON
line a frame with medians and quartiles, the seeds, valid modes and
regions, and the kernel's least time (41 B a pixel at 3.35 TB/s), beside
the card's name and power limit. Needs a CUDA card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "frame_objects_mean_shift"


def quartiles(xs):
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "q1": q[0], "q3": q[2]}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--calls", type=int, default=7)
    parser.add_argument("--seed", type=int, default=2 ** 31 + 25)
    parser.add_argument("--frames", type=int, default=2)
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    import dataclasses

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        sys.exit("mean_shift_time: no CUDA card")
    from pcseg_tpu_torch import native
    from pcseg_tpu_torch.kernels import mean_shift_modes as m1
    from pcseg_tpu_torch.models import config, mean_shift, pipeline
    from portbench.bench import roofline, spec
    from portbench.traffic import generate, scenes

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cell = spec.Cell(CELL)
    frame = cell.config["frame"]
    cfg = config.config_from_dict(cell.config["segmenter"])
    p = cfg.mean_shift
    lib = native.load_hostops()
    planar = pipeline.Segmenter(dataclasses.replace(cfg,
                                                    run_clustering=False),
                                device=dev)
    rays, origin = generate.rays_and_origin(frame)
    pool = generate.pool(cell.mix, frame, 1, args.seed)
    for i in range(args.frames):
        pts = scenes.unproject_range_np(pool[i][0], rays,
                                        frame["depth_scale"])
        labels = np.ascontiguousarray(
            planar.segment_frame(pts, origin).labels, np.int32)
        h, w = labels.shape
        n = h * w
        pts_d = torch.from_numpy(pts).to(dev)
        lab_d = torch.from_numpy(labels).to(dev)
        iterations = cfg.mean_shift_iterations

        def kernel(impl=None):
            return m1.mean_shift_modes(pts_d, lab_d, iterations, p,
                                       impl=impl)

        occ = np.ascontiguousarray(np.isfinite(pts).all(-1)
                                   .astype(np.uint8))
        cells = np.ascontiguousarray(np.nan_to_num(pts, nan=0.0))
        host_buf = np.empty(m1.BYTES_PER_PIXEL * n, np.uint8)
        state = m1.unpack(host_buf, n)

        def host_shift():
            lib.pcseg_mean_shift_shift(
                mean_shift._ptr(cells), mean_shift._ptr(occ), h, w,
                iterations, p.half_search_window,
                p.square_distance_threshold, p.min_support,
                config.UNLABELED, mean_shift._ptr(labels),
                *mean_shift._state_ptrs(state))

        def grow():
            out = labels.copy()
            return lib.pcseg_mean_shift_grow(
                mean_shift._ptr(cells), mean_shift._ptr(occ), h, w,
                *mean_shift._state_ptrs(state),
                p.squared_centroid_distance_threshold,
                p.squared_neighbor_distance_threshold,
                cfg.cluster.min_region_inliers, config.UNLABELED, 0,
                mean_shift._ptr(out))

        def modes():
            return mean_shift._device_modes(pts_d, pts, labels, iterations,
                                            p, dev, None)

        got = kernel().cpu().numpy()
        same_plain = bool(np.array_equal(got, kernel("plain").cpu().numpy()))
        host_shift()
        same_host = bool(np.array_equal(got, host_buf))
        times = {k: [] for k in ("m1_ms", "m1_of_10_ms", "plain_ms",
                                 "host_shift_ms", "grow_ms", "modes_ms")}
        regions = 0
        for _ in range(args.calls):
            e = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            torch.cuda.synchronize()
            e[0].record()
            kernel()
            e[1].record()
            for _ in range(10):
                kernel()
            e[2].record()
            torch.cuda.synchronize()
            times["m1_ms"].append(e[0].elapsed_time(e[1]))
            times["m1_of_10_ms"].append(e[1].elapsed_time(e[2]) / 10)
            for key, fn in (("plain_ms", lambda: kernel("plain")),
                            ("host_shift_ms", host_shift),
                            ("grow_ms", grow), ("modes_ms", modes)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                times[key].append((time.perf_counter() - t0) * 1e3)
                if key == "grow_ms":
                    regions = out
        least = roofline.least_seconds((16 + 25) * n) * 1e3
        print(json.dumps(dict(
            card=card, cell=CELL, frame=i, seed=args.seed, calls=args.calls,
            seeds=int(np.count_nonzero(occ.astype(bool)
                                       & (labels == config.UNLABELED))),
            valid_modes=int(state.valid.sum()), regions=int(regions),
            same_as_plain=same_plain, same_as_host=same_host,
            least_ms=least,
            **{k: quartiles(v) for k, v in times.items()})), flush=True)
        if not (same_plain and same_host):
            sys.exit("mean_shift_time: the shifts disagree")


if __name__ == "__main__":
    main()
