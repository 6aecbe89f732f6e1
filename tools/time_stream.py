#!/usr/bin/env python3
"""Time the serving path of a checkout, for comparing two trees on one card.

    python3 tools/time_stream.py [--root DIR] [--calls N]

Imports ``pcseg_tpu_torch`` from ``--root`` (default: this checkout), so
one copy of this script can time an unpacked other tree (``git archive``)
in turn with this one, each in its own process. Drives
``Segmenter.device_forward_stream`` on the cluttered VGA batch of
``chip_smoke.py`` (480x640, B = 8, frames jittered by <= 1 mm) at 32 and
64 slots: two warm-up calls, then N calls, each timed by CUDA events
around the call (it syncs inside, so the events read its wall time).
Prints one JSON line: the card's name and power limit, the root, and per
slot count the median and quartiles of the ms per call. Needs a CUDA card.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

import numpy as np


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--calls", type=int, default=15)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_stream: no CUDA card")
    import chip_smoke
    from pcseg_tpu_torch.kernels import build
    from pcseg_tpu_torch.models import config, pipeline

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    build.build_all()
    dev = torch.device("cuda")
    rays, origin, scenes = chip_smoke.vga_scenes()
    batch = torch.from_numpy(chip_smoke.make_batch(scenes["cluttered"], 1)) \
        .to(dev)
    rays_d = torch.from_numpy(rays).to(dev)
    origin_d = torch.from_numpy(np.asarray(origin)).to(dev)
    out = dict(card=card, root=root, calls=args.calls)
    for k in (32, 64):
        seg = pipeline.Segmenter(config.SegmenterConfig(
            planar=config.PlanarRegionConfig(max_regions=k)), device=dev)
        for _ in range(2):
            seg.device_forward_stream(batch, rays_d, origin_d)
        times = []
        for _ in range(args.calls):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            seg.device_forward_stream(batch, rays_d, origin_d)
            e.record()
            torch.cuda.synchronize()
            times.append(s.elapsed_time(e))
        q = statistics.quantiles(times, n=4)
        out[f"k{k}_ms"] = dict(median=statistics.median(times), q1=q[0],
                               q3=q[2])
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
