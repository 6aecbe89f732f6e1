#!/usr/bin/env python3
"""Where the time of the persistent flood kernels goes, phase by phase.

    python3 tools/kernel_phases.py

Builds instrumented copies of ``pcseg_tpu_torch/csrc`` into
``build/kernel_phases/`` (block 0's thread 0 reads the device's
``%globaltimer`` at the kernel's start, after every grid sync and at its
end), swaps them in for the wrappers' libraries, and prints one JSON line
per case: the microseconds between stamps, in order. For ``epoch_word``
(B1) they are the prelude, then a row pass and a column pass per flood
round, then the claims and the finalize; for ``flood_packed`` (B3) the
flags' reset, then a row and a column pass per round. Each gap includes
the grid sync that ends it; one line gives the cost of a bare grid sync.
The cases are the first closure epoch of the 32-slot VGA stream (room
scene, B = 8, captured from a plain run) at caps 64 and 1 and with no slot
alive, the first flood of the 64-slot stream (cluttered scene, N = 16 word
planes, and its first 2), one staircase plane at cap 64, and 16 staircase
planes that stop on their own after 95 to 470 rounds against 16 that all
need 470 (what a whole-stack stop would cost). Needs a CUDA card and nvcc;
the stamps add a few instructions to block 0 and no launch.
"""

import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OUT = os.path.join(ROOT, "build", "kernel_phases")
STAMP = """
__device__ unsigned long long g_stamps[4096];
__device__ int g_nstamps;
#define STAMP()                                                      \\
  do {                                                               \\
    if (blockIdx.x == 0 && threadIdx.x == 0 && g_nstamps < 4096) {   \\
      unsigned long long t_;                                         \\
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));         \\
      g_stamps[g_nstamps++] = t_;                                    \\
    }                                                                \\
  } while (0)
"""
EXPORTS = """
extern "C" void stamps_reset() {
  int z = 0;
  cudaMemcpyToSymbol(g_nstamps, &z, sizeof(int));
}
extern "C" int stamps_get(unsigned long long* out) {
  int n = 0;
  cudaMemcpyFromSymbol(&n, g_nstamps, sizeof(int));
  cudaMemcpyFromSymbol(out, g_stamps, sizeof(unsigned long long) * n);
  return n;
}
__global__ void sync_loop(int n) {
  cooperative_groups::grid_group g = cooperative_groups::this_grid();
  STAMP();
  for (int i = 0; i < n; ++i) g.sync();
  STAMP();
}
extern "C" int sync_loop_launch(int n, int blocks, int threads) {
  void* p[] = {&n};
  return (int)cudaLaunchCooperativeKernel((const void*)sync_loop, blocks,
                                          threads, p, 0, 0);
}
"""


# (old, new, times it must occur) per source: the phase boundaries
STAMPS = {
    "seg_flood.cuh": [("namespace seg_flood {",
                       STAMP + "\nnamespace seg_flood {", 1),
                      ("grid.sync();", "grid.sync(); STAMP();", 2)],
    "epoch_word.cu": [("cg::this_grid();", "cg::this_grid();\n  STAMP();", 1),
                      ("grid.sync();", "grid.sync(); STAMP();", 2),
                      ("  finalize(a);\n}", "  finalize(a);\n  STAMP();\n}",
                       1)],
    "flood_packed.cu": [("cg::this_grid();", "cg::this_grid();\n  STAMP();",
                         1),
                        ("grid.sync();", "grid.sync(); STAMP();", 1)],
}


def stamped(build, name):
    """The source ``name`` with its STAMP() calls; exits when a phase
    boundary is not where it is expected, so no stamp goes missing."""
    with open(os.path.join(build.CSRC, name)) as f:
        src = f.read()
    for old, new, times in STAMPS[name]:
        if src.count(old) != times:
            sys.exit(f"tools/kernel_phases.py: {name} has {src.count(old)} "
                     f"of {old!r}, not {times}: update STAMPS")
        src = src.replace(old, new)
    return src


def instrument(build):
    """Write and compile the stamped sources; returns {name: CDLL}."""
    os.makedirs(OUT, exist_ok=True)
    with open(os.path.join(OUT, "seg_flood.cuh"), "w") as f:
        f.write(stamped(build, "seg_flood.cuh"))
    libs = {}
    for name in ("epoch_word", "flood_packed"):
        path = os.path.join(OUT, name + ".cu")
        with open(path, "w") as f:
            f.write(stamped(build, name + ".cu") + EXPORTS)
        lib = path[:-3] + ".so"
        run = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", lib,
                              path], capture_output=True, text=True)
        if run.returncode:
            sys.exit(f"nvcc failed for {path}:\n{run.stdout}{run.stderr}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def stamps(lib):
    buf = (ctypes.c_ulonglong * 4096)()
    n = lib.stamps_get(buf)
    return [(buf[i + 1] - buf[i]) / 1e3 for i in range(n - 1)]


def main():
    import torch
    if not torch.cuda.is_available():
        sys.exit("tools/kernel_phases.py needs a CUDA card")
    import chip_smoke as cs
    from pcseg_tpu_torch.kernels import build, epoch_word, flood_packed
    from pcseg_tpu_torch.models import config, pipeline
    from pcseg_tpu_torch.ops import unproject
    from pcseg_tpu_torch.utils.synthetic import (
        synthetic_cluttered_room_cloud, synthetic_room_cloud)

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    libs = instrument(build)
    for blocks in (132, 264):
        lib = libs["flood_packed"]
        lib.stamps_reset()
        lib.sync_loop_launch(1000, blocks, 1024 * 132 // blocks)
        torch.cuda.synchronize()
        print(json.dumps({"case": "grid_sync", "card": card,
                          "blocks": blocks,
                          "us_each": stamps(lib)[0] / 1000}))

    h, w = cs.H, cs.W
    rays = torch.from_numpy(unproject.camera_ray_table(h, w, f=float(h))) \
        .to(dev)
    origin = torch.zeros(3, device=dev)

    def batch(make, seed):
        u16 = unproject.encode_range(make(h, w, f=float(h), seed=1)[0])
        return torch.from_numpy(cs.make_batch(u16, seed)).to(dev)

    eargs = cs.capture(epoch_word, "epoch_word", lambda: pipeline.Segmenter(
        device=dev, impl="plain").device_forward_stream(
            batch(synthetic_room_cloud, 0), rays, origin))
    cfg64 = config.SegmenterConfig(
        planar=config.PlanarRegionConfig(max_regions=64))
    fargs = cs.capture(
        flood_packed, "flood_packed", lambda: pipeline.Segmenter(
            cfg64, device=dev, impl="plain").device_forward_stream(
                batch(synthetic_cluttered_room_cloud, 1), rays, origin))
    empty = list(eargs)
    empty[5] = torch.zeros_like(eargs[5])  # no members
    empty[7] = torch.zeros_like(eargs[7])  # no slot alive
    one = tuple(torch.from_numpy(a).to(dev)
                for a in cs.staircase_words([470]))
    own = tuple(torch.from_numpy(a).to(dev) for a in cs.staircase_words(
        [470 - 25 * p for p in range(16)]))
    same = tuple(torch.from_numpy(a).to(dev)
                 for a in cs.staircase_words([470] * 16))
    cases = [
        ("epoch_word real cap64", epoch_word, lambda: epoch_word.epoch_word(
            *eargs)),
        ("epoch_word real cap1", epoch_word, lambda: epoch_word.epoch_word(
            *eargs[:-1], 1)),
        ("epoch_word no slot alive", epoch_word,
         lambda: epoch_word.epoch_word(*empty)),
        ("flood_packed real N=16", flood_packed,
         lambda: flood_packed.flood_packed(*fargs)),
        ("flood_packed real N=2", flood_packed,
         lambda: flood_packed.flood_packed(fargs[0][:2].contiguous(),
                                           fargs[1][:2].contiguous(), 64)),
        ("flood_packed staircase N=1 cap64", flood_packed,
         lambda: flood_packed.flood_packed(*one, 64)),
        ("flood_packed staircases N=16 stopping after 95..470", flood_packed,
         lambda: flood_packed.flood_packed(*own, 600)),
        ("flood_packed staircases N=16 all 470", flood_packed,
         lambda: flood_packed.flood_packed(*same, 600)),
    ]
    real_load = build.load
    # the wrappers load their libraries through build.load: hand them the
    # stamped ones
    build.load = lambda name: libs.get(name) or real_load(name)
    for case, mod, fn in cases:
        name = mod.__name__.rsplit(".", 1)[-1]
        fn()
        torch.cuda.synchronize()
        libs[name].stamps_reset()
        fn()
        torch.cuda.synchronize()
        gaps = stamps(libs[name])
        print(json.dumps({"case": case, "card": card,
                          "total_us": sum(gaps), "gaps_us": gaps
                          if len(gaps) <= 40 else gaps[:20] + gaps[-20:],
                          "gaps": len(gaps)}), flush=True)
    build.load = real_load


if __name__ == "__main__":
    main()
