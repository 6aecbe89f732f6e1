#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases (each prints one JSON line; any failure exits nonzero without the
final result line):
  1. device: the card's name and power limit; TF32 off;
  2. build: both CUDA kernels from ``pcseg_tpu_torch/csrc`` (one nvcc
     each, started together);
  3. the main path, ``Segmenter.device_forward_stream`` at VGA (480x640),
     batch 8, on the room and the cluttered scenes, with every launch
     counter set to 0 just before and read just after; each kernel must
     have launched;
  4. the epoch kernel against its plain PyTorch version on real inputs of
     that path (the first closure epoch's state, captured from a plain
     run): words, counts, ranks and indices exact, moments within the
     stated tolerance;
  5. the CCL kernel against its plain version on the cluster stage's real
     inputs (captured the same way, cluttered scene): exact;
  6. the stream forward against its ``impl="plain"`` run (labels and
     counts exact, planes within 1e-4) and against a second kernel run
     (bit-identical);
  7. the committed JAX golden at 128x160 (cluttered scene, seed 5, B=2):
     labels and counts exact, planes within the conditioning-aware
     tolerance of the CPU tests (PLANE_ATOL for well-conditioned fits);
  8. times: CUDA-event medians of kernel vs plain, and the stream's
     ms/batch and points/s.

The line before the last lists the kernels; the last line is
``{"ok": true, "device": {...}}``. Needs a CUDA card and the CUDA toolkit
(nvcc); builds into ``build/pcseg_tpu_torch/``.
"""

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

H, W, B = 480, 640, 8
REPS = 5
# moments: f32 products summed in f64 in two orders, then rounded to f32
MOM_RTOL, MOM_ATOL = 1e-6, 1e-5
PLANE_ATOL = 1e-4
EPS32 = 2.0 ** -23


def plane_tolerance(points):
    """Tolerance for a plane fitted to ``points`` [N, 3] against JAX's:
    JAX sums the moments in f32 (XLA:CPU's order), the port in f64, so a
    poorly conditioned fit moves by about eps32 * mean|p|^2 /
    (lambda1 - lambda0) * (1 + |centroid|); 4x that, and at least
    PLANE_ATOL (tests/test_torch_grower.py holds the same rule)."""
    p = points.astype(np.float64)
    c = p.mean(0)
    ev = np.linalg.eigvalsh(np.cov((p - c).T, bias=True))
    gap = max(ev[1] - ev[0], 1e-30)
    bound = EPS32 * (p * p).sum(1).mean() / gap * (1 + np.linalg.norm(c))
    return max(PLANE_ATOL, 4 * bound)


def emit(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def fail(msg):
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(torch, fn, reps=REPS):
    """Median CUDA-event time of ``fn`` in ms after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def make_batch(base_u16, seed):
    """[B, H, W] u16 frames: the scene jittered by <= 1 mm per frame."""
    rng = np.random.default_rng(seed)
    jit = rng.integers(0, 5, size=(B,) + base_u16.shape, dtype=np.uint16)
    return np.where(base_u16[None] > 0, base_u16[None] + jit, 0) \
        .astype(np.uint16)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from pcseg_tpu_torch.kernels import build, ccl_gated, epoch_word
    from pcseg_tpu_torch.models import pipeline
    from pcseg_tpu_torch.ops import nansafe, unproject
    from pcseg_tpu_torch.utils.synthetic import (
        synthetic_cluttered_room_cloud, synthetic_room_cloud)

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build
    build_s = build.build_all()
    emit("build", seconds=build_s, dir=os.path.relpath(build.BUILD_DIR, ROOT))

    rays = unproject.camera_ray_table(H, W, f=float(H))
    origin = np.zeros(3, np.float32)
    scenes = {
        "room": unproject.encode_range(
            synthetic_room_cloud(H, W, f=float(H), seed=1)[0]),
        "cluttered": unproject.encode_range(
            synthetic_cluttered_room_cloud(H, W, f=float(H), seed=1)[0]),
    }
    batches = {name: torch.from_numpy(make_batch(u16, i)).to(dev)
               for i, (name, u16) in enumerate(scenes.items())}
    rays_d = torch.from_numpy(rays).to(dev)
    origin_d = torch.from_numpy(origin).to(dev)
    seg = pipeline.Segmenter(device=dev)
    seg_plain = pipeline.Segmenter(device=dev, impl="plain")

    def stream(s, name):
        out = s.device_forward_stream(batches[name], rays_d, origin_d)
        torch.cuda.synchronize()
        return out

    # 3. the main path, counted
    stream(seg, "room")  # warm-up (first kernel load)
    epoch_word.launches = 0
    ccl_gated.launches = 0
    main_out = {name: stream(seg, name) for name in batches}
    counts = {"epoch_word": epoch_word.launches,
              "ccl_gated": ccl_gated.launches}
    for name, (lab, npl, ncl, planes) in main_out.items():
        ok = (lab.shape == (B, H, W) and lab.dtype == torch.uint8
              and planes.shape == (B, 32, 4)
              and bool(nansafe.isfinite(planes).all())
              and bool((npl > 0).all()))
        emit("main_path", scene=name, num_planar=npl.tolist(),
             num_clusters=ncl.tolist(), ok=ok)
        if not ok:
            fail(f"main path output on {name} is malformed")
    emit("launches", **counts)
    for k, n in counts.items():
        if n <= 0:
            fail(f"kernel {k} was not launched on the main path")

    # 4. epoch kernel vs plain on the first closure epoch's real inputs
    def capture(module, fn_name, scene):
        """Arguments of the first call of module.fn_name in a plain run of
        the stream forward on ``scene``."""
        seen = []
        real = getattr(module, fn_name)

        def spy(*args, **kw):
            if not seen:
                seen.append(args)
            return real(*args, **kw)

        setattr(module, fn_name, spy)
        try:
            stream(seg_plain, scene)
        finally:
            setattr(module, fn_name, real)
        return seen[0]

    eargs = capture(epoch_word, "epoch_word", "room")
    got = epoch_word.epoch_word(*eargs)
    want = epoch_word.epoch_word(*eargs, impl="plain")
    torch.cuda.synchronize()
    exact = all(bool(torch.equal(g, w)) for g, w in zip(got[:4], want[:4]))
    mom_err = float((got[4] - want[4]).abs().max())
    mom_ok = bool(torch.allclose(got[4], want[4], rtol=MOM_RTOL,
                                 atol=MOM_ATOL))
    emit("epoch_word_vs_plain", exact_words_counts=exact,
         moments_max_abs_err=mom_err, rtol=MOM_RTOL, atol=MOM_ATOL,
         reached_members=int((got[0] != 0).sum()))
    if not (exact and mom_ok):
        fail("epoch_word disagrees with its plain version")

    # 5. CCL kernel vs plain on the cluster stage's real inputs
    cargs = capture(ccl_gated, "ccl_gated", "cluttered")
    c_got = ccl_gated.ccl_gated(*cargs)
    c_want = ccl_gated.ccl_gated(*cargs, impl="plain")
    torch.cuda.synchronize()
    c_exact = bool(torch.equal(c_got, c_want))
    c_err = float((c_got - c_want).abs().max())
    emit("ccl_gated_vs_plain", exact=c_exact, max_abs_err=c_err,
         eligible=int((c_got < H * W).sum()),
         components=int(torch.unique(c_got[c_got < H * W]).numel()))
    if not c_exact:
        fail("ccl_gated disagrees with its plain version")

    # 6. stream forward vs plain, and run-to-run
    for name in batches:
        a = main_out[name]
        p = stream(seg_plain, name)
        again = stream(seg, name)
        same_plain = (torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])
                      and torch.equal(a[2], p[2]))
        plane_err = float((a[3] - p[3]).abs().max())
        bit_identical = all(torch.equal(x, y) for x, y in zip(a, again))
        emit("stream_vs_plain", scene=name, labels_counts_equal=same_plain,
             planes_max_abs_err=plane_err, atol=PLANE_ATOL,
             bit_identical_rerun=bit_identical)
        if not (same_plain and plane_err <= PLANE_ATOL and bit_identical):
            fail(f"stream forward on {name} disagrees (plain or rerun)")

    # 7. the committed JAX golden
    gold = np.load(os.path.join(ROOT, "pcseg_tpu_torch", "testdata",
                                "jax_stream_128x160.npz"))
    gh, gw = gold["depth"].shape[1:]
    g_out = seg.device_forward_stream(
        torch.from_numpy(gold["depth"]).to(dev),
        torch.from_numpy(unproject.camera_ray_table(gh, gw, f=float(gh)))
        .to(dev), origin_d)
    g_lab, g_npl, g_ncl, g_planes = (t.cpu().numpy() for t in g_out)
    lab_ok = bool((g_lab == gold["labels"]).all()
                  and (g_npl == gold["num_planar"]).all()
                  and (g_ncl == gold["num_clusters"]).all())
    g_pts = unproject.unproject_range_np(
        gold["depth"], unproject.camera_ray_table(gh, gw, f=float(gh)))
    worst = 0.0  # error / tolerance
    max_err = 0.0
    for b in range(g_lab.shape[0]):
        for r in range(int(gold["num_planar"][b])):
            err = float(np.abs(g_planes[b, r] - gold["planes"][b, r]).max())
            tol = plane_tolerance(g_pts[b][gold["labels"][b] == r])
            worst = max(worst, err / tol)
            max_err = max(max_err, err)
    emit("jax_golden", labels_counts_equal=lab_ok,
         planes_worst_err_over_tolerance=worst, planes_max_abs_err=max_err,
         atol=PLANE_ATOL)
    if not (lab_ok and worst <= 1.0):
        fail("stream forward disagrees with the committed JAX golden")

    # 8. times
    e_ms = cuda_ms(torch, lambda: epoch_word.epoch_word(*eargs))
    e_plain = cuda_ms(torch, lambda: epoch_word.epoch_word(*eargs,
                                                           impl="plain"))
    c_ms = cuda_ms(torch, lambda: ccl_gated.ccl_gated(*cargs))
    c_plain = cuda_ms(torch, lambda: ccl_gated.ccl_gated(*cargs,
                                                         impl="plain"))
    times = {}
    for name in batches:
        ms = cuda_ms(torch, lambda: seg.device_forward_stream(
            batches[name], rays_d, origin_d))
        t0 = time.perf_counter()
        for _ in range(REPS):
            stream(seg, name)
        host_ms = (time.perf_counter() - t0) * 1e3 / REPS
        times[name] = dict(ms_per_batch=ms, host_ms_per_batch=host_ms,
                           points_per_s=B * H * W / (ms / 1e3))
    emit("times", card=card, epoch_word_ms=e_ms, epoch_word_plain_ms=e_plain,
         ccl_gated_ms=c_ms, ccl_gated_plain_ms=c_plain, stream=times)

    kernels = [
        dict(name="epoch_word", route="cuda",
             source="pcseg_tpu_torch/csrc/epoch_word.cu",
             replaces="pcseg_tpu/models/planar_batched.py:291",
             launches=counts["epoch_word"], max_abs_err=mom_err,
             ms=e_ms, plain_ms=e_plain),
        dict(name="ccl_gated", route="cuda",
             source="pcseg_tpu_torch/csrc/ccl_gated.cu",
             replaces="pcseg_tpu/ops/connectivity.py:296",
             launches=counts["ccl_gated"], max_abs_err=c_err,
             ms=c_ms, plain_ms=c_plain),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
