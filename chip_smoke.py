#!/usr/bin/env python3
"""Drive the PyTorch port's paths on NVIDIA GPUs and check them.

    python3 chip_smoke.py          # every phase; 25 and 26 on 2+ cards
    python3 chip_smoke.py --nccl   # phases 1, 2, 23, 25, 26 and the dry
                                   # run over 2 and 4 cards; 2+ cards

Phases (each prints one JSON line; any failure exits nonzero without the
final result line):
  1. device: the card's name and power limit; TF32 off;
  2. build: the five CUDA kernels from ``pcseg_tpu_torch/csrc`` (one nvcc
     each, started together, with ptxas' report of each kernel's
     registers, shared memory and spills) and the host-ops library (g++),
     which must load;
  3. the serving path at 32 slots, ``Segmenter.device_forward_stream`` at
     VGA (480x640), batch 8, on the room and the cluttered scenes, with
     every launch counter set to 0 just before and read just after; the
     epoch and CCL kernels must have launched, the normals' support kernel
     once a batch;
  4. the epoch kernel (B1) against its plain PyTorch version on real inputs
     of that path (the first closure epoch's state, captured from a plain
     run) at flood caps 1, 2 and 64, and on a VGA staircase of member bits
     whose flood needs ~470 rounds (the cap binds at 64), and on frames
     whose strips (1920 rows) or rows (38,400 columns) do not fit in
     shared memory: words, counts, ranks, indices and the flood rounds
     each frame ran exact, moments within the stated tolerance; a
     torch.profiler window counts the device kernels per call (must be
     one);
  5. the CCL kernel (B2) against its plain version: labels and the rounds
     each frame ran exact, on the cluster stage's real inputs (captured the
     same way, cluttered scene) at caps 1, 2 and 24, on a VGA batch of two
     serpentines whose fixed points need ~210 and ~110 rounds (cap 24
     binds; cap 256 reaches both), on the captured inputs laid out as tall
     (1920-row) and wide (38,400-column) frames, which take the kernel's
     second instance, and with the 5x5 window (24 offsets, its gate built
     from the captured points); one device kernel per call, as in phase 4;
  6. the stream forward against its ``impl="plain"`` run (labels and
     counts exact, planes within 1e-4) and against a second kernel run
     (bit-identical);
  7. the committed JAX golden at 128x160 (cluttered scene, seed 5, B=2):
     labels and counts exact, planes within the conditioning-aware
     tolerance of the CPU tests (PLANE_ATOL for well-conditioned fits);
  8. times of that path: CUDA-event medians of B1 (also on the staircase)
     and B2 (also on the serpentines at cap 24), of a single call (as earlier runs timed them; the kernels
     line's ``ms``) and per call over 10 back-to-back calls
     (``ms_per_call_of_10``), against their plain versions, and the
     stream's ms/batch and points/s (taken here, before the 64-slot
     phases, so they compare with earlier runs); then the normals' support
     kernel (``normal_support``) on the cluttered stream's own points, at
     B = 8 and on its first frame (B = 1): counts, moment sums, center
     mask, hint and the normals solved from them bitwise equal to its plain
     version, one device kernel per call, and its times (one call, per call
     of 10, plain) beside its bound;
  9. the serving path at 64 slots (flood epochs), same batches, counted
     like phase 3: the flood and CCL kernels must launch, the epoch kernel
     must not;
 10. the flood kernel (B3) against its plain version: exact on the first
     flood of a plain 64-slot run (cluttered scene, N = 16 word planes) at
     caps 1, 2 and 64, on a constructed stack whose gate runs are all <= 8
     cells, and on a VGA stack of staircases whose planes reach their fixed
     points after 94 to 469 rounds (caps 64 and 600), and on the real
     words laid out as planes past shared memory (1920 rows, 38,400
     columns); the rounds each plane ran equal the plain version's, and on
     the staircases its rounds to the fixed point plus one, or the cap; one
     device kernel per call, as in phase 4;
 11. the 64-slot stream against its plain run and a rerun, as phase 6;
 12. the full pipeline, ``segment_frame_stream``, one VGA frame per case
     (room and cluttered at 64 slots, cluttered at 32), counted like phase
     3: equal to its plain run and to the committed JAX golden
     ``jax_frame_vga.npz`` under ``golden_mismatches``' rule (the seed,
     planar-region and cluster counts exact; labels, cluster sizes,
     classes and boundary sets exact except for the known tau-band cells
     of GOLDEN_CELLS, which the phase lists with the fits involved);
 13. times: B3 against its plain version at N = 16 and N = 2 and on the
     staircases at cap 64, as in phase 8; the 64-slot stream,
     ``segment_frame_stream`` ms/frame split into the device program and
     the host finalize, synced stage times and a torch.profiler window of
     the cluttered scene's paths.
 14. temporal seeds: frame 1 is the room scene (``segment_frame_stream``,
     32 slots), frame 2 the same points after the sensor moved by 3
     degrees about z and (0.05, 0.02, 0) m, through ``segment_frame`` with
     frame 1's records and the pose, at 32 and 64 slots, counted like
     phase 3: equal to the plain run and a rerun and to the committed JAX
     golden ``jax_temporal_vga.npz`` under ``golden_mismatches``' rule
     (OPTION_GOLDEN_CELLS), with the temporal seeds found and the regions
     they founded; then B1 against its plain version on the epoch inputs
     of that frame, whose rank grid must hold negative ranks;
 15. average-normal seeds: the cluttered VGA frame against its plain run,
     a rerun and ``jax_options_vga.npz``; the VGA stream at B = 8 against
     its plain run and a rerun; the 128x160 stream golden
     ``jax_avg_stream_128x160.npz`` (frame 0 exact, frame 1 as
     AVG_STREAM_KNOWN records);
 16. mean shift: the cluttered VGA frame with ``ClusterMethod.MEAN_SHIFT``,
     which must take the native growth with its shift as one launch of
     ``mean_shift_modes`` (M1), against its plain run, a rerun and
     ``jax_options_vga.npz``; the device growth on the card against the
     host growth at 120x160 (labels agree on >= 99% of the cells, equal
     region counts, the rule of tests/test_mean_shift.py);
 17. the cluster stage's CCL at half-window 3 (48 offsets, one bool gate
     per offset) on the card, on the captured inputs of phase 5 (the
     first frame), equal to the same call on the CPU;
 18. times: ms per frame of the temporal, average-normal and mean-shift
     frames split into the device program and the host finalize, the
     average-normal stream, the device mean shift and the 48-offset CCL;
 19. unorganized clouds (BASELINE config 3: four Gaussian blobs of 250,000
     points, the cloud of the committed golden ``jax_unorganized_1m.npz``):
     the euclidean call (``cluster_unorganized``, 0.5 m cells, 256x256,
     min 1,000 points), counted like phase 3 (one B2 launch, nothing
     else), equal to its plain run, a rerun (bit-identical), the native
     host path and the golden; its times (from a device tensor and from
     NumPy, plain, native host) and synced stages;
 20. B2 on the voxel grids (that call's 256x256 and the 512x512 grid of
     0.25 m cells) against its plain version, with rounds run, ms and
     bound;
 21. the mean-shift call (0.125 m cells, 512x512, 5 iterations): the host
     backend equal to the golden, the device backend on the card agreeing
     with it on >= 99% of the points; both timed;
 22. ``Segmenter`` with the sequential grower (hybrid, wavefront) on a
     120x160 room frame on the card, equal to the same frame on the CPU,
     counted (B2 in the cluster stage; B1 and B3 not);
 23. the column-sharded step (``parallel/sharded.build_sharded_segment_step``)
     on the VGA room and cluttered frames over 2 and then 4 ranks:
     processes sharing the card (``cuda:0``) in a gloo group over a
     FileStore, each collective staged through host memory (NCCL refuses
     two ranks on one device); on every rank B2 (the local CCL on global
     labels) must launch once and B3 (the sharded flood's local rounds)
     must launch, the
     labels equal the ranks' ``impl="plain"`` run and a rerun
     (bit-identical), and against the 1-rank step on the card the region
     and cluster counts are equal and the labels and planes within JAX's
     bound (tests/test_sharded.py: >= 99% of the labels, plane |dot| >
     0.999); ms per step by CUDA events; the ranks also run the 128x160
     scenes of ``jax_sharded_128x160.npz`` and must give JAX's labels and
     counts exactly (planes within the plane tolerance);
 24. protos: the cluttered VGA frame's detected objects and its cloud
     through the port's proto codec (``protos/pcseg_pb2.py``, no
     protobuf), bytes equal after a parse, and the objects and channels
     equal what went in;
 25. (two or more cards; run right after phase 23, whose groups it is
     compared with) the sharded step with one rank per card over NCCL,
     2 ranks on cards 0-1 and 4 on cards 0-3: processes started with
     torchrun's environment (RANK, LOCAL_RANK, WORLD_SIZE, MASTER_ADDR,
     MASTER_PORT) that join through ``distributed.initialize("nccl")``;
     each rank prints its transport and current card (must be ``nccl``
     and its LOCAL_RANK), gathers f64, int64, int32 and bool probes byte
     for byte, and runs what a phase 23 rank runs; phase 23's rules hold,
     B2 launches once per rank per step, and labels, counts and planes
     are byte-equal to the gloo group's of the same rank count. Ranks of
     both phases report the host seconds spent inside
     ``Comm.all_gather`` per step;
 26. (two or more cards) in this process, card 0 current and no
     ``set_device``, ``Segmenter(device=f"cuda:{k}").device_forward_stream``
     on every card k at 32 and 64 slots on phase 3's VGA batches: labels,
     counts and planes byte-equal to card 0's, with phases 3 and 9's
     launch counts (each wrapper launches on its tensors' card);
 27. the JAX package's last public surface: ``flood_fill_static`` (B3's
     public entry) on the first flood's gates of a plain 64-slot stream
     run, counted (one B3 launch, nothing else) and equal to its plain
     version; ``connected_components_mask`` on the cluttered VGA frame's
     unlabeled mask, 4- and 8-neighbourhood, rounds free and capped at 1
     and 3, equal to the CPU; ``classify_planes_batched`` on that frame's
     records (SURFACE_CLASSIFY) equal to the CPU; ``graft_entry.entry()``'s QVGA
     forward, counted (B1 and B2 launch) and equal to its plain run on the
     card; ``utils/profiling.trace_to`` around one stream call with
     ``stage`` on four stages, whose names must be in the Chrome trace
     (the count of CUDA kernel records is printed, not gated);
     ``graft_entry.dryrun_multichip(1)``, its ok line; ``--nccl`` runs the
     dry run over 2 and 4 cards after phase 26;
 28. the public functions at JAX's single-frame shapes on one VGA frame of
     each scene (``conventions_phase``): normals (also on a sub-rectangle,
     NaN or ``out_normals`` outside it), both seed finders and the seed
     list, the temporal rank grid, ``rank_grid_from_seed_vector``, the
     scan and window CCLs, ``segment_field`` (float min),
     ``segment_clusters``, ``discontinuity_flags`` and, at 120x160,
     ``mean_shift_modes``, each equal bitwise to frame 0 of its batched
     call, and the kernel paths to their ``impl="plain"`` run; the grower
     from the seed vector with default arguments equal to its call on the
     vector's rank grid at 32 (B1) and 64 (B3) slots; the grower with
     CONVENTION_SCHEDULE (flood cap 4, which must bind on some frame),
     counted (B1 at 32 slots, B3 at 64) and equal to its plain run; the
     single-frame CCL scan counted (one B2 launch) and equal to its plain
     run; the times beside the card;
 29. the input rule of every public op (``inputs_phase``) on the same
     frames (the sequential grower and the mean shift at 120x160): a NumPy
     frame raises the TypeError that names the argument; f64/i64 tensors
     on the card give the f32/i32 call's result bitwise, the growers at
     32 (B1) and 64 (B3) slots and the single-frame CCL scan (B2) counted;
     the growers' f64 calls (kernel path) equal their f32 plain runs in
     every field, centroids, curvatures and moments bitwise; each call's
     ms beside the card.

On one card the run prints that phases 25 and 26 need two or more cards,
with the ``--nccl`` command, and goes on.

The line before the last lists the kernels with their bounds; the last
line is ``{"ok": true, "device": {...}}``. Needs a CUDA card, the CUDA
toolkit (nvcc) and a host C++ compiler; builds into
``build/pcseg_tpu_torch/``.
"""

import hashlib
import json
import math
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
OPTION_REPS = 3  # the timings of phases 14-18
# moments: f32 products summed in f64 in two orders, then rounded to f32
MOM_RTOL, MOM_ATOL = 1e-6, 1e-5
PLANE_ATOL = 1e-4
AREA_RTOL = 1e-5
EPS32 = 2.0 ** -23
# H100 SXM: 3.35 TB/s of HBM, 67 TFLOP/s f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
EXACT = ("labels", "metrics", "cluster_sizes", "counts", "plane_class",
         "seed_indices", "boundary", "boundary_len", "disc", "disc_len")
# The label cells where the port's VGA frames differ from JAX's golden
# (jax_frame_vga.npz), as [(row, col), port label, golden label]: what the
# port computes on the CPU (tests/test_torch_vga_fits.py holds it to this
# list). JAX built the golden on the CPU, whose closure epochs sum the fit
# moments in f32 in XLA's order; the port sums them in f64 and, at 32 slots,
# runs the word epochs of JAX's TPU path. Tau-band edge cells of the floor
# (region 1) and of region 3 then fall on either side. The port with f32
# sums gives the 64-slot golden, and JAX's own word-epoch path gives the
# port's 32-slot labels (tests/test_torch_vga_epoch_path.py).
GOLDEN_CELLS = {
    "room_k64": [],
    "cluttered_k64": [[[376, 577], 1, 7], [[377, 577], 1, 7],
                      [[377, 578], 1, 7], [[378, 577], 1, 7]],
    "cluttered_k32": [[[376, 577], 1, 7], [[377, 577], 1, 7],
                      [[377, 578], 1, 7], [[378, 577], 1, 7],
                      [[474, 33], 4, 3], [[475, 33], 4, 3]],
}


# The label cells where the port's frames of the other options differ from
# their JAX goldens (jax_temporal_vga.npz, jax_options_vga.npz), as in
# GOLDEN_CELLS: what the port computes on the CPU. The mean-shift frame
# runs the 32-slot grower on the cluttered scene, so it has the six
# tau-band cells of cluttered_k32; the one off the floor is left unclaimed
# by the port's grower and then taken by a mean-shift cluster (id 6, 4
# planar regions + cluster 2) where JAX's golden has planar region 3.
OPTION_GOLDEN_CELLS = {
    "temporal_frame1": [],
    "temporal_k32": [],
    "temporal_k64": [],
    "avg": [],
    "ms": [[[376, 577], 1, 7], [[377, 577], 1, 7], [[377, 578], 1, 7],
           [[378, 577], 1, 7], [[474, 33], 6, 3], [[475, 33], 6, 3]],
}
# The average-normal stream golden (jax_avg_stream_128x160.npz, B = 2):
# frame 0 is exact; on frame 1 (the scene jittered by 3 mm) the port's
# closure epochs end with 13 device regions where JAX's end with 12, and
# this many label cells differ: JAX sums the refit moments in f32, the port
# in f64, and JAX with f64 sums gives the port's labels
# (tests/test_torch_avg_seeds.py). The card must give what the port gives
# on the CPU.
AVG_STREAM_KNOWN = {1: dict(num_planar=13, golden_num_planar=12,
                            cells=14645)}
# the temporal frames' motion (tests/test_torch_golden_temporal.py)
YAW_DEG = 3.0
TRANS = (0.05, 0.02, 0.0)
# the device mean shift's frame (phase 16)
MS_DEVICE_SHAPE = (120, 160)
# BASELINE config 3 (benchmarks/measure_tpu.py:269-312): four Gaussian
# blobs of 250,000 points (utils/synthetic.gaussian_blobs, seed 0), the
# euclidean call and the mean-shift call
UNORG_POINTS_PER_BLOB = 250_000
UNORG_CASES = {
    "euclid": dict(min_region_inliers=1000, cell_size=0.5,
                   grid_shape=(256, 256)),
    "mean_shift": dict(cell_size=0.125, grid_shape=(512, 512),
                       iterations=5),
}


# the sharded step (phases 23 and 25): rank counts (processes sharing the
# card over gloo; one rank per card over NCCL), JAX's bound for the
# sharded step against one device (tests/test_sharded.py:117-160: >= 99%
# of the labels agree, plane normals |dot| > 0.999), the 128x160 golden's
# scenes ((generator, seed);
# tests/test_torch_sharded_step.py writes jax_sharded_128x160.npz from
# them) and the time limits of the group and of each rank
SHARDED_RANKS = (2, 4)
SHARDED_AGREE, SHARDED_DOT = 0.99, 0.999
SHARDED_GOLDEN_SHAPE = (128, 160)
SHARDED_GOLDEN_SCENES = {"room": ("synthetic_room_cloud", 5),
                         "cluttered": ("synthetic_cluttered_room_cloud", 3)}
SHARDED_GROUP_TIMEOUT_S = 300
SHARDED_RANK_TIMEOUT_S = 420


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


def cuda_ms(torch, fn, reps=REPS, calls=1):
    """Median CUDA-event time of ``fn`` in ms after one warm-up call: events
    around ``calls`` back-to-back calls, divided by ``calls``. One call
    also counts the host's work before its first launch; many calls hide
    it behind the device's."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        torch.cuda.synchronize()
        times.append(s.elapsed_time(e) / calls)
    return statistics.median(times)


def make_batch(base_u16, seed):
    """[B, H, W] u16 frames: the scene jittered by <= 1 mm per frame."""
    rng = np.random.default_rng(seed)
    jit = rng.integers(0, 5, size=(B,) + base_u16.shape, dtype=np.uint16)
    return np.where(base_u16[None] > 0, base_u16[None] + jit, 0) \
        .astype(np.uint16)


def capture(module, fn_name, run):
    """Arguments of the first call of ``module.fn_name`` during ``run()``
    (a plain run: the spy records, the plain version computes)."""
    seen = []
    real = getattr(module, fn_name)

    def spy(*args, **kw):
        if not seen:
            seen.append(args)
        return real(*args, **kw)

    setattr(module, fn_name, spy)
    try:
        run()
    finally:
        setattr(module, fn_name, real)
    return seen[0]


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes, f32_ops=0):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and f32
    operations over the f32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = f32_ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare_frames(got, want, tol_of, skip=()):
    """frame_arrays dicts -> list of (field, message) mismatches: exact
    fields, areas (rtol), planes and centroids (within tol_of(region)).
    Regions in ``skip`` are left out of the per-region areas and boundary
    sets."""
    bad = []
    per_region = ("boundary", "disc", "areas")
    for key in EXACT:
        if key.split("_len")[0] in per_region and skip:
            continue
        if got[key].shape != want[key].shape or \
                not np.array_equal(got[key], want[key]):
            bad.append((key, "differs"))
    if bad:
        return bad
    for r in range(len(want["counts"])):
        if r not in skip and not np.isclose(got["areas"][r], want["areas"][r],
                                            rtol=AREA_RTOL, atol=0):
            bad.append(("areas", f"region {r}"))
        tol = tol_of(r)
        for key in ("planes", "centroids"):
            err = float(np.abs(got[key][r] - want[key][r]).max())
            if err > tol:
                bad.append((key, f"region {r}: {err} > {tol}"))
    for key, n_key in (("boundary", "boundary_len"), ("disc", "disc_len")):
        if not skip:
            continue
        g_parts = np.split(got[key], np.cumsum(got[n_key])[:-1])
        w_parts = np.split(want[key], np.cumsum(want[n_key])[:-1])
        for r, (a, b) in enumerate(zip(g_parts, w_parts)):
            if r not in skip and not np.array_equal(a, b):
                bad.append((key, f"region {r}"))
    return bad


def staircase_words(lengths, h=H, w=W):
    """int32 [N, H, W] gate and source words of N = len(lengths) planes:
    each of the 32 bits of plane p carries a one-cell staircase (i, c0 + i)
    -> (i, c0 + i + 1) -> (i + 1, c0 + i + 1) ... of lengths[p] diagonal
    cells from column c0 = 4 * bit, sourced at its first cell. A flood
    gains one step a round, so plane p reaches its fixed point after
    lengths[p] - 1 rounds."""
    gate = np.zeros((len(lengths), h, w), np.int64)
    src = np.zeros_like(gate)
    for p, n in enumerate(lengths):
        i = np.arange(n)
        for bit in range(32):
            c0 = 4 * bit
            gate[p, i, c0 + i] |= 1 << bit
            gate[p, i[:-1], c0 + i[:-1] + 1] |= 1 << bit
            src[p, 0, c0] |= 1 << bit
    return gate.astype(np.int32), src.astype(np.int32)


def serpentine(ncols, h=H, w=W, step=3):
    """[H, W, 3] points and [H, W] eligibility of a serpentine over the
    first ``ncols`` columns: eligible vertical runs at columns 0, step, ...,
    joined alternately along the top and the bottom row, the ineligible
    columns between runs keeping the 3x3 window from cutting corners. All
    points are equal, so every edge between eligible cells passes, and the
    minimum label crosses one run a round: the fixed point takes about
    ncols / step rounds."""
    elig = np.zeros((h, w), bool)
    elig[:, :ncols:step] = True
    for k, c in enumerate(range(0, ncols - step, step)):
        elig[0 if k % 2 == 0 else h - 1, c:c + step + 1] = True
    return np.zeros((h, w, 3), np.float32), elig


def ccl_inputs(torch, connectivity, points, eligible, thr, half_window):
    """CCL kernel arguments (gate, labels0, offsets, big) of [B, H, W, 3]
    points, as connected_components_scan builds them."""
    h, w = eligible.shape[1:]
    offsets = connectivity.window_offsets(half_window)
    gate = connectivity._gate_bits(points, eligible, thr, offsets)
    labels0 = torch.where(eligible, connectivity.colmajor_index_grid(
        h, w, points.device), h * w).to(torch.int32).contiguous()
    return gate, labels0, offsets, h * w


def reframe_epoch(args, b, h, w):
    """Closure-epoch arguments of the first ``b`` frames with their grids
    laid out as [b, h, w] (h * w must be the pixels of a frame) and each
    anchor moved with its pixel: the same pixels in a taller or wider
    frame."""
    out = list(args)
    w0 = args[0].shape[2]
    for i in range(6):  # px, py, pz, rank, elig, word
        out[i] = args[i][:b].reshape(b, h, w)
    for i in (6, 7, 8, 11):  # srank, alive, plane, radius
        out[i] = args[i][:b].contiguous()
    lin = args[9][:b] * w0 + args[10][:b]
    out[9], out[10] = lin // w, lin % w
    return tuple(out)


LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaMemcpy", "cudaMemset",
                "cuMemcpy", "cuMemset")


def kernels_per_call(torch, fn, calls=5):
    """Device work per call of ``fn`` over a short torch.profiler window:
    (device events per call, runtime calls that put work on the device per
    call, their names). Kernels, copies and fills all count; the
    profiler's own buffer requests do not. The device events are CUPTI's
    records, which a window can drop; the runtime calls are the host's."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    device = [e for e in averages if e.device_type.name == "CUDA"
              and not e.key.startswith("Activity Buffer")]
    host = [e for e in averages if e.device_type.name == "CPU"
            and e.key.startswith(LAUNCH_CALLS)]
    return (sum(e.count for e in device) / calls,
            sum(e.count for e in host) / calls,
            sorted(e.key[:60] for e in device + host))


def normal_support_phase(torch, card, points8):
    """The normals' support kernel against its plain version on ``points8``
    ([8, H, W, 3] on the card) and on its first frame, bitwise; one device
    kernel per call; times beside the bound. Returns the kernels line's
    fields of each case, the largest |kernel - plain| over the fields
    compared (``max_abs_err``) among them."""
    from pcseg_tpu_torch.kernels import normal_support
    from pcseg_tpu_torch.models import config
    from pcseg_tpu_torch.ops import normals

    params = config.ComputeNormalsParams()
    origin = torch.zeros(3, device=points8.device)

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def abs_err(a, b):
        # 0 where the bits agree (NaN against NaN too), else |a - b| in f64
        diff = (a.double() - b.double()).abs()
        return float(torch.where(bits(a) == bits(b), 0.0, diff).max())

    out = {}
    for case, pts in (("b8", points8), ("b1", points8[:1].contiguous())):
        got = normals.find_normal_support(pts, params)
        want = normals.find_normal_support(pts, params, impl="plain")
        torch.cuda.synchronize()
        fields = {"count": (got.count, want.count),
                  "center_valid": (got.center_valid, want.center_valid),
                  **{f: (a, b) for f, a, b in zip(
                      got.moments._fields, got.moments, want.moments)}}
        unequal = [f for f, (a, b) in fields.items()
                   if not torch.equal(bits(a), bits(b))]
        err = max(abs_err(a, b) for a, b in fields.values())
        n_got = normals.normals_from_support(got, pts, origin, params)
        n_want = normals.normals_from_support(want, pts, origin, params)
        normals_equal = bool(torch.equal(bits(n_got), bits(n_want)))

        def run(impl=None):
            return normal_support.normal_support(pts, params, impl)

        ms = cuda_ms(torch, run)
        ms_10 = cuda_ms(torch, run, calls=10)
        plain_ms = cuda_ms(torch, lambda: run("plain"))
        bound_ms, bound_by = bound(nbytes(pts, *[a for a, _ in
                                                 fields.values()]))
        out[case] = dict(shape=list(pts.shape), max_abs_err=err, ms=ms,
                         ms_per_call_of_10=ms_10, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by)
        emit("normal_support_vs_plain", case=case, card=card,
             unequal_fields=unequal, normals_equal=normals_equal,
             supported=int((got.count >= params.min_num_support_neighbors)
                           .sum()), **out[case])
        if unequal or not normals_equal:
            fail(f"normal_support disagrees with its plain version ({case}):"
                 f" {unequal}, normals equal: {normals_equal}")
    per_call, launched, names = kernels_per_call(
        torch, lambda: normals.find_normal_support(points8, params))
    emit("normal_support_device_events", per_call=per_call,
         launch_calls_per_call=launched, names=names)
    if per_call > 1 or launched != 1:
        fail(f"normal_support put {per_call} device events and {launched} "
             "launches per call on the card, not one kernel")
    return out


def golden_mismatches(got, want, points, known_cells):
    """The port's frame_arrays against a JAX golden's -> (mismatches,
    [(row, col), port label, golden label] of each differing cell, the fits
    involved).

    The seed count and the numbers of planar regions and of clusters are
    exact. The differing label cells must be exactly ``known_cells`` (an
    entry of GOLDEN_CELLS), and every record's count and every cluster's
    size moves by no more than those cells. The planes and centroids stay
    within plane_tolerance, widened for a region the cells touch by what
    they can move its fit (their summed distance from its centroid over its
    count); those regions are left out of the area and boundary checks.
    Otherwise every field is exact, as in compare_frames."""
    bad = []
    for i, name in ((0, "num_seeds"), (2, "num_planar_regions"),
                    (3, "num_clusters")):
        if got["metrics"][i] != want["metrics"][i]:
            bad.append((name, f"{got['metrics'][i]} != {want['metrics'][i]}"))
    if bad:
        return bad, [], []
    cells = np.argwhere(got["labels"] != want["labels"])
    g_lab = got["labels"][tuple(cells.T)]
    w_lab = want["labels"][tuple(cells.T)]
    n_planar = int(want["metrics"][2])
    planar_g = (g_lab >= 0) & (g_lab < n_planar)
    planar_w = (w_lab >= 0) & (w_lab < n_planar)
    touched = sorted({int(x) for x in np.concatenate([g_lab[planar_g],
                                                      w_lab[planar_w]])})

    def tol_of(r):
        tol = plane_tolerance(points[want["labels"] == r])
        if r in touched:
            moved = points[tuple(cells[(g_lab == r) | (w_lab == r)].T)]
            tol += float(np.linalg.norm(moved - want["centroids"][r],
                                        axis=1).sum()) / want["counts"][r]
        return tol

    fits = [dict(region=r, port_plane=got["planes"][r].tolist(),
                 golden_plane=want["planes"][r].tolist(),
                 port_count=int(got["counts"][r]),
                 golden_count=int(want["counts"][r]),
                 plane_err=float(np.abs(got["planes"][r]
                                        - want["planes"][r]).max()),
                 centroid_err=float(np.abs(got["centroids"][r]
                                           - want["centroids"][r]).max()),
                 tolerance=tol_of(r))
            for r in touched]
    listed = [[c.tolist(), int(a), int(b)] for c, a, b in zip(cells, g_lab,
                                                               w_lab)]
    if listed != known_cells:
        bad.append(("labels", f"{len(cells)} cells differ, not the "
                    f"{len(known_cells)} known ones"))
    if len(cells) == 0:
        return bad + compare_frames(got, want, tol_of), [], []
    for key in ("counts", "cluster_sizes"):
        if got[key].shape != want[key].shape or \
                np.abs(got[key] - want[key]).sum() > len(cells):
            bad.append((key, "moved by more than the differing cells"))
    relaxed = dict(got, labels=want["labels"], metrics=want["metrics"],
                   counts=want["counts"], cluster_sizes=want["cluster_sizes"])
    bad += compare_frames(relaxed, want, tol_of, skip=set(touched))
    return bad, listed, fits


def device_and_build(torch):
    """Phases 1 and 2; returns the card's name and power limit."""
    from pcseg_tpu_torch import native
    from pcseg_tpu_torch.kernels import build

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    card = smi[0] if smi else "nvidia-smi unavailable"
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit("device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), cards=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. build (once, here: the rank processes of phases 23 and 25 load
    # these libraries)
    t0 = time.perf_counter()
    kernel_s, ptxas = build.build_all()
    hostops = native.load_hostops() is not None
    emit("build", kernels_seconds=kernel_s,
         seconds=time.perf_counter() - t0, hostops_loaded=hostops,
         dir=os.path.relpath(build.BUILD_DIR, ROOT), ptxas=ptxas)
    if not hostops:
        fail("the host-ops library (g++) did not build or load")
    return card


def vga_scenes():
    """(ray table, sensor origin, {scene: [H, W] u16 range frame}): the
    room and cluttered VGA scenes of every VGA phase."""
    from pcseg_tpu_torch.ops import unproject
    from pcseg_tpu_torch.utils.synthetic import (
        synthetic_cluttered_room_cloud, synthetic_room_cloud)
    rays = unproject.camera_ray_table(H, W, f=float(H))
    origin = np.zeros(3, np.float32)
    scenes = {
        "room": unproject.encode_range(
            synthetic_room_cloud(H, W, f=float(H), seed=1)[0]),
        "cluttered": unproject.encode_range(
            synthetic_cluttered_room_cloud(H, W, f=float(H), seed=1)[0]),
    }
    return rays, origin, scenes


def kernel_counters():
    """({name: kernel module}, reset, read) for the launch counts: read
    gives each kernel's ``launches.<name>`` counter of ``utils/profiling``
    since the last reset."""
    from pcseg_tpu_torch.kernels import (ccl_gated, epoch_word, flood_packed,
                                         mean_shift_modes, normal_support)
    from pcseg_tpu_torch.utils import profiling
    kernels_mod = {"epoch_word": epoch_word, "ccl_gated": ccl_gated,
                   "flood_packed": flood_packed,
                   "normal_support": normal_support,
                   "mean_shift_modes": mean_shift_modes}
    base = {}

    def reset_counts():
        for k in kernels_mod:
            base[k] = profiling.total("launches." + k)

    def read_counts():
        return {k: profiling.total("launches." + k) - base.get(k, 0)
                for k in kernels_mod}

    return kernels_mod, reset_counts, read_counts


def nonzero_counts(counts):
    """The kernels of a ``read_counts()`` dict that launched, with their
    counts."""
    return {k: v for k, v in counts.items() if v}


def result_line(torch):
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    from pcseg_tpu_torch.kernels import ccl_gated, epoch_word, flood_packed
    from pcseg_tpu_torch.models import config, pipeline
    from pcseg_tpu_torch.ops import connectivity, nansafe, unproject
    from pcseg_tpu_torch.ops import normals as normals_op

    kernels_mod, reset_counts, read_counts = kernel_counters()

    card = device_and_build(torch)
    dev = torch.device("cuda")
    rays, origin, scenes = vga_scenes()
    batches = {name: torch.from_numpy(make_batch(u16, i)).to(dev)
               for i, (name, u16) in enumerate(scenes.items())}
    rays_d = torch.from_numpy(rays).to(dev)
    origin_d = torch.from_numpy(origin).to(dev)
    cfg64 = config.SegmenterConfig(
        planar=config.PlanarRegionConfig(max_regions=64))
    seg = pipeline.Segmenter(device=dev)
    seg_plain = pipeline.Segmenter(device=dev, impl="plain")
    seg64 = pipeline.Segmenter(cfg64)
    seg64_plain = pipeline.Segmenter(cfg64, device=dev, impl="plain")
    segs = {32: (seg, seg_plain), 64: (seg64, seg64_plain)}

    def stream(s, name):
        out = s.device_forward_stream(batches[name], rays_d, origin_d)
        torch.cuda.synchronize()
        return out

    def counted_streams(s, k_cap, phase):
        reset_counts()
        outs = {name: stream(s, name) for name in batches}
        counts = read_counts()
        for name, (lab, npl, ncl, planes) in outs.items():
            ok = (lab.shape == (B, H, W) and lab.dtype == torch.uint8
                  and planes.shape == (B, k_cap, 4)
                  and bool(nansafe.isfinite(planes).all())
                  and bool((npl > 0).all()))
            emit(phase, scene=name, num_planar=npl.tolist(),
                 num_clusters=ncl.tolist(), ok=ok)
            if not ok:
                fail(f"{phase} output on {name} is malformed")
        emit(phase + "_launches", **counts)
        return outs, counts

    def check_vs_plain_and_rerun(outs, s, s_plain, phase):
        for name in batches:
            a = outs[name]
            p = stream(s_plain, name)
            again = stream(s, name)
            same_plain = (torch.equal(a[0], p[0]) and torch.equal(a[1], p[1])
                          and torch.equal(a[2], p[2]))
            plane_err = float((a[3] - p[3]).abs().max())
            bit_identical = all(torch.equal(x, y) for x, y in zip(a, again))
            emit(phase, scene=name, labels_counts_equal=same_plain,
                 planes_max_abs_err=plane_err, atol=PLANE_ATOL,
                 bit_identical_rerun=bit_identical)
            if not (same_plain and plane_err <= PLANE_ATOL
                    and bit_identical):
                fail(f"{phase} on {name} disagrees (plain or rerun)")

    def kernel_times(fn, *args):
        """(kernel ms of a single call, as earlier runs timed it, kernel ms
        per call over 10 back-to-back calls, plain ms of a single call)."""
        return (cuda_ms(torch, lambda: fn(*args)),
                cuda_ms(torch, lambda: fn(*args), calls=10),
                cuda_ms(torch, lambda: fn(*args, impl="plain")))

    def stream_times(s):
        out = {}
        for name in batches:
            ms = cuda_ms(torch, lambda: s.device_forward_stream(
                batches[name], rays_d, origin_d))
            t0 = time.perf_counter()
            for _ in range(REPS):
                stream(s, name)
            out[name] = dict(
                ms_per_batch=ms,
                host_ms_per_batch=(time.perf_counter() - t0) * 1e3 / REPS,
                points_per_s=B * H * W / (ms / 1e3))
        return out

    # 3. the serving path at 32 slots, counted
    stream(seg, "room")  # warm-up (first kernel load)
    main_out, counts32 = counted_streams(seg, 32, "main_path")
    for k in ("epoch_word", "ccl_gated"):
        if counts32[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")
    if counts32["normal_support"] != len(batches):
        fail(f"normal_support launched {counts32['normal_support']} times "
             f"for {len(batches)} stream batches, not once a batch")

    # 4. epoch kernel vs plain on the first closure epoch's real inputs at
    # three flood caps, and on a staircase of member bits where the cap
    # binds (dead slots, so the gate is the member bits; anchors at the
    # staircases' first cells)
    eargs = capture(epoch_word, "epoch_word", lambda: stream(seg_plain,
                                                             "room"))
    e_stair_word, _ = staircase_words([470 - 40 * b for b in range(B)])
    e_slots = torch.arange(32, dtype=torch.int32, device=dev)
    e_stair = list(eargs)
    e_stair[5] = torch.from_numpy(e_stair_word).to(dev)  # word
    e_stair[6] = (e_slots[None] + 100 * torch.arange(
        B, dtype=torch.int32, device=dev)[:, None]).contiguous()  # srank
    e_stair[7] = torch.zeros_like(eargs[7])  # alive
    e_stair[9] = torch.zeros_like(eargs[9])  # anchor_r
    e_stair[10] = (4 * e_slots).expand(B, 32).contiguous()  # anchor_c
    e_stair = tuple(e_stair)
    mom_err = 0.0
    for case, args, expect in (
            [(f"real_cap{cap}", eargs[:-1] + (cap,), None)
             for cap in (1, 2, 64)]
            + [("staircase_cap64", e_stair, [64] * B),
               # frames past shared memory: strips of 1920 rows, rows of
               # 38,400 columns (no prelude tables either)
               ("tall_2x1920x160", reframe_epoch(eargs, 2, 1920, 160), None),
               ("wide_1x8x38400", reframe_epoch(eargs, 1, 8, 38400), None)]):
        ran = [torch.zeros(args[0].shape[0], dtype=torch.int32, device=dev)
               for _ in range(2)]
        e_got = epoch_word.epoch_word(*args, rounds_out=ran[0])
        e_want = epoch_word.epoch_word(*args, impl="plain", rounds_out=ran[1])
        torch.cuda.synchronize()
        exact = all(bool(torch.equal(g, w))
                    for g, w in zip(e_got[:4], e_want[:4]))
        # staircase members include NaN points: NaN moments on both sides
        err = float((e_got[4] - e_want[4]).nan_to_num(0.0).abs().max())
        mom_ok = bool(torch.allclose(e_got[4], e_want[4], rtol=MOM_RTOL,
                                     atol=MOM_ATOL, equal_nan=True))
        rounds_ok = torch.equal(ran[0], ran[1]) and (
            expect is None or ran[0].tolist() == expect)
        mom_err = max(mom_err, err)
        emit("epoch_word_vs_plain", case=case, shape=list(args[0].shape),
             exact_words_counts=exact, moments_max_abs_err=err,
             rtol=MOM_RTOL, atol=MOM_ATOL,
             reached_members=int((e_got[0] != 0).sum()),
             rounds_run=ran[0].tolist(), plain_rounds_run=ran[1].tolist(),
             ms=cuda_ms(torch, lambda: epoch_word.epoch_word(*args)))
        if not (exact and mom_ok and rounds_ok):
            fail(f"epoch_word disagrees with its plain version ({case})")
        if case == "real_cap64":
            got = e_got
    per_call, launched, names = kernels_per_call(
        torch, lambda: epoch_word.epoch_word(*eargs))
    emit("epoch_word_device_events", per_call=per_call,
         launch_calls_per_call=launched, names=names)
    if per_call > 1 or launched != 1:
        fail(f"epoch_word put {per_call} device events and {launched} "
             "launches per call on the card, not one kernel")

    # 5. CCL kernel vs plain on the cluster stage's real inputs at three
    # caps, on serpentines where the cap binds and where it does not, on
    # the same inputs as frames past shared memory, and with the 5x5 window
    cargs = capture(ccl_gated, "ccl_gated", lambda: stream(seg_plain,
                                                           "cluttered"))
    cpts = capture(connectivity, "connected_components_scan",
                   lambda: stream(seg_plain, "cluttered"))
    gate, lab0, offs, _, big = cargs
    s_frames = [serpentine(W), serpentine(W // 2)]
    s_args = ccl_inputs(
        torch, connectivity,
        torch.from_numpy(np.stack([f[0] for f in s_frames])).to(dev),
        torch.from_numpy(np.stack([f[1] for f in s_frames])).to(dev),
        1.0, 1)
    g5 = ccl_inputs(torch, connectivity, cpts[0], cpts[1], cpts[2], 2)

    def laid_out(b, h, w):
        return (gate.reshape(b, h, w), lab0.reshape(b, h, w), offs, 24,
                h * w)

    c_err = 0
    for case, args, expect in (
            [(f"real_cap{cap}", (gate, lab0, offs, cap, big), None)
             for cap in (1, 2, 24)]
            + [("serpentine_cap24", s_args[:3] + (24, s_args[3]), [24, 24]),
               ("serpentine_cap256", s_args[:3] + (256, s_args[3]), None),
               ("tall_2x1920x640", laid_out(2, 1920, W), None),
               ("wide_8x8x38400", laid_out(8, 8, 38400), None),
               ("window5x5_cap24", g5[:3] + (24, g5[3]), None)]):
        n = args[0].shape[0]
        ran = [torch.zeros(n, dtype=torch.int32, device=dev)
               for _ in range(2)]
        c_got = ccl_gated.ccl_gated(*args, rounds_out=ran[0])
        c_want = ccl_gated.ccl_gated(*args, impl="plain", rounds_out=ran[1])
        torch.cuda.synchronize()
        exact = bool(torch.equal(c_got, c_want))
        err = int((c_got.to(torch.int64) - c_want).abs().max())
        rounds_ok = torch.equal(ran[0], ran[1]) and (
            expect is None or ran[0].tolist() == expect)
        c_err = max(c_err, err)
        live = c_got < args[4]
        emit("ccl_gated_vs_plain", case=case, shape=list(args[0].shape),
             offsets=len(args[2]), exact=exact, max_abs_err=err,
             eligible=int(live.sum()),
             components=int(torch.unique(c_got[live]).numel()),
             rounds_run=ran[0].tolist(), plain_rounds_run=ran[1].tolist(),
             ms=cuda_ms(torch, lambda: ccl_gated.ccl_gated(*args)))
        if not (exact and rounds_ok):
            fail(f"ccl_gated disagrees with its plain version ({case})")
        if case == "real_cap24":
            c_got24, c_rounds = c_got, ran[0].tolist()
    per_call, launched, names = kernels_per_call(
        torch, lambda: ccl_gated.ccl_gated(*cargs))
    emit("ccl_gated_device_events", per_call=per_call,
         launch_calls_per_call=launched, names=names)
    if per_call > 1 or launched != 1:
        fail(f"ccl_gated put {per_call} device events and {launched} "
             "launches per call on the card, not one kernel")

    # 6. stream forward vs plain, and run-to-run
    check_vs_plain_and_rerun(main_out, seg, seg_plain, "stream_vs_plain")

    # 7. the committed JAX golden of the stream
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

    # 8. times of the 32-slot path (right after its checks, as before the
    # 64-slot phases existed, so its numbers compare with earlier runs)
    e_ms, e_10, e_plain = kernel_times(epoch_word.epoch_word, *eargs)
    es_ms, es_10, es_plain = kernel_times(epoch_word.epoch_word, *e_stair)
    c_ms, c_10, c_plain = kernel_times(ccl_gated.ccl_gated, *cargs)
    cs_ms, cs_10, cs_plain = kernel_times(ccl_gated.ccl_gated,
                                          *s_args[:3], 24, s_args[3])
    emit("times", card=card, epoch_word_ms=e_ms,
         epoch_word_ms_per_call_of_10=e_10, epoch_word_plain_ms=e_plain,
         epoch_word_staircase_cap64_ms=es_ms,
         epoch_word_staircase_cap64_ms_per_call_of_10=es_10,
         epoch_word_staircase_cap64_plain_ms=es_plain,
         ccl_gated_ms=c_ms, ccl_gated_ms_per_call_of_10=c_10,
         ccl_gated_plain_ms=c_plain, ccl_gated_rounds_run=c_rounds,
         ccl_gated_serpentine_cap24_ms=cs_ms,
         ccl_gated_serpentine_cap24_ms_per_call_of_10=cs_10,
         ccl_gated_serpentine_cap24_plain_ms=cs_plain,
         stream=stream_times(seg))
    ns_times = normal_support_phase(torch, card, capture(
        normals_op, "compute_normals_organized",
        lambda: stream(seg_plain, "cluttered"))[0])

    # 9. the serving path at 64 slots, counted
    stream(seg64, "room")  # warm-up
    out64, counts64 = counted_streams(seg64, 64, "stream64_path")
    if counts64["flood_packed"] <= 0 or counts64["ccl_gated"] <= 0 \
            or counts64["epoch_word"] != 0:
        fail("the 64-slot path must launch flood_packed and ccl_gated and "
             f"not epoch_word: {counts64}")

    # 10. flood kernel vs plain on real and constructed inputs
    fargs = capture(flood_packed, "flood_packed",
                    lambda: stream(seg64_plain, "cluttered"))
    rng = np.random.default_rng(9)
    g9 = rng.integers(-2 ** 31, 2 ** 31, (2, H, W), dtype=np.int64) \
        & rng.integers(-2 ** 31, 2 ** 31, (2, H, W), dtype=np.int64) \
        | rng.integers(-2 ** 31, 2 ** 31, (2, H, W), dtype=np.int64)
    g9[:, ::9, :] = 0  # every run <= 8 cells, as in JAX's max_run test
    g9[:, :, ::9] = 0
    s9 = g9 & rng.integers(-2 ** 31, 2 ** 31, (2, H, W), dtype=np.int64) \
        & rng.integers(-2 ** 31, 2 ** 31, (2, H, W), dtype=np.int64) \
        & rng.integers(-2 ** 31, 2 ** 31, (2, H, W), dtype=np.int64)
    g9, s9 = (torch.from_numpy(a.astype(np.int32)).to(dev) for a in (g9, s9))
    stair_len = [470 - 25 * p for p in range(16)]
    f_stair = tuple(torch.from_numpy(a).to(dev)
                    for a in staircase_words(stair_len))
    f_err = 0
    for case, args, expect in (
            [(f"real_cap{cap}", (fargs[0], fargs[1], cap), None)
             for cap in (1, 2, 64)]
            + [("short_runs", (g9, s9, 64), None),
               ("staircase_cap64", f_stair + (64,), [64] * 16),
               ("staircase_cap600", f_stair + (600,), stair_len),
               # the same words as planes past shared memory
               ("tall_4x1920x640", (fargs[0].reshape(4, 1920, W),
                                    fargs[1].reshape(4, 1920, W), 64), None),
               ("wide_16x8x38400", (fargs[0].reshape(16, 8, 38400),
                                    fargs[1].reshape(16, 8, 38400), 64),
                None)]):
        n = args[0].shape[0]
        ran = [torch.zeros(n, dtype=torch.int32, device=dev)
               for _ in range(2)]
        out = flood_packed.flood_packed(*args, rounds_out=ran[0])
        want = flood_packed.flood_packed(*args, impl="plain",
                                         rounds_out=ran[1])
        torch.cuda.synchronize()
        exact = bool(torch.equal(out, want))
        err = int((out.to(torch.int64) - want.to(torch.int64)).abs().max())
        rounds_ok = torch.equal(ran[0], ran[1]) and (
            expect is None or ran[0].tolist() == expect)
        f_err = max(f_err, err)
        emit("flood_packed_vs_plain", case=case, shape=list(args[0].shape),
             exact=exact, max_abs_err=err,
             reached_words=int((out != 0).sum()),
             rounds_run=ran[0].tolist(), plain_rounds_run=ran[1].tolist(),
             rounds_to_fixed_point=[r - 1 for r in ran[0].tolist()
                                    if r < args[2]],
             ms=cuda_ms(torch, lambda: flood_packed.flood_packed(*args)))
        if not (exact and rounds_ok):
            fail(f"flood_packed disagrees with its plain version ({case})")
        if case == "real_cap64":
            f_got = out
    per_call, launched, names = kernels_per_call(
        torch, lambda: flood_packed.flood_packed(*fargs))
    emit("flood_packed_device_events", per_call=per_call,
         launch_calls_per_call=launched, names=names)
    if per_call > 1 or launched != 1:
        fail(f"flood_packed put {per_call} device events and {launched} "
             "launches per call on the card, not one kernel")

    # 11. 64-slot stream vs plain, and run-to-run
    check_vs_plain_and_rerun(out64, seg64, seg64_plain, "stream64_vs_plain")

    # 12. the full pipeline at VGA against plain and the JAX golden
    vga = np.load(os.path.join(ROOT, "pcseg_tpu_torch", "testdata",
                               "jax_frame_vga.npz"))
    frame_cases = [("room", 64), ("cluttered", 64), ("cluttered", 32)]
    frame_counts = {}
    for scene, k in frame_cases:
        d16 = scenes[scene]
        prefix = f"{scene}_k{k}__"
        if hashlib.sha256(d16.tobytes()).digest() != \
                vga[prefix + "depth_sha256"].tobytes():
            fail(f"the {scene} frame differs from the golden's input")
        s, s_plain = segs[k]
        s.segment_frame_stream(d16, rays, origin)  # warm-up
        reset_counts()
        res = s.segment_frame_stream(d16, rays, origin)
        torch.cuda.synchronize()
        frame_counts[f"{scene}_k{k}"] = read_counts()
        res_plain = s_plain.segment_frame_stream(d16, rays, origin)
        got_a = pipeline.frame_arrays(res)
        pts = unproject.unproject_range_np(d16, rays)
        bad_plain = compare_frames(got_a, pipeline.frame_arrays(res_plain),
                                   lambda r: PLANE_ATOL)
        bad_plain += [("objects", "count")] \
            if len(res.objects) != len(res_plain.objects) else []
        want = {f[len(prefix):]: vga[f] for f in vga.files
                if f.startswith(prefix) and not f.endswith("sha256")}
        bad_gold, cells, fits = golden_mismatches(
            got_a, want, pts, GOLDEN_CELLS[f"{scene}_k{k}"])
        emit("frame_vs_plain_and_golden", scene=scene, slots=k,
             metrics=got_a["metrics"].tolist(),
             cluster_sizes=sorted(got_a["cluster_sizes"].tolist()),
             plane_class=got_a["plane_class"].tolist(),
             objects=len(res.objects), launches=frame_counts[
                 f"{scene}_k{k}"], plain_mismatches=bad_plain,
             golden_mismatches=bad_gold, golden_cells_differing=cells,
             fits_involved=fits)
        if bad_plain or bad_gold:
            fail(f"segment_frame_stream on {scene} at {k} slots disagrees "
                 "with its plain run or the JAX golden")
        need = "flood_packed" if k == 64 else "epoch_word"
        if frame_counts[f"{scene}_k{k}"][need] <= 0 or \
                frame_counts[f"{scene}_k{k}"]["ccl_gated"] <= 0:
            fail(f"segment_frame_stream at {k} slots did not launch {need} "
                 "and ccl_gated")

    # 13. times of the 64-slot paths and the frames, where the time goes
    f_ms, f_10, f_plain = kernel_times(flood_packed.flood_packed, *fargs)
    fargs2 = tuple(a[:2].contiguous() if torch.is_tensor(a) else a
                   for a in fargs)  # frame 0's two word planes
    f2_ms, f2_10, f2_plain = kernel_times(flood_packed.flood_packed,
                                          *fargs2)
    fs_ms, fs_10, fs_plain = kernel_times(flood_packed.flood_packed,
                                          *f_stair, 64)

    times64 = stream_times(seg64)

    def frame_times(s, d16):
        """(device program ms by CUDA events, host finalize ms by the host
        clock after a synchronise, whole call ms by the host clock)."""
        pts_d = unproject.unproject_range(torch.from_numpy(d16).to(dev)[None],
                                          rays_d)
        dev_ms = cuda_ms(torch, lambda: s._payload(pts_d, origin_d, None,
                                                   None))
        pts = unproject.unproject_range_np(d16, rays)
        host, whole = [], []
        for _ in range(REPS):
            payload = s._payload(pts_d, origin_d, None, None)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s._host_finalize(pts, pts_d, payload, None)
            host.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            s.segment_frame_stream(d16, rays, origin)
            torch.cuda.synchronize()
            whole.append((time.perf_counter() - t0) * 1e3)
        return dict(device_ms=dev_ms, host_finalize_ms=statistics.median(host),
                    whole_ms=statistics.median(whole))

    ftimes = {f"{scene}_k{k}": frame_times(segs[k][0], scenes[scene])
              for scene, k in frame_cases}
    emit("times64", card=card, flood_packed_n16_ms=f_ms,
         flood_packed_n16_ms_per_call_of_10=f_10,
         flood_packed_n16_plain_ms=f_plain, flood_packed_n2_ms=f2_ms,
         flood_packed_n2_ms_per_call_of_10=f2_10,
         flood_packed_n2_plain_ms=f2_plain,
         flood_packed_staircase_cap64_ms=fs_ms,
         flood_packed_staircase_cap64_ms_per_call_of_10=fs_10,
         flood_packed_staircase_cap64_plain_ms=fs_plain, stream=times64,
         segment_frame_stream=ftimes)

    stage_profile(torch, card, segs, stream, scenes, rays, origin, pipeline)

    opt_times = option_phases(
        torch, card, dev, scenes, rays, origin, origin_d, rays_d, batches,
        reset_counts, read_counts, kernels_mod, cpts)

    unorg_times, voxel_b2, unorg_b2 = unorganized_phases(
        torch, card, dev, reset_counts, read_counts, kernels_mod)
    seq_times = sequential_phase(torch, card, dev, reset_counts, read_counts)
    cards = torch.cuda.device_count()
    sharded_times, sharded_launches, nccl_launches = sharded_phase(
        torch, card, dev, scenes, rays, origin, nccl=cards >= 2)
    if cards < 2:
        emit("nccl_sharded_step", cards=cards, ran=False,
             note="phase 25 (the sharded step with one rank per card over "
                  "NCCL) and phase 26 (every card's Segmenter) need two or "
                  "more cards: run python3 chip_smoke.py --nccl on a machine "
                  "with 2 or 4")
    sharded_times.update(proto_phase(torch, card, dev, scenes, rays, origin))
    if cards >= 2:
        every_card_phase(torch, card, scenes, rays, origin,
                         expect={32: counts32, 64: counts64})
    surface_launches, surface_times = surface_phase(
        torch, card, dev, scenes, rays, origin, stream,
        (batches["cluttered"], rays_d, origin_d), segs, reset_counts,
        read_counts)
    conv_launches, conv_times = conventions_phase(
        torch, card, dev, scenes, rays, origin, reset_counts, read_counts)
    in_launches, in_times = inputs_phase(
        torch, card, dev, scenes, rays, origin, reset_counts, read_counts)

    # kernels line: bounds from this run's inputs
    px_b1 = eargs[0].numel()
    e_bound = bound(nbytes(*[a for a in eargs if torch.is_tensor(a)])
                    + nbytes(*got),
                    # gate distances (3 mul, 3 add, abs per slot and
                    # pixel) and 6 moment products per member
                    f32_ops=7 * eargs[6].shape[1] * px_b1
                    + 6 * int((got[0] != 0).sum()))
    c_bound = bound(nbytes(cargs[0], cargs[1], c_got24))
    f_bound = bound(nbytes(fargs[0], fargs[1], f_got))
    kernels = [
        dict(name="normal_support", route="cuda",
             source="pcseg_tpu_torch/csrc/normal_support.cu",
             replaces=None, launches=counts32["normal_support"],
             **ns_times["b8"], library_ms=None, b1=ns_times["b1"],
             launches_sharded_per_rank={
                 n: {s: [c[2] for c in per] for s, per in v.items()}
                 for n, v in sharded_launches.items()},
             launches_nccl_per_rank={
                 n: {s: [c[2] for c in per] for s, per in v.items()}
                 for n, v in nccl_launches.items()}),
        dict(name="epoch_word", route="cuda",
             source="pcseg_tpu_torch/csrc/epoch_word.cu",
             replaces="pcseg_tpu/models/planar_batched.py:291",
             launches=counts32["epoch_word"], max_abs_err=mom_err,
             ms=e_ms, ms_per_call_of_10=e_10, plain_ms=e_plain,
             bound_ms=e_bound[0], bound_by=e_bound[1], library_ms=None,
             launches_entry_forward=surface_launches["entry_forward"][
                 "epoch_word"],
             launches_single_frame_schedule={
                 s: conv_launches[f"{s}_grower_k32_schedule"]["epoch_word"]
                 for s in scenes},
             launches_f64_inputs={
                 s: in_launches[f"{s}_grow_planar_regions_batched_k32"][
                     "epoch_word"] for s in scenes}),
        dict(name="ccl_gated", route="cuda",
             source="pcseg_tpu_torch/csrc/ccl_gated.cu",
             replaces="pcseg_tpu/ops/connectivity.py:296",
             launches=counts32["ccl_gated"], max_abs_err=c_err,
             ms=c_ms, ms_per_call_of_10=c_10, plain_ms=c_plain,
             bound_ms=c_bound[0], bound_by=c_bound[1], library_ms=None,
             rounds_run=c_rounds, launches_unorganized_euclid=unorg_b2,
             launches_entry_forward=surface_launches["entry_forward"][
                 "ccl_gated"],
             launches_single_frame_scan={
                 s: conv_launches[f"{s}_ccl_scan"]["ccl_gated"]
                 for s in scenes},
             launches_f64_inputs_scan={
                 s: in_launches[f"{s}_connected_components_scan"][
                     "ccl_gated"] for s in scenes},
             voxel_grid=voxel_b2,
             launches_sharded_per_rank={
                 n: {s: [c[0] for c in per] for s, per in v.items()}
                 for n, v in sharded_launches.items()},
             launches_nccl_per_rank={
                 n: {s: [c[0] for c in per] for s, per in v.items()}
                 for n, v in nccl_launches.items()}),
        dict(name="flood_packed", route="cuda",
             source="pcseg_tpu_torch/csrc/flood_packed.cu",
             replaces="pcseg_tpu/models/planar_batched.py:133",
             launches=counts64["flood_packed"], max_abs_err=f_err,
             ms=f_ms, ms_per_call_of_10=f_10, plain_ms=f_plain,
             bound_ms=f_bound[0], bound_by=f_bound[1], library_ms=None,
             launches_flood_fill_static=surface_launches[
                 "flood_fill_static"]["flood_packed"],
             launches_single_frame_schedule={
                 s: conv_launches[f"{s}_grower_k64_schedule"]["flood_packed"]
                 for s in scenes},
             launches_f64_inputs={
                 s: in_launches[f"{s}_grow_planar_regions_batched_k64"][
                     "flood_packed"] for s in scenes},
             launches_sharded_per_rank={
                 n: {s: [c[1] for c in per] for s, per in v.items()}
                 for n, v in sharded_launches.items()},
             launches_nccl_per_rank={
                 n: {s: [c[1] for c in per] for s, per in v.items()}
                 for n, v in nccl_launches.items()}),
    ]
    emit("times_options", card=card, **opt_times)
    emit("times_unorganized", card=card, **unorg_times, **seq_times)
    emit("times_sharded", card=card, **sharded_times)
    emit("times_surface", card=card, **surface_times)
    emit("times_conventions", card=card, **conv_times)
    emit("times_inputs", card=card, **in_times)
    print(json.dumps({"kernels": kernels}), flush=True)
    result_line(torch)


def temporal_config(config, k):
    """The temporal frames' configuration: seeds from the previous
    regions within 0.5 m and 0.2 rad, ``k`` slots."""
    import dataclasses
    return config.SegmenterConfig(planar=dataclasses.replace(
        config.PlanarRegionConfig(max_regions=k),
        max_distance_for_seed_point=0.5,
        max_normal_difference_angle_for_seed_point=0.2))


def moved_frame(points):
    """Frame 1's points and sensor origin (0) after the sensor moved by
    YAW_DEG about z and by TRANS: p' = R p + t elementwise in NumPy f32
    (no BLAS, so every machine gives the same bits). The golden's
    generator (tests/test_torch_golden_temporal.py) calls this too.
    Returns (points, origin, quat wxyz, trans)."""
    rad = math.radians(YAW_DEG)
    c, s = np.float32(math.cos(rad)), np.float32(math.sin(rad))
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    t = np.float32(TRANS)
    out = np.stack([c * x - s * y + t[0], s * x + c * y + t[1], z + t[2]],
                   axis=-1).astype(np.float32)
    quat = np.float32([math.cos(rad / 2), 0, 0, math.sin(rad / 2)])
    return out, t.copy(), quat, t


def unorganized_case(config, name):
    """(ClusterRegionConfig from the ``config`` module given, keyword
    arguments) of a config-3 call; the goldens' generator
    (tests/test_torch_golden_unorganized.py) calls this too."""
    kw = dict(UNORG_CASES[name])
    fields = {k: kw.pop(k) for k in ("min_region_inliers",) if k in kw}
    return config.ClusterRegionConfig(**fields), kw


def golden_arrays(gold, prefix):
    return {f[len(prefix):]: gold[f] for f in gold.files
            if f.startswith(prefix) and not f.endswith("sha256")}


def option_phases(torch, card, dev, scenes, rays, origin, origin_d, rays_d,
                  batches, reset_counts, read_counts, kernels_mod, cpts):
    """Phases 14-18: the temporal, average-normal and mean-shift frames at
    VGA, the device mean shift, the 48-offset CCL, and their times.
    Returns the times (phase 18)."""
    import dataclasses
    from pcseg_tpu_torch.kernels import epoch_word
    from pcseg_tpu_torch.models import config, mean_shift, pipeline
    from pcseg_tpu_torch.ops import connectivity, geom, seeds, unproject

    t_start = time.perf_counter()
    testdata = os.path.join(ROOT, "pcseg_tpu_torch", "testdata")

    def check_frame(phase, res, res_plain, again, want, pts, known,
                    counts, **extra):
        got = pipeline.frame_arrays(res)
        bad_plain = compare_frames(got, pipeline.frame_arrays(res_plain),
                                   lambda r: PLANE_ATOL)
        bad_plain += [("objects", "count")] \
            if len(res.objects) != len(res_plain.objects) else []
        again_a = pipeline.frame_arrays(again)
        identical = all(np.array_equal(got[k], again_a[k]) for k in got)
        bad_gold, cells, fits = golden_mismatches(got, want, pts, known)
        emit(phase, metrics=got["metrics"].tolist(),
             cluster_sizes=sorted(got["cluster_sizes"].tolist()),
             objects=len(res.objects), launches=counts,
             plain_mismatches=bad_plain, bit_identical_rerun=identical,
             golden_mismatches=bad_gold, golden_cells_differing=cells,
             fits_involved=fits, **extra)
        if bad_plain or bad_gold or not identical:
            fail(f"{phase}: disagrees with its plain run, its rerun or the "
                 "JAX golden")

    def counted(run):
        run()  # warm-up
        reset_counts()
        out = run()
        torch.cuda.synchronize()
        return out, read_counts()

    # 14. temporal frames: frame 1 is the room scene, frame 2 the same
    # points after a known motion, seeded from frame 1's records
    tgold = np.load(os.path.join(testdata, "jax_temporal_vga.npz"))
    d16 = scenes["room"]
    if hashlib.sha256(d16.tobytes()).digest() != \
            tgold["depth_sha256"].tobytes():
        fail("the room frame differs from the temporal golden's input")
    pts1 = unproject.unproject_range_np(d16, rays)
    pts2, origin2, quat, trans = moved_frame(pts1)
    if hashlib.sha256(pts2.tobytes()).digest() != \
            tgold["points2_sha256"].tobytes():
        fail("frame 2 differs from the temporal golden's input")
    pose = geom.Pose.from_arrays(quat, trans, dev)
    tsegs = {k: (pipeline.Segmenter(temporal_config(config, k), device=dev),
                 pipeline.Segmenter(temporal_config(config, k), device=dev,
                                    impl="plain")) for k in (32, 64)}
    f1 = tsegs[32][0].segment_frame_stream(d16, rays, origin)
    bad1, cells1, _ = golden_mismatches(
        pipeline.frame_arrays(f1), golden_arrays(tgold, "frame1__"), pts1,
        OPTION_GOLDEN_CELLS["temporal_frame1"])
    emit("temporal_frame1", metrics=pipeline.frame_arrays(f1)["metrics"]
         .tolist(), golden_mismatches=bad1, golden_cells_differing=cells1)
    if bad1:
        fail("temporal frame 1 disagrees with the JAX golden")
    prev = f1.planar_regions
    t_found = []
    real_last = seeds.seeds_from_last_regions

    def spy_last(*a, **kw):
        out = real_last(*a, **kw)
        t_found.append((out[0].cpu().numpy(), out[1].cpu().numpy()))
        return out

    t_args = None
    for k, (s, s_plain) in tsegs.items():
        def run(s=s):
            return s.segment_frame(pts2, origin2, None, prev, pose)
        seeds.seeds_from_last_regions = spy_last
        try:
            res, counts = counted(run)
        finally:
            seeds.seeds_from_last_regions = real_last
        t_idx, found = t_found[-1][0][0], t_found[-1][1][0]
        founded = {int(r.seed_point_index) for r in res.planar_regions} \
            & set(t_idx[found].tolist())
        plain_out = []

        def run_plain(s_plain=s_plain):
            plain_out.append(s_plain.segment_frame(pts2, origin2, None,
                                                   prev, pose))
        if k == 32:  # B1's inputs: the first epoch of the plain run
            t_args = capture(epoch_word, "epoch_word", run_plain)
        else:
            run_plain()
        res_plain = plain_out[0]
        check_frame("temporal_frame_vs_plain_and_golden", res, res_plain,
                    run(), golden_arrays(tgold, f"k{k}__"), pts2,
                    OPTION_GOLDEN_CELLS[f"temporal_k{k}"], counts, slots=k,
                    temporal_seeds_found=int(found.sum()),
                    regions_founded_by_temporal_seeds=len(founded))
        need = "epoch_word" if k == 32 else "flood_packed"
        if counts[need] <= 0 or counts["ccl_gated"] <= 0:
            fail(f"the temporal frame at {k} slots did not launch {need} "
                 "and ccl_gated")
    # B1 on the captured epoch of the temporal frame (negative ranks)
    if not bool((t_args[3] < 0).any()):
        fail("the temporal frame's rank grid holds no negative ranks")
    e_got = epoch_word.epoch_word(*t_args)
    e_want = epoch_word.epoch_word(*t_args, impl="plain")
    torch.cuda.synchronize()
    exact = all(bool(torch.equal(g, w)) for g, w in zip(e_got[:4],
                                                         e_want[:4]))
    mom_ok = bool(torch.allclose(e_got[4], e_want[4], rtol=MOM_RTOL,
                                 atol=MOM_ATOL, equal_nan=True))
    emit("epoch_word_negative_ranks", exact_words_counts=exact,
         moments_ok=mom_ok, negative_rank_cells=int((t_args[3] < 0).sum()),
         min_rank=int(t_args[3].min()),
         negative_slot_ranks=int((e_got[2] < 0).sum()))
    if not (exact and mom_ok):
        fail("epoch_word disagrees with its plain version on negative ranks")

    # 15. average-normal seeds: the VGA frame, the VGA stream at B = 8 and
    # the 128x160 stream golden
    ogold = np.load(os.path.join(testdata, "jax_options_vga.npz"))
    avg_cfg = config.SegmenterConfig(seed_method="average_normals")
    ms_cfg = config.SegmenterConfig(cluster=dataclasses.replace(
        config.ClusterRegionConfig(),
        cluster_method=config.ClusterMethod.MEAN_SHIFT))
    osegs = {name: (pipeline.Segmenter(c, device=dev),
                    pipeline.Segmenter(c, device=dev, impl="plain"))
             for name, c in (("avg", avg_cfg), ("ms", ms_cfg))}
    dc = scenes["cluttered"]
    ptsc = unproject.unproject_range_np(dc, rays)
    for name in ("avg", "ms"):
        if hashlib.sha256(dc.tobytes()).digest() != \
                ogold[f"{name}__depth_sha256"].tobytes():
            fail(f"the cluttered frame differs from the {name} golden's input")
    s, s_plain = osegs["avg"]
    res, counts = counted(lambda: s.segment_frame_stream(dc, rays, origin))
    check_frame("avg_frame_vs_plain_and_golden", res,
                s_plain.segment_frame_stream(dc, rays, origin),
                s.segment_frame_stream(dc, rays, origin),
                golden_arrays(ogold, "avg__"), ptsc,
                OPTION_GOLDEN_CELLS["avg"], counts)
    if counts["epoch_word"] <= 0 or counts["ccl_gated"] <= 0:
        fail("the average-normal frame did not launch epoch_word and "
             "ccl_gated")
    a_out, a_counts = counted(lambda: s.device_forward_stream(
        batches["cluttered"], rays_d, origin_d))
    p_out = s_plain.device_forward_stream(batches["cluttered"], rays_d,
                                          origin_d)
    again = s.device_forward_stream(batches["cluttered"], rays_d, origin_d)
    torch.cuda.synchronize()
    same_plain = all(torch.equal(a_out[i], p_out[i]) for i in range(3))
    plane_err = float((a_out[3] - p_out[3]).abs().max())
    identical = all(torch.equal(x, y) for x, y in zip(a_out, again))
    emit("avg_stream_vs_plain", num_planar=a_out[1].tolist(),
         num_clusters=a_out[2].tolist(), launches=a_counts,
         labels_counts_equal=same_plain, planes_max_abs_err=plane_err,
         atol=PLANE_ATOL, bit_identical_rerun=identical)
    if not (same_plain and plane_err <= PLANE_ATOL and identical
            and a_counts["epoch_word"] > 0 and a_counts["ccl_gated"] > 0
            and bool((a_out[1] > 0).all())):
        fail("the average-normal stream disagrees with its plain run or "
             "rerun, or did not launch its kernels")
    sgold = np.load(os.path.join(testdata, "jax_avg_stream_128x160.npz"))
    gh, gw = sgold["depth"].shape[1:]
    g_rays = unproject.camera_ray_table(gh, gw, f=float(gh))
    g_out = [t.cpu().numpy() for t in s.device_forward_stream(
        torch.from_numpy(sgold["depth"]).to(dev),
        torch.from_numpy(g_rays).to(dev), origin_d)]
    lab_ok = bool((g_out[2] == sgold["num_clusters"]).all())
    per_frame = []
    for b in range(g_out[0].shape[0]):
        cells = int((g_out[0][b] != sgold["labels"][b]).sum())
        got_b = dict(num_planar=int(g_out[1][b]),
                     golden_num_planar=int(sgold["num_planar"][b]),
                     cells=cells)
        per_frame.append(got_b)
        known = AVG_STREAM_KNOWN.get(b)
        lab_ok &= got_b == known if known else \
            (cells == 0 and got_b["num_planar"] == got_b["golden_num_planar"])
    g_pts = unproject.unproject_range_np(sgold["depth"], g_rays)
    worst = max((float(np.abs(g_out[3][b, r] - sgold["planes"][b, r]).max())
                 / plane_tolerance(g_pts[b][sgold["labels"][b] == r])
                 for b in range(g_out[0].shape[0]) if b not in AVG_STREAM_KNOWN
                 for r in range(int(sgold["num_planar"][b]))), default=0.0)
    emit("avg_stream_jax_golden", frames=per_frame, known=AVG_STREAM_KNOWN,
         labels_counts_as_known=lab_ok, planes_worst_err_over_tolerance=worst)
    if not (lab_ok and worst <= 1.0):
        fail("the average-normal stream disagrees with its JAX golden "
             "beyond the known frame")

    # 16. mean shift: the VGA frame (native growth), then the device
    # growth on the card against the host growth at 120x160
    native_calls = []
    real_native = mean_shift._sliding_mean_shift_native

    def spy_native(*a, **kw):
        native_calls.append(1)
        return real_native(*a, **kw)

    s, s_plain = osegs["ms"]
    mean_shift._sliding_mean_shift_native = spy_native
    try:
        res, counts = counted(lambda: s.segment_frame_stream(dc, rays,
                                                             origin))
        if not native_calls:
            fail("the mean-shift frame did not take the native growth")
        check_frame("mean_shift_frame_vs_plain_and_golden", res,
                    s_plain.segment_frame_stream(dc, rays, origin),
                    s.segment_frame_stream(dc, rays, origin),
                    golden_arrays(ogold, "ms__"), ptsc,
                    OPTION_GOLDEN_CELLS["ms"], counts,
                    native_growth_calls=len(native_calls))
    finally:
        mean_shift._sliding_mean_shift_native = real_native
    if counts["epoch_word"] <= 0 or counts["ccl_gated"] != 0 \
            or counts["mean_shift_modes"] != 1:
        fail("the mean-shift frame must launch epoch_word, the shift's "
             "mean_shift_modes once and not the euclidean cluster stage's "
             f"ccl_gated: {counts}")
    mh, mw = MS_DEVICE_SHAPE
    from pcseg_tpu_torch.utils.synthetic import synthetic_cluttered_room_cloud
    m16 = unproject.encode_range(synthetic_cluttered_room_cloud(
        mh, mw, f=float(mh), seed=1)[0])
    mpts = unproject.unproject_range_np(
        m16, unproject.camera_ray_table(mh, mw, f=float(mh)))
    mres = pipeline.Segmenter(device=dev).segment_frame(mpts, origin)
    n_pl = mres.metrics.num_planar_regions
    # the frame's planar labels; the mean shift clusters the rest
    mlab = np.where(mres.labels >= n_pl, config.UNLABELED,
                    mres.labels).astype(np.int32)
    grown = {}
    for growth in ("device", "host"):
        lab = mlab.copy()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        regions = mean_shift.sliding_mean_shift(
            mpts, lab, config.ClusterRegionConfig(), 5, n_pl,
            growth=growth, device=dev)
        torch.cuda.synchronize()
        grown[growth] = (lab, regions, (time.perf_counter() - t0) * 1e3)
    agree = float((grown["device"][0] == grown["host"][0]).mean())
    emit("device_mean_shift_vs_host", shape=[mh, mw], agreement=agree,
         regions=[len(grown[g][1]) for g in ("device", "host")],
         device_ms=grown["device"][2], host_growth_ms=grown["host"][2],
         card=card)
    if agree < 0.99 or len(grown["device"][1]) != len(grown["host"][1]):
        fail("the device mean shift disagrees with the host growth")

    # 17. the cluster stage's CCL at half-window 3 (48 offsets, the
    # bool-gate rounds) on the card against the same call on the CPU (the
    # first frame: the CPU call is the phase's cost)
    c_pts, c_elig, c_thr = (a[:1] if torch.is_tensor(a) else a
                            for a in cpts[:3])
    on_card = connectivity.connected_components_scan(c_pts, c_elig, c_thr, 3)
    on_cpu = connectivity.connected_components_scan(c_pts.cpu(),
                                                    c_elig.cpu(), c_thr, 3)
    same = bool(torch.equal(on_card.cpu(), on_cpu))
    live = on_cpu < on_cpu.shape[1] * on_cpu.shape[2]
    ccl48_ms = cuda_ms(torch, lambda: connectivity.connected_components_scan(
        c_pts, c_elig, c_thr, 3), reps=OPTION_REPS)
    emit("ccl_48_offsets_card_vs_cpu", shape=list(c_elig.shape), equal=same,
         components=int(torch.unique(on_cpu[live]).numel()), ms=ccl48_ms,
         card=card)
    if not same:
        fail("the 48-offset CCL on the card differs from the CPU's")

    # 18. times: ms per frame, device program and host finalize
    def split_times(s, run_payload, finalize, whole):
        dev_ms = cuda_ms(torch, run_payload, reps=OPTION_REPS)
        host, total = [], []
        for _ in range(OPTION_REPS):
            payload = run_payload()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            finalize(payload)
            host.append((time.perf_counter() - t0) * 1e3)
            t0 = time.perf_counter()
            whole()
            torch.cuda.synchronize()
            total.append((time.perf_counter() - t0) * 1e3)
        return dict(device_ms=dev_ms,
                    host_finalize_ms=statistics.median(host),
                    whole_ms=statistics.median(total))

    times = {}
    pts2_d = torch.from_numpy(pts2).to(dev)[None]
    o2_d = torch.from_numpy(origin2).to(dev)
    for k, (s, _) in tsegs.items():
        tables = s._temporal_tables(prev, pose)
        times[f"temporal_k{k}"] = split_times(
            s, lambda s=s, tables=tables: s._payload(pts2_d, o2_d, None, None,
                                                     tables),
            lambda p, s=s: s._host_finalize(pts2, pts2_d, p, None),
            lambda s=s: s.segment_frame(pts2, origin2, None, prev, pose))
    dc_d = unproject.unproject_range(torch.from_numpy(dc).to(dev)[None],
                                     rays_d)
    for name, (s, _) in osegs.items():
        times[f"{name}_frame"] = split_times(
            s, lambda s=s: s._payload(dc_d, origin_d, None, None),
            lambda p, s=s: s._host_finalize(ptsc, dc_d, p, None),
            lambda s=s: s.segment_frame_stream(dc, rays, origin))
    times["avg_stream_b8_ms_per_batch"] = cuda_ms(
        torch, lambda: osegs["avg"][0].device_forward_stream(
            batches["cluttered"], rays_d, origin_d), reps=OPTION_REPS)
    times["device_mean_shift"] = dict(shape=[mh, mw],
                                      ms=grown["device"][2],
                                      host_growth_ms=grown["host"][2])
    times["ccl_48_offsets_ms"] = ccl48_ms
    times["phases_14_to_18_seconds"] = time.perf_counter() - t_start
    return times


def unorganized_phases(torch, card, dev, reset_counts, read_counts,
                       kernels_mod):
    """Phases 19-21: the unorganized clouds of BASELINE config 3 (1M points)
    and B2 on their voxel grids. Returns (times, B2's voxel-grid entries,
    B2's launches in the euclidean call)."""
    from pcseg_tpu_torch.kernels import ccl_gated
    from pcseg_tpu_torch.models import cluster, config, unorganized
    from pcseg_tpu_torch.ops import voxelize
    from pcseg_tpu_torch.utils.synthetic import gaussian_blobs

    t_start = time.perf_counter()
    pts = gaussian_blobs(n_per=UNORG_POINTS_PER_BLOB, seed=0)
    gold = np.load(os.path.join(ROOT, "pcseg_tpu_torch", "testdata",
                                "jax_unorganized_1m.npz"))
    if hashlib.sha256(pts.tobytes()).digest() != \
            gold["cloud_sha256"].tobytes():
        fail("the config-3 cloud differs from the golden's")
    pts_d = torch.from_numpy(pts).to(dev)
    ecfg, ekw = unorganized_case(config, "euclid")

    def euclid(impl=None, points=pts_d, **kw):
        out = unorganized.cluster_unorganized(points, ecfg, device=dev,
                                              impl=impl, **{**ekw, **kw})
        torch.cuda.synchronize()
        return out

    # 19. the euclidean call: one B2 launch, equal to its plain run, a
    # rerun, the native host path and the JAX golden
    euclid()  # warm-up
    reset_counts()
    res = euclid()
    counts = read_counts()
    again, plain = euclid(), euclid(impl="plain")
    host = unorganized.cluster_unorganized_host(pts, ecfg, **ekw)
    fields = ("grid_labels", "num_regions", "region_sizes")
    checks = dict(
        launches_ok=counts["ccl_gated"] == 1 and sum(counts.values()) == 1,
        well_formed=(res.point_labels.shape == (len(pts),)
                     and res.point_labels.dtype == torch.int32
                     and int(res.num_regions) == 4),
        bit_identical_rerun=all(torch.equal(a, b)
                                for a, b in zip(res, again)),
        equal_plain=all(torch.equal(a, b) for a, b in zip(res, plain)),
        equal_native_host=all(
            np.array_equal(np.asarray(getattr(res, f).cpu()),
                           np.asarray(getattr(host, f)))
            for f in ("point_labels",) + fields),
        equal_jax_golden=all(
            np.array_equal(getattr(res, f).cpu().numpy(),
                           gold["euclid__" + f]) for f in fields))
    emit("unorganized_euclid_1m", points=len(pts), card=card,
         num_regions=int(res.num_regions),
         region_sizes=res.region_sizes[:4].tolist(), launches=counts,
         **checks)
    if not all(checks.values()):
        fail(f"the 1M-point euclidean call failed a check: {checks}")

    def host_ms(fn, reps=OPTION_REPS):
        fn()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    times = dict(
        euclid_1m_device_ms=cuda_ms(torch, euclid, reps=OPTION_REPS),
        euclid_1m_plain_ms=cuda_ms(torch, lambda: euclid("plain"),
                                   reps=OPTION_REPS),
        euclid_1m_from_host_ms=host_ms(lambda: euclid(points=pts)),
        euclid_1m_native_host_ms=host_ms(
            lambda: unorganized.cluster_unorganized_host(pts, ecfg, **ekw)))
    times["euclid_1m_points_per_s"] = len(pts) / (
        times["euclid_1m_device_ms"] / 1e3)
    stages = [(voxelize, "voxelize_xy"), (cluster, "segment_clusters"),
              (ccl_gated, "ccl_gated"),
              (voxelize, "scatter_labels_to_points")]
    emit("stages", path="unorganized_euclid_1m", card=card,
         synced_ms=synced_stages(torch, stages, euclid),
         profile=profile_window(torch, euclid))

    # 20. B2 on the voxel grids: the euclidean call's 256x256 grid and the
    # default 512x512 grid (0.25 m cells)
    voxel = []
    for label, kw in (("256x256", {}),
                      ("512x512", dict(cell_size=0.25,
                                       grid_shape=(512, 512)))):
        args = capture(ccl_gated, "ccl_gated",
                       lambda kw=kw: euclid("plain", **kw))
        gate, lab0, offs, cap, big = args
        ran = [torch.zeros(1, dtype=torch.int32, device=dev)
               for _ in range(2)]
        got = ccl_gated.ccl_gated(*args, rounds_out=ran[0])
        want = ccl_gated.ccl_gated(*args, impl="plain", rounds_out=ran[1])
        torch.cuda.synchronize()
        exact = bool(torch.equal(got, want)) and torch.equal(*ran)
        per_call, launched, _ = kernels_per_call(
            torch, lambda: ccl_gated.ccl_gated(*args))
        b_ms, b_by = bound(nbytes(gate, lab0, got))
        entry = dict(shape=list(gate.shape), cap=cap,
                     rounds_run=ran[0].tolist(),
                     eligible=int((got < big).sum()),
                     max_abs_err=int((got.to(torch.int64) - want).abs().max()),
                     ms=cuda_ms(torch, lambda: ccl_gated.ccl_gated(*args)),
                     ms_per_call_of_10=cuda_ms(
                         torch, lambda: ccl_gated.ccl_gated(*args),
                         calls=10),
                     plain_ms=cuda_ms(torch, lambda: ccl_gated.ccl_gated(
                         *args, impl="plain")),
                     bound_ms=b_ms, bound_by=b_by,
                     launch_calls_per_call=launched)
        emit("ccl_gated_voxel_grid", grid=label, card=card, exact=exact,
             device_events_per_call=per_call, **entry)
        if not exact or launched != 1:
            fail(f"ccl_gated on the {label} voxel grid disagrees with its "
                 "plain version or is not one launch")
        voxel.append(entry)

    # 21. the mean-shift call at 512x512 (0.125 m cells): the host backend
    # equal to the JAX golden, the device backend on the card agreeing
    # with it on >= 99% of the points (tests/test_unorganized.py's bound)
    mcfg, mkw = unorganized_case(config, "mean_shift")
    t0 = time.perf_counter()
    mhost = unorganized.cluster_unorganized_mean_shift(pts, mcfg,
                                                       backend="host", **mkw)
    mhost_ms = (time.perf_counter() - t0) * 1e3
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mdev = unorganized.cluster_unorganized_mean_shift(
        pts_d, mcfg, backend="device", device=dev, **mkw)
    torch.cuda.synchronize()
    mdev_ms = (time.perf_counter() - t0) * 1e3
    mcounts = read_counts()
    agree = float((mdev.point_labels.cpu().numpy()
                   == mhost.point_labels).mean())
    checks = dict(
        host_equal_jax_golden=bool(
            np.array_equal(mhost.grid_labels, gold["ms__grid_labels"])
            and int(mhost.num_regions) == int(gold["ms__num_regions"])),
        device_on_card=mdev.point_labels.device.type == "cuda",
        device_agreement_ok=agree >= 0.99)
    emit("unorganized_mean_shift_1m", points=len(pts), card=card,
         host_regions=int(mhost.num_regions),
         device_regions=int(mdev.num_regions), point_agreement=agree,
         host_ms=mhost_ms, device_ms=mdev_ms, launches=mcounts, **checks)
    if not all(checks.values()):
        fail(f"the 1M-point mean-shift call failed a check: {checks}")
    times.update(mean_shift_1m_host_ms=host_ms(
        lambda: unorganized.cluster_unorganized_mean_shift(
            pts, mcfg, backend="host", **mkw)),
        mean_shift_1m_device_ms=mdev_ms)
    times["phases_19_to_21_seconds"] = time.perf_counter() - t_start
    return times, voxel, counts["ccl_gated"]


def sequential_phase(torch, card, dev, reset_counts, read_counts):
    """Phase 22: ``Segmenter`` with the sequential grower (hybrid and
    wavefront) on a 120x160 room frame on the card against the same frame
    on the CPU, counted like phase 3 (the cluster stage's B2 launches, B1
    and B3 do not). Returns the frames' ms."""
    import dataclasses
    from pcseg_tpu_torch.models import config, pipeline
    from pcseg_tpu_torch.ops import unproject
    from pcseg_tpu_torch.utils.synthetic import synthetic_room_cloud

    h, w = MS_DEVICE_SHAPE
    d16 = unproject.encode_range(synthetic_room_cloud(
        h, w, f=float(h), seed=1)[0])
    pts = unproject.unproject_range_np(
        d16, unproject.camera_ray_table(h, w, f=float(h)))
    origin = np.zeros(3, np.float32)
    out = {}
    for mode in ("hybrid", "wavefront"):
        cfg = config.SegmenterConfig(planar=dataclasses.replace(
            config.PlanarRegionConfig(), growth_mode=mode))
        seg = pipeline.Segmenter(cfg, device=dev)
        seg.segment_frame(pts, origin)  # warm-up
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pipeline.frame_arrays(seg.segment_frame(pts, origin))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        counts = read_counts()
        cpu = pipeline.Segmenter(cfg, device="cpu")
        t0 = time.perf_counter()
        want = pipeline.frame_arrays(cpu.segment_frame(pts, origin))
        cpu_ms = (time.perf_counter() - t0) * 1e3
        same = all(np.array_equal(got[k], want[k]) for k in EXACT)
        plane_err = float(np.abs(got["planes"] - want["planes"]).max()) \
            if len(want["planes"]) else 0.0
        emit("sequential_grower_frame", mode=mode, shape=[h, w], card=card,
             metrics=got["metrics"].tolist(), exact_vs_cpu=same,
             planes_max_abs_err=plane_err, atol=PLANE_ATOL, launches=counts,
             ms=ms, cpu_ms=cpu_ms)
        if not (same and plane_err <= PLANE_ATOL):
            fail(f"the {mode} frame on the card differs from the CPU's")
        if counts["ccl_gated"] <= 0 or counts["epoch_word"] \
                or counts["flood_packed"] or got["metrics"][2] < 1:
            fail(f"the {mode} frame must find planes and launch only "
                 f"ccl_gated: {counts}")
        out[f"{mode}_frame_ms"] = ms
    return out


def synced_stages(torch, stages, run):
    """Synced wall ms of each (module, function name) in ``stages`` during
    ``run()`` (a sync before and after each wrapped call) and of the whole
    call."""
    acc = {name: 0.0 for _, name in stages}
    real = {}
    for mod, name in stages:
        real[name] = getattr(mod, name)

        def wrap(*a, _f=real[name], _n=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _f(*a, **kw)
            torch.cuda.synchronize()
            acc[_n] += (time.perf_counter() - t0) * 1e3
            return out
        setattr(mod, name, wrap)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        acc["whole call"] = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name in stages:
            setattr(mod, name, real[name])
    return acc


def profile_window(torch, run):
    """A torch.profiler window of one unsynced ``run()``: wall ms, device
    busy ms, idle share, device events and the top kernels."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type.name == "CUDA"]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
    return dict(wall_ms=wall, device_busy_ms=busy,
                idle_share=1 - busy / wall if wall else None,
                device_events=sum(e.count for e in kernels),
                top=[(e.key[:60], e.self_device_time_total / 1e3, e.count)
                     for e in top])


def stage_profile(torch, card, segs, stream, scenes, rays, origin,
                  pipeline):
    """Where the time goes on the cluttered scene, for the stream batch and
    the full-pipeline frame at 32 and 64 slots: synced wall ms per stage,
    then a torch.profiler window (device busy vs wall) of one unsynced call
    of each."""
    from pcseg_tpu_torch.kernels import ccl_gated, epoch_word, flood_packed
    from pcseg_tpu_torch.models import cluster, planar_batched
    from pcseg_tpu_torch.ops import discontinuity, normals, seeds

    stages = [(normals, "compute_normals_organized"),
              (seeds, "seeds_from_plane_support"),
              (planar_batched, "grow_planar_regions_batched"),
              (epoch_word, "epoch_word"), (flood_packed, "flood_packed"),
              (cluster, "segment_clusters"), (ccl_gated, "ccl_gated"),
              (discontinuity, "discontinuity_flags"),
              (pipeline.Segmenter, "_host_finalize")]
    d16 = scenes["cluttered"]
    runs = {}
    for k, (s, _) in segs.items():
        runs[f"stream{k}_cluttered"] = lambda s=s: stream(s, "cluttered")
        runs[f"frame{k}_cluttered"] = lambda s=s: s.segment_frame_stream(
            d16, rays, origin)
    for name, run in runs.items():
        run()
        emit("stages", path=name, card=card,
             synced_ms=synced_stages(torch, stages, run),
             profile=profile_window(torch, run))


def proto_phase(torch, card, dev, scenes, rays, origin):
    """Phase 24: the cluttered VGA frame's detected objects
    (``segment_frame_stream``, 32 slots) and its cloud (points and the
    frame's normals) through the port's proto codec: serialised, parsed
    and serialised again to the same bytes; the parsed planes, object
    classes, point counts and cloud channels equal what went in. Returns
    the times."""
    from pcseg_tpu_torch.models import extract, pipeline
    from pcseg_tpu_torch.ops import normals as normals_op
    from pcseg_tpu_torch.ops import unproject
    from pcseg_tpu_torch.protos import pcseg_pb2
    from pcseg_tpu_torch.utils import cloud as cloud_lib
    from pcseg_tpu_torch.utils import io

    d16 = scenes["cluttered"]
    res = pipeline.Segmenter(device=dev).segment_frame_stream(d16, rays,
                                                              origin)
    pts = torch.from_numpy(unproject.unproject_range_np(d16, rays))
    nrm = normals_op.compute_normals_organized(
        pts[None].to(dev), torch.from_numpy(origin).to(dev))[0].cpu()
    cloud = cloud_lib.PointCloud(points=pts, normals=nrm)
    t0 = time.perf_counter()
    obj_bytes = extract.detected_objects_proto(res.objects) \
        .SerializeToString()
    t1 = time.perf_counter()
    objs = pcseg_pb2.DetectedObjectsProto.FromString(obj_bytes)
    t2 = time.perf_counter()
    cloud_bytes = io.cloud_to_proto(cloud).SerializeToString()
    t3 = time.perf_counter()
    back = io.proto_to_cloud(
        pcseg_pb2.MultichannelCloudProto.FromString(cloud_bytes))
    t4 = time.perf_counter()
    same_bytes = (objs.SerializeToString() == obj_bytes
                  and pcseg_pb2.MultichannelCloudProto.FromString(
                      cloud_bytes).SerializeToString() == cloud_bytes)
    planes_ok = all(
        (o.plane is None) == (p.WhichOneof("geometry") == "cluster_geometry")
        and o.object_class == p.object_class
        and len(getattr(p, p.WhichOneof("geometry")).points_xyz)
        == 3 * len(o.points)
        and (o.plane is None or np.allclose(
            extract.plane_from_proto(p.planar_geometry.plane), o.plane,
            atol=1e-6))
        for o, p in zip(res.objects, objs.detected_objects))
    cloud_ok = all(torch.equal(torch.nan_to_num(getattr(back, k), 7.0),
                               torch.nan_to_num(getattr(cloud, k), 7.0))
                   for k in ("points", "normals"))
    ok = (same_bytes and planes_ok and cloud_ok
          and len(objs.detected_objects) == len(res.objects) > 0)
    times = dict(objects_serialize_ms=(t1 - t0) * 1e3,
                 objects_parse_ms=(t2 - t1) * 1e3,
                 cloud_serialize_ms=(t3 - t2) * 1e3,
                 cloud_parse_ms=(t4 - t3) * 1e3)
    emit("protos", card=card, objects=len(res.objects),
         objects_bytes=len(obj_bytes), cloud_bytes=len(cloud_bytes),
         bytes_round_trip_equal=same_bytes, objects_equal=planes_ok,
         cloud_channels_equal=cloud_ok, **times)
    if not ok:
        fail("the proto round trips of the cluttered VGA frame disagree")
    return times


SURFACE_CLASSIFY = dict(
    floor_params=dict(max_up_direction_delta_angle_degrees=0.0,
                      floor_offset=0.0, max_floor_offset_deviation=0.05,
                      min_area=0.5, max_area=50.0),
    coffee_table_params=dict(max_up_direction_delta_angle_degrees=10.0,
                             floor_offset=-0.45,
                             max_floor_offset_deviation=0.1, min_area=0.1,
                             max_area=2.0),
    wall_params=dict(max_horizontal_delta_angle_degrees=10.0,
                     min_height=0.6))
SURFACE_STAGES = ("compute_normals_organized", "seeds_from_plane_support",
                  "grow_planar_regions_batched", "segment_clusters")


def surface_phase(torch, card, dev, scenes, rays, origin, stream,
                  stream_args, segs, reset_counts, read_counts):
    """Phase 27: the JAX package's last public surface on the card.
    ``flood_fill_static`` on the first flood's gates of a plain 64-slot
    stream run (cluttered, B = 8), counted (one B3 launch, nothing else)
    and equal to its plain version; ``connected_components_mask`` on the
    cluttered VGA frame's unlabeled mask, both neighbourhoods, rounds free
    and capped at 1 and 3, equal to the CPU; ``classify_planes_batched``
    on that frame's records equal to the CPU; ``graft_entry.entry()``'s
    forward,
    counted (B1 and B2 launch) and equal to ``Segmenter(impl="plain")``
    on the card; ``utils/profiling.trace_to`` around one stream call with
    ``stage`` on its stages (``stream_args``: the cluttered batch, rays
    and origin), whose names must be in the trace;
    ``graft_entry.dryrun_multichip(1)`` (:func:`dryrun_phase`). Returns
    ({call: launches per kernel} of the counted calls, times)."""
    import tempfile
    from pcseg_tpu_torch import graft_entry
    from pcseg_tpu_torch.models import (classify, cluster, config, pipeline,
                                        planar_batched)
    from pcseg_tpu_torch.ops import connectivity, nansafe, normals, seeds
    from pcseg_tpu_torch.ops import unproject
    from pcseg_tpu_torch.utils import profiling

    t_start = time.perf_counter()
    seg, _ = segs[32]
    _, seg64_plain = segs[64]
    times = {}

    # flood_fill_static (B3) on the 64-slot stream's first flood
    gate, src, rounds = capture(planar_batched, "flood_fill_static",
                                lambda: stream(seg64_plain, "cluttered"))
    planar_batched.flood_fill_static(gate, src, rounds)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    got = planar_batched.flood_fill_static(gate, src, rounds)
    torch.cuda.synchronize()
    flood_counts = read_counts()
    want = planar_batched.flood_fill_static(gate, src, rounds, impl="plain")
    exact = bool(torch.equal(got, want))
    times["flood_fill_static_ms"] = cuda_ms(
        torch, lambda: planar_batched.flood_fill_static(gate, src, rounds))
    times["flood_fill_static_plain_ms"] = cuda_ms(
        torch, lambda: planar_batched.flood_fill_static(gate, src, rounds,
                                                        impl="plain"))
    emit("surface_flood_fill_static", card=card, shape=list(gate.shape),
         rounds=rounds, launches=flood_counts, exact=exact,
         reached=int(got.sum()), sources=int((src & gate).sum()),
         ms=times["flood_fill_static_ms"],
         plain_ms=times["flood_fill_static_plain_ms"])
    if not exact or nonzero_counts(flood_counts) != {"flood_packed": 1}:
        fail(f"flood_fill_static: exact={exact}, launches {flood_counts} "
             "(one flood_packed launch and nothing else expected)")

    # connected_components_mask on the cluttered frame's unlabeled mask
    pts = torch.from_numpy(unproject.unproject_range_np(
        scenes["cluttered"], rays)).to(dev)
    _, _, regions, _ = seg.device_forward(pts, origin)
    mask = (regions.labels == config.UNLABELED) & nansafe.all_finite(pts)
    ccl = []
    for nb4 in (True, False):
        free, free_cpu = (connectivity.connected_components_mask(
            m, max_iters=100_000, neighborhood4=nb4)
            for m in (mask, mask.cpu()))
        capped = {cap: [connectivity.connected_components_mask(
            m, max_iters=cap, neighborhood4=nb4) for m in (mask, mask.cpu())]
            for cap in (1, 3)}
        line = dict(neighborhood4=nb4, cells=int(mask.sum()),
                    components=int(torch.unique(free[mask]).numel()),
                    free_equal_cpu=torch.equal(free.cpu(), free_cpu),
                    capped_equal_cpu={cap: torch.equal(c[0].cpu(), c[1])
                                      for cap, c in capped.items()},
                    cap_binds={cap: not torch.equal(free, c[0])
                               for cap, c in capped.items()},
                    ms=cuda_ms(torch, lambda: connectivity
                               .connected_components_mask(
                                   mask, max_iters=100_000,
                                   neighborhood4=nb4)))
        times[f"ccl_mask_nb{4 if nb4 else 8}_ms"] = line["ms"]
        ccl.append(line)
        emit("surface_ccl_mask", card=card, shape=list(mask.shape), **line)
    if not all(c["free_equal_cpu"] and all(c["capped_equal_cpu"].values())
               for c in ccl):
        fail("connected_components_mask on the card differs from the CPU")

    # classify_planes_batched on that frame's records
    cfg = config.config_from_dict(
        dict(classification=SURFACE_CLASSIFY)).classification
    up = np.float32([0.0, 0.0, 1.0])
    floor_point = np.float32([0.0, 0.0, -1.0])
    recs = seg.segment_frame_stream(scenes["cluttered"], rays,
                                    origin).planar_regions
    planes = np.stack([r.plane for r in recs]).astype(np.float32)
    areas = np.float32([r.area for r in recs])
    hull = [np.asarray(r.projected_boundary_points, np.float32) @ up
            for r in recs]
    heights = np.float32([h.max() - h.min() if len(h) else 0.0
                          for h in hull])
    args = [torch.from_numpy(a) for a in (planes, areas, heights, up,
                                          floor_point)]
    cls = classify.classify_planes_batched(*[a.to(dev) for a in args], cfg)
    cls_cpu = classify.classify_planes_batched(*args, cfg)
    cls_equal = torch.equal(cls.cpu(), cls_cpu)
    emit("surface_classify", card=card, planes=len(recs),
         classes=cls.tolist(), equal_cpu=cls_equal)
    if not cls_equal:
        fail("classify_planes_batched on the card differs from the CPU")

    # the graft entry's forward
    forward, fargs = graft_entry.entry(dev)
    forward(*fargs)  # warm-up
    torch.cuda.synchronize()
    reset_counts()
    out = forward(*fargs)
    torch.cuda.synchronize()
    entry_counts = read_counts()
    forward_plain = pipeline.Segmenter(device=dev, impl="plain") \
        .device_forward
    plain = forward_plain(*fargs)
    same = (torch.equal(out[0], plain[0])
            and torch.equal(out[2].num_regions, plain[2].num_regions)
            and torch.equal(out[3].num_regions, plain[3].num_regions))
    n_planar = int(out[2].num_regions)
    plane_err = float((out[2].planes[:n_planar]
                       - plain[2].planes[:n_planar]).abs().max())
    times["entry_forward_ms"] = cuda_ms(torch, lambda: forward(*fargs))
    times["entry_forward_plain_ms"] = cuda_ms(
        torch, lambda: forward_plain(*fargs))
    emit("surface_entry_forward", card=card, shape=list(fargs[0].shape),
         launches=entry_counts, labels_counts_equal_plain=same,
         planes_max_abs_err=plane_err, atol=PLANE_ATOL,
         num_planar=n_planar, num_clusters=int(out[3].num_regions),
         ms=times["entry_forward_ms"],
         plain_ms=times["entry_forward_plain_ms"])
    if not (same and plane_err <= PLANE_ATOL and n_planar > 0):
        fail("the entry forward differs from its plain run")
    if entry_counts["epoch_word"] <= 0 or entry_counts["ccl_gated"] <= 0:
        fail(f"the entry forward did not launch B1 and B2: {entry_counts}")

    # a profiler trace of one stream call with stage() on its stages
    mods = dict(compute_normals_organized=normals,
                seeds_from_plane_support=seeds,
                grow_planar_regions_batched=planar_batched,
                segment_clusters=cluster)
    real = {name: getattr(mods[name], name) for name in SURFACE_STAGES}

    def staged(name):
        def run(*a, **kw):
            with profiling.stage(name):
                return real[name](*a, **kw)
        return run

    timer = profiling.Timer()
    for name in SURFACE_STAGES:
        setattr(mods[name], name, staged(name))
    try:
        with tempfile.TemporaryDirectory() as tmp:
            with profiling.trace_to(tmp) as path:
                outs = []
                with timer.measure("stream32_cluttered", sync_value=outs):
                    outs.append(seg.device_forward_stream(*stream_args))
            with open(path) as f:
                events = json.load(f)["traceEvents"]
    finally:
        for name in SURFACE_STAGES:
            setattr(mods[name], name, real[name])
    names = {e.get("name") for e in events}
    kernel_records = sum(e.get("cat") == "kernel" for e in events)
    missing = [n for n in SURFACE_STAGES if n not in names]
    emit("surface_trace", card=card, stages=list(SURFACE_STAGES),
         missing=missing, events=len(events),
         cuda_kernel_records=kernel_records, timer=timer.summary())
    if missing:
        fail(f"the stage names {missing} are not in the trace")

    times["dryrun_1_seconds"] = dryrun_phase(card, 1)
    times["phase_27_seconds"] = time.perf_counter() - t_start
    return dict(flood_fill_static=flood_counts, entry_forward=entry_counts), \
        times


def compare_bitwise(torch, bad, name, got, want):
    """Bitwise equality (NaN equal NaN, equal shapes and dtypes) of tensors
    or (Named)tuples of them, None fields equal to None; appends the name
    of each field that differs to ``bad`` and returns {name: max |got -
    want|} of the float fields."""
    out = {}
    if isinstance(got, tuple):
        for f, g, w in zip(getattr(got, "_fields", range(len(got))), got,
                           want):
            out.update(compare_bitwise(torch, bad, f"{name}.{f}", g, w))
    elif got is None or want is None:
        if got is not want:
            bad.append(name)
    elif got.shape != want.shape or got.dtype != want.dtype:
        bad.append(f"{name} {tuple(got.shape)} {got.dtype}")
    elif got.is_floating_point():
        d = (got - want).abs().nan_to_num(0.0)
        out[name] = float(d.max()) if d.numel() else 0.0
        if not bool(((got == want) | (got.isnan() & want.isnan())).all()):
            bad.append(name)
    elif not torch.equal(got, want):
        bad.append(name)
    return out


# phase 28's grower schedule: a binding flood cap, no unboxed closure
# epochs past the final one, stage A as 26 generations of one ring, and an
# id offset (tests/test_torch_jax_conventions.py holds it to JAX)
CONVENTION_SCHEDULE = dict(initial_id_offset=7, stage_a_gens=26,
                           stage_a_rings=1, closure_epochs=0, flood_rounds=4)


def conventions_phase(torch, card, dev, scenes, rays, origin, reset_counts,
                      read_counts):
    """Phase 28: the public functions at JAX's single-frame shapes on one
    VGA frame of each scene. Each equals frame 0 of its batched call
    bitwise; those with a kernel (the CCL scan, the clusters, the grower)
    also equal their ``impl="plain"`` run. Normals on a sub-rectangle
    equal the full normals inside it and NaN or ``out_normals`` outside.
    The grower from the seed vector with default arguments equals the
    call on the vector's rank grid at 32 (B1) and 64 (B3) slots; with
    CONVENTION_SCHEDULE (its flood cap binds) the kernels equal the plain
    versions, counted. ``connected_components_scan`` on one frame makes one
    B2 launch. Returns ({call: launches}, times)."""
    from pcseg_tpu_torch.models import (cluster, config, mean_shift,
                                        planar_batched)
    from pcseg_tpu_torch.ops import (connectivity, discontinuity, nansafe,
                                     normals, seeds, unproject)
    from pcseg_tpu_torch.ops.frames import frame0

    t_start = time.perf_counter()
    launches, times, bad = {}, {}, []
    binds_any = False
    origin_d = torch.from_numpy(origin).to(dev)
    cfg = config.SegmenterConfig()

    def same(name, got, want):
        compare_bitwise(torch, bad, name, got, want)

    def counted(fn):
        torch.cuda.synchronize()
        reset_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, read_counts()

    for scene, u16 in scenes.items():
        pts = torch.from_numpy(unproject.unproject_range_np(u16, rays)) \
            .to(dev)
        nrm = normals.compute_normals_organized(pts, origin_d, cfg.normals)
        same(f"{scene}.normals", nrm, normals.compute_normals_organized(
            pts[None], origin_d, cfg.normals)[0])
        roi = dict(row_range=(100, 300), col_range=(150, 500))
        inside = torch.zeros((H, W), dtype=torch.bool, device=dev)
        inside[100:300, 150:500] = True
        buf = torch.full_like(nrm, 2.0)
        for out in (None, buf):
            got = normals.compute_normals_organized(
                pts, origin_d, cfg.normals, out_normals=out, **roi)
            want = torch.where(inside[..., None], nrm, float("nan")
                               if out is None else out)
            same(f"{scene}.normals_roi_{'nan' if out is None else 'buf'}",
                 got, want)
        ranked = seeds.seeds_from_plane_support(
            pts, nrm, cfg.plane_support_seeds, seed_vector=True)
        same(f"{scene}.plane_support_seeds", ranked,
             frame0(seeds.seeds_from_plane_support(
                 pts[None], nrm[None], cfg.plane_support_seeds,
                 seed_vector=True)))
        if ranked.rank_grid.shape != (H, W) or ranked.indices.dim() != 1:
            bad.append(f"{scene}.plane_support_seeds shapes")
        avg = seeds.seeds_from_average_normals(nrm)
        same(f"{scene}.average_normal_seeds", avg,
             frame0(seeds.seeds_from_average_normals(nrm[None])))
        same(f"{scene}.average_normal_seed_list",
             seeds.average_normal_seed_list(avg, 4096),
             frame0(seeds.average_normal_seed_list(
                 seeds.SeedMask(*[t[None] for t in avg]), 4096)))
        t_idx, t_found = ranked.indices[-5:], ranked.valid[-5:]
        same(f"{scene}.append_temporal", seeds.append_temporal_to_rank_grid(
            ranked.rank_grid, t_idx, t_found),
            seeds.append_temporal_to_rank_grid(
                ranked.rank_grid[None], t_idx[None], t_found[None])[0])

        labels0 = torch.full((H, W), config.UNLABELED, dtype=torch.int32,
                             device=dev)
        grid = planar_batched.rank_grid_from_seed_vector(
            ranked.indices, ranked.valid, H, W)
        same(f"{scene}.rank_grid_from_seed_vector", grid,
             planar_batched.rank_grid_from_seed_vector(
                 ranked.indices[None], ranked.valid[None], H, W)[0])
        for k in (32, 64):
            pcfg = config.PlanarRegionConfig(max_regions=k)
            from_vector = planar_batched.grow_planar_regions_batched(
                pts, nrm, labels0, ranked.indices, ranked.valid, pcfg)
            same(f"{scene}.grower_k{k}_seed_vector", from_vector,
                 planar_batched.grow_planar_regions_batched(
                     pts, nrm, labels0, None, None, pcfg,
                     seed_rank_grid=grid))
            sched, n = counted(
                lambda: planar_batched.grow_planar_regions_batched(
                    pts, nrm, labels0, ranked.indices, ranked.valid, pcfg,
                    **CONVENTION_SCHEDULE))
            launches[f"{scene}_grower_k{k}_schedule"] = n
            plain = planar_batched.grow_planar_regions_batched(
                pts, nrm, labels0, ranked.indices, ranked.valid, pcfg,
                **CONVENTION_SCHEDULE, impl="plain")
            same(f"{scene}.grower_k{k}_schedule_vs_plain", sched, plain)
            free = planar_batched.grow_planar_regions_batched(
                pts, nrm, labels0, ranked.indices, ranked.valid, pcfg,
                **dict(CONVENTION_SCHEDULE, flood_rounds=64))
            binds = not torch.equal(free.labels, sched.labels)
            binds_any = binds_any or binds
            offset_ok = int(sched.labels[sched.labels >= 0].min()) == \
                CONVENTION_SCHEDULE["initial_id_offset"]
            kernel = "epoch_word" if k <= 32 else "flood_packed"
            if n[kernel] <= 0 or not offset_ok or \
                    sched.labels.shape != (H, W):
                bad.append(f"{scene}.grower_k{k}_schedule launches {n}, "
                           f"offset {offset_ok}")
            ms = cuda_ms(torch, lambda: planar_batched
                         .grow_planar_regions_batched(
                             pts, nrm, labels0, ranked.indices, ranked.valid,
                             pcfg, **CONVENTION_SCHEDULE), reps=3)
            plain_ms = cuda_ms(torch, lambda: planar_batched
                               .grow_planar_regions_batched(
                                   pts, nrm, labels0, ranked.indices,
                                   ranked.valid, pcfg, **CONVENTION_SCHEDULE,
                                   impl="plain"), reps=2)
            times[f"{scene}_grower_k{k}_schedule_ms"] = ms
            times[f"{scene}_grower_k{k}_schedule_plain_ms"] = plain_ms
            emit("conventions_grower", card=card, scene=scene, slots=k,
                 schedule=CONVENTION_SCHEDULE, launches=n,
                 num_regions=int(sched.num_regions),
                 num_regions_seed_vector_defaults=int(
                     from_vector.num_regions),
                 cap_binds=binds, ms=ms, plain_ms=plain_ms)

        eligible = (labels0 == config.UNLABELED) & nansafe.all_finite(pts)
        thr = cfg.cluster.squared_distance_threshold
        half = cfg.cluster.half_search_window
        roots, n = counted(lambda: connectivity.connected_components_scan(
            pts, eligible, thr, half, cfg.cluster.scan_rounds))
        launches[f"{scene}_ccl_scan"] = n
        if nonzero_counts(n) != {"ccl_gated": 1}:
            bad.append(f"{scene}.ccl_scan launches {n}")
        same(f"{scene}.ccl_scan_vs_plain", roots,
             connectivity.connected_components_scan(
                 pts, eligible, thr, half, cfg.cluster.scan_rounds,
                 impl="plain"))
        same(f"{scene}.ccl_scan_vs_batch", roots,
             connectivity.connected_components_scan(
                 pts[None], eligible[None], thr, half,
                 cfg.cluster.scan_rounds)[0])
        times[f"{scene}_ccl_scan_ms"] = cuda_ms(
            torch, lambda: connectivity.connected_components_scan(
                pts, eligible, thr, half, cfg.cluster.scan_rounds), reps=3)
        same(f"{scene}.ccl_window", connectivity.connected_components_window(
            pts, eligible, thr, half),
            connectivity.connected_components_window(
                pts[None], eligible[None], thr, half)[0])
        vals = torch.where(eligible, pts[..., 2], float("nan"))
        same(f"{scene}.segment_field_min_f32", connectivity.segment_field(
            vals, roots, eligible, H, W, "min"),
            connectivity.segment_field(vals[None], roots[None],
                                       eligible[None], H, W, "min")[0])
        clusters = cluster.segment_clusters(
            pts, labels0, None, cfg.cluster, canonical_seeds=True,
            need_sizes=False)
        same(f"{scene}.segment_clusters_vs_plain", clusters,
             cluster.segment_clusters(
                 pts, labels0, None, cfg.cluster, canonical_seeds=True,
                 need_sizes=False, impl="plain"))
        same(f"{scene}.segment_clusters_vs_batch", clusters,
             frame0(cluster.segment_clusters(
                 pts[None], labels0[None], None, cfg.cluster,
                 canonical_seeds=True, need_sizes=False)))
        rot = torch.eye(3, device=dev)
        same(f"{scene}.discontinuity_flags", discontinuity.discontinuity_flags(
            pts, nrm, sched.labels, rot, cfg.planar),
            discontinuity.discontinuity_flags(
                pts[None], nrm[None], sched.labels[None], rot,
                cfg.planar)[0])
        # the mean shift at phase 16's shape (121 offsets per iteration)
        mh, mw = MS_DEVICE_SHAPE
        mpts = pts[::H // mh, ::W // mw].contiguous()
        mlab = torch.full((mh, mw), config.UNLABELED, dtype=torch.int32,
                          device=dev)
        same(f"{scene}.mean_shift_modes", mean_shift.mean_shift_modes(
            mpts, mlab, 5), frame0(mean_shift.mean_shift_modes(
                mpts[None], mlab[None], 5)))
        emit("conventions_frame", card=card, scene=scene,
             seed_cells=int((ranked.rank_grid < seeds.SEED_RANK_INF).sum()),
             seed_vector=int(ranked.valid.sum()),
             components=int(torch.unique(roots[eligible]).numel()),
             clusters=int(clusters.num_regions),
             ccl_launches=launches[f"{scene}_ccl_scan"],
             ccl_ms=times[f"{scene}_ccl_scan_ms"], mismatches=bad)
    times["phase_28_seconds"] = time.perf_counter() - t_start
    emit("conventions", card=card, launches=launches, mismatches=bad,
         cap_binds=binds_any, seconds=times["phase_28_seconds"])
    if bad:
        fail(f"phase 28: {bad}")
    if not binds_any:
        fail("phase 28: flood_rounds=4 bound on no frame; the schedule "
             "comparison needs a binding cap")
    return launches, times


def widen(torch, x):
    """``x`` with every f32 tensor in f64 and every i32 tensor in i64, in
    (Named)tuples and geom.Pose too: the 64-bit twin of a call's input."""
    from pcseg_tpu_torch.ops import geom
    wide = {torch.float32: torch.float64, torch.int32: torch.int64}
    if torch.is_tensor(x):
        return x.to(wide.get(x.dtype, x.dtype))
    if isinstance(x, geom.Pose):
        return geom.Pose(widen(torch, x.quat), widen(torch, x.trans))
    if isinstance(x, tuple):
        items = [widen(torch, v) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def first_as_numpy(torch, fn, args):
    """``args`` with the first tensor argument (the first tensor field of a
    NamedTuple argument) moved to a NumPy array on the host, and the name
    the input rule must give it."""
    import inspect
    names = list(inspect.signature(fn).parameters)
    args = list(args)
    for i, a in enumerate(args):
        if torch.is_tensor(a):
            args[i] = a.cpu().numpy()
            return args, names[i]
        if isinstance(a, tuple) and hasattr(a, "_fields"):
            for f, v in zip(a._fields, a):
                if torch.is_tensor(v):
                    args[i] = a._replace(**{f: v.cpu().numpy()})
                    return args, f"{names[i]}.{f}"
    raise ValueError(f"{fn.__name__}: no tensor argument")


def inputs_phase(torch, card, dev, scenes, rays, origin, reset_counts,
                 read_counts):
    """Phase 29: the input rule of every public op on the card, on one
    unjittered VGA frame of each scene (the sequential grower and the mean
    shift at 120x160). Each function given a NumPy frame raises the
    TypeError that names the argument; given f64/i64 tensors on the card
    it returns its f32/i32 call's result bitwise, the growers at 32 (B1)
    and 64 (B3) slots and the single-frame CCL scan (B2) counted. The
    growers' f64 calls (kernel path) also equal their f32 plain runs in
    every field: centroids, curvatures and moments bitwise (the kernels
    keep the f64 moment order). Returns ({call: launches}, times)."""
    from pcseg_tpu_torch.models import (cluster, config, mean_shift, planar,
                                        planar_batched)
    from pcseg_tpu_torch.ops import (connectivity, discontinuity, geom,
                                     nansafe, normals, seeds, unproject,
                                     voxelize)

    t_start = time.perf_counter()
    launches, times, bad = {}, {}, []
    origin_d = torch.from_numpy(origin).to(dev)
    cfg = config.SegmenterConfig()
    mh, mw = MS_DEVICE_SHAPE

    def diff(name, got, want):
        return compare_bitwise(torch, bad, name, got, want)

    def timed(fn):
        torch.cuda.synchronize()
        reset_counts()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        out = fn()
        e.record()
        torch.cuda.synchronize()
        return out, s.elapsed_time(e), read_counts()

    for scene, u16 in scenes.items():
        pts = torch.from_numpy(unproject.unproject_range_np(u16, rays)) \
            .to(dev)
        nrm = normals.compute_normals_organized(pts, origin_d, cfg.normals)
        support = normals.find_normal_support(pts, cfg.normals)
        sp = cfg.plane_support_seeds
        count, ok = seeds.plane_support_counts(pts, nrm, sp)
        qual = ok & (count >= sp.min_num_support_points)
        ranked = seeds.seeds_from_plane_support(pts, nrm, sp,
                                                seed_vector=True)
        avg = seeds.seeds_from_average_normals(nrm)
        labels0 = torch.full((H, W), config.UNLABELED, dtype=torch.int32,
                             device=dev)
        elig = nansafe.all_finite(pts)
        thr = cfg.cluster.squared_distance_threshold
        half = cfg.cluster.half_search_window
        roots = connectivity.connected_components_scan(pts, elig, thr, half)
        cells = ranked.indices[-6:].long()
        flat_p = pts.transpose(0, 1).reshape(-1, 3)
        flat_n = nrm.transpose(0, 1).reshape(-1, 3)
        pose = geom.Pose(torch.tensor([0.999, 0.02, -0.01, 0.03],
                                      device=dev) / 0.99975,
                         torch.tensor([0.05, -0.02, 0.01], device=dev))
        gen = torch.Generator(device="cpu").manual_seed(3)
        gate = (torch.rand((3, H, W), generator=gen) < 0.6).to(dev)
        src = gate & (torch.rand((3, H, W), generator=gen) < 0.001).to(dev)
        mpts = pts[::H // mh, ::W // mw].contiguous()
        mnrm = nrm[::H // mh, ::W // mw].contiguous()
        mlab = torch.full((mh, mw), config.UNLABELED, dtype=torch.int32,
                          device=dev)
        m_ranked = seeds.seeds_from_plane_support(mpts, mnrm, sp,
                                                  seed_vector=True)
        vox = pts.reshape(-1, 3)
        grid = voxelize.voxelize_xy(vox, 0.1, (128, 128))
        calls = {
            "compute_normals_organized": (
                normals.compute_normals_organized, (pts, origin_d,
                                                    cfg.normals)),
            "find_normal_support": (normals.find_normal_support,
                                    (pts, cfg.normals)),
            "normals_from_support": (normals.normals_from_support,
                                     (support, pts, origin_d, cfg.normals)),
            "plane_support_counts": (seeds.plane_support_counts,
                                     (pts, nrm, sp)),
            "plane_support_rank_grid": (
                seeds.plane_support_rank_grid,
                (count, qual, H, W, sp.neighborhood_size ** 2 + 1)),
            "rank_plane_support_seeds": (seeds.rank_plane_support_seeds,
                                         (count, qual, H, W, sp.max_seeds)),
            "seeds_from_plane_support": (seeds.seeds_from_plane_support,
                                         (pts, nrm, sp, True, True)),
            "seeds_from_average_normals": (seeds.seeds_from_average_normals,
                                           (nrm,)),
            "average_normal_seed_list": (seeds.average_normal_seed_list,
                                         (avg, 4096)),
            "append_temporal_to_rank_grid": (
                seeds.append_temporal_to_rank_grid,
                (ranked.rank_grid, ranked.indices[-5:], ranked.valid[-5:])),
            "seeds_from_last_regions": (
                seeds.seeds_from_last_regions,
                (pts, nrm, flat_p[cells].nan_to_num(), flat_n[cells]
                 .nan_to_num(1.0), torch.arange(6, dtype=torch.int32,
                                                device=dev) * 50,
                 torch.ones(6, dtype=torch.bool, device=dev), pose, 0.3,
                 0.35)),
            "connected_components_scan": (
                connectivity.connected_components_scan,
                (pts, elig, thr, half)),
            "connected_components_window": (
                connectivity.connected_components_window,
                (pts, elig, thr, half)),
            "connected_components_mask": (
                connectivity.connected_components_mask, (elig,)),
            # int32 sums, as the cluster stage's sizes (a float sum on the
            # card adds by atomics in no fixed order), and the f32 min
            "segment_field": (connectivity.segment_field,
                              (roots % 97, roots, elig, H, W)),
            "segment_field_min_f32": (
                connectivity.segment_field,
                (pts[..., 2], roots, elig, H, W, "min")),
            "reachable_from": (connectivity.reachable_from,
                               (gate, src, 64)),
            "discontinuity_flags": (
                discontinuity.discontinuity_flags,
                (pts, nrm, torch.where(elig, torch.arange(
                    W, device=dev, dtype=torch.int32)[None, :] // 160,
                    config.UNLABELED), torch.eye(3, device=dev),
                 cfg.planar)),
            "segment_clusters": (cluster.segment_clusters,
                                 (pts, labels0, None, cfg.cluster, 0, None,
                                  True)),
            "mean_shift_modes": (mean_shift.mean_shift_modes,
                                 (mpts, mlab, 5)),
            "rank_grid_from_seed_vector": (
                planar_batched.rank_grid_from_seed_vector,
                (ranked.indices, ranked.valid, H, W)),
            "flood_fill_static": (planar_batched.flood_fill_static,
                                  (gate, src, 4)),
            **{f"grow_planar_regions_batched_k{k}": (
                planar_batched.grow_planar_regions_batched,
                (pts, nrm, labels0, ranked.indices, ranked.valid,
                 config.PlanarRegionConfig(max_regions=k)))
               for k in (32, 64)},
            "grow_planar_regions": (
                planar.grow_planar_regions,
                (mpts, mnrm, mlab, m_ranked.indices, m_ranked.valid,
                 config.PlanarRegionConfig(growth_mode="wavefront"))),
            "voxelize_xy": (voxelize.voxelize_xy, (vox, 0.1, (128, 128))),
            "cell_ids": (voxelize.cell_ids, (vox, 0.1, (128, 128))),
            "scatter_labels_to_points": (
                voxelize.scatter_labels_to_points,
                (torch.arange(128 * 128, device=dev, dtype=torch.int32)
                 .reshape(128, 128), grid.point_cell)),
        }
        errs = {}
        for name, (fn, args) in calls.items():
            np_args, arg = first_as_numpy(torch, fn, args)
            want_msg = (f"{fn.__name__}: {arg} must be a torch.Tensor on "
                        f"the device to run on, got numpy.ndarray")
            try:
                fn(*np_args)
                bad.append(f"{scene}.{name} took a NumPy {arg}")
            except TypeError as e:
                if str(e) != want_msg:
                    bad.append(f"{scene}.{name}: {e}")
            got32, ms32, n32 = timed(lambda: fn(*args))
            got64, ms64, n64 = timed(lambda: fn(*widen(torch, args)))
            errs.update(diff(f"{scene}.{name}", got64, got32))
            times[f"{scene}_{name}_ms"] = ms64
            times[f"{scene}_{name}_f32_ms"] = ms32
            launches[f"{scene}_{name}"] = n64
            if n64 != n32:
                bad.append(f"{scene}.{name} launches {n64} against {n32}")
        for k, kernel in ((32, "epoch_word"), (64, "flood_packed")):
            n = launches[f"{scene}_grow_planar_regions_batched_k{k}"]
            if n[kernel] <= 0:
                bad.append(f"{scene}.grower_k{k} launched no {kernel}: {n}")
            fn, args = calls[f"grow_planar_regions_batched_k{k}"]
            got = fn(*widen(torch, args))
            plain = fn(*args, impl="plain")
            table = diff(f"{scene}.grower_k{k}_vs_plain", got, plain)
            emit("inputs_grower", card=card, scene=scene, slots=k,
                 launches=n, num_regions=int(got.num_regions),
                 ms=times[f"{scene}_grow_planar_regions_batched_k{k}_ms"],
                 max_abs_vs_plain={f.split(".", 2)[2]: v
                                   for f, v in table.items()
                                   if any(t in f for t in (
                                       "centroids", "curvatures",
                                       "moments"))})
        n = launches[f"{scene}_connected_components_scan"]
        if nonzero_counts(n) != {"ccl_gated": 1}:
            bad.append(f"{scene}.ccl_scan launches {n}")
        emit("inputs_frame", card=card, scene=scene, functions=len(calls),
             launches={k: v for k, v in launches.items()
                       if k.startswith(scene) and any(v.values())},
             ms={k[len(scene) + 1:]: v for k, v in times.items()
                 if k.startswith(scene) and not k.endswith("_f32_ms")},
             max_abs_f64_vs_f32=max(errs.values()), mismatches=bad)
    times["phase_29_seconds"] = time.perf_counter() - t_start
    emit("inputs", card=card, launches={
        k: v for k, v in launches.items() if any(v.values())},
        mismatches=bad, seconds=times["phase_29_seconds"])
    if bad:
        fail(f"phase 29: {bad}")
    return launches, times


def dryrun_phase(card, n):
    """``graft_entry.dryrun_multichip(n)``: n ranks, one per card over
    NCCL, which must print JAX's ok line. Returns its seconds."""
    import contextlib
    import io
    from pcseg_tpu_torch import graft_entry

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        graft_entry.dryrun_multichip(n)
    seconds = time.perf_counter() - t0
    line = buf.getvalue().strip()
    emit("surface_dryrun", card=card, ranks=n, line=line, seconds=seconds)
    if not line.startswith(f"dryrun_multichip ok: {n} devices"):
        fail(f"dryrun_multichip({n}) printed {line!r}")
    return seconds


def sharded_golden_points():
    """The 128x160 golden's scenes: {name: ([H, W, 3] points, origin)}."""
    from pcseg_tpu_torch.utils import synthetic
    h, w = SHARDED_GOLDEN_SHAPE
    return {name: getattr(synthetic, fn)(h, w, f=float(h), seed=seed)
            for name, (fn, seed) in SHARDED_GOLDEN_SCENES.items()}


def gather_probe(torch, comm):
    """True when every rank's f64, int64, int32 and bool probe (NaN
    payloads, -0.0, subnormals, infinities, the int64 extremes) comes back
    byte for byte through ``comm.all_gather``."""
    def probe(r):
        raw = np.random.default_rng(100 + r).integers(
            -2 ** 63, 2 ** 63 - 1, size=64, dtype=np.int64)
        f64 = raw.view(np.float64).copy()
        f64[:6] = [0.0, -0.0, 5e-324, np.inf, -np.inf, np.nan]
        f64[5:6] = np.array([0x7FF8_0000_DEAD_BEEF + r], np.uint64) \
            .view(np.float64)
        i64 = raw.copy()
        i64[:2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max]
        return dict(f64=f64, i64=i64, i32=raw.view(np.int32),
                    bool=(raw & 1) == 1)

    ok = True
    for key in ("f64", "i64", "i32", "bool"):
        got = comm.all_gather(torch.from_numpy(probe(comm.rank)[key])
                              .to(comm.device)).cpu().numpy()
        want = np.stack([probe(r)[key] for r in range(comm.size)])
        ok &= got.dtype == want.dtype and got.tobytes() == want.tobytes()
    return bool(ok)


# the kernels counted per rank and step in phases 23 and 25, in this order
SHARDED_KERNELS = ("ccl_gated", "flood_packed", "normal_support")


def sharded_rank(backend, tmp):
    """One rank of phase 23 (``gloo``: every rank on ``cuda:0``, meeting
    over a FileStore in DIR) or phase 25 (``nccl``: one rank per card,
    ``distributed.initialize("nccl")``): ``chip_smoke.py --sharded-rank
    BACKEND DIR`` with torchrun's environment (RANK, WORLD_SIZE,
    LOCAL_RANK, MASTER_ADDR, MASTER_PORT). Prints its transport and
    current card; checks its gathers' bytes; on each VGA scene runs the
    step with the kernels (counted, timed by CUDA events on its card, with
    the host seconds spent inside ``Comm.all_gather``), its plain run and
    a timed rerun, then the golden's scenes; writes its column blocks and
    the replicated tables to DIR."""
    import torch
    from pcseg_tpu_torch.parallel import distributed, halo, sharded
    from pcseg_tpu_torch.utils import profiling

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if backend == "nccl":
        distributed.initialize("nccl", timeout_s=SHARDED_GROUP_TIMEOUT_S)
        comm = distributed.make_group()
    else:
        store = torch.distributed.FileStore(
            os.path.join(tmp, f"store{world}"), world)
        distributed.initialize("gloo", store=store, world_size=world,
                               rank=rank, timeout_s=SHARDED_GROUP_TIMEOUT_S)
        comm = distributed.make_group(device="cuda:0")
    print(json.dumps(dict(rank=rank, world=world, transport=comm.transport,
                          device=str(comm.device),
                          current_device=torch.cuda.current_device())),
          flush=True)
    step = sharded.build_sharded_segment_step(comm)
    step_plain = sharded.build_sharded_segment_step(comm, impl="plain")
    out = {"transport": np.array(comm.transport),
           "current_device": np.array(torch.cuda.current_device()),
           "gather_exact": np.array(gather_probe(torch, comm))}

    # host seconds inside Comm.all_gather (psum, pmin, pmax and the halos
    # go through it)
    spent = [0.0]
    real_gather = halo.Comm.all_gather

    def timed_gather(self, x):
        t0 = time.perf_counter()
        try:
            return real_gather(self, x)
        finally:
            spent[0] += time.perf_counter() - t0

    halo.Comm.all_gather = timed_gather

    def run(s, pts, origin):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        spent[0] = 0.0
        e0.record()
        res = s(distributed.local_columns(pts, comm), origin)
        e1.record()
        torch.cuda.synchronize()
        return res, e0.elapsed_time(e1), spent[0]

    def keep(key, res):
        out[key + "_labels"] = res.labels.cpu().numpy()
        out[key + "_num_regions"] = res.planar.num_regions.cpu().numpy()
        out[key + "_num_clusters"] = res.num_clusters.cpu().numpy()
        out[key + "_planes"] = res.planar.planes.cpu().numpy()

    with np.load(os.path.join(tmp, "inputs.npz")) as data:
        origin = data["origin"]
        scenes = data["scenes"].tolist()
        run(step, data[scenes[0]], origin)  # warm-up
        for name in scenes:
            pts = data[name]
            l0 = [profiling.total("launches." + k)
                  for k in SHARDED_KERNELS]
            g0 = comm.gathers
            res, ms, gs = run(step, pts, origin)
            out[name + "_launches"] = np.array(
                [profiling.total("launches." + k) - b
                 for k, b in zip(SHARDED_KERNELS, l0)])
            out[name + "_gathers"] = np.array(comm.gathers - g0)
            keep(name, res)
            keep(name + "_plain", run(step_plain, pts, origin)[0])
            again, ms2, gs2 = run(step, pts, origin)
            keep(name + "_rerun", again)
            out[name + "_ms"] = np.array([ms, ms2])
            out[name + "_gather_s"] = np.array([gs, gs2])
        for name in SHARDED_GOLDEN_SCENES:
            keep("golden_" + name, run(step, data["golden_" + name],
                                       data["golden_" + name + "_origin"])[0])
    np.savez(os.path.join(tmp, f"{backend}{world}_rank{rank}.npz"), **out)
    torch.distributed.destroy_process_group()


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(backend, n, tmp):
    """Start ``n`` ranks of ``--sharded-rank BACKEND DIR`` with the
    environment torchrun gives its processes, wait for them (each within
    SHARDED_RANK_TIMEOUT_S, then killed), relay each rank's line and fail
    with the log of a rank that failed; returns the merged results:
    column blocks (``*_labels``) joined, per-rank values (launches, times,
    card) as lists, every other value replicated (the same bytes on every
    rank)."""
    env = dict(os.environ, WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--sharded-rank",
         backend, tmp], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SHARDED_RANK_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            print(log[-6000:], file=sys.stderr, flush=True)
            fail(f"{backend} rank {r} of {n} exited {p.returncode}")
        for line in log.splitlines():
            if line.startswith('{"rank"'):
                print(line, flush=True)
    ranks = [dict(np.load(os.path.join(tmp, f"{backend}{n}_rank{r}.npz")))
             for r in range(n)]
    merged = {}
    for key in ranks[0]:
        vals = [d[key] for d in ranks]
        if key.endswith(("_launches", "_ms", "_gather_s", "current_device",
                         "gather_exact")):
            merged[key] = [v.tolist() for v in vals]
        elif key.endswith("_labels"):
            merged[key] = np.concatenate(vals, axis=1)
        else:
            if any(v.tobytes() != vals[0].tobytes() for v in vals[1:]):
                fail(f"{backend}: sharded {key} differs between the ranks "
                     f"({n})")
            merged[key] = vals[0]
    return merged


def check_group(phase, backend, n, m, pts, ref, gold, gpts, card, times,
                gloo=None):
    """The rules of phase 23 on one group's merged results ``m``: labels
    equal to the ranks' plain runs and reruns, region and cluster counts
    equal to the 1-rank step, labels >= 99% and planes within JAX's bound
    against it, one B2 launch, some B3 launches and one normal_support
    launch per rank per step, the 128x160 golden exact; with ``gloo``
    (phase 25) also labels, counts and planes byte-equal to the gloo
    group's of the same rank count. Returns {scene: per-rank [B2, B3,
    normal_support] launches}."""
    def same(a, b):
        return np.asarray(a).tobytes() == np.asarray(b).tobytes()

    tables = ("_labels", "_num_regions", "_num_clusters", "_planes")
    pre = "" if backend == "gloo" else backend + "_"
    launches = {}
    for name in pts:
        lab = m[name + "_labels"]
        num = int(m[name + "_num_regions"])
        planes = m[name + "_planes"]
        want = ref[name]
        agree = float((lab == want["labels"]).mean())
        dots = [abs(float(planes[i, :3] @ want["planes"][i, :3]))
                for i in range(min(num, want["num_regions"]))]
        per_rank = m[name + "_launches"]
        launches[name] = per_rank
        same_plain = (np.array_equal(lab, m[name + "_plain_labels"])
                      and num == int(m[name + "_plain_num_regions"])
                      and same(m[name + "_num_clusters"],
                               m[name + "_plain_num_clusters"]))
        plain_err = float(np.abs(planes - m[name + "_plain_planes"]).max())
        rerun = all(same(m[name + k], m[name + "_rerun" + k])
                    for k in tables)
        ms = m[name + "_ms"]
        times[f"{pre}n{n}_{name}_ms"] = statistics.median(ms[0])
        line = dict(
            ranks=n, scene=name, shape=[H, W], card=card,
            transport=str(m["transport"]),
            current_device_per_rank=m["current_device"],
            gathers_exact=m["gather_exact"], num_regions=num,
            one_rank_num_regions=want["num_regions"],
            num_clusters=int(m[name + "_num_clusters"]),
            one_rank_num_clusters=want["num_clusters"],
            launches_per_rank=dict(zip(SHARDED_KERNELS,
                                       np.asarray(per_rank).T.tolist())),
            collectives_per_step=int(m[name + "_gathers"]),
            ms_per_step_per_rank=ms,
            gather_host_s_per_step_per_rank=m[name + "_gather_s"],
            one_rank_ms=times[f"n1_{name}_ms"],
            labels_counts_equal_plain=same_plain,
            planes_max_abs_err_plain=plain_err, atol=PLANE_ATOL,
            bit_identical_rerun=rerun, agreement_vs_one_rank=agree,
            min_plane_dot_vs_one_rank=min(dots) if dots else None,
            bound=[SHARDED_AGREE, SHARDED_DOT])
        if gloo is not None:
            line["bytes_equal_gloo"] = all(same(m[name + k], gloo[name + k])
                                           for k in tables)
        emit(phase, **line)
        if not all(m["gather_exact"]):
            fail(f"{phase}: a gather on {n} ranks changed bytes")
        if backend == "nccl" and (
                str(m["transport"]) != "nccl"
                or m["current_device"] != list(range(n))):
            fail(f"{phase}: ranks are not one per card over NCCL: "
                 f"{m['transport']} on {m['current_device']}")
        if not (same_plain and plain_err <= PLANE_ATOL and rerun):
            fail(f"{phase} on {n} ranks ({name}) disagrees with its plain "
                 "run or its rerun")
        if num != want["num_regions"] or agree < SHARDED_AGREE \
                or any(d <= SHARDED_DOT for d in dots) \
                or int(m[name + "_num_clusters"]) != want["num_clusters"]:
            fail(f"{phase} on {n} ranks ({name}) is outside JAX's bound "
                 "against the 1-rank step")
        if any(c[0] != 1 or c[1] <= 0 or c[2] != 1 for c in per_rank):
            fail(f"{phase} on {n} ranks ({name}) did not launch B2 once, B3 "
                 f"and normal_support once on every rank: {per_rank}")
        if gloo is not None and not line["bytes_equal_gloo"]:
            fail(f"{phase} on {n} ranks ({name}) differs from the gloo "
                 "group's bytes")
    bad = []
    for name, (p, _) in gpts.items():
        gpre = f"n{n}_{name}__"
        key = f"golden_{name}"
        lab = m[key + "_labels"]
        num = int(gold[gpre + "num_regions"])
        planes = m[key + "_planes"]
        worst = max([float(np.abs(planes[r] - gold[gpre + "planes"][r])
                           .max()) / plane_tolerance(
            p[gold[gpre + "labels"] == r]) for r in range(num)] or [0])
        ok = (np.array_equal(lab, gold[gpre + "labels"])
              and int(m[key + "_num_regions"]) == num
              and int(m[key + "_num_clusters"])
              == int(gold[gpre + "num_clusters"]) and worst <= 1.0)
        line = dict(ranks=n, scene=name, shape=list(SHARDED_GOLDEN_SHAPE),
                    exact=ok, labels_differing=int(
                        (lab != gold[gpre + "labels"]).sum()),
                    planes_worst_err_over_tolerance=worst)
        if gloo is not None:
            line["bytes_equal_gloo"] = all(same(m[key + k], gloo[key + k])
                                           for k in tables)
            ok &= line["bytes_equal_gloo"]
        emit(phase + "_golden", **line)
        bad += [] if ok else [name]
    if bad:
        fail(f"{phase} on {n} ranks differs from the JAX golden (or the gloo "
             f"group) on {bad}")
    return launches


def sharded_phase(torch, card, dev, scenes, rays, origin, nccl):
    """Phase 23: ``build_sharded_segment_step`` on the VGA room and
    cluttered frames over 2 and then 4 ranks, processes sharing the card
    over gloo (NCCL refuses two ranks on one device), against the 1-rank
    step on the card; the 128x160 golden. With ``nccl``, phase 25 right
    after it: the same over NCCL with one rank per card (2 ranks, and 4
    where there are 4 cards), also byte-equal to the gloo group of the
    same rank count. Returns (times, {rank count: per-rank [B2, B3,
    normal_support] launches per scene} for gloo, the same for NCCL)."""
    import tempfile
    from pcseg_tpu_torch.ops import unproject
    from pcseg_tpu_torch.parallel import halo, sharded

    t_start = time.perf_counter()
    pts = {name: unproject.unproject_range_np(d16, rays)
           for name, d16 in scenes.items()}
    step1 = sharded.build_sharded_segment_step(halo.Comm(device=dev))
    step1(pts["room"], origin)  # warm-up
    ref, times = {}, {}
    for name, p in pts.items():
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        res = step1(p, origin)
        t1.record()
        torch.cuda.synchronize()
        times[f"n1_{name}_ms"] = t0.elapsed_time(t1)
        ref[name] = dict(labels=res.labels.cpu().numpy(),
                         num_regions=int(res.planar.num_regions),
                         num_clusters=int(res.num_clusters),
                         planes=res.planar.planes.cpu().numpy())
    gold = np.load(os.path.join(ROOT, "pcseg_tpu_torch", "testdata",
                                "jax_sharded_128x160.npz"))
    gpts = sharded_golden_points()
    launches, nccl_launches = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        inputs = dict(origin=origin, scenes=np.array(list(pts)), **pts)
        for name, (p, o) in gpts.items():
            inputs["golden_" + name] = p
            inputs["golden_" + name + "_origin"] = o
        np.savez(os.path.join(tmp, "inputs.npz"), **inputs)
        gloo = {}
        for n in SHARDED_RANKS:
            gloo[n] = run_ranks("gloo", n, tmp)
            launches[n] = check_group("sharded_step", "gloo", n, gloo[n],
                                      pts, ref, gold, gpts, card, times)
        times["phase_23_seconds"] = time.perf_counter() - t_start
        if nccl:
            t_start = time.perf_counter()
            for n in SHARDED_RANKS:
                if n > torch.cuda.device_count():
                    continue
                m = run_ranks("nccl", n, tmp)
                nccl_launches[n] = check_group(
                    "nccl_sharded_step", "nccl", n, m, pts, ref, gold, gpts,
                    card, times, gloo=gloo[n])
            times["phase_25_seconds"] = time.perf_counter() - t_start
    return times, launches, nccl_launches


def every_card_phase(torch, card, scenes, rays, origin, expect=None):
    """Phase 26: in this process, card 0 current and no set_device,
    ``Segmenter(device=f"cuda:{k}").device_forward_stream`` on every card
    k at 32 and 64 slots on the VGA batches of phase 3 (B = 8): labels,
    counts and planes byte-equal to card 0's, with card 0's launch counts
    (and ``expect[slots]``, phases 3 and 9's, where given)."""
    from pcseg_tpu_torch.models import config, pipeline

    kernels_mod, reset_counts, read_counts = kernel_counters()
    cfgs = {32: config.SegmenterConfig(), 64: config.SegmenterConfig(
        planar=config.PlanarRegionConfig(max_regions=64))}
    batches = {name: make_batch(u16, i)
               for i, (name, u16) in enumerate(scenes.items())}
    want = {}
    for k in range(torch.cuda.device_count()):
        dev = torch.device("cuda", k)
        rays_d = torch.from_numpy(rays).to(dev)
        origin_d = torch.from_numpy(origin).to(dev)
        on_card = {name: torch.from_numpy(b).to(dev)
                   for name, b in batches.items()}
        for slots, cfg in cfgs.items():
            seg = pipeline.Segmenter(cfg, device=dev)
            reset_counts()
            outs = {name: [t.cpu().numpy() for t in seg.device_forward_stream(
                b, rays_d, origin_d)] for name, b in on_card.items()}
            counts = read_counts()
            want.setdefault(slots, (outs, counts))
            w_outs, w_counts = want[slots]
            equal = all(a.tobytes() == b.tobytes() for name in outs
                        for a, b in zip(outs[name], w_outs[name]))
            current = torch.cuda.current_device()
            emit("every_card", card=card, card_index=k, slots=slots,
                 launches=counts, card0_launches=w_counts,
                 expected_launches=expect and expect[slots],
                 bytes_equal_card0=equal, current_device=current,
                 num_planar={n: o[1].tolist() for n, o in outs.items()})
            if not equal or counts != w_counts or current != 0:
                fail(f"every_card: cuda:{k} at {slots} slots differs from "
                     "card 0 (outputs, launch counts or current card)")
            if expect and counts != expect[slots]:
                fail(f"every_card: {slots} slots launched {counts}, phase "
                     f"3/9 launched {expect[slots]}")
            used = ("epoch_word" if slots == 32 else "flood_packed",
                    "ccl_gated")
            if any(counts[u] <= 0 for u in used):
                fail(f"every_card: {used} did not launch on cuda:{k}")


def nccl_main():
    """``chip_smoke.py --nccl``: the build, the 1-rank step on card 0,
    phase 23's gloo groups, phase 25, phase 26 and the dry run
    (``graft_entry.dryrun_multichip``) over 2 and, with four cards, 4
    ranks; needs two or more cards."""
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs a GPU")
    if torch.cuda.device_count() < 2:
        fail(f"--nccl needs two or more cards, found "
             f"{torch.cuda.device_count()}")
    card = device_and_build(torch)
    rays, origin, scenes = vga_scenes()
    times, launches, nccl_launches = sharded_phase(
        torch, card, torch.device("cuda"), scenes, rays, origin, nccl=True)
    every_card_phase(torch, card, scenes, rays, origin)
    for n in (2, 4):
        if n <= torch.cuda.device_count():
            times[f"dryrun_{n}_seconds"] = dryrun_phase(card, n)
    emit("times_sharded", card=card, **times,
         launches_per_rank_gloo=launches, launches_per_rank_nccl=nccl_launches)
    result_line(torch)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sharded-rank"]:
        sharded_rank(*sys.argv[2:4])
    elif sys.argv[1:] == ["--nccl"]:
        nccl_main()
    else:
        main()
