"""One closure epoch of the batched planar grower: wrapper of
``csrc/epoch_word.cu`` and its plain PyTorch version (the port of
pcseg_tpu/models/planar_batched.py::_epoch_kernel_batched).

Up to 32 slots ride in the bits of one int32 member word per pixel (read
with ``(w >> k) & 1``). Per frame: the claim rank and the gate/anchor words,
the segmented OR-flood of the anchors through the gate to the fixed point
(or the rounds cap), min-rank claims (the new word), and per slot the
member count, the best member seed rank, the col-major index holding it,
and the 10 plane-fit moment sums (f32 products summed in f64, then
rounded to f32: the kernel and the plain version sum in different orders,
and the f64 sums round to the same f32 except at a rounding boundary).
"""

from __future__ import annotations

import ctypes

import torch

from pcseg_tpu_torch.kernels import build, common

# CUDA launches of this kernel since the caller last reset it
launches = 0

INF_RANK = 2 ** 30
BIG_LIN = 2 ** 30

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("epoch_word")
    fn = lib.epoch_word_launch
    if fn.argtypes is None:
        fn.argtypes = ([_VP] * 23 + [_I] * 4 + [ctypes.c_float, _I, _VP])
        fn.restype = _I
        lib.epoch_word_pixels_per_block.argtypes = []
        lib.epoch_word_pixels_per_block.restype = _I
    return lib


def _bit(word, k):
    return ((word >> k) & 1) == 1


def epoch_word_plain(px, py, pz, rank, elig, word, srank, alive, plane,
                     anchor_r, anchor_c, radius, tau, rounds, rounds_out=None):
    """Plain PyTorch version of one epoch (see the module docstring)."""
    b, h, w = px.shape
    k_cap = srank.shape[1]
    dev = px.device
    rows = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    cols = torch.arange(w, dtype=torch.int32, device=dev)[None, :]
    rad = radius[:, None, None]
    el = elig != 0
    tau = torch.tensor(tau, dtype=torch.float32, device=dev)

    def col(t, k):
        return t[:, k, None, None]

    claim = torch.full((b, h, w), INF_RANK, dtype=torch.int32, device=dev)
    for k in range(k_cap):
        claim = torch.minimum(claim, torch.where(_bit(word, k), col(srank, k),
                                                 INF_RANK))
    gate = torch.zeros((b, h, w), dtype=torch.int32, device=dev)
    reach = torch.zeros_like(gate)
    for k in range(k_cap):
        pl = plane[:, k, :, None, None]
        dist = (px * pl[:, 0] + py * pl[:, 1] + pz * pl[:, 2] + pl[:, 3]).abs()
        ar, ac = col(anchor_r, k), col(anchor_c, k)
        inbox = ((rows - ar).abs() <= rad) & ((cols - ac).abs() <= rad)
        g = ((dist < tau) & el & (claim >= col(srank, k))
             & (col(alive, k) != 0) & inbox) | _bit(word, k)
        anchor = (rows == ar) & (cols == ac) & g
        gate |= g.to(torch.int32) << k
        reach |= anchor.to(torch.int32) << k

    reach, ran = common.or_flood(gate, reach, rounds)
    if rounds_out is not None:
        rounds_out.copy_(ran)

    best = torch.full((b, h, w), INF_RANK, dtype=torch.int32, device=dev)
    for k in range(k_cap):
        best = torch.minimum(best, torch.where(_bit(reach, k), col(srank, k),
                                               INF_RANK))
    new_word = torch.zeros_like(gate)
    for k in range(k_cap):
        keep = _bit(reach, k) & (best < INF_RANK) & (best == col(srank, k))
        new_word |= keep.to(torch.int32) << k

    lin = cols * h + rows
    cnt = torch.empty((b, k_cap), dtype=torch.int32, device=dev)
    mrank = torch.empty_like(cnt)
    alin = torch.empty_like(cnt)
    mom = torch.empty((b, k_cap, 10), dtype=torch.float32, device=dev)
    for k in range(k_cap):
        bit = _bit(new_word, k)
        cnt[:, k] = bit.sum(dim=(1, 2)).to(torch.int32)
        mr = torch.where(bit, rank, INF_RANK).amin(dim=(1, 2))
        mrank[:, k] = mr
        alin[:, k] = torch.where(bit & (rank == mr[:, None, None]), lin,
                                 BIG_LIN).amin(dim=(1, 2))
        qx = torch.where(bit, px, 0.0)
        qy = torch.where(bit, py, 0.0)
        qz = torch.where(bit, pz, 0.0)
        terms = torch.stack([qx * qx, qx * qy, qx * qz, qy * qy, qy * qz,
                             qz * qz, qx, qy, qz, bit.to(torch.float32)])
        mom[:, k] = terms.to(torch.float64).sum(dim=(2, 3)).T \
            .to(torch.float32)
    return new_word, cnt, mrank, alin, mom


def epoch_word(px, py, pz, rank, elig, word, srank, alive, plane, anchor_r,
               anchor_c, radius, tau: float, rounds: int, impl=None,
               rounds_out=None):
    """One closure epoch over a batch of frames.

    Grids [B, H, W]: px/py/pz f32, rank/elig/word int32. Slot tables
    [B, K] int32: srank, alive, anchor_r, anchor_c; plane f32 [B, K, 4];
    radius int32 [B]. K <= 32. Returns (word int32 [B, H, W], cnt, mrank,
    alin int32 [B, K], mom f32 [B, K, 10]). ``rounds_out`` (int32 [B] on
    the frames' device, optional) receives the flood rounds each frame ran:
    its rounds to the fixed point plus the one that confirms it, or
    ``rounds``.

    CPU tensors (or ``impl="plain"``) take the plain version; CUDA tensors
    launch the kernel, one cooperative launch per call, for any H and W
    (frames whose rows or column strips do not fit in shared memory take
    the kernel's in-place instance)."""
    global launches
    b, h, w = px.shape
    k_cap = srank.shape[1] if srank.dim() == 2 else -1
    dev = px.device
    if not 0 < k_cap <= 32:
        raise ValueError(f"srank must be [B, K] with 0 < K <= 32, got "
                         f"{tuple(srank.shape)}")
    for name, t in (("px", px), ("py", py), ("pz", pz)):
        common.check(name, t, torch.float32, (b, h, w), dev)
    for name, t in (("rank", rank), ("elig", elig), ("word", word)):
        common.check(name, t, torch.int32, (b, h, w), dev)
    for name, t in (("srank", srank), ("alive", alive),
                    ("anchor_r", anchor_r), ("anchor_c", anchor_c)):
        common.check(name, t, torch.int32, (b, k_cap), dev)
    common.check("plane", plane, torch.float32, (b, k_cap, 4), dev)
    common.check("radius", radius, torch.int32, (b,), dev)
    if rounds_out is not None:
        common.check("rounds_out", rounds_out, torch.int32, (b,), dev)
    if not common.use_kernel(dev, impl):
        return epoch_word_plain(px, py, pz, rank, elig, word, srank, alive,
                                plane, anchor_r, anchor_c, radius, tau,
                                rounds, rounds_out)
    lib = _lib()
    ppb = lib.epoch_word_pixels_per_block()
    nblk = -(-(h * w) // ppb)
    i32 = dict(dtype=torch.int32, device=dev)
    out = torch.empty((b, h, w), **i32)
    gate = torch.empty((b, h, w), **i32)
    flags = torch.empty(3 * b, **i32)
    part_mom = torch.empty((b, k_cap, 10, nblk), dtype=torch.float64,
                           device=dev)
    part_cnt = torch.empty((b, k_cap, nblk), **i32)
    part_key = torch.empty((b, k_cap, nblk), dtype=torch.int64, device=dev)
    cnt = torch.empty((b, k_cap), **i32)
    mrank = torch.empty((b, k_cap), **i32)
    alin = torch.empty((b, k_cap), **i32)
    mom = torch.empty((b, k_cap, 10), dtype=torch.float32, device=dev)
    p = common.ptr
    rc = lib.epoch_word_launch(
        p(px), p(py), p(pz), p(rank), p(elig), p(word), p(srank), p(alive),
        p(plane), p(anchor_r), p(anchor_c), p(radius), p(out), p(gate),
        p(flags), p(rounds_out), p(part_mom), p(part_cnt), p(part_key), p(cnt),
        p(mrank), p(alin), p(mom), b, h, w, k_cap, float(tau), int(rounds),
        common.stream_ptr())
    if rc != 0:
        raise RuntimeError(f"epoch_word_launch failed with CUDA error {rc}")
    launches += 1
    return out, cnt, mrank, alin, mom
