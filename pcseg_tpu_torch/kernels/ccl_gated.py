"""Gated CCL to the fixed point: wrapper of ``csrc/ccl_gated.cu`` and its
plain PyTorch version (the port of pcseg_tpu/ops/connectivity.py::
_ccl_pallas).

Each round: row segmented min-scans cut where gate bit (0,-1) is clear,
column scans cut where bit (-1,0) is clear, then the window offsets'
min-exchanges one after another, each reading the labels as the previous
offset left them. Rounds stop at the fixed point or after ``rounds``, the
first one always. The kernel stops each frame on its own, the plain version
the whole batch: rounds past a frame's fixed point change nothing, so the
labels are the same.
"""

from __future__ import annotations

import ctypes

import torch

from pcseg_tpu_torch.kernels import build, common

# CUDA launches of this kernel since the caller last reset it
launches = 0

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("ccl_gated")
    fn = lib.ccl_gated_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 7 + [_I] * 7 + [_VP]
        fn.restype = _I
    return lib


def ccl_gated_plain(gate, labels0, offsets, rounds, big):
    """Plain PyTorch version: the JAX kernel's Hillis-Steele scans and
    offset exchanges, batched over the leading frame axis. Returns (labels,
    rounds_run per frame: the first round plus one per round that changed
    the frame before the last, as the kernel's per-frame stop counts)."""
    oks = [((gate >> o) & 1) == 1 for o in range(len(offsets))]
    return common.ccl_rounds(oks, labels0, offsets, rounds, big)


def ccl_gated(gate: torch.Tensor, labels0: torch.Tensor, offsets, rounds: int,
              big: int, impl=None, rounds_out=None) -> torch.Tensor:
    """Gated CCL over [B, H, W] int32 ``gate`` (bit o = edge to
    ``offsets[o]`` passes) from [B, H, W] int32 ``labels0``. Returns each
    cell's min label over its component (under the ``rounds`` cap).
    ``rounds_out`` (int32 [B] on the frames' device, optional) receives the
    rounds each frame ran: its rounds to the fixed point plus the one that
    confirms it, or ``rounds``.

    CPU tensors (or ``impl="plain"``) take the plain version; CUDA tensors
    launch the kernel, one cooperative launch per call, for any B, H and W
    and any even count of at most 32 offsets (frames whose column strips,
    with their halo columns, or rows do not fit in shared memory take the
    kernel's second instance)."""
    global launches
    if gate.dim() != 3:
        raise ValueError(f"gate must be [B, H, W], got {tuple(gate.shape)}")
    b, h, w = gate.shape
    dev = gate.device
    common.check("gate", gate, torch.int32, (b, h, w), dev)
    common.check("labels0", labels0, torch.int32, (b, h, w), dev)
    if rounds_out is not None:
        common.check("rounds_out", rounds_out, torch.int32, (b,), dev)
    offsets = [tuple(o) for o in offsets]
    if not common.use_kernel(dev, impl):
        out, ran = ccl_gated_plain(gate, labels0, offsets, rounds, big)
        if rounds_out is not None:
            rounds_out.copy_(ran)
        return out
    n = len(offsets)
    if n == 0 or n > 32 or n % 2:
        raise ValueError(f"the kernel takes an even count of <= 32 "
                         f"offsets, got {n}")
    o_row = offsets.index((0, -1))
    o_col = offsets.index((-1, 0))
    out = torch.empty_like(labels0)
    tmp = torch.empty_like(labels0)
    flags = torch.empty(3 * b, dtype=torch.int32, device=dev)
    offs = (ctypes.c_int * (2 * n))(*[v for o in offsets for v in o])
    rc = _lib().ccl_gated_launch(
        common.ptr(gate), common.ptr(labels0), common.ptr(out),
        common.ptr(tmp), common.ptr(flags), common.ptr(rounds_out),
        ctypes.cast(offs, ctypes.c_void_p), n, o_row, o_col, b, h, w,
        int(rounds), common.stream_ptr())
    if rc != 0:
        raise RuntimeError(f"ccl_gated_launch failed with CUDA error {rc}")
    launches += 1
    return out
