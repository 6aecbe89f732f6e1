"""Gated CCL to the fixed point: wrapper of ``csrc/ccl_gated.cu`` and its
plain PyTorch version (the port of pcseg_tpu/ops/connectivity.py::
_ccl_pallas).

Each round: row segmented min-scans cut where gate bit (0,-1) is clear,
column scans cut where bit (-1,0) is clear, then the window offsets'
min-exchanges one after another, each reading the labels as the previous
offset left them. Rounds stop at the fixed point or after ``rounds``.
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
        fn.argtypes = [_VP] * 6 + [_I] * 7 + [_VP]
        fn.restype = _I
    return lib


def ccl_gated_plain(gate, labels0, offsets, rounds, big):
    """Plain PyTorch version: the JAX kernel's Hillis-Steele scans and
    offset exchanges, batched over the leading frame axis."""
    o_row = offsets.index((0, -1))
    o_col = offsets.index((-1, 0))
    row_reset = ((gate >> o_row) & 1) == 0
    col_reset = ((gate >> o_col) & 1) == 0
    # backward scans: the edge to the next cell is that cell's bit
    row_reset_rev = common.shift2(row_reset, 0, 1, True)
    col_reset_rev = common.shift2(col_reset, 1, 0, True)
    oks = [((gate >> o) & 1) == 1 for o in range(len(offsets))]

    def one_round(lab):
        lab = torch.minimum(
            common.seg_min_scan(lab, row_reset, -1, False, big),
            common.seg_min_scan(lab, row_reset_rev, -1, True, big))
        lab = torch.minimum(
            common.seg_min_scan(lab, col_reset, -2, False, big),
            common.seg_min_scan(lab, col_reset_rev, -2, True, big))
        for (dr, dc), ok in zip(offsets, oks):
            nb = common.shift2(lab, dr, dc, big)
            lab = torch.minimum(lab, torch.where(ok, nb, big))
        return lab

    prev, lab = labels0, one_round(labels0)
    it = 1
    while it < rounds and bool((lab != prev).any()):
        prev, lab = lab, one_round(lab)
        it += 1
    return lab


def ccl_gated(gate: torch.Tensor, labels0: torch.Tensor, offsets, rounds: int,
              big: int, impl=None) -> torch.Tensor:
    """Gated CCL over [B, H, W] int32 ``gate`` (bit o = edge to
    ``offsets[o]`` passes) from [B, H, W] int32 ``labels0``. Returns each
    cell's min label over its component (under the ``rounds`` cap).

    CPU tensors (or ``impl="plain"``) take the plain version; CUDA tensors
    launch the kernel."""
    global launches
    b, h, w = gate.shape
    common.check("gate", gate, torch.int32, (b, h, w), gate.device)
    common.check("labels0", labels0, torch.int32, (b, h, w), gate.device)
    offsets = [tuple(o) for o in offsets]
    if not common.use_kernel(gate.device, impl):
        return ccl_gated_plain(gate, labels0, offsets, rounds, big)
    n = len(offsets)
    if n == 0 or n > 32 or n % 2:
        raise ValueError(f"the kernel takes an even count of <= 32 "
                         f"offsets, got {n}")
    o_row = offsets.index((0, -1))
    o_col = offsets.index((-1, 0))
    out = labels0.clone()
    tmp = torch.empty_like(out)
    start = torch.empty_like(out)
    flags = torch.zeros(max(rounds, 1), dtype=torch.int32, device=gate.device)
    offs = (ctypes.c_int * (2 * n))(*[v for o in offsets for v in o])
    rc = _lib().ccl_gated_launch(
        common.ptr(gate), common.ptr(out), common.ptr(tmp),
        common.ptr(start), common.ptr(flags),
        ctypes.cast(offs, ctypes.c_void_p), n, o_row, o_col, b, h, w,
        int(rounds), common.stream_ptr())
    if rc != 0:
        raise RuntimeError(f"ccl_gated_launch failed with CUDA error {rc}")
    launches += 1
    return out
