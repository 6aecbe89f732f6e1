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

import torch

from portbench.reference.port_plain.kernels import common

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

    Always the plain version here (``impl`` is accepted and ignored)."""
    if gate.dim() != 3:
        raise ValueError(f"gate must be [B, H, W], got {tuple(gate.shape)}")
    b, h, w = gate.shape
    dev = gate.device
    common.check("gate", gate, torch.int32, (b, h, w), dev)
    common.check("labels0", labels0, torch.int32, (b, h, w), dev)
    if rounds_out is not None:
        common.check("rounds_out", rounds_out, torch.int32, (b,), dev)
    offsets = [tuple(o) for o in offsets]
    out, ran = ccl_gated_plain(gate, labels0, offsets, rounds, big)
    if rounds_out is not None:
        rounds_out.copy_(ran)
    return out
