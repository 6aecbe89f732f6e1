"""Shared pieces of the kernel wrappers: grid shifts, segmented
Hillis-Steele scans, the OR-flood and the CCL rounds for the plain PyTorch
versions, and argument checks.
"""

from __future__ import annotations

import ctypes

import torch


def shift2(x: torch.Tensor, dr: int, dc: int, fill) -> torch.Tensor:
    """out[..., r, c] = x[..., r + dr, c + dc] on the last two axes (out of
    bounds -> fill)."""
    h, w = x.shape[-2], x.shape[-1]
    out = torch.full_like(x, fill)
    if abs(dr) >= h or abs(dc) >= w:
        return out
    out[..., max(0, -dr):h + min(0, -dr), max(0, -dc):w + min(0, -dc)] = \
        x[..., max(0, dr):h + min(0, dr), max(0, dc):w + min(0, dc)]
    return out


def _shift_dim(x, d, dim, fill):
    """out[j] = x[j - d] along ``dim`` (out of range -> fill)."""
    n = x.shape[dim]
    out = torch.full_like(x, fill)
    if abs(d) >= n:
        return out
    if d > 0:
        out.narrow(dim, d, n - d).copy_(x.narrow(dim, 0, n - d))
    else:
        out.narrow(dim, 0, n + d).copy_(x.narrow(dim, -d, n + d))
    return out


def seg_min_scan(v, blocked, dim, reverse, big):
    """Segmented inclusive min-scan (Hillis-Steele doubling): per position,
    the min over the run of unblocked elements ending there; a blocked
    element contributes only its own value."""
    b = blocked
    d = 1
    n = v.shape[dim]
    while d < n:
        s = -d if reverse else d
        vs = _shift_dim(v, s, dim, big)
        bs = _shift_dim(b, s, dim, True)
        v = torch.where(b, v, torch.minimum(v, vs))
        b = b | bs
        d *= 2
    return v


def seg_or_scan(v, blocked, dim, reverse):
    """Segmented inclusive OR-scan on packed int32 bit words; ``blocked``
    is a word too (bit set = that bit's run is cut)."""
    b = blocked
    d = 1
    n = v.shape[dim]
    while d < n:
        s = -d if reverse else d
        vs = _shift_dim(v, s, dim, 0)
        bs = _shift_dim(b, s, dim, -1)
        v = v | (vs & ~b)
        b = b | bs
        d *= 2
    return v


def or_flood(gate, reach0, rounds):
    """Plain segmented OR-flood of [N, H, W] int32 word planes (the port of
    JAX's ``_seg_or_scan_packed`` rounds and while-loop): one round spreads
    every set bit through its run of gate bits along the rows, then along
    the columns (fwd | bwd, masked by the gate); the first round always
    runs, and rounds repeat while the stack changed, at most ``rounds``.

    Returns (words, rounds_run): int32 [N], the rounds each plane would run
    if it stopped on its own (the kernels' per-plane stop), the first round
    plus one per round that changed the plane before the last."""
    not_g = ~gate

    def spread(r, dim):
        fwd = seg_or_scan(r, not_g, dim, False)
        bwd = seg_or_scan(r, not_g, dim, True)
        return (fwd | bwd) & gate

    def one_round(r):
        return spread(spread(r, -1), -2)

    prev, reach = reach0, one_round(reach0)
    ran = torch.ones(gate.shape[0], dtype=torch.int32, device=gate.device)
    it = 1
    while it < rounds:
        moved = (reach != prev).flatten(1).any(dim=1)
        if not bool(moved.any()):
            break
        ran += moved.to(torch.int32)
        prev, reach = reach, one_round(reach)
        it += 1
    return reach, ran


def ccl_rounds(oks, labels0, offsets, rounds, big):
    """Gated CCL rounds over [B, H, W] labels, one bool gate per window
    offset (``oks[o]``: the edge to ``offsets[o]`` passes): row segmented
    min-scans forward and backward on the (0, -1) gate, then the columns' on
    the (-1, 0) gate, then each offset's min-exchange in order. The first
    round always runs; rounds repeat while the batch changed, at most
    ``rounds``. Returns (labels, rounds_run per frame: the first round plus
    one per round that changed the frame before the last)."""
    row_reset = ~oks[offsets.index((0, -1))]
    col_reset = ~oks[offsets.index((-1, 0))]
    # backward scans: the edge to the next cell is that cell's gate
    row_reset_rev = shift2(row_reset, 0, 1, True)
    col_reset_rev = shift2(col_reset, 1, 0, True)

    def one_round(lab):
        lab = torch.minimum(seg_min_scan(lab, row_reset, -1, False, big),
                            seg_min_scan(lab, row_reset_rev, -1, True, big))
        lab = torch.minimum(seg_min_scan(lab, col_reset, -2, False, big),
                            seg_min_scan(lab, col_reset_rev, -2, True, big))
        for (dr, dc), ok in zip(offsets, oks):
            nb = shift2(lab, dr, dc, big)
            lab = torch.minimum(lab, torch.where(ok, nb, big))
        return lab

    prev, lab = labels0, one_round(labels0)
    ran = torch.ones(labels0.shape[0], dtype=torch.int32,
                     device=labels0.device)
    it = 1
    while it < rounds:
        moved = (lab != prev).flatten(1).any(dim=1)
        if not bool(moved.any()):
            break
        ran += moved.to(torch.int32)
        prev, lab = lab, one_round(lab)
        it += 1
    return lab, ran


def check(name, t, dtype, shape, device):
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device``."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def use_kernel(device: torch.device, impl) -> bool:
    """True when the CUDA kernel runs: a CUDA tensor and no ``impl`` given.
    A CPU tensor takes the plain version; ``impl="plain"`` (tests and the
    smoke script only) forces it. Anything else raises."""
    if impl not in (None, "plain"):
        raise ValueError(f"impl must be None or 'plain', got {impl!r}")
    if impl == "plain" or device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    return True


def ptr(t) -> ctypes.c_void_p:
    """The device pointer of tensor ``t``; NULL for None."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def stream_ptr() -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
