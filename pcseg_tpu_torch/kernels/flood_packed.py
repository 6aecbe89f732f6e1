"""Segmented OR-flood of packed bit-planes: wrapper of
``csrc/flood_packed.cu`` and its plain PyTorch version (the port of
pcseg_tpu/models/planar_batched.py::_flood_pallas), plus the packing of
[B, K, H, W] bool slot masks into int32 word planes.

Each bit of a word plane floods on its own: one round spreads every
reached bit through its run of gate bits along the rows, then along the
columns (fwd | bwd, masked by the gate); rounds repeat to the fixed point
or ``rounds`` rounds, the first one always. The kernel stops each plane on
its own, the plain version the whole stack: rounds past a plane's fixed
point change nothing, so the words are the same.
"""

from __future__ import annotations

import ctypes

import torch

from pcseg_tpu_torch.kernels import build, common

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = build.load("flood_packed")
    fn = lib.flood_packed_launch
    if fn.argtypes is None:
        fn.argtypes = [_VP] * 5 + [_I] * 4 + [_VP]
        fn.restype = _I
    return lib


def pack_bits(masks: torch.Tensor) -> torch.Tensor:
    """[B, K, H, W] bool -> [B, NW, H, W] int32 word planes, NW =
    ceil(K/32): bit k % 32 of word k // 32 is slot k. Eight slots sum into
    a byte (distinct bits, so no carry), four bytes into an int64 word, so
    bit 31 lands on the sign without overflow; a fixed number of ops for
    any K."""
    b, k, h, w = masks.shape
    nw = -(-k // 32)
    dev = masks.device
    bits = torch.zeros((b, nw * 32, h, w), dtype=torch.uint8, device=dev)
    bits[:, :k] = masks
    bytes_ = (bits.view(b, nw * 4, 8, h, w)
              << torch.arange(8, dtype=torch.uint8, device=dev)[:, None, None]
              ).sum(dim=2, dtype=torch.uint8)
    acc = (bytes_.view(b, nw, 4, h, w).to(torch.int64)
           << (8 * torch.arange(4, device=dev))[:, None, None]).sum(dim=2)
    return torch.where(acc >= 2 ** 31, acc - 2 ** 32, acc).to(torch.int32)


def unpack_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """[B, NW, H, W] int32 -> [B, K, H, W] bool."""
    ks = torch.arange(k, device=words.device)
    return ((words[:, ks // 32] >> (ks % 32).to(torch.int32)[
        None, :, None, None]) & 1) == 1


def flood_packed_plain(gate, reach0, rounds):
    """Plain PyTorch version: JAX's Hillis-Steele doubling scans
    (``_seg_or_scan_packed``) over whole axes and its while-loop round
    structure. Returns (words, rounds_run per plane)."""
    return common.or_flood(gate, reach0, rounds)


def flood_packed(gate_words: torch.Tensor, reach0_words: torch.Tensor,
                 rounds: int, impl=None, rounds_out=None) -> torch.Tensor:
    """Flood the set bits of ``reach0_words`` through ``gate_words``, both
    int32 [N, H, W] word planes; returns the reached words.

    Both versions scan whole runs of gate bits. JAX's kernel takes a
    ``max_run`` bound on its doubling scans, which only its own tests
    pass; where no run is longer than that bound, its words equal these.
    ``rounds_out`` (int32 [N] on the planes' device, optional) receives the
    rounds each plane ran: its rounds to the fixed point plus the one that
    confirms it, or ``rounds``.

    CPU tensors (or ``impl="plain"``) take the plain version; CUDA tensors
    launch the kernel, one cooperative launch per call, for any H and W
    (planes whose rows or column strips do not fit in shared memory take
    the kernel's in-place instance)."""
    if gate_words.dim() != 3:
        raise ValueError(f"gate_words must be [N, H, W], got "
                         f"{tuple(gate_words.shape)}")
    n, h, w = gate_words.shape
    dev = gate_words.device
    common.check("gate_words", gate_words, torch.int32, (n, h, w), dev)
    common.check("reach0_words", reach0_words, torch.int32, (n, h, w), dev)
    if rounds_out is not None:
        common.check("rounds_out", rounds_out, torch.int32, (n,), dev)
    if not common.use_kernel(dev, impl):
        out, ran = flood_packed_plain(gate_words, reach0_words, rounds)
        if rounds_out is not None:
            rounds_out.copy_(ran)
        return out
    out = torch.empty_like(reach0_words)
    flags = torch.empty(3 * n, dtype=torch.int32, device=dev)
    common.launch(
        _lib().flood_packed_launch, dev, common.ptr(gate_words),
        common.ptr(reach0_words), common.ptr(out), common.ptr(flags),
        common.ptr(rounds_out), n, h, w, int(rounds))
    return out
