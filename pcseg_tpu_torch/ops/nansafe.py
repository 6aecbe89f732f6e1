"""Finite test on the integer view of a float (port of pcseg_tpu.ops.nansafe).

A float is non-finite iff its exponent bits are all ones. Testing the bits
instead of comparing floats keeps the eligibility masks independent of how
a compiler treats NaN comparisons, and is what the JAX package does.
"""

from __future__ import annotations

import torch

_EXP_MASK = {
    torch.float32: (torch.int32, 0x7F800000),
    torch.float16: (torch.int16, 0x7C00),
    torch.bfloat16: (torch.int16, 0x7F80),
    torch.float64: (torch.int64, 0x7FF0000000000000),
}


def isfinite(x: torch.Tensor) -> torch.Tensor:
    """Elementwise finite test via exponent bits (True = finite)."""
    entry = _EXP_MASK.get(x.dtype)
    if entry is None:
        return torch.isfinite(x)
    itype, mask = entry
    return (x.contiguous().view(itype) & mask) != mask


def all_finite(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``isfinite(x).all(dim)`` — the common channel-reduced form."""
    return isfinite(x).all(dim=dim)


def sanitize(x: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Replace non-finite entries by ``fill`` using the bit-level mask."""
    return torch.where(isfinite(x), x, torch.full_like(x, fill))
