"""f32 sums in the order XLA:CPU evaluates them.

These helpers exist only for bit parity with the JAX package on the CPU:
seeds, scores and mean-shift modes sit on knife edges (a threshold, an
argmin between near-equal candidates), and the port must land on the same
side as JAX's jitted functions. They hold on the card too, where they are
plain elementwise arithmetic: no TF32, no library matmul, no global flag.

  * :func:`fma_sum3` is a length-3 dot as XLA:CPU fuses it,
    fma(a2, b2, fma(a1, b1, a0 * b0)), each fused step exact in f64 and
    rounded to f32;
  * :func:`cumsum_last` is an f32 inclusive sum-scan as XLA:CPU rewrites
    ``cumsum``: sequential within blocks of :data:`CUMSUM_BLOCK`, the block
    totals scanned the same way. The block size is XLA:CPU's, not a
    property of the data; if JAX's CPU backend changes it, the tests that
    hold the average-normal seeds to JAX's show it.
"""

from __future__ import annotations

import torch

CUMSUM_BLOCK = 16  # XLA:CPU's block of a rewritten f32 cumsum


def fma_sum3(a, b):
    """sum(a * b, -1) of broadcastable [..., 3] f32 tensors in XLA:CPU's
    fused order."""
    acc = a[..., 0] * b[..., 0]
    for i in (1, 2):
        acc = (a[..., i].double() * b[..., i].double()
               + acc.double()).float()
    return acc


def dot3(a, b):
    """[..., R, N] dots of a [..., R, 3] with b [..., N, 3] (:func:`fma_sum3`
    over every pair)."""
    return fma_sum3(a[..., :, None, :], b[..., None, :, :])


def sumsq(d):
    """sum(d * d, -1) of [..., 3] f32 (:func:`fma_sum3` of ``d`` with
    itself)."""
    return fma_sum3(d, d)


def cumsum_last(x):
    """Inclusive f32 sum-scan of the last axis in XLA:CPU's order."""
    n = x.shape[-1]
    if n <= CUMSUM_BLOCK:
        out = x.clone()
        for k in range(1, n):
            out[..., k] += out[..., k - 1]
        return out
    m = -(-n // CUMSUM_BLOCK)
    xp = torch.nn.functional.pad(x, (0, m * CUMSUM_BLOCK - n))
    inner = cumsum_last(xp.reshape(x.shape[:-1] + (m, CUMSUM_BLOCK)))
    outer = cumsum_last(inner[..., -1])
    carry = torch.nn.functional.pad(outer[..., :-1], (1, 0))
    return (inner + carry[..., None]).reshape(x.shape[:-1]
                                              + (m * CUMSUM_BLOCK,))[..., :n]
