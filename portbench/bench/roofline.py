"""Published peaks of one NVIDIA H100 SXM (dense, at its 700 W limit) and
the least time of a kernel call (copied from ``chip_smoke.bound`` at
commit 9e5028f)."""

HBM_BYTES_PER_S = 3.35e12   # HBM3
F32_OPS_PER_S = 67e12       # f32 outside the tensor cores


def least_seconds(n_bytes: float, f32_ops: float = 0.0) -> float:
    """The larger of bytes over the HBM rate and f32 operations over the
    f32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, f32_ops / F32_OPS_PER_S)
