"""B2, ``pcseg_tpu_torch/csrc/ccl_gated.cu``: the gated CCL to its fixed
point. Counted from the call's logical arguments: the gate word and the
initial labels read once, the labels written once; no float work."""

WRAPPER = "pcseg_tpu_torch.kernels.ccl_gated:ccl_gated"
DEVICE_NAME = "ccl_gated_kernel"


def cost(a: dict):
    """(bytes, f32 operations) of one call from its bound arguments."""
    b, h, w = a["gate"].shape
    out = 4 * b if a.get("rounds_out") is not None else 0
    return 3 * 4 * b * h * w + out, 0
