"""B3, ``pcseg_tpu_torch/csrc/flood_packed.cu``: the OR-flood of packed
slot words. Counted from the call's logical arguments: the gate and
source word planes read once, the reached words written once; no float
work."""

WRAPPER = "pcseg_tpu_torch.kernels.flood_packed:flood_packed"
DEVICE_NAME = "flood_packed_kernel"


def cost(a: dict):
    """(bytes, f32 operations) of one call from its bound arguments."""
    n, h, w = a["gate_words"].shape
    out = 4 * n if a.get("rounds_out") is not None else 0
    return 3 * 4 * n * h * w + out, 0
