"""N1, ``pcseg_tpu_torch/csrc/normal_support.cu``: the normals' support
walks and moment sums. Counted from the call's logical arguments: the
points read once (12 B a pixel); the six moment sums, the weight, the
count, the center mask and the normal hint written once (57 B a pixel).
The walks' distances and the moment products are not counted: the bytes
bound the call."""

WRAPPER = "pcseg_tpu_torch.kernels.normal_support:normal_support"
DEVICE_NAME = "normal_support_kernel"


def cost(a: dict):
    """(bytes, f32 operations) of one call from its bound arguments."""
    b, h, w = a["points"].shape[:3]
    # s2 24, s1 12, w 4, count 4, center mask 1, hint 12
    return (12 + 57) * b * h * w, 0
