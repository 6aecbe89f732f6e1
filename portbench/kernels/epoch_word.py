"""B1, ``pcseg_tpu_torch/csrc/epoch_word.cu``: one closure epoch of the
batched grower. Counted from the call's logical arguments: every grid and
slot table read once, the new member word and the slot tables written
once; f32 work is the gate's plane distance (3 multiplies, 3 adds and an
absolute value) per slot and pixel. Moment products are left out: the
bytes bound the call by far."""

WRAPPER = "pcseg_tpu_torch.kernels.epoch_word:epoch_word"
DEVICE_NAME = "epoch_word_kernel"


def cost(a: dict):
    """(bytes, f32 operations) of one call from its bound arguments."""
    b, h, w = a["px"].shape
    k = a["srank"].shape[1]
    # px, py, pz, rank, elig, word; four slot tables, planes, radius
    grids_in = 6 * 4 * b * h * w
    slots_in = 4 * 4 * b * k + 16 * b * k + 4 * b
    # the new word; cnt, mrank, alin; the moments
    out = 4 * b * h * w + 3 * 4 * b * k + 40 * b * k
    if a.get("rounds_out") is not None:
        out += 4 * b
    return grids_in + slots_in + out, 7 * k * b * h * w
