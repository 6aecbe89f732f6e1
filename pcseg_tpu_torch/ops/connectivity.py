"""Gated connected-component labelling on dense grids (port of
pcseg_tpu.ops.connectivity: the scan CCL of the cluster stage).

The reference grows euclidean clusters by BFS with a per-step distance
gate (cluster_region.h:85-150); the accepted set is the closure of the
gated window graph. Every component is labelled at once with its minimum
col-major index by min-propagation: the scan CCL (row and column segmented
min-scans, then the window offsets; kernels/ccl_gated.py up to 32 offsets)
or the window CCL with pointer jumping (``ccl_mode="while"`` and the device
mean-shift growth); ``connected_components_mask`` is the same rounds on a
bool mask whose edges are joint membership. ``reachable_from`` is the
4-connected flood of the sequential grower. Each function takes JAX's
single frame ([H, W, 3] points, [H, W] grids) or a batch with a leading
frame axis ``B`` (ops/frames.py); the shapes below are the batch's.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.kernels import ccl_gated, common
from pcseg_tpu_torch.kernels.common import shift2
from pcseg_tpu_torch.ops.frames import takes_frames
from pcseg_tpu_torch.utils import profiling


def colmajor_index_grid(h, w, device=None):
    """[H, W] int32 grid of col-major linear indices (col*H + row),
    the reference's cloud.h:38-41 convention."""
    rows = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    cols = torch.arange(w, dtype=torch.int32, device=device)[None, :]
    return cols * h + rows


def window_offsets(half_window):
    """Window offsets in the JAX order: dc outer, dr inner, (0, 0) left
    out."""
    return [(dr, dc)
            for dc in range(-half_window, half_window + 1)
            for dr in range(-half_window, half_window + 1)
            if (dr, dc) != (0, 0)]


def window_gates(points, eligible, squared_threshold, offsets):
    """[O, B, H, W] bool: gate o is set where the edge to ``offsets[o]``
    passes (both ends eligible, ||p - q||^2 < tau).

    All offsets at once: the cloud is padded once (NaN points, ineligible
    cells) and the shifted views stacked, so a call costs a fixed number of
    device ops; the distance keeps the per-offset f32 expression."""
    b, h, w = points.shape[:3]
    dev = points.device
    p = max(max(abs(dr), abs(dc)) for dr, dc in offsets)
    padded = torch.full((b, h + 2 * p, w + 2 * p, 3), float("nan"),
                        dtype=points.dtype, device=dev)
    padded[:, p:p + h, p:p + w] = points
    elig = torch.zeros((b, h + 2 * p, w + 2 * p), dtype=torch.bool,
                       device=dev)
    elig[:, p:p + h, p:p + w] = eligible
    nb = torch.stack([padded[:, p + dr:p + dr + h, p + dc:p + dc + w]
                      for dr, dc in offsets])
    nb_elig = torch.stack([elig[:, p + dr:p + dr + h, p + dc:p + dc + w]
                           for dr, dc in offsets])
    with profiling.blocking("clusters.threshold"):
        thr = torch.tensor(squared_threshold, dtype=points.dtype, device=dev)
    d = nb - points
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    return (d2 < thr) & eligible & nb_elig


def _gate_bits(points, eligible, squared_threshold, offsets):
    """[B, H, W] int32 word: bit o set iff the edge to ``offsets[o]``
    passes. At most 32 offsets (a word has 32 bits)."""
    if len(offsets) > 32:
        raise ValueError(f"a gate word holds at most 32 offsets, got "
                         f"{len(offsets)}")
    ok = window_gates(points, eligible, squared_threshold, offsets)
    # distinct bits: the int64 sum is their OR; bit 31 lands on the sign
    bits = (ok.to(torch.int64) << torch.arange(
        len(offsets), device=points.device)[:, None, None, None]).sum(dim=0)
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32)


@takes_frames(points=3, eligible=2, init_labels=2)
def connected_components_scan(points, eligible, squared_threshold,
                              half_window, rounds=24, init_labels=None,
                              big_value=None, impl=None):
    """Gated CCL of [B, H, W, 3] points over the eligible cells.

    Returns [B, H, W] int32: the min col-major index of each cell's
    component (under the ``rounds`` cap), H*W where ineligible. Up to 32
    window offsets (half_window <= 2) the gates ride in one int32 word
    through the CCL kernel; above that, as in JAX (which has no kernel
    there), one bool gate per offset through the same rounds in torch ops
    on either device.

    ``init_labels`` ([H, W] or [B, H, W] int32) and ``big_value`` let a
    column shard start from GLOBAL col-major indices with the global
    sentinel H*W_total (parallel/sharded.py); by default the local grid's
    indices and H*W."""
    b, h, w = points.shape[:3]
    big = h * w if big_value is None else int(big_value)
    offsets = window_offsets(half_window)
    if init_labels is None:
        init_labels = colmajor_index_grid(h, w, points.device)
    labels0 = torch.where(eligible, init_labels.to(torch.int32), big) \
        .to(torch.int32).expand(b, h, w).contiguous()
    if len(offsets) > 32:
        gates = window_gates(points, eligible, squared_threshold, offsets)
        out, _ = common.ccl_rounds(list(gates), labels0, offsets, rounds, big)
    else:
        gate = _gate_bits(points, eligible, squared_threshold, offsets)
        out = ccl_gated.ccl_gated(gate, labels0, offsets, rounds, big,
                                  impl=impl)
    return torch.where(eligible, out, big)


def _lookup_colmajor(values, indices, fill):
    """Gather [B, H, W] ``values`` at the col-major linear ``indices``
    ([B, H, W] int32; H*W and up -> ``fill``), the indices clipped."""
    b, h, w = values.shape
    r = indices % h
    c = torch.div(indices, h, rounding_mode="floor")
    safe = (r * w + c).clamp(0, h * w - 1).reshape(b, -1).long()
    out = torch.gather(values.reshape(b, -1), 1, safe).reshape(b, h, w)
    return torch.where(indices >= h * w, fill, out)


@takes_frames(points=3, eligible=2)
def connected_components_window(points, eligible, squared_threshold,
                                half_window, max_iters=256, num_jumps=2):
    """Component roots by min-propagation over the window with pointer
    jumping (JAX's ``connected_components_window``, the ``ccl_mode="while"``
    CCL): per round every offset's min-exchange against the round's start,
    then ``num_jumps`` jumps through the labels; rounds repeat while the
    batch changes, at most ``max_iters``. [B, H, W, 3] points and [B, H, W]
    eligibility in; [B, H, W] int32 out, H*W where ineligible."""
    b, h, w = points.shape[:3]
    big = h * w
    offsets = window_offsets(half_window)
    gates = window_gates(points, eligible, squared_threshold, offsets)
    init = torch.where(eligible, colmajor_index_grid(h, w, points.device),
                       big).to(torch.int32)

    def one_round(labels):
        new = labels
        for (dr, dc), gate in zip(offsets, gates):
            nb = shift2(labels, dr, dc, big)
            new = torch.minimum(new, torch.where(gate, nb, big))
        for _ in range(num_jumps):
            jumped = _lookup_colmajor(new, new, big)
            new = torch.where(eligible, torch.minimum(new, jumped), big)
        return new

    prev, labels = init, one_round(init)
    it = 1
    while it < max_iters and bool((labels != prev).any()):
        prev, labels = labels, one_round(labels)
        it += 1
    return labels


@takes_frames(mask=2)
def connected_components_mask(mask, max_iters=64, num_jumps=2,
                              neighborhood4=True):
    """Component roots (min col-major index) of a bool mask under 4- (or
    8-) adjacency, where the edge gate is joint membership (JAX's
    ``connected_components_mask``). [H, W] as in JAX, or [B, H, W]; int32
    out, H*W off the mask.

    JAX's rounds in torch ops: from the col-major index on the mask, each
    round takes the min over the gated shifted neighbours, then
    ``num_jumps`` pointer jumps; the first round always runs, and rounds
    repeat while a label changed, at most ``max_iters``. A batch stops
    together: rounds past a frame's fixed point leave it as it is, so each
    frame is JAX's also where ``max_iters`` binds."""
    h, w = mask.shape[-2:]
    big = h * w
    offsets = ([(-1, 0), (1, 0), (0, -1), (0, 1)] if neighborhood4 else
               [(dr, dc) for dr in (-1, 0, 1) for dc in (-1, 0, 1)
                if (dr, dc) != (0, 0)])
    gates = [mask & shift2(mask, dr, dc, False) for dr, dc in offsets]
    init = torch.where(mask, colmajor_index_grid(h, w, mask.device),
                       big).to(torch.int32)

    def one_round(labels):
        new = labels
        for (dr, dc), gate in zip(offsets, gates):
            new = torch.minimum(new, torch.where(
                gate, shift2(labels, dr, dc, big), big))
        for _ in range(num_jumps):
            jumped = _lookup_colmajor(new, new, big)
            new = torch.where(mask, torch.minimum(new, jumped), big)
        return new

    prev, labels = init, one_round(init)
    it = 1
    while it < max_iters and bool((labels != prev).any()):
        prev, labels = labels, one_round(labels)
        it += 1
    return labels


@takes_frames()
def reachable_from(mask, sources, max_rounds=64):
    """Cells of the bool ``mask`` [..., H, W] 4-connected to a cell of
    ``sources`` (JAX's ``reachable_from``, the sequential grower's epoch
    flood). A round OR-spreads reachability through whole runs of the mask
    along the rows, then along the columns (segmented scans forward and
    backward); the first round always runs and rounds repeat while a grid
    changed, at most ``max_rounds``: JAX's rounds, run by the plain flood of
    one bit per word in torch ops."""
    shape = mask.shape
    gate = mask.reshape((-1,) + shape[-2:]).to(torch.int32)
    reach0 = (sources & mask).reshape(gate.shape).to(torch.int32)
    reach, _ = common.or_flood(gate, reach0, max_rounds)
    return (reach != 0).reshape(shape)


@takes_frames(values=2, roots=2, eligible=2)
def segment_field(values, roots, eligible, h, w, reduce="sum"):
    """Reduce [B, H, W] ``values`` over the cells of each component of the
    col-major ``roots`` (H*W = no component): ``"sum"`` over the eligible
    cells (0 elsewhere), ``"min"`` over the values as given (the dtype's
    largest value, +inf for floats, where a root has no cell: the identity
    of ``jax.ops.segment_min``). Returns [B, H*W] indexed by root."""
    b = values.shape[0]
    if tuple(values.shape[1:]) != (h, w):
        raise ValueError(f"values of shape {tuple(values.shape)} on an "
                         f"{h}x{w} grid")
    seg = roots.reshape(b, -1).long()
    if reduce == "sum":
        out = torch.zeros((b, h * w + 1), dtype=values.dtype,
                          device=values.device)
        out.scatter_add_(1, seg, torch.where(eligible, values, 0)
                         .reshape(b, -1))
    elif reduce == "min":
        top = float("inf") if values.dtype.is_floating_point \
            else torch.iinfo(values.dtype).max
        out = torch.full((b, h * w + 1), top, dtype=values.dtype,
                         device=values.device)
        out.scatter_reduce_(1, seg, values.reshape(b, -1), "amin")
    else:
        raise ValueError(f"unknown reduce {reduce!r}")
    return out[:, :h * w]
