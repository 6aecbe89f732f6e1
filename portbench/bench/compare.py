"""The numbers that decide ``correct``: a program's outputs against the
reference's for the same request, accumulated over every compared output.

Counts (cells, frames, fields, objects that differ) add up; gaps (the
largest absolute difference of a float field, NaN against a number read
as infinite) take the maximum. ``limits`` come from the configuration
file; a run is correct when every number is at or under its limit.
"""

from __future__ import annotations

import math

import numpy as np

# frame fields compared exactly (pipeline.frame_arrays' keys)
EXACT_FRAME_FIELDS = ("metrics", "cluster_sizes", "counts", "areas",
                      "plane_class", "seed_indices", "boundary",
                      "boundary_len", "disc", "disc_len")


def gap(a, b) -> float:
    """Largest |a - b| over two float arrays of one shape; NaN on one side
    only is infinite, NaN on both is no gap."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        return math.inf
    if a.size == 0:
        return 0.0
    both = np.isnan(a) & np.isnan(b)
    d = np.where(both, 0.0, np.abs(a - b))
    d = np.where(np.isnan(d), np.inf, d)
    return float(d.max())


class Tally:
    """Counts and gaps over many compared outputs."""

    def __init__(self, counts=(), gaps=()):
        self.values = {n: 0 for n in counts}
        self.values.update({n: 0.0 for n in gaps})
        self.gaps = set(gaps)
        self.compared = 0

    def add(self, name, value):
        if name in self.gaps:
            self.values[name] = max(self.values[name], float(value))
        else:
            self.values[name] += int(value)


def stream_tally():
    return Tally(counts=("labels_differing", "counts_differing"),
                 gaps=("plane_gap",))


def compare_stream(t: Tally, got, want):
    """``device_forward_stream``'s host outputs (labels u8 [B, H, W],
    planar counts [B], cluster counts [B], planes [B, K, 4])."""
    labels, n_planar, n_clusters, planes = got
    r_labels, r_planar, r_clusters, r_planes = want
    t.compared += 1
    if labels.shape != r_labels.shape:
        t.add("labels_differing", r_labels.size)
    else:
        t.add("labels_differing", (labels != r_labels).sum())
    for b in range(len(r_planar)):
        same = (b < len(n_planar) and n_planar[b] == r_planar[b]
                and n_clusters[b] == r_clusters[b])
        if not same:
            t.add("counts_differing", 1)
            continue
        n = int(r_planar[b])
        t.add("plane_gap", gap(planes[b, :n], r_planes[b, :n]))


def frame_tally():
    return Tally(counts=("labels_differing", "fields_differing",
                         "objects_differing"),
                 gaps=("plane_gap",))


def compare_frame(t: Tally, got: dict, want: dict):
    """Two ``frame_arrays`` dicts, each with ``objects`` added (a list of
    (class, points, centroid, plane, discontinuous positions))."""
    t.compared += 1
    if got["labels"].shape != want["labels"].shape:
        t.add("labels_differing", want["labels"].size)
    else:
        t.add("labels_differing", (got["labels"] != want["labels"]).sum())
    for k in EXACT_FRAME_FIELDS:
        if not np.array_equal(got[k], want[k]):
            t.add("fields_differing", 1)
    for k in ("planes", "centroids"):
        t.add("plane_gap", gap(got[k], want[k]))
    objs, r_objs = got["objects"], want["objects"]
    t.add("objects_differing", abs(len(objs) - len(r_objs)))
    for o, r in zip(objs, r_objs):
        if o[0] != r[0] or not np.array_equal(o[1], r[1], equal_nan=True) \
                or not np.array_equal(o[4], r[4]):
            t.add("objects_differing", 1)
        for i in (2, 3):
            if r[i] is not None:
                t.add("plane_gap", gap(o[i], r[i]) if o[i] is not None
                      else math.inf)


def sharded_tally():
    return Tally(counts=("labels_differing", "counts_differing"),
                 gaps=("plane_gap",))


def compare_sharded(t: Tally, got, want):
    """One rank's step outputs (its labels block [H, W_local], planar
    count, cluster count, planes [K, 4])."""
    labels, n_planar, n_clusters, planes = got
    r_labels, r_planar, r_clusters, r_planes = want
    t.compared += 1
    if labels.shape != r_labels.shape:
        t.add("labels_differing", r_labels.size)
    else:
        t.add("labels_differing", (labels != r_labels).sum())
    if n_planar != r_planar or n_clusters != r_clusters:
        t.add("counts_differing", 1)
        return
    n = int(r_planar)
    t.add("plane_gap", gap(planes[:n], r_planes[:n]))
