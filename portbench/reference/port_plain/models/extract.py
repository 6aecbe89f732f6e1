"""Detected-object extraction: finalized regions -> DetectedObjects ->
protos (port of pcseg_tpu.models.extract, on the port's codec
protos/pcseg_pb2.py).

Reimplements detected_objects.{h,cc}: the Plane3dProto round trip
(detected_objects.h:37-59), cluster extraction (detected_objects.h:62-74)
and planar extraction with re-indexed discontinuous boundary indices
(detected_objects.cc:21-48).

Ordering note: the reference gathers inlier points in BFS discovery order;
both packages normalise inlier order to ascending col-major linear index
(the point set, centroid and plane are identical).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from portbench.reference.port_plain.models.classify import plane_class_name
from portbench.reference.port_plain.models.cluster import gather_region_indices
from portbench.reference.port_plain.models.config import SEMANTIC_UNKNOWN


@dataclasses.dataclass
class DetectedObject:
    """In-memory detected object (planar or cluster geometry)."""
    object_class: str
    points: np.ndarray                    # [N, 3] inlier points
    centroid: Optional[np.ndarray] = None  # planar only
    plane: Optional[np.ndarray] = None     # planar only, coeffs (n, d)
    discontinuous_boundary_positions: Optional[np.ndarray] = None


def _gather_points(points: np.ndarray, indices: np.ndarray) -> np.ndarray:
    rows = points.shape[0]
    return points[indices % rows, indices // rows]


class RegionIndexer:
    """Shared index for extracting many regions from one label grid: one
    stable argsort of the col-major labels instead of a full [H, W] scan
    per object. ``indices(id)`` equals :func:`gather_region_indices`."""

    def __init__(self, labels: np.ndarray):
        flat_cm = np.ascontiguousarray(labels.T).ravel()
        self._order = np.argsort(flat_cm, kind="stable").astype(np.int64)
        self._sorted = flat_cm[self._order]

    def indices(self, region_id: int) -> np.ndarray:
        lo = np.searchsorted(self._sorted, region_id, side="left")
        hi = np.searchsorted(self._sorted, region_id, side="right")
        return np.sort(self._order[lo:hi])


def cluster_detected_object(points: np.ndarray, labels: np.ndarray,
                            region_id: int,
                            object_class: str = SEMANTIC_UNKNOWN,
                            indexer: Optional[RegionIndexer] = None
                            ) -> DetectedObject:
    """CreateClusterDetectedObjectProto (detected_objects.h:62-74)."""
    idx = indexer.indices(region_id) if indexer is not None \
        else gather_region_indices(labels, region_id)
    return DetectedObject(object_class=object_class,
                          points=_gather_points(points, idx))


def planar_detected_object_from_labels(points: np.ndarray,
                                       labels: np.ndarray,
                                       record,
                                       indexer: Optional[RegionIndexer]
                                       = None) -> DetectedObject:
    """CreatePlanarDetectedObjectProto (detected_objects.cc:21-48): gather
    inliers, centroid + plane from the estimator, and re-map discontinuous
    boundary indices to positions within the gathered point list."""
    idx = indexer.indices(record.label_id) if indexer is not None \
        else gather_region_indices(labels, record.label_id)
    pts = _gather_points(points, idx)
    disc = record.discontinuous_boundary_indices
    positions = np.nonzero(np.isin(idx, list(disc)))[0].astype(np.int32) \
        if disc else np.zeros((0,), np.int32)
    return DetectedObject(
        object_class=plane_class_name(record.plane_class),
        points=pts,
        centroid=record.centroid.copy(),
        plane=record.plane.copy(),
        discontinuous_boundary_positions=positions,
    )
