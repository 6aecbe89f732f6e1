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

from pcseg_tpu_torch.models.classify import plane_class_name
from pcseg_tpu_torch.models.cluster import gather_region_indices
from pcseg_tpu_torch.models.config import SEMANTIC_UNKNOWN
from pcseg_tpu_torch.protos import pcseg_pb2


@dataclasses.dataclass
class DetectedObject:
    """In-memory detected object (planar or cluster geometry)."""
    object_class: str
    points: np.ndarray                    # [N, 3] inlier points
    centroid: Optional[np.ndarray] = None  # planar only
    plane: Optional[np.ndarray] = None     # planar only, coeffs (n, d)
    discontinuous_boundary_positions: Optional[np.ndarray] = None


def plane_to_proto(plane: np.ndarray, proto: pcseg_pb2.Plane3dProto) -> None:
    """detected_objects.h:37-49: the closest point to the origin
    (-n * offset) and the unit normal."""
    point = -plane[:3] * plane[3]
    proto.x, proto.y, proto.z = (float(v) for v in point)
    proto.nx, proto.ny, proto.nz = (float(v) for v in plane[:3])


def plane_from_proto(proto: pcseg_pb2.Plane3dProto) -> np.ndarray:
    """detected_objects.h:51-59."""
    normal = np.array([proto.nx, proto.ny, proto.nz], np.float32)
    nrm = np.linalg.norm(normal)
    if not nrm > 1e-12:
        raise ValueError("invalid plane proto (zero normal)")
    normal = normal / nrm
    point = np.array([proto.x, proto.y, proto.z], np.float32)
    return np.concatenate([normal, [-normal @ point]]).astype(np.float32)


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


def to_proto(obj: DetectedObject,
             proto: Optional[pcseg_pb2.DetectedObjectProto] = None
             ) -> pcseg_pb2.DetectedObjectProto:
    """A DetectedObjectProto: planar geometry (points, centroid, plane,
    boundary positions) when the object has a plane, else cluster
    geometry."""
    if proto is None:
        proto = pcseg_pb2.DetectedObjectProto()
    proto.object_class = obj.object_class
    flat = np.asarray(obj.points, np.float32).reshape(-1)
    if obj.plane is not None:
        geom = proto.planar_geometry
        geom.points_xyz.extend(flat)
        geom.centroid.x, geom.centroid.y, geom.centroid.z = \
            (float(v) for v in obj.centroid[:3])
        plane_to_proto(obj.plane, geom.plane)
        if obj.discontinuous_boundary_positions is not None:
            geom.discontinuous_boundary_indices.extend(
                np.asarray(obj.discontinuous_boundary_positions, np.int64))
    else:
        proto.cluster_geometry.points_xyz.extend(flat)
    return proto


def detected_objects_proto(objects: List[DetectedObject]
                           ) -> pcseg_pb2.DetectedObjectsProto:
    out = pcseg_pb2.DetectedObjectsProto()
    for obj in objects:
        to_proto(obj, out.detected_objects.add())
    return out
