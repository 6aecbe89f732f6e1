"""Geometric plane classification: floor / table / wall / unknown.

A host pass over finalized region records and a batched pass on tensors
(``classify_planes_batched``), ports of pcseg_tpu.models.classify;
reimplements plane_classification.cc:
  * floor / coffee-table: near-horizontal normal (cosine gate), signed
    offset from a known floor point within deviation, area within
    [min, max] (:34-65);
  * wall: near-vertical normal plus hull height extent >= min_height
    (:68-93);
  * priority floor > table > wall > unknown (:111-136);
  * per-reason rejection counters (plane_classification.h:31-45).
"""

from __future__ import annotations

import dataclasses
import math
from typing import List

import numpy as np
import torch

from portbench.reference.port_plain.models.config import (
    PlaneClass, PlaneClassificationConfig, ClassifyHorizontalPlaneParams,
    ClassifyWallParams, PLANE_CLASS_NAMES)
from portbench.reference.port_plain.ops import xla_order


@dataclasses.dataclass
class HorizontalPlaneRejections:
    """plane_classification.h:33-39."""
    rejected_for_angle: int = 0
    rejected_for_distance: int = 0
    rejected_for_size: int = 0

    def report(self) -> str:
        """plane_classification.cc:97-102."""
        return (f"regions rejection:{self.rejected_for_angle} for angle, "
                f"{self.rejected_for_distance} for distance, "
                f"{self.rejected_for_size} for size.")


@dataclasses.dataclass
class ClassificationDebugSummary:
    """plane_classification.h:31-45."""
    total_considered: int = 0
    floor_rejections: HorizontalPlaneRejections = dataclasses.field(
        default_factory=HorizontalPlaneRejections)
    coffee_table_rejections: HorizontalPlaneRejections = dataclasses.field(
        default_factory=HorizontalPlaneRejections)

    def full_report(self) -> str:
        """plane_classification.cc:104-109."""
        return (f"Considered {self.total_considered} planes:\n Floor "
                f"{self.floor_rejections.report()}\n Coffee Table "
                f"{self.coffee_table_rejections.report()}")


def _is_horizontal(params: ClassifyHorizontalPlaneParams, plane, area,
                   up, floor_point, rej: HorizontalPlaneRejections) -> bool:
    cos_max = math.cos(math.radians(
        params.max_up_direction_delta_angle_degrees))
    if float(np.dot(plane[:3], up)) < cos_max:
        rej.rejected_for_angle += 1
        return False
    floor_offset = float(np.dot(plane[:3], floor_point) + plane[3])
    if abs(params.floor_offset + floor_offset) \
            > params.max_floor_offset_deviation:
        rej.rejected_for_distance += 1
        return False
    if area < params.min_area or area > params.max_area:
        rej.rejected_for_size += 1
        return False
    return True


def _is_wall(params: ClassifyWallParams, plane, hull_points, up) -> bool:
    cos_max = math.cos(math.radians(
        90.0 - params.max_horizontal_delta_angle_degrees))
    if abs(float(np.dot(plane[:3], up))) > cos_max:
        return False
    if len(hull_points) == 0:
        return False
    heights = np.asarray(hull_points, np.float32) @ np.asarray(up, np.float32)
    return float(heights.max() - heights.min()) >= params.min_height


def classify_regions(records, config: PlaneClassificationConfig,
                     up_direction, known_floor_point,
                     summary: ClassificationDebugSummary = None) -> List:
    """Classify finalized PlanarRegionRecords in place (host pass)."""
    if summary is None:
        summary = ClassificationDebugSummary()
    up = np.asarray(up_direction, np.float32)
    floor_pt = np.asarray(known_floor_point, np.float32)
    for rec in records:
        summary.total_considered += 1
        if _is_horizontal(config.floor_params, rec.plane, rec.area, up,
                          floor_pt, summary.floor_rejections):
            rec.plane_class = PlaneClass.FLOOR
        elif _is_horizontal(config.coffee_table_params, rec.plane, rec.area,
                            up, floor_pt, summary.coffee_table_rejections):
            rec.plane_class = PlaneClass.TABLE
        elif _is_wall(config.wall_params, rec.plane,
                      rec.projected_boundary_points, up):
            rec.plane_class = PlaneClass.WALL
        else:
            rec.plane_class = PlaneClass.UNKNOWN
    return records


def plane_class_name(plane_class: PlaneClass) -> str:
    """planar_region.h:270-282."""
    return PLANE_CLASS_NAMES[PlaneClass(plane_class)]


def classify_planes_batched(planes, areas, hull_heights, up, floor_point,
                            config: PlaneClassificationConfig):
    """Classification of padded region tables on their device (JAX's
    ``classify_planes_batched``): planes [R, 4], areas [R], hull_heights
    [R] (the hull's extent along ``up``), up and floor_point [3] -> [R]
    int32 PlaneClass values, the priority of :func:`classify_regions`.

    All in f32 as JAX's jitted call: the two length-3 dots in XLA:CPU's
    fused order (ops/xla_order.fma_sum3; an eager JAX call rounds the
    products first and may land on the other side of an ulp-wide gate),
    and every bound and cosine cast to f32 as JAX's weak types are. The
    default floor and table gates have a 0 degree angle, so their cosine
    is exactly 1 and only normals whose up component is exactly 1 pass."""
    dev = planes.device

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    planes, areas, hull_heights = f32(planes), f32(areas), f32(hull_heights)
    n_dot_up = xla_order.fma_sum3(planes[:, :3], f32(up))
    floor_offset = xla_order.fma_sum3(planes[:, :3], f32(floor_point)) \
        + planes[:, 3]

    def horizontal(p: ClassifyHorizontalPlaneParams):
        cos_max = math.cos(math.radians(
            p.max_up_direction_delta_angle_degrees))
        return ((n_dot_up >= f32(cos_max))
                & ((f32(p.floor_offset) + floor_offset).abs()
                   <= f32(p.max_floor_offset_deviation))
                & (areas >= f32(p.min_area)) & (areas <= f32(p.max_area)))

    cos_wall = math.cos(math.radians(
        90.0 - config.wall_params.max_horizontal_delta_angle_degrees))
    is_wall = ((n_dot_up.abs() <= f32(cos_wall))
               & (hull_heights >= f32(config.wall_params.min_height)))
    out = torch.where(is_wall, int(PlaneClass.WALL), int(PlaneClass.UNKNOWN))
    out = torch.where(horizontal(config.coffee_table_params),
                      int(PlaneClass.TABLE), out)
    return torch.where(horizontal(config.floor_params),
                       int(PlaneClass.FLOOR), out).to(torch.int32)
