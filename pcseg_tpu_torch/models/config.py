"""Configuration dataclasses mirroring the reference's proto configs.

Every field and default matches the reference's proto schemas plus their
in-code ApplyDefaultConfigValues:
  * PlanarRegionConfig    <- PlanarRegionConfigProto
      (region_segmentation_config.proto:42-72, planar_region.h:93-121)
  * ClusterRegionConfig   <- ClusterRegionConfigProto
      (region_segmentation_config.proto:22-39, cluster_region.h:53-63)
  * ClassifyHorizontalPlaneParams / ClassifyWallParams /
    PlaneClassificationConfig <- plane_classification_config.proto:23-58
  * ComputeNormalsParams  <- algorithms.h:313-322
  * MeanShiftParams       <- hard-coded constexprs
      (mean_shift_segmentation.h:31-51)

Extra device knobs (capacities, scan bounds) are grouped separately in
each dataclass and documented; they bound on-device shapes and do not
change semantics when large enough.

This module is the PyTorch port's copy of ``pcseg_tpu.models.config``
(numpy/stdlib only, so the port never imports JAX). Field names, defaults
and sentinels are identical; :func:`config_from_dict` rebuilds a
:class:`SegmenterConfig` from a ``dataclasses.asdict`` tree of either
package's config — the one piece of state that crosses between them.
"""

from __future__ import annotations

import dataclasses
import enum
import typing

# Label sentinels (segmentation.h:36-45).
UNLABELED = -1
MASKED_OUT = -2
IN_QUEUE = -3            # kAlreadyInUnexaminedPointsQueue
EXAMINED = -4            # kAlreadyExamedPoint
MASKED_EGO = -5


class ClusterMethod(enum.Enum):
    """region_segmentation_config.proto:23-29."""
    NEAREST_NEIGHBOR_DEFAULT = 0
    MEAN_SHIFT = 1


@dataclasses.dataclass(frozen=True)
class ComputeNormalsParams:
    """algorithms.h:313-322."""
    min_neighbor_distance: float = 0.1    # meters
    max_neighbor_distance: float = 1.0    # meters
    include_diagonal_neighbors: bool = True
    min_num_support_neighbors: int = 4

    # TPU-only: static bound on the variable-radius directional walk
    # (algorithms.h:136-199 walks until the grid edge; a bounded scan of
    # max_scan_steps covers the reference's reach on real sensor data).
    # The worst-case reach is ~f * min_neighbor_distance / min_range: at
    # VGA-class focal lengths with a 1 m closest return, ~56 steps. 64
    # gives EXACT normal agreement with the unbounded oracle walk on the
    # 560x560 room scene (K=16 left 0.8% of pixels without supports and
    # 3.8% with degraded fits, all at the near floor); the extra steps are
    # nearly free on TPU (the scan is elementwise shift arithmetic).
    max_scan_steps: int = 64


@dataclasses.dataclass(frozen=True)
class PlanarRegionConfig:
    """region_segmentation_config.proto:42-72 with defaults from
    planar_region.h:93-121."""
    max_plane_distance: float = 0.05
    min_region_area: float = 0.05
    min_region_inliers: int = 5
    plane_model_reestimation_period: int = 30
    discontinuity_min_range: float = 1.2
    discontinuity_max_range: float = 4.0
    discontinuity_normal_angle_diff: float = 5.0   # degrees
    discontinuity_z_diff: float = 0.05             # meters
    discontinuity_z_ratio: float = 0.7
    # Temporal seed transfer (region_segmentation_config.proto:43-48); no
    # in-code defaults in the reference, so callers must set them to use
    # FindSeedPointsFromLastPlanarRegions.
    max_distance_for_seed_point: float = 0.0
    max_normal_difference_angle_for_seed_point: float = 0.0

    # TPU-only static bounds. 32 slots cover real frames by a wide margin
    # (room scenes produce <= ~10 planar regions; the overflow flag reports
    # exhaustion) and halve the batched grower's per-epoch HBM traffic —
    # measured 560x560 oracle agreement is unchanged vs 64 slots.
    max_regions: int = 32          # capacity of the per-frame region table
    max_growth_iters: int = 4096   # bound on BFS wavefronts per region

    # TPU-only growth strategy. "batched" (default) = all regions grown
    # concurrently with rank conflict resolution, statically unrolled
    # (models/planar_batched.py). "wavefront" = ring-by-ring BFS (closest to
    # the reference's queue cadence). "hybrid" = wavefront until
    # ``warmup_inliers`` then whole-component closure per plane re-fit via
    # pointer-jumping CCL — O(log diameter) passes instead of O(diameter);
    # after ~4 re-estimation periods the fitted plane is numerically
    # converged, so later per-30-inlier re-fits are no-ops and closure
    # growth matches the reference within the >=99% agreement budget.
    growth_mode: str = "batched"
    warmup_inliers: int = 120      # 4 * plane_model_reestimation_period
    max_growth_epochs: int = 8


@dataclasses.dataclass(frozen=True)
class ClusterRegionConfig:
    """region_segmentation_config.proto:22-39 with defaults from
    cluster_region.h:53-63."""
    min_region_inliers: int = 7
    squared_distance_threshold: float = 1.0
    half_search_window: int = 1
    cluster_method: ClusterMethod = ClusterMethod.NEAREST_NEIGHBOR_DEFAULT

    # TPU-only static bounds.
    max_regions: int = 128
    max_growth_iters: int = 4096

    # TPU-only CCL strategy: "scan" = statically-unrolled segmented-scan
    # min-propagation (no data-dependent loops; scan_rounds bounds the
    # rounds); "while" = fixed-point min-propagation + pointer jumping.
    ccl_mode: str = "scan"
    scan_rounds: int = 24


@dataclasses.dataclass(frozen=True)
class MeanShiftParams:
    """Hard-coded constants of the reference (mean_shift_segmentation.h:31-51)."""
    square_distance_threshold: float = 1.0
    half_search_window: int = 5
    intensity_ratio_threshold: float = 0.5
    squared_centroid_distance_threshold: float = 1.0
    squared_neighbor_distance_threshold: float = 0.04  # 0.2^2

    @property
    def min_support(self) -> float:
        # kIntensityRatioThreshold * kHalfSearchWindow^2 * 4
        # (mean_shift_segmentation.h:245-247)
        return (self.intensity_ratio_threshold
                * self.half_search_window * self.half_search_window * 4)


@dataclasses.dataclass(frozen=True)
class ClassifyHorizontalPlaneParams:
    """plane_classification_config.proto:23-36. proto2 optionals with no
    in-code defaults; zeros reject everything, so callers configure these."""
    max_up_direction_delta_angle_degrees: float = 0.0
    floor_offset: float = 0.0
    max_floor_offset_deviation: float = 0.0
    min_area: float = 0.0
    max_area: float = 0.0


@dataclasses.dataclass(frozen=True)
class ClassifyWallParams:
    """plane_classification_config.proto:40-46."""
    max_horizontal_delta_angle_degrees: float = 0.0
    min_height: float = 0.0


@dataclasses.dataclass(frozen=True)
class PlaneClassificationConfig:
    """plane_classification_config.proto:49-58."""
    floor_params: ClassifyHorizontalPlaneParams = ClassifyHorizontalPlaneParams()
    coffee_table_params: ClassifyHorizontalPlaneParams = ClassifyHorizontalPlaneParams()
    wall_params: ClassifyWallParams = ClassifyWallParams()


@dataclasses.dataclass(frozen=True)
class SeedsFromAverageNormalsParams:
    """Defaults of FindSeedPointsFromAverageNormals (segmentation.h:136-140)."""
    neighborhood_size: int = 5
    min_num_valid_normals: int = 8
    min_avg_normal_length: float = 0.9999


@dataclasses.dataclass(frozen=True)
class SeedsFromPlaneSupportParams:
    """Defaults of FindSeedPointsFromPlaneSupport (segmentation.h:190-194)."""
    neighborhood_size: int = 9
    max_plane_distance: float = 0.05
    min_num_support_points: int = 12
    # TPU-only: capacity of the returned ranked seed list.
    max_seeds: int = 8192


# Semantic class vocabulary (semantic_types.h:25-37).
SEMANTIC_UNKNOWN = "not sure"
SEMANTIC_EGO = "ego"
SEMANTIC_FLOOR = "floor"
SEMANTIC_WALL = "wall"
SEMANTIC_TABLE = "table"


class PlaneClass(enum.IntEnum):
    """planar_region.h:40."""
    UNKNOWN = 0
    FLOOR = 1
    WALL = 2
    TABLE = 3


PLANE_CLASS_NAMES = {
    PlaneClass.UNKNOWN: SEMANTIC_UNKNOWN,
    PlaneClass.FLOOR: SEMANTIC_FLOOR,
    PlaneClass.WALL: SEMANTIC_WALL,
    PlaneClass.TABLE: SEMANTIC_TABLE,
}


@dataclasses.dataclass(frozen=True)
class SegmenterConfig:
    """pcseg_tpu.models.pipeline.SegmenterConfig, field for field."""
    normals: ComputeNormalsParams = ComputeNormalsParams()
    seed_method: str = "plane_support"  # or "average_normals"
    plane_support_seeds: SeedsFromPlaneSupportParams = \
        SeedsFromPlaneSupportParams()
    average_normal_seeds: SeedsFromAverageNormalsParams = \
        SeedsFromAverageNormalsParams()
    planar: PlanarRegionConfig = PlanarRegionConfig()
    cluster: ClusterRegionConfig = ClusterRegionConfig()
    classification: PlaneClassificationConfig = PlaneClassificationConfig()
    up_direction: tuple = (0.0, 0.0, 1.0)
    known_floor_point: tuple = (0.0, 0.0, -1.0)
    run_clustering: bool = True
    max_region_attempts: int = 256
    mean_shift: MeanShiftParams = MeanShiftParams()
    mean_shift_iterations: int = 5


def _from_dict(cls, d):
    hints = typing.get_type_hints(cls)
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        t = hints[f.name]
        if dataclasses.is_dataclass(t):
            v = v if isinstance(v, t) else _from_dict(t, v)
        elif isinstance(t, type) and issubclass(t, enum.Enum):
            # enums travel by name (an enum of the other package, a name
            # string, or a value)
            v = t[v.name] if isinstance(v, enum.Enum) else \
                (t[v] if isinstance(v, str) else t(v))
        elif t is tuple:
            v = tuple(v)
        kwargs[f.name] = v
    return cls(**kwargs)


def config_from_dict(d) -> SegmenterConfig:
    """Build the port's :class:`SegmenterConfig` from a nested dict, e.g.
    ``dataclasses.asdict(jax_config)``. Enums are matched by name; missing
    keys keep their defaults."""
    return _from_dict(SegmenterConfig, d)
