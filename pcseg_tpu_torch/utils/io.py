"""MultichannelCloudProto <-> PointCloud conversion and the config schemas
(port of pcseg_tpu.utils.io, on the port's codec protos/pcseg_pb2.py).

The reference maps typed CloudViews directly onto the proto's
repeated-float fields (multichannel_cloud.cc:70-107, cloud_proto_utils.h),
so their storage order is the cloud's col-major linearization
(``value[(col*rows + row)*C + c]``); the channels are written and read in
that layout. Field numbers match the reference's (protos/pcseg.proto).
"""

from __future__ import annotations

import numpy as np
import torch

from pcseg_tpu_torch.models import config as _config
from pcseg_tpu_torch.ops import geom, plane_fit
from pcseg_tpu_torch.protos import pcseg_pb2
from pcseg_tpu_torch.utils import cloud as cloud_lib


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _flatten_cm(arr: np.ndarray) -> np.ndarray:
    """[H, W(, C)] -> flat col-major channel data."""
    if arr.ndim == 2:
        arr = arr[..., None]
    return np.swapaxes(arr, 0, 1).reshape(-1)


def _unflatten_cm(data, rows, cols, comps):
    arr = np.asarray(data, np.float32).reshape(cols, rows, comps)
    arr = np.swapaxes(arr, 0, 1)
    return arr[..., 0] if comps == 1 else arr


def cloud_to_proto(cloud: cloud_lib.PointCloud,
                   proto=None) -> pcseg_pb2.MultichannelCloudProto:
    if proto is None:
        proto = pcseg_pb2.MultichannelCloudProto()
    proto.height = cloud.rows
    proto.width = cloud.cols
    for name, field, _ in cloud_lib.CHANNELS:
        value = getattr(cloud, name)
        getattr(proto, field)[:] = []
        if value is not None:
            getattr(proto, field).extend(_flatten_cm(_numpy(value)))
    q = _numpy(cloud.pose.quat).astype(np.float64)
    t = _numpy(cloud.pose.trans).astype(np.float64)
    pose = proto.point_cloud_pose_sensor
    pose.translation.x, pose.translation.y, pose.translation.z = \
        t[0], t[1], t[2]
    pose.qw, pose.qx, pose.qy, pose.qz = q[0], q[1], q[2], q[3]
    return proto


def proto_to_cloud(proto: pcseg_pb2.MultichannelCloudProto,
                   device=None) -> cloud_lib.PointCloud:
    """The cloud of a proto, its channels as f32 tensors on ``device``."""
    rows, cols = proto.height, proto.width
    kwargs = {}
    for name, field, comps in cloud_lib.CHANNELS:
        data = getattr(proto, field)
        if len(data):
            expected = rows * cols * comps
            if len(data) != expected:
                raise ValueError(f"channel {field}: {len(data)} values, "
                                 f"expected {expected}")
            kwargs[name] = torch.from_numpy(
                np.ascontiguousarray(_unflatten_cm(data, rows, cols,
                                                   comps))).to(device)
    p = proto.point_cloud_pose_sensor
    pose = geom.Pose.from_arrays(
        [p.qw or 1.0, p.qx, p.qy, p.qz],
        [p.translation.x, p.translation.y, p.translation.z], device)
    return cloud_lib.PointCloud(pose=pose, **kwargs)


def plane_estimator_to_proto(m, proto=None) -> pcseg_pb2.PlaneEstimatorProto:
    """PlaneMoments -> PlaneEstimatorProto (plane_estimator.cc:231-245);
    the serializable accumulator is the reference's checkpoint/resume
    mechanism."""
    if proto is None:
        proto = pcseg_pb2.PlaneEstimatorProto()
    proto.covariance_accumulator[:] = _numpy(m.s2).astype(np.float32)
    proto.cumulative_centroid[:] = _numpy(m.s1).astype(np.float32)
    proto.cumulative_weights = float(_numpy(m.w))
    proto.normal[:] = _numpy(m.normal_hint).astype(np.float32)
    return proto


def plane_estimator_from_proto(proto, device=None) -> plane_fit.PlaneMoments:
    """PlaneEstimatorProto -> PlaneMoments (plane_estimator.cc:28-44)."""
    def t(x):
        return torch.tensor(np.asarray(x, np.float32), device=device)
    return plane_fit.PlaneMoments(
        s2=t(list(proto.covariance_accumulator)),
        s1=t(list(proto.cumulative_centroid)),
        w=t(proto.cumulative_weights), normal_hint=t(list(proto.normal)))


# ---------------------------------------------------------------------------
# Config schemas (region_segmentation_config.proto:22-72,
# plane_classification_config.proto:23-58). Unset fields take the
# reference's in-code defaults, as ApplyDefaultConfigValues does
# (planar_region.h:93-121, cluster_region.h:53-63).
# ---------------------------------------------------------------------------

_PLANAR_FIELDS = (
    "max_distance_for_seed_point",
    "max_normal_difference_angle_for_seed_point",
    "max_plane_distance", "min_region_area", "min_region_inliers",
    "plane_model_reestimation_period", "discontinuity_min_range",
    "discontinuity_max_range", "discontinuity_normal_angle_diff",
    "discontinuity_z_diff", "discontinuity_z_ratio")

_CLUSTER_FIELDS = ("min_region_inliers", "squared_distance_threshold",
                   "half_search_window")

_HORIZ_FIELDS = ("max_up_direction_delta_angle_degrees", "floor_offset",
                 "max_floor_offset_deviation", "min_area", "max_area")
_WALL_FIELDS = ("max_horizontal_delta_angle_degrees", "min_height")


def planar_config_to_proto(cfg, proto=None):
    if proto is None:
        proto = pcseg_pb2.PlanarRegionConfigProto()
    for f in _PLANAR_FIELDS:
        setattr(proto, f, getattr(cfg, f))
    return proto


def planar_config_from_proto(proto) -> _config.PlanarRegionConfig:
    """Unset fields keep the defaults (planar_region.h:93-121)."""
    return _config.PlanarRegionConfig(**{
        f: getattr(proto, f) for f in _PLANAR_FIELDS if proto.HasField(f)})


def cluster_config_to_proto(cfg, proto=None):
    if proto is None:
        proto = pcseg_pb2.ClusterRegionConfigProto()
    for f in _CLUSTER_FIELDS:
        setattr(proto, f, getattr(cfg, f))
    proto.cluster_method = cfg.cluster_method.value
    return proto


def cluster_config_from_proto(proto) -> _config.ClusterRegionConfig:
    """Defaults of cluster_region.h:53-63 on unset fields."""
    kwargs = {f: getattr(proto, f) for f in _CLUSTER_FIELDS
              if proto.HasField(f)}
    if proto.HasField("cluster_method"):
        kwargs["cluster_method"] = _config.ClusterMethod(proto.cluster_method)
    return _config.ClusterRegionConfig(**kwargs)


def classification_config_to_proto(cfg, proto=None):
    if proto is None:
        proto = pcseg_pb2.PlaneClassificationConfigProto()
    for f in _HORIZ_FIELDS:
        setattr(proto.floor_params, f, getattr(cfg.floor_params, f))
        setattr(proto.coffee_table_params, f,
                getattr(cfg.coffee_table_params, f))
    for f in _WALL_FIELDS:
        setattr(proto.wall_params, f, getattr(cfg.wall_params, f))
    return proto


def classification_config_from_proto(proto):
    """plane_classification_config.proto has no in-code defaults; unset
    fields stay zero like the reference's direct field reads
    (plane_classification.cc:34-93)."""
    def sub(msg, fields, cls):
        return cls(**{f: getattr(msg, f) for f in fields if msg.HasField(f)})
    return _config.PlaneClassificationConfig(
        floor_params=sub(proto.floor_params, _HORIZ_FIELDS,
                         _config.ClassifyHorizontalPlaneParams),
        coffee_table_params=sub(proto.coffee_table_params, _HORIZ_FIELDS,
                                _config.ClassifyHorizontalPlaneParams),
        wall_params=sub(proto.wall_params, _WALL_FIELDS,
                        _config.ClassifyWallParams))
