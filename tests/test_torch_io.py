"""The port's proto codec (pcseg_tpu_torch/protos/pcseg_pb2.py), cloud and
config conversions (utils/io.py) and detected-object protos
(models/extract.py) against protobuf and the JAX package on the CPU.

tests/test_io.py's checks run on the port; every one of the 14 messages is
built with the same values through both APIs and the port's bytes must
equal protobuf's (unset optional fields, empty repeated fields, NaN, -0.0
and negative values, both oneof arms); each side parses the other's bytes
back to the same message. No module of the port imports google.protobuf.
"""

import ast
import dataclasses
import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pcseg_tpu.models import extract as jextract
from pcseg_tpu.ops import geom as jgeom
from pcseg_tpu.protos import pcseg_pb2 as jpb
from pcseg_tpu.utils import cloud as jcloud
from pcseg_tpu.utils import io as jio

from pcseg_tpu_torch.models import extract
from pcseg_tpu_torch.models.config import (
    ClassifyHorizontalPlaneParams, ClassifyWallParams, ClusterMethod,
    ClusterRegionConfig, PlanarRegionConfig, PlaneClassificationConfig)
from pcseg_tpu_torch.ops import geom, plane_fit
from pcseg_tpu_torch.protos import pcseg_pb2
from pcseg_tpu_torch.utils import cloud as cloud_lib
from pcseg_tpu_torch.utils import io

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAN = float("nan")


def make_cloud(h=6, w=8, seed=0):
    """tests/test_io.py's cloud, as the port's PointCloud."""
    rng = np.random.default_rng(seed)
    quat = rng.normal(size=4).astype(np.float32)
    return cloud_lib.PointCloud(
        points=torch.from_numpy(rng.normal(size=(h, w, 3)).astype(np.float32)),
        normals=torch.from_numpy(rng.normal(size=(h, w, 3))
                                 .astype(np.float32)),
        intensities=torch.from_numpy(rng.random((h, w)).astype(np.float32)),
        colors=torch.from_numpy(rng.random((h, w, 3)).astype(np.float32)),
        pose=geom.Pose(geom.quat_normalize(torch.from_numpy(quat)),
                       torch.from_numpy(rng.normal(size=3)
                                        .astype(np.float32))))


# -- tests/test_io.py on the port ---------------------------------------------

def test_wire_round_trip():
    c = make_cloud()
    data = io.cloud_to_proto(c).SerializeToString()
    back_proto = pcseg_pb2.MultichannelCloudProto()
    back_proto.ParseFromString(data)
    back = io.proto_to_cloud(back_proto)
    for name in ("points", "normals", "intensities", "colors"):
        np.testing.assert_allclose(getattr(back, name).numpy(),
                                   getattr(c, name).numpy(), atol=1e-6)
    np.testing.assert_allclose(back.pose.quat.numpy(), c.pose.quat.numpy(),
                               atol=1e-6)
    assert back.sensor_origins is None


def test_colmajor_linearization():
    """value[(col*rows + row)*3 + k], the reference's CloudView mapping."""
    c = make_cloud(3, 4)
    proto = io.cloud_to_proto(c)
    pts = c.points.numpy()
    for col in range(4):
        for row in range(3):
            lin = col * 3 + row
            np.testing.assert_allclose(proto.points_xyz[lin * 3:lin * 3 + 3],
                                       pts[row, col], atol=1e-6)


def test_nan_invalid_points_survive():
    c = make_cloud()
    c.points[2, 3] = NAN
    c = cloud_lib.PointCloud(points=c.points, pose=c.pose)
    back = io.proto_to_cloud(io.cloud_to_proto(c))
    assert torch.isnan(back.points[2, 3]).all()


def test_planar_config_roundtrip_and_defaults():
    cfg = dataclasses.replace(PlanarRegionConfig(), max_plane_distance=0.08,
                              min_region_inliers=9)
    rt = io.planar_config_from_proto(io.planar_config_to_proto(cfg))
    for f in io._PLANAR_FIELDS:
        assert np.float32(getattr(rt, f)) == np.float32(getattr(cfg, f)), f
    assert io.planar_config_from_proto(
        pcseg_pb2.PlanarRegionConfigProto()) == PlanarRegionConfig()
    p = pcseg_pb2.PlanarRegionConfigProto()
    p.max_plane_distance = 0.2
    got = io.planar_config_from_proto(p)
    assert got.max_plane_distance == np.float32(0.2)
    assert (got.min_region_inliers, got.plane_model_reestimation_period) \
        == (5, 30)


def test_cluster_config_roundtrip_and_method():
    cfg = dataclasses.replace(ClusterRegionConfig(),
                              cluster_method=ClusterMethod.MEAN_SHIFT,
                              half_search_window=2)
    rt = io.cluster_config_from_proto(io.cluster_config_to_proto(cfg))
    assert rt.cluster_method is ClusterMethod.MEAN_SHIFT
    assert rt.half_search_window == 2
    empty = io.cluster_config_from_proto(pcseg_pb2.ClusterRegionConfigProto())
    assert empty == ClusterRegionConfig()


def test_classification_config_roundtrip():
    cfg = PlaneClassificationConfig(
        floor_params=ClassifyHorizontalPlaneParams(
            max_up_direction_delta_angle_degrees=10.0, floor_offset=-1.0,
            max_floor_offset_deviation=0.1, min_area=0.3, max_area=100.0),
        wall_params=ClassifyWallParams(
            max_horizontal_delta_angle_degrees=10.0, min_height=0.5))
    rt = io.classification_config_from_proto(
        io.classification_config_to_proto(cfg))
    assert io.classification_config_from_proto(
        io.classification_config_to_proto(rt)) == rt
    assert np.float32(rt.floor_params.min_area) == np.float32(0.3)
    assert rt.wall_params.min_height == 0.5


def test_plane_estimator_roundtrip():
    m = plane_fit.PlaneMoments(
        s2=torch.arange(6, dtype=torch.float32), s1=torch.tensor([1., -2, 3]),
        w=torch.tensor(7.0), normal_hint=torch.tensor([0., 0, -1]))
    back = io.plane_estimator_from_proto(pcseg_pb2.PlaneEstimatorProto
                                         .FromString(io.plane_estimator_to_proto(
                                             m).SerializeToString()))
    for f in plane_fit.PlaneMoments._fields:
        assert torch.equal(getattr(back, f), getattr(m, f)), f


# -- byte equality with protobuf on every message -------------------------------

def _vector(pb):
    v = pb.Vector3dProto()
    v.x, v.y, v.z = -1.5, NAN, -0.0
    return v


def _pose(pb):
    p = pb.Pose3dProto()
    p.translation.x = 0.0     # a submessage set to its default is present
    p.qw, p.qx, p.qy, p.qz = 0.5, -0.5, 0.0, 1e-300
    return p


def _cloud(pb):
    c = pb.MultichannelCloudProto()
    c.height, c.width = 2, -3
    c.points_xyz.extend([1.0, NAN, -2.5, 0.1, -0.0, 3e38])
    c.intensities[:] = []                  # an empty repeated field
    c.normals_xyz.extend(np.float32([0.3, -0.7]))
    c.point_cloud_pose_sensor.qw = 1.0
    return c


def _estimator(pb):
    e = pb.PlaneEstimatorProto()
    e.covariance_accumulator[:] = [1.0, -2.0, NAN, 4.0, 5.0, 6.0]
    e.cumulative_weights = -7.25
    return e


def _plane(pb):
    p = pb.Plane3dProto()
    p.x, p.nz, p.ny = 0.25, -1.0, NAN
    return p


def _planar_geometry(pb):
    g = pb.PlanarGeometryProto()
    g.points_xyz.extend([0.5, -1.0, NAN])
    g.centroid.y = -3.0
    g.discontinuous_boundary_indices.extend([0, -1, 300, 2 ** 31 - 1,
                                             -2 ** 31])
    return g


def _cluster_geometry(pb):
    g = pb.ClusterGeometryProto()
    g.points_xyz.extend([])
    return g


def _object_planar(pb):
    o = pb.DetectedObjectProto()
    o.object_class = "floor"
    o.planar_geometry.plane.nx = 1.0
    return o


def _object_cluster(pb):
    o = pb.DetectedObjectProto()
    o.planar_geometry.points_xyz.extend([1.0])
    o.cluster_geometry.points_xyz.extend([])  # clears the planar arm
    return o


def _objects(pb):
    s = pb.DetectedObjectsProto()
    s.detected_objects.add()
    o = s.detected_objects.add()
    o.object_class = "not sure é"
    o.cluster_geometry.points_xyz.extend([2.0, -2.0])
    return s


def _cluster_config(pb):
    c = pb.ClusterRegionConfigProto()
    c.min_region_inliers = 0           # optional at its default: written
    c.half_search_window = -4
    c.cluster_method = pb.ClusterRegionConfigProto.MEAN_SHIFT
    return c


def _planar_config(pb):
    c = pb.PlanarRegionConfigProto()
    c.max_distance_for_seed_point = 0.0
    c.discontinuity_z_ratio = -0.7
    c.min_region_inliers = 12
    return c


def _horizontal(pb):
    p = pb.ClassifyHorizontalPlaneParams()
    p.floor_offset, p.max_area = -1.0, NAN
    return p


def _wall(pb):
    p = pb.ClassifyWallParams()
    p.min_height = 0.5
    return p


def _classification(pb):
    c = pb.PlaneClassificationConfigProto()
    c.floor_params.min_area = 0.0
    c.wall_params.ClearField("min_height")   # touched, still absent
    return c


MESSAGES = {f.__name__[1:]: f for f in (
    _vector, _pose, _cloud, _estimator, _plane, _planar_geometry,
    _cluster_geometry, _object_planar, _object_cluster, _objects,
    _cluster_config, _planar_config, _horizontal, _wall, _classification)}
EMPTY = ["Vector3dProto", "Pose3dProto", "MultichannelCloudProto",
         "PlaneEstimatorProto", "Plane3dProto", "PlanarGeometryProto",
         "ClusterGeometryProto", "DetectedObjectProto",
         "DetectedObjectsProto", "ClusterRegionConfigProto",
         "PlanarRegionConfigProto", "ClassifyHorizontalPlaneParams",
         "ClassifyWallParams", "PlaneClassificationConfigProto"]


@pytest.mark.parametrize("name", list(MESSAGES))
def test_bytes_equal_protobuf(name):
    build = MESSAGES[name]
    want = build(jpb).SerializeToString()
    got = build(pcseg_pb2).SerializeToString()
    assert got == want
    # each side parses the other's bytes back to the same message
    cls = type(build(pcseg_pb2))
    assert cls.FromString(want).SerializeToString() == want
    assert type(build(jpb)).FromString(got).SerializeToString() == got


@pytest.mark.parametrize("name", EMPTY)
def test_unset_message_is_empty(name):
    assert getattr(pcseg_pb2, name)().SerializeToString() == b"" == \
        getattr(jpb, name)().SerializeToString()


def test_presence_and_oneof_agree_with_protobuf():
    for pb in (jpb, pcseg_pb2):
        o = _object_cluster(pb)
        assert o.WhichOneof("geometry") == "cluster_geometry"
        assert o.HasField("cluster_geometry")
        assert not o.HasField("planar_geometry")
        assert not pb.DetectedObjectProto().HasField("geometry")
        c = _classification(pb)
        assert c.HasField("floor_params") and c.HasField("wall_params")
        assert not c.HasField("coffee_table_params")
        assert c.floor_params.HasField("min_area")
        assert not c.floor_params.HasField("max_area")
        with pytest.raises(ValueError):
            pb.Vector3dProto().HasField("x")
        with pytest.raises(ValueError):
            pb.MultichannelCloudProto().width = 2 ** 31
        assert pb.PlanarRegionConfigProto(max_plane_distance=0.2) \
            .max_plane_distance == float(np.float32(0.2))
    assert pcseg_pb2.ClusterRegionConfigProto.ClusterMethod.Name(1) \
        == "MEAN_SHIFT"


def test_parsed_values_equal_protobuf():
    """Parsing gives the same field values as protobuf's parser (NaN as
    NaN, packed negatives, the f32 rounding of float fields)."""
    data = _cloud(jpb).SerializeToString()
    got = pcseg_pb2.MultichannelCloudProto.FromString(data)
    want = jpb.MultichannelCloudProto.FromString(data)
    np.testing.assert_array_equal(np.asarray(got.points_xyz),
                                  np.asarray(want.points_xyz))
    assert (got.height, got.width) == (want.height, want.width)
    g = pcseg_pb2.PlanarGeometryProto.FromString(
        _planar_geometry(jpb).SerializeToString())
    assert list(g.discontinuous_boundary_indices) == \
        [0, -1, 300, 2 ** 31 - 1, -2 ** 31]


# -- the conversions against the JAX package's -------------------------------

def test_cloud_proto_bytes_equal_jax():
    c = make_cloud(5, 7, seed=3)
    c.points[1, 2] = NAN
    jc = jcloud.PointCloud(
        points=jnp.asarray(c.points.numpy()),
        normals=jnp.asarray(c.normals.numpy()),
        intensities=jnp.asarray(c.intensities.numpy()),
        colors=jnp.asarray(c.colors.numpy()),
        pose=jgeom.Pose(jnp.asarray(c.pose.quat.numpy()),
                        jnp.asarray(c.pose.trans.numpy())))
    want = jio.cloud_to_proto(jc).SerializeToString()
    assert io.cloud_to_proto(c).SerializeToString() == want
    back = io.proto_to_cloud(pcseg_pb2.MultichannelCloudProto.FromString(
        want))
    jback = jio.proto_to_cloud(jpb.MultichannelCloudProto.FromString(want))
    np.testing.assert_array_equal(back.points.numpy(),
                                  np.asarray(jback.points))
    np.testing.assert_array_equal(back.pose.trans.numpy(),
                                  np.asarray(jback.pose.trans))


def _objects_list(mod):
    rng = np.random.default_rng(4)
    plane = np.float32([0.0, 0.6, 0.8, -1.25])
    return [
        mod.DetectedObject(object_class="floor",
                           points=rng.normal(size=(9, 3)).astype(np.float32),
                           centroid=np.float32([0.1, -0.2, 0.3]),
                           plane=plane,
                           discontinuous_boundary_positions=np.int32([0, 4])),
        mod.DetectedObject(object_class="not sure",
                           points=rng.normal(size=(4, 3)).astype(np.float32)),
        mod.DetectedObject(object_class="wall",
                           points=np.zeros((0, 3), np.float32),
                           centroid=np.float32([NAN, 0, 0]), plane=plane),
    ]


def test_detected_objects_proto_bytes_equal_jax():
    want = jextract.detected_objects_proto(_objects_list(jextract)) \
        .SerializeToString()
    assert extract.detected_objects_proto(_objects_list(extract)) \
        .SerializeToString() == want
    assert extract.to_proto(_objects_list(extract)[1]).SerializeToString() \
        == jextract.to_proto(_objects_list(jextract)[1]).SerializeToString()


def test_plane_proto_round_trip_matches_jax():
    plane = np.float32([0.0, 0.6, -0.8, 2.5])
    p, jp = pcseg_pb2.Plane3dProto(), jpb.Plane3dProto()
    extract.plane_to_proto(plane, p)
    jextract.plane_to_proto(plane, jp)
    assert p.SerializeToString() == jp.SerializeToString()
    np.testing.assert_array_equal(extract.plane_from_proto(p),
                                  jextract.plane_from_proto(jp))
    np.testing.assert_allclose(extract.plane_from_proto(p), plane, atol=1e-6)
    with pytest.raises(ValueError):
        extract.plane_from_proto(pcseg_pb2.Plane3dProto())
    assert math.isclose(p.z, -plane[2] * plane[3], rel_tol=1e-7)


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_protobuf_jax_or_jax_package():
    """No module of pcseg_tpu_torch (nor chip_smoke.py) imports
    google.protobuf, jax or pcseg_tpu; importing the proto modules loads
    no google package."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "pcseg_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    bad = [(f, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("google", "jax", "jaxlib")
           or m.split(".")[0] == "pcseg_tpu"]
    assert not bad, bad
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys; import pcseg_tpu_torch.utils.io, "
         "pcseg_tpu_torch.models.extract; "
         "print(sorted(m for m in sys.modules if m.startswith("
         "('google.protobuf', 'jax', 'pcseg_tpu.'))))"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
