"""The messages of ``pcseg.proto`` (beside this file, the schema of record)
with a small proto3 wire codec, without ``google.protobuf``.

The classes expose the part of protobuf's Python API that the port uses:
attribute access with lazily created submessages, repeated fields with
``extend``/``append``/``add``/slice assignment, ``HasField``,
``WhichOneof``, ``ClearField``, ``SerializeToString``, ``ParseFromString``
and ``FromString``. Presence follows proto3: a submessage or an
``optional`` field is present once set (setting a field of a submessage,
even to its default, or touching one of its repeated fields, makes the
submessage present), one arm of a oneof clears the others, and plain
scalars are written only when they differ from their default (bitwise
for floats, so -0.0 and NaN are written). Fields go out in field-number
order, repeated scalars packed, so the bytes equal protobuf's for the same
values (tests/test_torch_io.py). ``float`` fields hold the value rounded
to f32, as protobuf does. Unknown fields are skipped when parsing.
"""

from __future__ import annotations

import struct
from typing import NamedTuple, Optional

import numpy as np

# wire types
_VARINT, _I64, _LEN, _I32 = 0, 1, 2, 5


class _Field(NamedTuple):
    name: str
    number: int
    kind: str                 # double float int32 enum string message
    repeated: bool = False
    message: Optional[str] = None
    optional: bool = False    # proto3 ``optional``: has presence
    oneof: Optional[str] = None


def _varint(v: int) -> bytes:
    v &= (1 << 64) - 1
    out = bytearray()
    while v >= 0x80:
        out.append((v & 0x7F) | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _varints(vals) -> bytes:
    """Packed varints of int64 values (negative ones as 10 bytes)."""
    v = np.asarray(vals, np.int64).view(np.uint64)
    if v.size == 0:
        return b""
    n = np.ones(v.shape, np.int64)
    for k in range(1, 10):
        n += v >= np.uint64(1 << (7 * k))
    cols = np.arange(10)
    grid = ((v[:, None] >> (7 * cols).astype(np.uint64)) & np.uint64(0x7F)) \
        .astype(np.uint8)
    grid |= np.where(cols[None] < n[:, None] - 1, 0x80, 0).astype(np.uint8)
    return grid[cols[None] < n[:, None]].tobytes()


def _read_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if b < 0x80:
            return result, pos
        shift += 7


def _read_varints(buf) -> np.ndarray:
    """int64 values of a packed varint payload."""
    a = np.frombuffer(buf, np.uint8)
    if a.size == 0:
        return np.zeros(0, np.int64)
    ends = np.flatnonzero(a < 0x80)
    starts = np.concatenate([[0], ends[:-1] + 1])
    group = np.repeat(np.arange(ends.size), ends - starts + 1)
    pos = np.arange(a.size) - starts[group]
    vals = (a & 0x7F).astype(np.uint64) << (7 * pos).astype(np.uint64)
    return np.add.reduceat(vals, starts).view(np.int64)


def _int32(v: int) -> int:
    """The int32 a varint decodes to (sign-extended or truncated)."""
    v &= 0xFFFFFFFF
    return v - (1 << 32) if v >= 1 << 31 else v


def _check_int32(v):
    if isinstance(v, (float, np.floating)):
        raise TypeError(f"an int32 field takes integers, got {v!r}")
    v = int(v)
    if not -(1 << 31) <= v < 1 << 31:
        raise ValueError(f"Value out of range: {v}")
    return v


def _convert(field: _Field, v):
    if field.kind == "float":
        return float(np.float32(v))
    if field.kind == "double":
        return float(v)
    if field.kind in ("int32", "enum"):
        return _check_int32(v)
    if field.kind == "string":
        if not isinstance(v, str):
            raise TypeError(f"a string field takes str, got {v!r}")
        return v
    raise TypeError(f"field {field.name} is not a scalar")


def _convert_many(field: _Field, values) -> list:
    """Python values of an iterable (a NumPy array converts at once)."""
    if not isinstance(values, np.ndarray):
        values = list(values)
    if len(values) == 0:
        return []
    if field.kind == "float":
        return np.asarray(values, np.float32).astype(np.float64).tolist()
    if field.kind == "double":
        return np.asarray(values, np.float64).tolist()
    if field.kind in ("int32", "enum") and isinstance(values, np.ndarray):
        if values.dtype.kind not in "iub":
            raise TypeError(f"an int32 field takes integers, got "
                            f"{values.dtype}")
        if values.size and (values.min() < -(1 << 31)
                            or values.max() >= 1 << 31):
            raise ValueError("Value out of range for int32")
        return values.astype(np.int64).tolist()
    return [_convert(field, v) for v in values]


_DEFAULTS = {"double": 0.0, "float": 0.0, "int32": 0, "enum": 0,
             "string": ""}


class _Repeated:
    """A repeated field of a message: a list that converts what it is
    given and makes its message present when modified."""

    def __init__(self, owner: "Message", field: _Field):
        self._owner = owner
        self._field = field
        self._items = []

    def _touched(self):
        self._owner._touch()

    def __len__(self):
        return len(self._items)

    def __iter__(self):
        return iter(self._items)

    def __getitem__(self, i):
        return self._items[i]

    def __eq__(self, other):
        return list(self) == list(other)

    def __repr__(self):
        return repr(self._items)

    def __setitem__(self, i, value):
        if self._field.kind == "message":
            raise TypeError("assign to the elements' fields instead")
        if isinstance(i, slice):
            self._items[i] = _convert_many(self._field, value)
        else:
            self._items[i] = _convert(self._field, value)
        self._touched()

    def __delitem__(self, i):
        del self._items[i]
        self._touched()

    def append(self, value):
        self.extend([value])

    def extend(self, values):
        if self._field.kind == "message":
            raise TypeError("use add() on a repeated message field")
        self._items.extend(_convert_many(self._field, values))
        self._touched()

    def add(self, **kwargs):
        if self._field.kind != "message":
            raise TypeError("add() is for repeated message fields")
        msg = _CLASSES[self._field.message](**kwargs)
        object.__setattr__(msg, "_parent", (self._owner, None))
        self._items.append(msg)
        self._touched()
        return msg


class Message:
    """Base of the message classes: ``_FIELDS`` lists the fields."""

    _FIELDS: tuple = ()

    def __init__(self, **kwargs):
        object.__setattr__(self, "_values", {})
        object.__setattr__(self, "_present", set())
        object.__setattr__(self, "_parent", None)
        for k, v in kwargs.items():
            f = self._field(k)
            if f.repeated:
                if f.kind == "message":
                    for item in v:
                        getattr(self, k).add().CopyFrom(item)
                else:
                    getattr(self, k).extend(v)
            elif f.kind == "message":
                getattr(self, k).CopyFrom(v)
            else:
                setattr(self, k, v)

    @classmethod
    def _field(cls, name) -> _Field:
        f = cls._BY_NAME.get(name)
        if f is None:
            raise AttributeError(f"{cls.__name__} has no field {name!r}")
        return f

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        f = self._field(name)
        vals = self._values
        if name not in vals:
            if f.repeated:
                vals[name] = _Repeated(self, f)
            elif f.kind == "message":
                child = _CLASSES[f.message]()
                object.__setattr__(child, "_parent", (self, f))
                vals[name] = child
            else:
                return _DEFAULTS[f.kind]
        return vals[name]

    def __setattr__(self, name, value):
        f = self._field(name)
        if f.repeated or f.kind == "message":
            raise AttributeError(f"assignment not allowed to field {name!r} "
                                 f"of {type(self).__name__}")
        self._values[name] = _convert(f, value)
        self._mark(f)

    def _mark(self, f: _Field):
        """``f`` was set: it is present, the other arms of its oneof are
        cleared, and this message is present in its parent."""
        self._present.add(f.name)
        if f.oneof:
            for other in self._ONEOFS[f.oneof]:
                if other != f.name:
                    self._values.pop(other, None)
                    self._present.discard(other)
        self._touch()

    def _touch(self):
        if self._parent is not None:
            parent, pf = self._parent
            if pf is None:
                parent._touch()
            else:
                parent._values[pf.name] = self
                parent._mark(pf)

    # -- the protobuf API ---------------------------------------------------

    def HasField(self, name) -> bool:
        if name in self._ONEOFS:
            return self.WhichOneof(name) is not None
        f = self._field(name)
        if f.repeated or not (f.kind == "message" or f.optional or f.oneof):
            raise ValueError(f"Field {name} does not have presence.")
        return name in self._present

    def WhichOneof(self, oneof) -> Optional[str]:
        if oneof not in self._ONEOFS:
            raise ValueError(f"{type(self).__name__} has no oneof {oneof!r}")
        return next((n for n in self._ONEOFS[oneof] if n in self._present),
                    None)

    def ClearField(self, name):
        self._field(name)
        self._values.pop(name, None)
        self._present.discard(name)
        self._touch()  # a mutation: this submessage is present, as in protobuf

    def Clear(self):
        self._values.clear()
        self._present.clear()
        self._touch()

    def CopyFrom(self, other: "Message"):
        if type(other) is not type(self):
            raise TypeError(f"cannot copy {type(other).__name__} into "
                            f"{type(self).__name__}")
        self.Clear()
        self.MergeFromString(other.SerializeToString())
        self._touch()

    def __eq__(self, other):
        return type(other) is type(self) and \
            self.SerializeToString() == other.SerializeToString()

    def __repr__(self):
        parts = [f"{f.name}={self._values[f.name]!r}" for f in self._FIELDS
                 if f.name in self._values]
        return f"{type(self).__name__}({', '.join(parts)})"

    def SerializeToString(self) -> bytes:
        out = bytearray()
        for f in self._FIELDS:
            v = self._values.get(f.name)
            if f.repeated:
                if not v:
                    continue
                if f.kind == "message":
                    for item in v:
                        body = item.SerializeToString()
                        out += _varint(f.number << 3 | _LEN)
                        out += _varint(len(body)) + body
                    continue
                if f.kind == "string":
                    for s in v:
                        body = s.encode()
                        out += _varint(f.number << 3 | _LEN)
                        out += _varint(len(body)) + body
                    continue
                if f.kind == "float":
                    body = np.asarray(v._items, "<f4").tobytes()
                elif f.kind == "double":
                    body = np.asarray(v._items, "<f8").tobytes()
                else:
                    body = _varints(v._items)
                out += _varint(f.number << 3 | _LEN)
                out += _varint(len(body)) + body
                continue
            present = f.name in self._present
            if f.kind == "message":
                if present:
                    body = v.SerializeToString()
                    out += _varint(f.number << 3 | _LEN)
                    out += _varint(len(body)) + body
                continue
            if v is None:
                continue
            if f.kind == "double":
                body = struct.pack("<d", v)
                wire = _I64
            elif f.kind == "float":
                body = struct.pack("<f", v)
                wire = _I32
            elif f.kind == "string":
                enc = v.encode()
                body = _varint(len(enc)) + enc
                wire = _LEN
            else:
                body = _varint(v)
                wire = _VARINT
            has_presence = f.optional or f.oneof is not None
            if (has_presence and present) or (not has_presence and (
                    body.strip(b"\0") if f.kind in ("double", "float")
                    else v)):
                out += _varint(f.number << 3 | wire) + body
        return bytes(out)

    def MergeFromString(self, data) -> int:
        buf = memoryview(bytes(data))
        pos, end = 0, len(buf)
        while pos < end:
            key, pos = _read_varint(buf, pos)
            number, wire = key >> 3, key & 7
            f = self._BY_NUMBER.get(number)
            if wire == _VARINT:
                raw, pos = _read_varint(buf, pos)
                payload = None
            elif wire == _I64:
                payload, pos = buf[pos:pos + 8], pos + 8
            elif wire == _I32:
                payload, pos = buf[pos:pos + 4], pos + 4
            elif wire == _LEN:
                n, pos = _read_varint(buf, pos)
                payload, pos = buf[pos:pos + n], pos + n
            else:
                raise ValueError(f"unsupported wire type {wire}")
            if f is None:
                continue  # unknown field
            if f.kind == "message":
                if f.repeated:
                    getattr(self, f.name).add().MergeFromString(payload)
                else:
                    getattr(self, f.name).MergeFromString(payload)
                    self._values[f.name] = getattr(self, f.name)
                    self._mark(f)
                continue
            if f.kind == "string":
                val = bytes(payload).decode()
                vals = [val]
            elif f.kind == "double":
                vals = np.frombuffer(payload, "<f8").tolist()
            elif f.kind == "float":
                vals = np.frombuffer(payload, "<f4").astype(
                    np.float64).tolist()
            elif wire == _LEN:  # packed varints
                vals = [_int32(int(v)) for v in _read_varints(payload)]
            else:
                vals = [_int32(raw)]
            if f.repeated:
                getattr(self, f.name)._items.extend(vals)
            else:
                self._values[f.name] = vals[-1]
                self._present.add(f.name)
                if f.oneof:
                    self._mark(f)
        return end

    def ParseFromString(self, data) -> int:
        self.Clear()
        return self.MergeFromString(data)

    @classmethod
    def FromString(cls, data):
        msg = cls()
        msg.MergeFromString(data)
        return msg


_CLASSES = {}


def _message(name, fields, enums=()):
    """A Message subclass for ``fields`` (declaration order kept for
    reading; written in field-number order)."""
    fields = tuple(sorted(fields, key=lambda f: f.number))
    oneofs = {}
    for f in fields:
        if f.oneof:
            oneofs.setdefault(f.oneof, []).append(f.name)
    attrs = dict(_FIELDS=fields, _BY_NAME={f.name: f for f in fields},
                 _BY_NUMBER={f.number: f for f in fields}, _ONEOFS=oneofs)
    for enum in enums:
        attrs[enum.__name__] = enum
        for value_name, value in enum.values.items():
            attrs[value_name] = value
    cls = type(name, (Message,), attrs)
    _CLASSES[name] = cls
    return cls


class _Enum:
    """A proto enum: ``values`` by name, ``Name``/``Value`` lookups."""

    def __init__(self, name, values):
        self.__name__ = name
        self.values = dict(values)

    def Name(self, number):
        return next(k for k, v in self.values.items() if v == number)

    def Value(self, name):
        return self.values[name]

    def __getattr__(self, name):
        try:
            return self.values[name]
        except KeyError:
            raise AttributeError(name) from None


F = _Field


def _opt(name, number, kind, message=None):
    return F(name, number, kind, message=message, optional=True)


Vector3dProto = _message("Vector3dProto", [
    F("x", 1, "double"), F("y", 2, "double"), F("z", 3, "double")])

Pose3dProto = _message("Pose3dProto", [
    F("translation", 1, "message", message="Vector3dProto"),
    F("qx", 2, "double"), F("qy", 3, "double"), F("qz", 4, "double"),
    F("qw", 5, "double")])

MultichannelCloudProto = _message("MultichannelCloudProto", [
    F("point_cloud_pose_sensor", 12, "message", message="Pose3dProto"),
    F("width", 3, "int32"), F("height", 4, "int32"),
    F("points_xyz", 7, "float", True), F("normals_xyz", 8, "float", True),
    F("intensities", 9, "float", True), F("colors_rgb_f", 11, "float", True),
    F("sensor_origins", 13, "float", True),
    F("return_pulse_widths", 14, "float", True),
    F("return_intensities", 15, "float", True),
    F("return_ranges", 16, "float", True)])

PlaneEstimatorProto = _message("PlaneEstimatorProto", [
    F("covariance_accumulator", 1, "float", True),
    F("cumulative_centroid", 2, "float", True),
    F("cumulative_weights", 3, "float"), F("normal", 4, "float", True)])

Plane3dProto = _message("Plane3dProto", [
    F("x", 1, "double"), F("y", 2, "double"), F("z", 3, "double"),
    F("nx", 4, "double"), F("ny", 5, "double"), F("nz", 6, "double")])

PlanarGeometryProto = _message("PlanarGeometryProto", [
    F("points_xyz", 1, "float", True),
    F("centroid", 2, "message", message="Vector3dProto"),
    F("plane", 3, "message", message="Plane3dProto"),
    F("discontinuous_boundary_indices", 4, "int32", True)])

ClusterGeometryProto = _message("ClusterGeometryProto", [
    F("points_xyz", 1, "float", True)])

DetectedObjectProto = _message("DetectedObjectProto", [
    F("object_class", 1, "string"),
    F("planar_geometry", 2, "message", message="PlanarGeometryProto",
      oneof="geometry"),
    F("cluster_geometry", 3, "message", message="ClusterGeometryProto",
      oneof="geometry")])

DetectedObjectsProto = _message("DetectedObjectsProto", [
    F("detected_objects", 1, "message", True,
      message="DetectedObjectProto")])

ClusterRegionConfigProto = _message("ClusterRegionConfigProto", [
    _opt("min_region_inliers", 1, "int32"),
    _opt("squared_distance_threshold", 2, "float"),
    _opt("half_search_window", 3, "int32"),
    _opt("cluster_method", 4, "enum")],
    enums=[_Enum("ClusterMethod", {"NEAREST_NEIGHBOR_DEFAULT": 0,
                                   "MEAN_SHIFT": 1})])

PlanarRegionConfigProto = _message("PlanarRegionConfigProto", [
    _opt("max_distance_for_seed_point", 12, "float"),
    _opt("max_normal_difference_angle_for_seed_point", 11, "float"),
    _opt("max_plane_distance", 2, "float"),
    _opt("min_region_area", 3, "float"),
    _opt("min_region_inliers", 4, "int32"),
    _opt("plane_model_reestimation_period", 5, "int32"),
    _opt("discontinuity_min_range", 6, "float"),
    _opt("discontinuity_max_range", 7, "float"),
    _opt("discontinuity_normal_angle_diff", 8, "float"),
    _opt("discontinuity_z_diff", 9, "float"),
    _opt("discontinuity_z_ratio", 10, "float")])

ClassifyHorizontalPlaneParams = _message("ClassifyHorizontalPlaneParams", [
    _opt("max_up_direction_delta_angle_degrees", 1, "float"),
    _opt("floor_offset", 2, "float"),
    _opt("max_floor_offset_deviation", 3, "float"),
    _opt("min_area", 4, "float"), _opt("max_area", 5, "float")])

ClassifyWallParams = _message("ClassifyWallParams", [
    _opt("max_horizontal_delta_angle_degrees", 1, "float"),
    _opt("min_height", 2, "float")])

PlaneClassificationConfigProto = _message("PlaneClassificationConfigProto", [
    _opt("floor_params", 1, "message", "ClassifyHorizontalPlaneParams"),
    _opt("coffee_table_params", 2, "message",
         "ClassifyHorizontalPlaneParams"),
    _opt("wall_params", 3, "message", "ClassifyWallParams")])
