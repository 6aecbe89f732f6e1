"""Point-cloud data model on tensors (port of pcseg_tpu.utils.cloud).

Dense [H, W] grids replace the reference's Cloud/CloudBuffer/CloudView
(cloud.h:75-256) and its 8-channel MultichannelCloud (multichannel_cloud.h:
61-84, multichannel_cloud.cc:98-107). Every channel is a row-major
``[H, W, C]`` (or ``[H, W]``) tensor; the reference's grids are col-major
by default (cloud.h:31,38-41) and address cells by col-major linear
indices (``idx = col * rows + row``), which :func:`linearize_index` and
:func:`index_to_row_col` implement (cloud.h:37-63) and every API boundary
of the port keeps. Invalid points are NaN (multichannel_cloud.proto:30-31).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from pcseg_tpu_torch.ops import geom, nansafe

COL_MAJOR = 0  # cloud.h:31, the reference default
ROW_MAJOR = 1


def linearize_index(row, col, rows, cols, order=COL_MAJOR):
    """cloud.h:37-47."""
    if order == COL_MAJOR:
        return col * rows + row
    return row * cols + col


def index_to_row_col(index, rows, cols, order=COL_MAJOR):
    """cloud.h:51-63."""
    if order == COL_MAJOR:
        return index % rows, index // rows
    return index // cols, index % cols


def flatten_grid(grid, order=COL_MAJOR):
    """[H, W, ...] -> [H*W, ...] in the requested linear-index order."""
    if order == COL_MAJOR:
        grid = grid.transpose(0, 1)
    return grid.reshape((-1,) + tuple(grid.shape[2:]))


def unflatten_grid(flat, rows, cols, order=COL_MAJOR):
    """[H*W, ...] -> [H, W, ...] from the requested linear-index order."""
    if order == COL_MAJOR:
        return flat.reshape((cols, rows) + tuple(flat.shape[1:])) \
            .transpose(0, 1)
    return flat.reshape((rows, cols) + tuple(flat.shape[1:]))


# (python attr, proto field, components), multichannel_cloud.cc:98-107
CHANNELS = (
    ("points", "points_xyz", 3),
    ("normals", "normals_xyz", 3),
    ("intensities", "intensities", 1),
    ("colors", "colors_rgb_f", 3),
    ("sensor_origins", "sensor_origins", 3),
    ("return_pulse_widths", "return_pulse_widths", 3),
    ("return_intensities", "return_intensities", 3),
    ("return_ranges", "return_ranges", 3),
)


@dataclasses.dataclass
class PointCloud:
    """Organized (H > 1) or unorganized (H == 1) sensor cloud.

    Every channel but ``points`` is optional; each is [H, W, C] (or [H, W]
    for intensities). ``pose`` is point_cloud_pose_sensor, the sensor pose
    in the cloud's frame (multichannel_cloud.proto:34-36)."""
    points: torch.Tensor
    normals: Optional[torch.Tensor] = None
    intensities: Optional[torch.Tensor] = None
    colors: Optional[torch.Tensor] = None
    sensor_origins: Optional[torch.Tensor] = None
    return_pulse_widths: Optional[torch.Tensor] = None
    return_intensities: Optional[torch.Tensor] = None
    return_ranges: Optional[torch.Tensor] = None
    pose: geom.Pose = dataclasses.field(default_factory=geom.Pose)

    @property
    def rows(self) -> int:
        return self.points.shape[0]

    @property
    def cols(self) -> int:
        return self.points.shape[1]

    @property
    def size(self) -> int:
        return self.rows * self.cols

    @property
    def organized(self) -> bool:
        return self.rows > 1

    def valid_mask(self) -> torch.Tensor:
        """[H, W] bool: the point is finite (all 3 components)."""
        return nansafe.all_finite(self.points)

    def transform(self, pose: geom.Pose) -> "PointCloud":
        """Rotate and translate the points, rotate the normals
        (TransformInPlace, multichannel_cloud.cc:53-68); the other channels
        do not depend on the frame."""
        normals = pose.rotate(self.normals) if self.normals is not None \
            else None
        return dataclasses.replace(self, points=pose.apply(self.points),
                                   normals=normals)

    def resize(self, rows: int, cols: int) -> "PointCloud":
        """Resize keeping the overlap and zero-filling the rest
        (MultichannelCloud::Resize via ResizeField,
        multichannel_cloud.cc:112-124)."""
        def resized(arr):
            if arr is None:
                return None
            out = torch.zeros((rows, cols) + tuple(arr.shape[2:]),
                              dtype=arr.dtype, device=arr.device)
            r, c = min(rows, arr.shape[0]), min(cols, arr.shape[1])
            out[:r, :c] = arr[:r, :c]
            return out

        return dataclasses.replace(self, **{
            name: resized(getattr(self, name)) for name, _, _ in CHANNELS})

    # -- npz files, in the JAX package's layout ----------------------------

    def to_npz(self, path: str) -> None:
        arrays = {name: getattr(self, name).cpu().numpy()
                  for name, _, _ in CHANNELS
                  if getattr(self, name) is not None}
        arrays["pose_quat"] = self.pose.quat.cpu().numpy()
        arrays["pose_trans"] = self.pose.trans.cpu().numpy()
        np.savez(path, **arrays)

    @staticmethod
    def from_npz(path: str, device=None) -> "PointCloud":
        with np.load(path) as data:
            kwargs = {name: torch.as_tensor(data[name], device=device)
                      for name, _, _ in CHANNELS if name in data}
            pose = geom.Pose.from_arrays(data["pose_quat"],
                                         data["pose_trans"], device)
        return PointCloud(pose=pose, **kwargs)


def make_invalid_points(rows: int, cols: int, dtype=torch.float32,
                        device=None):
    """All-NaN [H, W, 3] points (the reference's invalid value,
    algorithms.h:335)."""
    return torch.full((rows, cols, 3), float("nan"), dtype=dtype,
                      device=device)
