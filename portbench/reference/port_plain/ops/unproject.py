"""u16 range frames -> organized point clouds (port of
pcseg_tpu.ops.unproject).

The serving payload is the sensor's native u16 range image (2 bytes/px);
the device unprojects it against a per-camera ray table with one f32
multiply per channel. 0 is the invalid sentinel (NaN point); ``scale``
converts integer units to meters. The numpy helpers are copies of the JAX
package's, so the port never imports it.
"""

from __future__ import annotations

import numpy as np
import torch

DEFAULT_DEPTH_SCALE = 1.0 / 4000.0  # meters per integer unit


def camera_ray_table(rows: int, cols: int, f: float,
                     cy: float | None = None, cz: float | None = None,
                     dtype=np.float32) -> np.ndarray:
    """Unit ray directions [H, W, 3]: +x forward, y along columns, z up
    along decreasing rows, focal length ``f`` pixels."""
    cy = rows / 2.0 if cy is None else cy
    cz = cols / 2.0 if cz is None else cz
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    d = np.stack([np.ones_like(rr, np.float64),
                  (cc - cz) / f,
                  (cy - rr) / f], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d.astype(dtype)


def unproject_range(range_u16: torch.Tensor, rays: torch.Tensor,
                    scale: float = DEFAULT_DEPTH_SCALE) -> torch.Tensor:
    """[..., H, W] u16 range-along-ray -> [..., H, W, 3] float32 points
    (0 -> NaN point). Bit-identical to :func:`unproject_range_np`."""
    r = range_u16.to(torch.int32).to(torch.float32) \
        * torch.tensor(scale, dtype=torch.float32)
    r = torch.where(range_u16.to(torch.int32) > 0, r,
                    torch.full_like(r, float("nan")))
    return r[..., None] * rays


def encode_range(points: np.ndarray,
                 scale: float = DEFAULT_DEPTH_SCALE) -> np.ndarray:
    """Host-side inverse of :func:`unproject_range`: [H, W, 3] points ->
    [H, W] u16 range image (NaN/out-of-range -> 0)."""
    r = np.linalg.norm(points.astype(np.float64), axis=-1) / scale
    r = np.where(np.isfinite(r) & (r >= 1.0) & (r <= 65535.0), r, 0.0)
    return np.round(r).astype(np.uint16)


def unproject_range_np(range_u16: np.ndarray, rays: np.ndarray,
                       scale: float = DEFAULT_DEPTH_SCALE) -> np.ndarray:
    """NumPy twin of :func:`unproject_range` — the same IEEE f32 chain."""
    r = range_u16.astype(np.float32) * np.float32(scale)
    r = np.where(range_u16 > 0, r, np.float32(np.nan))
    return (r[..., None] * rays).astype(np.float32)
