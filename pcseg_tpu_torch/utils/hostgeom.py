"""Host-side (NumPy) geometry for the per-region finalize (a copy of the
hull and area helpers of pcseg_tpu.utils.hostgeom).

These run on the gathered, small per-region point sets (boundary rings,
hulls): ordering-dependent walks stay on the host, the dense per-pixel math
on the device. The native library (pcseg_tpu_torch.native) runs the 2-D
hull when it loads; the NumPy path below gives the same vertices.
"""

from __future__ import annotations

import ctypes

import numpy as np

from pcseg_tpu_torch import native as _native


def convex_hull_2d(pts: np.ndarray) -> np.ndarray:
    """Andrew monotone chain on [N, 2] -> CCW hull vertices (float64).

    Replaces the reference's collision::ConvexHull (algorithms.h:27,540);
    vertex order may differ from the C++ library but the vertex set (and
    every area/height computed from it) is identical.
    """
    pts = np.asarray(pts, np.float64)
    # lexsort + adjacent-diff dedup == np.unique(axis=0), cheaper
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]
    if len(pts) > 1:
        keep = np.any(pts[1:] != pts[:-1], axis=1)
        pts = np.concatenate([pts[:1], pts[1:][keep]])
    if len(pts) <= 2:
        return pts

    lib = _native.load_hostops()
    if lib is not None:
        buf = np.ascontiguousarray(pts)
        out = np.empty(len(pts), np.int64)
        k = lib.pcseg_convex_hull_2d(
            buf.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            len(pts), out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        return pts[out[:k]]

    def cross2(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    def half(points):
        out = []
        for p in points:
            while len(out) >= 2 and cross2(out[-2], out[-1], p) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.array(lower[:-1] + upper[:-1])


def pose_from_plane(plane: np.ndarray):
    """(R columns = plane-frame axes in world, origin on plane); z = normal.
    eigenmath::PoseFromPlane as PlanarConvexHull uses it
    (algorithms.h:530-531)."""
    n = np.asarray(plane[:3], np.float64)
    t = (-plane[3] * plane[:3]).astype(np.float64)
    ax = np.abs(n)
    if ax[0] <= ax[1] and ax[0] <= ax[2]:
        helper = np.array([1.0, 0.0, 0.0])
    elif ax[1] <= ax[2]:
        helper = np.array([0.0, 1.0, 0.0])
    else:
        helper = np.array([0.0, 0.0, 1.0])
    x = np.cross(helper, n)
    x /= np.linalg.norm(x)
    y = np.cross(n, x)
    return np.stack([x, y, n], axis=1), t


def planar_convex_hull(points_gathered: np.ndarray,
                       plane: np.ndarray) -> np.ndarray:
    """algorithms.h:527-549 (with the output buffer sized correctly):
    project the gathered boundary points into the plane frame, 2-D hull,
    lift back."""
    rot, t = pose_from_plane(plane)
    local = (np.asarray(points_gathered, np.float64) - t) @ rot
    hull2 = convex_hull_2d(local[:, :2])
    if len(hull2) == 0:
        return np.zeros((0, 3), np.float32)
    lifted = np.concatenate([hull2, np.zeros((len(hull2), 1))], axis=1)
    return (lifted @ rot.T + t).astype(np.float32)


def cumulative_polygon_normal(ordered_points: np.ndarray) -> np.ndarray:
    """Stokes cumulative normal over an ordered polygon [N, 3]
    (algorithms.h:265-275), float32 accumulation like the C++."""
    p = np.asarray(ordered_points, np.float32)
    if len(p) == 0:
        return np.zeros(3, np.float32)
    nxt = np.roll(p, -1, axis=0)
    return np.sum(np.cross(p, nxt), axis=0, dtype=np.float32)


def polygon_area(ordered_points: np.ndarray) -> float:
    """algorithms.h:289-292."""
    return float(0.5 * np.linalg.norm(cumulative_polygon_normal(
        ordered_points)))
