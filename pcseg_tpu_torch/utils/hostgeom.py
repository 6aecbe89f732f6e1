"""Host-side (NumPy) geometry for the per-region finalize (a copy of
pcseg_tpu.utils.hostgeom: hulls, polygon normals and areas, and the
ear-clipping triangulation of algorithms.h).

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




def polygon_normal(ordered_points: np.ndarray) -> np.ndarray:
    """algorithms.h:279-284."""
    n = cumulative_polygon_normal(ordered_points)
    return n / np.linalg.norm(n)


def is_polygon_area_zero(ordered_points: np.ndarray,
                         eps: float = 1.0e-7) -> bool:
    """algorithms.h:294-299."""
    n = cumulative_polygon_normal(ordered_points)
    return float(n @ n) < eps


# ---------------------------------------------------------------------------
# Ear-clipping triangulation (algorithms.h:39-100, 386-521)
# ---------------------------------------------------------------------------

def is_inside_triangle(u, v, w, p) -> bool:
    """Barycentric point-in-triangle, both windings (algorithms.h:39-64)."""
    v0 = np.asarray(w, np.float64) - u
    v1 = np.asarray(v, np.float64) - u
    v2 = np.asarray(p, np.float64) - u
    dot00, dot01, dot02 = v0 @ v0, v0 @ v1, v0 @ v2
    dot11, dot12 = v1 @ v1, v1 @ v2
    denom = dot00 * dot11 - dot01 * dot01
    if denom == 0:
        return False
    inv = 1.0 / denom
    a = (dot11 * dot02 - dot01 * dot12) * inv
    b = (dot00 * dot12 - dot01 * dot02) * inv
    return a >= 0 and b >= 0 and (a + b) < 1


def _is_ear(points, u, v, w, poly, polygon_normal) -> bool:
    """algorithms.h:70-100; v is the candidate ear tip."""
    pu = points[poly[u]]
    pv = points[poly[v]]
    pw = points[poly[w]]
    tri_normal = np.cross(pv - pu, pw - pu)
    if float(tri_normal @ tri_normal) < 1e-25 \
            or float(np.dot(polygon_normal, tri_normal)) < 0.0:
        return False
    for k in range(len(poly)):
        if k in (u, v, w):
            continue
        if is_inside_triangle(pu, pv, pw, points[poly[k]]):
            return False
    return True


def triangulate_polygon(points: np.ndarray, polygon_indices,
                        triangles=None):
    """Ear clipping for simple concave polygons (algorithms.h:386-428).

    points: [N, 3] vertex table; polygon_indices: ordered index list.
    Returns (success, triangles) with triangles a flat index list
    (3 per triangle). Winding is preserved.
    """
    triangles = [] if triangles is None else triangles
    poly = list(polygon_indices)
    if len(poly) < 3:
        return False, triangles
    if poly[0] == poly[-1]:
        poly = poly[:-1]
        if len(poly) < 3:
            return False, triangles
    polygon_normal = cumulative_polygon_normal(points[poly]).astype(
        np.float64)

    u = len(poly) - 1
    null_iterations = 0
    while len(poly) > 2 and null_iterations < len(poly) * 3:
        v = (u + 1) % len(poly)
        w = (u + 2) % len(poly)
        if _is_ear(points, u, v, w, poly, polygon_normal):
            triangles.extend([poly[u], poly[v], poly[w]])
            del poly[v]
            null_iterations = 0
        else:
            null_iterations += 1
        u = (u + 1) % len(poly)
    return len(poly) == 2, triangles


def _triangulate_recursive(points, poly, polygon_normal, triangles) -> bool:
    """algorithms.h:431-484: split out loops at duplicate indices."""
    if len(poly) == 0 or is_polygon_area_zero(points[poly]):
        return True
    start_loop = end_loop = -1
    for i in range(len(poly)):
        for j in range(i + 1, len(poly)):
            if poly[i] == poly[j]:
                start_loop, end_loop = i, j
                break
        if start_loop >= 0:
            break
    if start_loop >= 0:
        loop = poly[start_loop:end_loop]
        rest = poly[:start_loop] + poly[end_loop:]
        return (_triangulate_recursive(points, loop, polygon_normal,
                                       triangles)
                and _triangulate_recursive(points, rest, polygon_normal,
                                           triangles))
    u = len(poly) - 1
    null_iterations = 0
    while len(poly) > 2 and null_iterations < len(poly) * 2:
        v = (u + 1) % len(poly)
        w = (u + 2) % len(poly)
        if _is_ear(points, u, v, w, poly, polygon_normal):
            triangles.extend([poly[u], poly[v], poly[w]])
            del poly[v]
            null_iterations = 0
        else:
            null_iterations += 1
        u = (u + 1) % len(poly)
    return len(poly) == 2


def triangulate_loopy_polygon(points: np.ndarray, polygon_indices,
                              triangles=None):
    """Ear clipping tolerating duplicate indices / loops
    (algorithms.h:494-521) — used for traced boundaries whose one-pixel
    branches revisit vertices."""
    triangles = [] if triangles is None else triangles
    poly = list(polygon_indices)
    if len(poly) < 3:
        return False, triangles
    if poly[0] == poly[-1]:
        poly = poly[:-1]
        if len(poly) < 3:
            return False, triangles
    polygon_normal = cumulative_polygon_normal(points[poly]).astype(
        np.float64)
    ok = _triangulate_recursive(points, poly, polygon_normal, triangles)
    return ok, triangles
