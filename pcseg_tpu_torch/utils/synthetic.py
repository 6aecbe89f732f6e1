"""Synthetic cloud generators (fixtures, benchmarks, demos)."""

from __future__ import annotations

import numpy as np


def analytic_plane_cloud(nx=200, ny=200, normal=(0.0, 0.0, 1.0), d=-1.0,
                         step=0.01, noise=0.0, seed=0):
    """Grid of points on plane n.x + d = 0, optional normal-direction noise."""
    rng = np.random.default_rng(seed)
    n = np.asarray(normal, np.float64)
    n = n / np.linalg.norm(n)
    helper = np.array([1.0, 0.0, 0.0]) if abs(n[0]) < 0.9 \
        else np.array([0.0, 1.0, 0.0])
    u = np.cross(helper, n)
    u /= np.linalg.norm(u)
    v = np.cross(n, u)
    origin = -d * n
    xs = (np.arange(nx) - nx / 2) * step
    ys = (np.arange(ny) - ny / 2) * step
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    pts = (origin[None, None]
           + gx[..., None] * u[None, None]
           + gy[..., None] * v[None, None])
    if noise:
        pts = pts + rng.normal(0, noise, pts.shape) * n[None, None]
    return pts.astype(np.float32)


def synthetic_room_cloud(rows=120, cols=160, f=120.0, seed=0,
                         with_nan_holes=True):
    """Depth-camera style organized cloud: floor z=-1, wall x=4, table slab
    z=-0.6 over 1.5<x<2.5, plus random NaN holes. Camera at the origin
    looking +x, z up. Returns ([H, W, 3] float32 points, sensor_origin)."""
    rng = np.random.default_rng(seed)
    cy, cz = rows / 2.0, cols / 2.0
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    d = np.stack([np.ones_like(rr, np.float64),
                  (cc - cz) / f,
                  (cy - rr) / f], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    inf = np.inf

    dz = d[..., 2]
    dx = d[..., 0]
    t_floor = np.where(dz < -1e-6, -1.0 / np.where(dz < -1e-6, dz, 1.0), inf)
    t_wall = np.where(dx > 1e-6, 4.0 / np.where(dx > 1e-6, dx, 1.0), inf)
    t_table = np.where(dz < -1e-6, -0.6 / np.where(dz < -1e-6, dz, 1.0), inf)
    with np.errstate(invalid="ignore"):
        p_table = np.where(np.isfinite(t_table)[..., None],
                           t_table[..., None], 0.0) * d
    table_ok = ((1.5 < p_table[..., 0]) & (p_table[..., 0] < 2.5)
                & (-0.8 < p_table[..., 1]) & (p_table[..., 1] < 0.8))
    t_table = np.where(table_ok, t_table, inf)

    t = np.minimum(np.minimum(np.where(t_floor > 0.1, t_floor, inf),
                              np.where(t_wall > 0.1, t_wall, inf)),
                   np.where(t_table > 0.1, t_table, inf))
    pts = (t[..., None] * d).astype(np.float32)
    pts[~np.isfinite(t)] = np.nan
    if with_nan_holes:
        holes = rng.random((rows, cols)) < 0.02
        pts[holes] = np.nan
    return pts, np.zeros(3, np.float32)


def synthetic_cluttered_room_cloud(rows=120, cols=160, f=120.0, seed=0,
                                   with_nan_holes=True, n_blobs=5,
                                   blob_noise=0.04, blob_radius=0.10):
    """Room scene plus non-planar clutter: noisy spheres sitting on the
    floor in front of the camera. The blob surfaces carry radial noise, so
    their normals are unreliable, planar seeds/growth cannot hold them
    inside the tau band, and they fall through to the euclidean-clustering
    stage — a scene where the cluster half of the pipeline
    (cluster_region.h, SURVEY §3.3) does real work, unlike the plain room
    (3 planar regions, 0 clusters every frame; VERDICT r4 weak #3).

    Blob centers are pairwise >1.5 m apart (the cluster gate is 1.0 m^2
    squared distance, cluster_region.h:94), so each blob is one cluster.
    Returns ([H, W, 3] float32 points, sensor_origin).
    """
    rng = np.random.default_rng(seed)
    pts, origin = synthetic_room_cloud(rows, cols, f=f, seed=seed,
                                       with_nan_holes=False)

    cy, cz = rows / 2.0, cols / 2.0
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    d = np.stack([np.ones_like(rr, np.float64),
                  (cc - cz) / f,
                  (cy - rr) / f], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)

    # fixed pairwise-separated blob layout on the floor (z = -1 + r)
    layout = np.array([
        [2.0, -1.1], [2.2, 0.9], [3.1, 0.0], [3.3, -1.6], [3.4, 1.8],
        [1.7, 0.1], [2.8, -2.3], [2.9, 2.4],
    ], np.float64)[:n_blobs]
    radius = blob_radius

    t_scene = np.where(np.isfinite(pts[..., 0]),
                       np.linalg.norm(np.where(np.isfinite(pts), pts, 0.0),
                                      axis=-1), np.inf)
    for bx, by in layout:
        c = np.array([bx, by, -1.0 + radius])
        dc = d @ c
        disc = dc * dc - (c @ c - radius * radius)
        hit = disc > 0
        t_blob = np.where(hit, dc - np.sqrt(np.where(hit, disc, 0.0)),
                          np.inf)
        t_blob = np.where(t_blob > 0.1, t_blob, np.inf)
        # radial surface noise: kills the local planarity of the blob
        t_blob = t_blob + np.where(
            np.isfinite(t_blob),
            rng.normal(0.0, blob_noise, t_blob.shape), 0.0)
        closer = t_blob < t_scene
        t_scene = np.where(closer, t_blob, t_scene)
        t_fin = np.where(np.isfinite(t_blob), t_blob, 0.0)
        pts = np.where(closer[..., None],
                       (t_fin[..., None] * d), pts).astype(np.float32)

    if with_nan_holes:
        holes = rng.random((rows, cols)) < 0.02
        pts[holes] = np.nan
    return pts, np.zeros(3, np.float32)


BLOB_CENTERS = ((0.0, 0.0, 0.0), (30.0, 0.0, 0.0), (0.0, 35.0, 0.0),
                (40.0, 40.0, 0.0))


def gaussian_blobs(n_per=250_000, sigma=0.4, seed=0):
    """The unorganized cloud of BASELINE config 3: four Gaussian blobs
    (sigma 0.4 m) of ``n_per`` points each, [4 * n_per, 3] f32, drawn in
    the order of ``benchmarks/measure_tpu.py`` (a 1M-point cloud at the
    default ``n_per``)."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        c + rng.normal(0, sigma, (n_per, 3)).astype(np.float32)
        for c in np.array(BLOB_CENTERS, np.float32)])
