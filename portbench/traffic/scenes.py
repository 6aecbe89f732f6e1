"""Frozen copies of the port's scene generators and range-frame helpers.

Copied from ``pcseg_tpu_torch/utils/synthetic.py``
(``synthetic_room_cloud``, ``synthetic_cluttered_room_cloud``) and
``pcseg_tpu_torch/ops/unproject.py`` (``camera_ray_table``,
``encode_range``, ``unproject_range_np``, ``DEFAULT_DEPTH_SCALE``) at
commit 9e5028f, and ``jitter`` from ``chip_smoke.make_batch`` there. The
generators take any seed ``np.random.default_rng`` takes (a
``SeedSequence`` too). Later changes to the program do not move them.
``carton_wall`` is the harness's own: the program has no such scene.
"""

from __future__ import annotations

import numpy as np

DEFAULT_DEPTH_SCALE = 1.0 / 4000.0  # meters per integer unit


def camera_ray_table(rows: int, cols: int, f: float) -> np.ndarray:
    """Unit ray directions [H, W, 3] f32: +x forward, y along columns, z
    up along decreasing rows, focal length ``f`` pixels."""
    cy, cz = rows / 2.0, cols / 2.0
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    d = np.stack([np.ones_like(rr, np.float64),
                  (cc - cz) / f,
                  (cy - rr) / f], axis=-1)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return d.astype(np.float32)


def encode_range(points: np.ndarray,
                 scale: float = DEFAULT_DEPTH_SCALE) -> np.ndarray:
    """[H, W, 3] points -> [H, W] u16 range image (NaN/out-of-range -> 0)."""
    r = np.linalg.norm(points.astype(np.float64), axis=-1) / scale
    r = np.where(np.isfinite(r) & (r >= 1.0) & (r <= 65535.0), r, 0.0)
    return np.round(r).astype(np.uint16)


def unproject_range_np(range_u16: np.ndarray, rays: np.ndarray,
                       scale: float = DEFAULT_DEPTH_SCALE) -> np.ndarray:
    """[..., H, W] u16 -> [..., H, W, 3] f32 points (0 -> NaN point), the
    IEEE f32 chain of the device's unprojection."""
    r = range_u16.astype(np.float32) * np.float32(scale)
    r = np.where(range_u16 > 0, r, np.float32(np.nan))
    return (r[..., None] * rays).astype(np.float32)


def jitter(base_u16: np.ndarray, n: int, max_units: int,
           rng: np.random.Generator) -> np.ndarray:
    """[n, H, W] u16: the frame plus +0..``max_units`` units of sensor
    noise per valid pixel, drawn anew for each of the n frames."""
    jit = rng.integers(0, max_units + 1, size=(n,) + base_u16.shape,
                       dtype=np.uint16)
    return np.where(base_u16[None] > 0, base_u16[None] + jit, 0) \
        .astype(np.uint16)


def _rays(rows, cols, f):
    cy, cz = rows / 2.0, cols / 2.0
    rr, cc = np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij")
    d = np.stack([np.ones_like(rr, np.float64),
                  (cc - cz) / f,
                  (cy - rr) / f], axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def room(rows=120, cols=160, f=120.0, seed=0, with_nan_holes=True):
    """Depth-camera style organized cloud: floor z=-1, wall x=4, table slab
    z=-0.6 over 1.5<x<2.5, plus random NaN holes (2% of the pixels).
    Camera at the origin looking +x, z up. Returns [H, W, 3] f32 points."""
    rng = np.random.default_rng(seed)
    d = _rays(rows, cols, f)
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
    return pts


def cluttered_room(rows=120, cols=160, f=120.0, seed=0, with_nan_holes=True,
                   n_blobs=5, blob_noise=0.04, blob_radius=0.10):
    """The room plus noisy spheres of radius ``blob_radius`` on the floor
    (radial noise ``blob_noise``), pairwise >1.5 m apart so each blob is
    one euclidean cluster. Returns [H, W, 3] f32 points."""
    rng = np.random.default_rng(seed)
    pts = room(rows, cols, f=f, seed=seed, with_nan_holes=False)
    d = _rays(rows, cols, f)
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
    return pts


def _box_hits(t, d, f, lo, hi):
    """Lower ``t`` [H, W] to the ray parameter where rays ``d`` from the
    origin enter the axis-aligned box [lo, hi] (lo[0] > 0, before the
    camera). Only the pixels inside the box's image, the bounds of its
    corners' projections widened by 2 pixels, are tested."""
    rows, cols = t.shape
    corners = np.array([[x, y, z] for x in (lo[0], hi[0])
                        for y in (lo[1], hi[1]) for z in (lo[2], hi[2])])
    r = rows / 2.0 - f * corners[:, 2] / corners[:, 0]
    c = cols / 2.0 + f * corners[:, 1] / corners[:, 0]
    r0, r1 = max(int(np.floor(r.min())) - 2, 0), min(int(r.max()) + 3, rows)
    c0, c1 = max(int(np.floor(c.min())) - 2, 0), min(int(c.max()) + 3, cols)
    if r0 >= r1 or c0 >= c1:
        return
    dw = d[r0:r1, c0:c1]
    with np.errstate(divide="ignore", invalid="ignore"):
        t1 = lo / dw
        t2 = hi / dw
    near = np.nanmax(np.minimum(t1, t2), axis=-1)
    far = np.nanmin(np.maximum(t1, t2), axis=-1)
    t[r0:r1, c0:c1] = np.minimum(
        t[r0:r1, c0:c1],
        np.where((near <= far) & (near > 0.1), near, np.inf))


def carton_wall(rows=120, cols=160, f=120.0, seed=0, with_nan_holes=True,
                columns=8, levels=3, width=0.5, height=0.45, front=3.0,
                step=0.2, depths=5):
    """The room's floor and wall with a wall of stacked cartons before
    it: ``levels`` x ``columns`` boxes of ``width`` x ``height`` m from
    the floor up, centred on the view, each reaching back to the wall
    from a face at ``front`` + ``step`` * j m, j < ``depths``. Box
    (l, c) takes depth ``perm[(l + 2 c) % depths]`` of a permutation drawn
    from the seed, so with ``depths`` 5 no two boxes that share an edge or
    a corner share a face plane, and a box that stands out shows its side
    or top beside its front. Every seed has the same boxes, in another
    order of depths. Returns [H, W, 3] f32 points."""
    rng = np.random.default_rng(seed)
    d = _rays(rows, cols, f)
    wall_x, floor_z = 4.0, -1.0
    dz, dx = d[..., 2], d[..., 0]
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.minimum(np.where(dz < -1e-6, floor_z / dz, np.inf),
                       np.where(dx > 1e-6, wall_x / dx, np.inf))
    t = np.where(t > 0.1, t, np.inf)
    perm = rng.permutation(depths)
    y0 = -columns * width / 2.0
    for lv in range(levels):
        for c in range(columns):
            x = front + step * perm[(lv + 2 * c) % depths]
            lo = np.array([x, y0 + c * width, floor_z + lv * height])
            hi = np.array([wall_x, y0 + (c + 1) * width,
                           floor_z + (lv + 1) * height])
            _box_hits(t, d, f, lo, hi)
    pts = (t[..., None] * d).astype(np.float32)
    pts[~np.isfinite(t)] = np.nan
    if with_nan_holes:
        holes = rng.random((rows, cols)) < 0.02
        pts[holes] = np.nan
    return pts


GENERATORS = {"room": room, "cluttered_room": cluttered_room,
              "carton_wall": carton_wall}
