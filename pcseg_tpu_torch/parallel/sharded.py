"""Column-sharded segmentation over the ranks of a process group (port of
pcseg_tpu.parallel.sharded).

The organized grid [H, W] is sharded over columns across the ranks of a
:class:`~pcseg_tpu_torch.parallel.halo.Comm`: every windowed op exchanges
halo columns, plane-fit moments merge with ``psum`` (the estimator's merge
algebra is addition, plane_estimator.cc:128-133), and cluster labels unify
by a local CCL on global labels plus a replicated union-find over the
boundary pairs.

Semantics are the single-device path's with JAX's one documented
difference: seeds rank in the natural grid orientation
(``seeds_from_plane_support(..., transposed_parity=False)``), not the
reference's transposed-access quirk.

All control flow is replicated: every rank computes the same region tables
and plane solves from psum'd quantities, and JAX's ``while_loop``s are host
loops whose conditions read all-reduced scalars, so every rank takes the
same branch. Shapes are one frame's, as JAX's: [H, W_local, ...] blocks.
On the card the local CCL is the CCL kernel (B2, kernels/ccl_gated.py) on
global col-major labels, and the local rounds of the sharded flood are the
flood kernel (B3, kernels/flood_packed.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pcseg_tpu_torch.kernels import flood_packed
from pcseg_tpu_torch.kernels.common import shift2
from pcseg_tpu_torch.models import planar_batched as pb
from pcseg_tpu_torch.models.config import (
    EXAMINED, UNLABELED, ClusterRegionConfig, ComputeNormalsParams,
    PlanarRegionConfig, SeedsFromPlaneSupportParams)
from pcseg_tpu_torch.models.planar_batched import PlanarRegions
from pcseg_tpu_torch.ops import connectivity, geom, nansafe, plane_fit
from pcseg_tpu_torch.ops import normals as normals_op
from pcseg_tpu_torch.ops import seeds as seeds_op
from pcseg_tpu_torch.parallel.halo import Comm, crop_halo, exchange_halo
from pcseg_tpu_torch.utils import profiling


# ---------------------------------------------------------------------------
# building blocks
# ---------------------------------------------------------------------------

def _global_cols(h, w_local, comm, device):
    """([H, 1] rows, [1, W_local] global columns) int32."""
    rows = torch.arange(h, dtype=torch.int32, device=device)[:, None]
    cols = torch.arange(w_local, dtype=torch.int32, device=device)[None, :] \
        + comm.rank * w_local
    return rows, cols


def _crop(tree, k, dim):
    """crop_halo on every tensor of a (nested) NamedTuple."""
    if isinstance(tree, tuple):
        return type(tree)(*[_crop(t, k, dim) for t in tree])
    return crop_halo(tree, k, dim)


def _shift_hw(x, dr, dc, fill):
    """out[r, c] = x[r + dr, c + dc] on the first two axes (out of bounds
    -> fill)."""
    return shift2(x.movedim((0, 1), (-2, -1)), dr, dc, fill) \
        .movedim((-2, -1), (0, 1))


def _gather_seed_values(grid_local, seed_indices, h, comm):
    """Values of a local [H, W_local(, C)] grid at GLOBAL col-major seed
    indices, combined with psum (each index has one owner; the others add
    zero)."""
    w_local = grid_local.shape[1]
    r = (seed_indices % h).long()
    c_local = torch.div(seed_indices, h, rounding_mode="floor") \
        - comm.rank * w_local
    owned = (c_local >= 0) & (c_local < w_local)
    vals = grid_local[r, c_local.clamp(0, w_local - 1).long()]
    mask = owned.reshape(owned.shape + (1,) * (vals.dim() - owned.dim()))
    return comm.psum(torch.where(mask, vals, torch.zeros_like(vals)))


def sharded_normals(points_local, sensor_origin,
                    params: ComputeNormalsParams, comm: Comm, impl=None):
    """Organized normals of a column block [H, W_local, 3]: the support
    scan over a halo of ``max_scan_steps`` columns (a NaN halo at the grid
    edges is the single-device edge), the eigensolve on the local columns
    only. ``impl`` as ``ops/normals.find_normal_support``'s."""
    k = params.max_scan_steps
    padded = exchange_halo(points_local, k, comm, fill=float("nan"))
    support = _crop(normals_op.find_normal_support(padded, params, impl), k,
                    1)
    return normals_op.normals_from_support(support, points_local,
                                           sensor_origin, params)


def _support_counts(points_local, normals_local, params, comm):
    """Plane-support counts and qualification of the local cells, from a
    halo of neighborhood_size // 2 columns."""
    half = params.neighborhood_size // 2
    pp = exchange_halo(points_local, half, comm, fill=float("nan"))
    np_ = exchange_halo(normals_local, half, comm, fill=float("nan"))
    count, ok = seeds_op.plane_support_counts(pp, np_, params)
    count = crop_halo(count, half)
    ok = crop_halo(ok, half)
    return count, ok & (count >= params.min_num_support_points)


def _top_desc(key, m):
    """JAX's lax.top_k: the ``m`` largest keys, descending, ties to the
    lower index."""
    order = torch.argsort(key, descending=True, stable=True)[:m]
    return key[order], order


def sharded_plane_support_seeds(points_local, normals_local,
                                params: SeedsFromPlaneSupportParams,
                                h, w, comm: Comm):
    """Globally ranked plane-support seed vector from column blocks: each
    rank keeps its local top ``max_seeds`` and only those are gathered;
    the global top is a subset of the local tops, so the replicated
    ranking is rank_plane_support_seeds' (natural orientation). Returns
    ([max_seeds] int32 col-major indices, ascending, front-padded; valid)."""
    max_seeds = params.max_seeds
    count, qualifies = _support_counts(points_local, normals_local, params,
                                       comm)
    rows, cols = _global_cols(h, count.shape[1], comm, count.device)
    lin = (cols * h + rows).reshape(-1)
    key = torch.where(qualifies.reshape(-1),
                      count.reshape(-1) * (h * w) + lin, -1)
    kk, ii = _top_desc(key, min(max_seeds, key.shape[0]))
    keys_all = comm.all_gather(kk).reshape(-1)
    lins_all = comm.all_gather(lin[ii]).reshape(-1)
    kk2, jj = _top_desc(keys_all, min(max_seeds, keys_all.shape[0]))
    pad = max_seeds - kk2.shape[0]
    dev = count.device
    indices = torch.cat([torch.zeros(pad, dtype=torch.int32, device=dev),
                         lins_all[jj].flip(0)])
    valid = torch.cat([torch.zeros(pad, dtype=torch.bool, device=dev),
                       (kk2 >= 0).flip(0)])
    return torch.where(valid, indices, 0).to(torch.int32), valid


def sharded_plane_support_rank_grid(points_local, normals_local,
                                    params: SeedsFromPlaneSupportParams,
                                    h, w, comm: Comm):
    """The local [H, W_local] block of the dense seed pop-priority grid
    (ops/seeds.plane_support_rank_grid, natural orientation): every
    qualifying seed, no top-k and no gathers."""
    count, qualifies = _support_counts(points_local, normals_local, params,
                                       comm)
    rows, cols = _global_cols(h, count.shape[1], comm, count.device)
    lin = cols * h + rows
    hw = h * w
    cmax = params.neighborhood_size ** 2 + 1
    rank = (cmax - count) * hw + (hw - 1 - lin)
    return torch.where(qualifies, rank, seeds_op.SEED_RANK_INF) \
        .to(torch.int32)


def _dilate4_halo(mask, comm):
    """The ungated 4-neighbourhood ring of [..., H, W_local] masks across
    the column blocks (halo 1)."""
    mp = exchange_halo(mask, 1, comm, fill=False, dim=-1)
    return (mp[..., :-2] | mp[..., 2:] | shift2(mask, 1, 0, False)
            | shift2(mask, -1, 0, False))


def _moment_sums(mask, points):
    """f64 (s2, s1, w) of the cells of ``mask`` (f32 products, f64 sums:
    plane_fit.moments_of_points before its rounding)."""
    p = torch.where(mask[..., None], points, 0.0).reshape(-1, 3)
    wts = mask.to(points.dtype).reshape(-1)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    terms = torch.stack([x * x * wts, x * y * wts, x * z * wts,
                         y * y * wts, y * z * wts, z * z * wts,
                         x * wts, y * wts, z * wts, wts], dim=-1)
    return terms.to(torch.float64).sum(dim=0)


def sharded_grow_planar_regions(points_local, normals_local, labels_local,
                                seed_indices, seed_valid,
                                config: PlanarRegionConfig, h, w, comm: Comm,
                                initial_id_offset: int = 0,
                                max_attempts: int = 256) -> PlanarRegions:
    """Column-sharded sequential growth (JAX's sharded wavefront grower,
    SegmentRegions<PlanarRegion>): one region at a time from the seed
    vector, its wavefront crossing the blocks by halo exchange, its
    moments and counts merged with psum (f64 partial sums, rounded to f32
    after the merge, as models/planar.py sums them on one device). The
    wavefront runs in every ``growth_mode``, as in JAX's sharded step.
    Labels come back as the local block; the tables are replicated."""
    w_local = points_local.shape[1]
    dev = points_local.device
    dtype = points_local.dtype
    r_cap = config.max_regions
    tau = config.max_plane_distance
    period = config.plane_model_reestimation_period
    col0 = comm.rank * w_local
    s = seed_indices.shape[0]
    seed_order = torch.arange(s, device=dev)

    planes = torch.zeros((r_cap, 4), dtype=dtype, device=dev)
    centroids = torch.zeros((r_cap, 3), dtype=dtype, device=dev)
    curvatures = torch.zeros((r_cap,), dtype=dtype, device=dev)
    counts = torch.zeros((r_cap,), dtype=torch.int32, device=dev)
    seeds_out = torch.zeros((r_cap,), dtype=torch.int32, device=dev)
    moments = plane_fit.empty((r_cap,), dtype, dev)

    def local_onehot(seed_idx):
        grid = torch.zeros((h, w_local), dtype=torch.bool, device=dev)
        c = seed_idx // h - col0
        if 0 <= c < w_local:
            grid[seed_idx % h, c] = True
        return grid

    def grow_one(labels_in, seed_idx):
        with profiling.blocking("sharded.seed"):
            idx = torch.tensor([seed_idx], dtype=torch.int32, device=dev)
        seed_point = _gather_seed_values(points_local, idx, h, comm)[0]
        seed_normal = _gather_seed_values(normals_local, idx, h, comm)[0]
        plane = geom.plane_from_normal_point(seed_normal, seed_point)
        m = plane_fit.set_normal_orientation(
            plane_fit.empty((), dtype, dev), seed_normal)
        frontier = local_onehot(seed_idx)
        member = torch.zeros((h, w_local), dtype=torch.bool, device=dev)
        eligible = labels_in == UNLABELED
        count, it, active = 0, 0, True
        while active and it < config.max_growth_iters:
            cand = frontier if it == 0 else \
                _dilate4_halo(frontier, comm) & eligible & ~member
            accepted = cand & (geom.plane_abs_distance(plane, points_local)
                               < tau)
            member = member | accepted
            sums = comm.psum(_moment_sums(accepted, points_local)).to(dtype)
            m = m._replace(s2=m.s2 + sums[:6], s1=m.s1 + sums[6:9],
                           w=m.w + sums[9])
            with profiling.blocking("sharded.accepted"):
                n_accepted = int(comm.psum(accepted.sum(dtype=torch.int32)))
            new_count = count + n_accepted
            crossed = new_count // period > count // period
            if crossed:
                sol = plane_fit.solve(m)
                recentered = geom.plane_from_normal_point(m.normal_hint,
                                                          sol.centroid)
                m = m._replace(normal_hint=torch.where(
                    sol.valid, sol.normal, m.normal_hint))
                plane = torch.where(sol.valid, sol.plane, recentered)
            frontier = member if crossed else accepted
            active = n_accepted > 0 or crossed
            count = new_count
            it += 1
        return member, plane, m, count

    labels = labels_local
    consumed = torch.zeros((s,), dtype=torch.bool, device=dev)
    num_regions = attempts = 0
    while attempts < max_attempts and num_regions < r_cap:
        seed_labels = _gather_seed_values(labels, seed_indices, h, comm)
        available = seed_valid & ~consumed & (seed_labels == UNLABELED)
        with profiling.blocking("sharded.available"):
            if not bool(available.any()):
                break
        with profiling.blocking("sharded.pick", 2):
            pick = int(torch.where(available, seed_order, -1).argmax())
            consumed[pick] = True
            seed_idx = int(seed_indices[pick])
        member, plane, m, count = grow_one(labels, seed_idx)
        attempts += 1
        accept = count >= config.min_region_inliers
        label_val = num_regions + initial_id_offset if accept else EXAMINED
        labels = torch.where(member, label_val, labels)
        if not accept:
            continue
        sol = plane_fit.solve(m._replace(normal_hint=plane[:3]))
        planes[num_regions] = torch.where(sol.valid, sol.plane, plane)
        centroids[num_regions] = sol.centroid
        curvatures[num_regions] = sol.curvature
        counts[num_regions] = count
        seeds_out[num_regions] = seed_idx
        for field in plane_fit.PlaneMoments._fields:
            getattr(moments, field)[num_regions] = getattr(m, field)
        num_regions += 1
    with profiling.blocking("sharded.result", 2):
        return PlanarRegions(
            labels=torch.where(labels == EXAMINED, UNLABELED, labels),
            num_regions=torch.tensor(num_regions, dtype=torch.int32,
                                     device=dev),
            planes=planes, centroids=centroids, curvatures=curvatures,
            counts=counts, seed_indices=seeds_out, moments=moments,
            overflow=torch.tensor(attempts >= max_attempts
                                  or num_regions >= r_cap, device=dev))


def _sharded_flood_packed(gate, sources, comm: Comm, rounds,
                          global_rounds=16, impl=None):
    """Cross-block flood of bool masks [..., K, H, W_local] on packed word
    planes: per global round the local flood to its fixed point (B3 on
    the card, capped at ``rounds``), then a one-column halo exchange ORs
    the boundary reach into the neighbours; rounds repeat while any rank's
    words changed (a psum), at most ``global_rounds``, and a last local
    flood spreads the final exchange's edge cells."""
    shape = gate.shape
    k, h, w = shape[-3:]
    nw = -(-k // 32)
    g = flood_packed.pack_bits(gate.reshape(-1, k, h, w)).reshape(-1, h, w)
    reach0 = flood_packed.pack_bits((sources & gate).reshape(-1, k, h, w)) \
        .reshape(-1, h, w)

    def local_flood(reach):
        return flood_packed.flood_packed(g, reach, rounds, impl=impl)

    def exchange(reach):
        padded = exchange_halo(reach, 1, comm, fill=0, dim=2)
        reach = reach.clone()
        reach[..., 0] |= padded[..., 0] & g[..., 0]
        reach[..., -1] |= padded[..., -1] & g[..., -1]
        return reach

    def changed(reach, prev):
        with profiling.blocking("sharded.flood"):
            return int(comm.psum((reach != prev).sum(dtype=torch.int32))) > 0

    prev, reach = reach0, exchange(local_flood(reach0))
    it = 1
    while it < global_rounds and changed(reach, prev):
        prev, reach = reach, exchange(local_flood(reach))
        it += 1
    out = local_flood(reach)
    return flood_packed.unpack_bits(out.reshape(-1, nw, h, w), k) \
        .reshape(shape)


class _ShardedGrowerBackend(pb.GrowerBackend):
    """Column-sharded hooks of the batched grower (models/planar_batched.
    GrowerBackend): collectives of the Comm, the cross-block flood, ring
    dilation by one-column halos and owner-resolved cell gathers."""

    def __init__(self, comm: Comm, w_total, w_local, impl=None):
        super().__init__(impl)
        self.comm = comm
        self.w_total = w_total
        self.col0 = comm.rank * w_local

    def psum(self, x):
        return self.comm.psum(x)

    def pmin(self, x):
        return self.comm.pmin(x)

    def pmax(self, x):
        return self.comm.pmax(x)

    def flood(self, gate, src, rounds):
        return _sharded_flood_packed(gate, src, self.comm, rounds,
                                     impl=self.impl)

    def dilate_rings(self, members, gate, n):
        m = members & gate
        for _ in range(n):
            m = m | (_dilate4_halo(m, self.comm) & gate)
        return m

    def dilate4(self, members):
        return members | _dilate4_halo(members, self.comm)

    def gather_cells(self, points, normals, lin_idx):
        h, wl = points.shape[1:3]
        bidx = torch.arange(points.shape[0], device=points.device)[:, None]
        r = (lin_idx % h).long()
        c_l = (lin_idx // h).clamp(0, self.w_total - 1) - self.col0
        owned = ((c_l >= 0) & (c_l < wl))[..., None]
        c_s = c_l.clamp(0, wl - 1).long()
        # NaN would poison the psum; only finite seeds are gathered
        pt = torch.where(owned, nansafe.sanitize(points[bidx, r, c_s]), 0.0)
        nm = torch.where(owned, nansafe.sanitize(normals[bidx, r, c_s]), 0.0)
        return self.comm.psum(pt), self.comm.psum(nm)


def sharded_grow_planar_regions_batched(
        points_local, normals_local, labels_local, seed_indices, seed_valid,
        config: PlanarRegionConfig, h, w, comm: Comm,
        initial_id_offset: int = 0, **grower_kwargs) -> PlanarRegions:
    """Column-sharded batched grower: the single-device grower
    (models/planar_batched.grow_planar_regions_batched) with the sharded
    hooks, so one and many devices run the same algorithm. The other
    arguments of the grower pass through ``grower_kwargs``
    (``seed_rank_grid`` [H, W_local], the schedule, ``impl``); without a
    rank grid the grower ranks the GLOBAL seed vector into the block.
    Labels come back as the local block; the tables are replicated. The
    moment sums merge in f64 before their rounding to f32, so the shards'
    partials add to the single-device sums up to f64 rounding."""
    del h  # the block's rows; kept for JAX's signature
    bk = _ShardedGrowerBackend(comm, w, points_local.shape[1],
                               grower_kwargs.get("impl"))
    return pb.grow_planar_regions_batched(
        points_local, normals_local, labels_local, seed_indices, seed_valid,
        config, initial_id_offset, backend=bk, **grower_kwargs)


def sharded_connected_components(points_local, eligible_local,
                                 squared_threshold, half_window, h, w,
                                 comm: Comm, max_rounds=128, uf_rounds=16,
                                 impl=None):
    """Column-sharded gated CCL by boundary-pair unification.

    1. The local gated CCL of the block on GLOBAL col-major labels with the
       global sentinel H*W (B2 on the card; no communication).
    2. The equivalence pairs (local root, neighbour root) of every gated
       window edge that crosses to the right neighbour's block, from one
       halo of ``half_window`` columns (the leftward edges are the left
       neighbour's rightward ones).
    3. One all_gather of the pairs, then a replicated union-find over an
       [H*W + 1] parent table (scatter-min unions and two pointer jumps per
       round, while it changes, at most ``uf_rounds``) and a remap of the
       local labels. The union's minimum is the component's global
       minimum, so the roots equal the single-device CCL's.

    Returns [H, W_local] int32 roots, H*W where ineligible."""
    w_local = points_local.shape[1]
    hw = h * w
    big = hw
    k = half_window
    dev = points_local.device
    rows, cols = _global_cols(h, w_local, comm, dev)
    labels = connectivity.connected_components_scan(
        points_local, eligible_local, squared_threshold, k,
        rounds=max_rounds, init_labels=cols * h + rows, big_value=hw,
        impl=impl)

    pp = exchange_halo(points_local, k, comm, fill=float("nan"))
    ep = exchange_halo(eligible_local, k, comm, fill=False)
    lp = exchange_halo(labels, k, comm, fill=big)
    src_pts = points_local[:, w_local - k:]
    src_lab = labels[:, w_local - k:]
    src_ok = eligible_local[:, w_local - k:]
    with profiling.blocking("clusters.threshold"):
        thr = torch.tensor(squared_threshold, dtype=points_local.dtype,
                           device=dev)
    strip = torch.arange(k, device=dev)[None, :]
    pair_a, pair_b = [], []
    for dc in range(1, k + 1):
        for dr in range(-k, k + 1):
            # the target (r + dr, c + dc) of the last k local columns; in
            # padded coordinates that strip starts at w_local
            dst_pts = _shift_hw(pp, dr, dc, float("nan"))[:, w_local:w_local + k]
            dst_lab = _shift_hw(lp, dr, dc, big)[:, w_local:w_local + k]
            dst_ok = _shift_hw(ep, dr, dc, False)[:, w_local:w_local + k]
            d = dst_pts - src_pts
            d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
                + d[..., 2] * d[..., 2]
            ok = (d2 < thr) & src_ok & dst_ok & (strip + dc >= k)
            pair_a.append(torch.where(ok, src_lab, big).reshape(-1))
            pair_b.append(torch.where(ok, dst_lab, big).reshape(-1))
    a_all = comm.all_gather(torch.cat(pair_a)).reshape(-1)
    b_all = comm.all_gather(torch.cat(pair_b)).reshape(-1)
    valid = (a_all < hw) & (b_all < hw)
    ia = torch.where(valid, a_all.clamp(0, hw - 1), hw).long()
    ib = torch.where(valid, b_all.clamp(0, hw - 1), hw).long()

    def uf_round(parent):
        pa = parent[ia]
        pb_ = parent[ib]
        m = torch.where(valid, torch.minimum(pa, pb_), hw)
        parent = parent.scatter_reduce(0, pa.long(), m, "amin")
        parent = parent.scatter_reduce(0, pb_.long(), m, "amin")
        parent = parent[parent.long()]
        return parent[parent.long()]

    def changed(parent, prev):
        with profiling.blocking("sharded.union_find"):
            return bool((parent != prev).any())

    prev = torch.arange(hw + 1, dtype=torch.int32, device=dev)
    parent = uf_round(prev)
    it = 1
    while it < uf_rounds and changed(parent, prev):
        prev, parent = parent, uf_round(parent)
        it += 1
    remapped = parent[labels.clamp(0, hw).long()]
    return torch.where(eligible_local, remapped, big)


class ShardedStepResult(NamedTuple):
    labels: torch.Tensor        # [H, W_local] combined labels of the block
    normals: torch.Tensor       # [H, W_local, 3]
    planar: PlanarRegions       # replicated tables, labels of the block
    num_clusters: torch.Tensor  # int32 scalar


def build_sharded_segment_step(
        comm: Comm, normals_params=ComputeNormalsParams(),
        seed_params=SeedsFromPlaneSupportParams(),
        planar_config=PlanarRegionConfig(),
        cluster_config=ClusterRegionConfig(), max_attempts: int = 64,
        impl=None):
    """(points_local [H, W_local, 3], sensor_origin [3]) -> ShardedStepResult
    on ``comm.device``: normals, seed ranking, planar growth and euclidean
    clustering over the column blocks. ``growth_mode="batched"`` grows with
    the batched grower on the dense rank grid; the other modes with the
    sequential wavefront (``max_attempts`` bounds its attempts).
    ``impl="plain"`` runs the kernels' plain versions (tests and the smoke
    script only). Each rank passes its own block; W = W_local * ranks."""

    def step(points_local, sensor_origin) -> ShardedStepResult:
        with profiling.request("sharded"):
            return run(points_local, sensor_origin)

    def run(points_local, sensor_origin):
        pts = profiling.to_device(points_local, torch.float32, comm.device)
        origin = profiling.to_device(sensor_origin, torch.float32,
                                     comm.device)
        h, w_local = pts.shape[:2]
        w = w_local * comm.size
        with profiling.stage("normals"):
            nrm = sharded_normals(pts, origin, normals_params, comm,
                                  impl=impl)
        labels0 = torch.full((h, w_local), UNLABELED, dtype=torch.int32,
                             device=comm.device)
        if planar_config.growth_mode == "batched":
            with profiling.stage("seeds"):
                rank_grid = sharded_plane_support_rank_grid(
                    pts, nrm, seed_params, h, w, comm)
            with profiling.stage("grower"):
                regions = sharded_grow_planar_regions_batched(
                    pts, nrm, labels0, None, None, planar_config, h, w,
                    comm, seed_rank_grid=rank_grid, impl=impl)
        else:
            with profiling.stage("seeds"):
                seed_idx, seed_valid = sharded_plane_support_seeds(
                    pts, nrm, seed_params, h, w, comm)
            with profiling.stage("grower"):
                regions = sharded_grow_planar_regions(
                    pts, nrm, labels0, seed_idx, seed_valid, planar_config,
                    h, w, comm, 0, max_attempts)
        with profiling.stage("clusters"):
            return clusters(pts, nrm, regions, h, w)

    def clusters(pts, nrm, regions, h, w):
        eligible = (regions.labels == UNLABELED) & nansafe.all_finite(pts)
        roots = sharded_connected_components(
            pts, eligible, cluster_config.squared_distance_threshold,
            cluster_config.half_search_window, h, w, comm, impl=impl)
        # component sizes by global root, merged with one psum of the
        # [H*W] table; dense ids in ascending root order
        hw = h * w
        sizes = torch.zeros(hw + 1, dtype=torch.int32, device=comm.device)
        sizes.scatter_add_(0, roots.reshape(-1).long(),
                           eligible.to(torch.int32).reshape(-1))
        sizes = comm.psum(sizes[:hw])
        accepted = sizes >= cluster_config.min_region_inliers
        order = torch.cumsum(accepted.to(torch.int32), 0,
                             dtype=torch.int32) - 1
        roots_safe = roots.clamp(0, hw - 1).long()
        cluster_id = torch.where((roots < hw) & eligible
                                 & accepted[roots_safe], order[roots_safe],
                                 -1)
        combined = torch.where(cluster_id >= 0,
                               cluster_id + regions.num_regions,
                               regions.labels).to(torch.int32)
        return ShardedStepResult(
            labels=combined, normals=nrm, planar=regions,
            num_clusters=accepted.sum(dtype=torch.int32))

    return step
