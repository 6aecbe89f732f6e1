"""Batched planar region growing — all regions of all frames at once (port
of pcseg_tpu.models.planar_batched, single-device path).

K = ``max_regions`` slots per frame; each holds a founder seed, its pop
rank, a plane, a sticky orientation hint and a member mask. Region identity
follows the seed rank grid: a slot's rank is the best rank among its
members' seed cells and conflicts resolve to the best rank (see the JAX
module for the full semantics map to segmentation.h / planar_region.h).

  * Stage A: 13 generations of 2 gated 4-neighbourhood rings with a refit
    at every 30-inlier crossing. On grids of at least 64x64 and 16384
    cells it runs on 64x64 patches around each slot's founder
    (``stage_a_patched``); below that on the full grid
    (``generation``/``settle``) — the same switch as JAX.
  * Stage B: closure epochs under Chebyshev boxes growing by 4/3 per
    epoch, then unboxed epochs. With K <= 32 each epoch is one call of the
    epoch kernel (kernels/epoch_word.py) on the packed member word, as JAX
    runs it on a TPU; with K > 32 (more slots than a word has bits) each
    epoch builds the slots' gates, floods them from the anchors on packed
    word planes (kernels/flood_packed.py) and settles the claims, as JAX's
    ``epoch``. A frame freezes once an unboxed epoch leaves its members
    unchanged (JAX's while_loop under vmap); frozen frames keep their state
    while the others go on.
  * Tail: degenerate (collinear) slots dissolve into an adjacent robust
    slot covering >= 90% of their members; final claims, acceptance and
    dense ids in rank order.

Every tensor carries a leading frame axis ``B``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from pcseg_tpu_torch.kernels import epoch_word, flood_packed
from pcseg_tpu_torch.kernels.common import shift2
from pcseg_tpu_torch.models.config import UNLABELED, PlanarRegionConfig
from pcseg_tpu_torch.ops import geom, nansafe, plane_fit

# Rank sentinel for "not a seed" / dead slot (== ops.seeds.SEED_RANK_INF).
INF_RANK = 2 ** 30
BIG_LIN = 2 ** 30
N_TILES_AXIS = 8
PATCH = 64
# growth schedule (the JAX defaults): stage A = 13 generations of 2 rings,
# then 2 unboxed closure epochs after the boxed ones, <= 64 flood rounds
STAGE_A_GENS = 13
STAGE_A_RINGS = 2
CLOSURE_EPOCHS = 2
FLOOD_ROUNDS = 64


class PlanarRegions(NamedTuple):
    """Bounded per-frame region table (capacity K = max_regions)."""
    labels: torch.Tensor       # [B, H, W] int32 final device labels
    num_regions: torch.Tensor  # [B] int32 device-accepted count
    planes: torch.Tensor       # [B, K, 4] plane coeffs of the final fit
    centroids: torch.Tensor    # [B, K, 3]
    curvatures: torch.Tensor   # [B, K]
    counts: torch.Tensor       # [B, K] int32 inlier counts
    seed_indices: torch.Tensor  # [B, K] int32 col-major seed index
    moments: plane_fit.PlaneMoments  # batched [B, K]
    overflow: torch.Tensor     # [B] bool: a qualified seed left ungrown


class _Slots(NamedTuple):
    seed_idx: torch.Tensor   # [B, K] int32 col-major seed index
    rank: torch.Tensor       # [B, K] int32 pop priority (smaller = earlier)
    alive: torch.Tensor      # [B, K] bool
    plane: torch.Tensor      # [B, K, 4]
    hint: torch.Tensor       # [B, K, 3] sticky normal orientation
    members: torch.Tensor    # [B, K, H, W] bool (None in the word epochs)
    fit_count: torch.Tensor  # [B, K] int32 member count at the last refit


def _where(mask, a, b):
    """torch.where with ``mask`` [B, K] broadcast over trailing dims."""
    while mask.dim() < a.dim():
        mask = mask[..., None]
    return torch.where(mask, a, b)


def _select_frames(active, new: _Slots, old: _Slots) -> _Slots:
    """Per-frame select: frames with ``active`` take ``new``."""
    return _Slots(*[None if n is None else _where(active[:, None], n, o)
                    for n, o in zip(new, old)])


def rank_grid_from_seed_vector(seed_indices, seed_valid, h, w,
                               w_local=None, col0=0):
    """[B, H, W] int32 pop-rank grid from ranked seed vectors [B, S] (the
    reference's grow loop pops back-to-front, so the LAST entry gets rank
    0). ``w`` is the GLOBAL column count; ``w_local``/``col0`` carve out a
    column shard ([B, H, W_local]; default the whole grid)."""
    b, s = seed_indices.shape
    dev = seed_indices.device
    w_local = w if w_local is None else w_local
    rank = ((s - 1) - torch.arange(s, dtype=torch.int32, device=dev)) \
        .expand(b, s)
    ok = seed_valid & (seed_indices >= 0) & (seed_indices < h * w)
    c_local = torch.div(seed_indices, h, rounding_mode="floor") - col0
    ok = ok & (c_local >= 0) & (c_local < w_local)
    flat_cm = torch.full((b, h * w_local), INF_RANK, dtype=torch.int32,
                         device=dev)
    flat_cm.scatter_reduce_(
        1, (c_local.clamp(0, w_local - 1) * h + seed_indices % h).long(),
        torch.where(ok, rank, INF_RANK), "amin")
    return flat_cm.reshape(b, w_local, h).transpose(1, 2).contiguous()


def _dilate4(m):
    """The 4-neighbourhood ring around bool masks [..., H, W]."""
    return (shift2(m, 1, 0, False) | shift2(m, -1, 0, False)
            | shift2(m, 0, 1, False) | shift2(m, 0, -1, False))


def _plane_dist(plane, px, py, pz):
    """|a x + b y + c z + d| for planes [..., 4] broadcast against point
    components; the kernel's evaluation order."""
    return (px * plane[..., 0, None, None] + py * plane[..., 1, None, None]
            + pz * plane[..., 2, None, None] + plane[..., 3, None, None]).abs()


def _moment_features(px, py, pz):
    """[..., 10] f32 per-cell moment terms (products rounded to f32)."""
    return torch.stack([px * px, px * py, px * pz, py * py, py * pz,
                        pz * pz, px, py, pz, torch.ones_like(px)], dim=-1)


def _masked_moments(mask, feat, psum=None):
    """Moment sums of the cells in ``mask`` [B, K, N] over features
    [B, N, 10] (or [B, K, N, 10]): f64 sums rounded to f32, like the
    epoch kernel. ``psum`` merges a column shard's f64 sums across the
    shards before the rounding."""
    f64 = feat.to(torch.float64)
    m64 = mask.to(torch.float64)
    if feat.dim() == 3:
        sums = torch.bmm(m64, f64)
    else:
        sums = torch.einsum("bkn,bknf->bkf", m64, f64)
    if psum is not None:
        sums = psum(sums)
    return sums.to(torch.float32)


def flood_fill_static(gate, sources, rounds, max_run=None, impl=None):
    """The 4-connected flood of ``sources`` through ``gate``, every slot on
    its own: bool [K, H, W] (JAX's signature) or [B, K, H, W] in, the
    reached cells out, same shape. The slots are packed into int32 word
    planes (bit k % 32 of plane k // 32) and flooded by B3
    (kernels/flood_packed.py): one cooperative launch for the whole stack
    on the card, the plain version on the CPU. A round spreads along the
    rows, then the columns; rounds repeat to the fixed point, at most
    ``rounds``, the first one always.

    ``max_run`` is kept for JAX's signature and not read: JAX's scans
    double up to that bound on the longest gate run, which its docstring
    makes the caller's promise, while the port scans whole runs. Wherever
    the promise holds the result is JAX's."""
    del max_run
    batched = gate.dim() == 4
    if not batched:
        gate, sources = gate[None], sources[None]
    b, k, h, w = gate.shape
    nw = -(-k // 32)
    reach = flood_packed.flood_packed(
        flood_packed.pack_bits(gate).reshape(b * nw, h, w),
        flood_packed.pack_bits(sources & gate).reshape(b * nw, h, w),
        rounds, impl=impl)
    out = flood_packed.unpack_bits(reach.reshape(b, nw, h, w), k)
    return out if batched else out[0]


class GrowerBackend:
    """The hooks of :func:`grow_planar_regions_batched` that differ between
    one device and a column shard (JAX's GrowerBackend contract;
    parallel/sharded.py gives the sharded ones). Masks are
    [B, K, H, W_local] bool; slot tables are replicated. These defaults
    are the single-device grower's own operations."""

    w_total = None  # global column count (None: the local one)
    col0 = 0        # global column of local column 0

    def __init__(self, impl=None):
        self.impl = impl

    def psum(self, x):
        """Sum a replicated-shape value across the shards."""
        return x

    def pmin(self, x):
        return x

    def pmax(self, x):
        return x

    def flood(self, gate, src, rounds):
        """The 4-connected flood of ``src`` through ``gate``
        (:func:`flood_fill_static`, B3)."""
        return flood_fill_static(gate, src, rounds, impl=self.impl)

    def dilate_rings(self, members, gate, n):
        """``n`` rings of gated 4-neighbourhood dilation."""
        m = members & gate
        for _ in range(n):
            m = m | (_dilate4(m) & gate)
        return m

    def dilate4(self, members):
        """The members and their ungated 4-neighbourhood ring."""
        return members | _dilate4(members)

    def gather_cells(self, points, normals, lin_idx):
        """(points, normals) [B, K, 3] at global col-major ``lin_idx``
        [B, K]."""
        h, w = points.shape[1:3]
        bidx = torch.arange(points.shape[0], device=points.device)[:, None]
        r = (lin_idx % h).long()
        c = (lin_idx // h).clamp(0, w - 1).long()
        return points[bidx, r, c], normals[bidx, r, c]


def grow_planar_regions_batched(
        points: torch.Tensor, normals: torch.Tensor, labels: torch.Tensor,
        seed_rank_grid: torch.Tensor,
        config: PlanarRegionConfig = PlanarRegionConfig(),
        impl=None, backend: GrowerBackend = None) -> PlanarRegions:
    """Batched planar growth over [B, H, W, 3] points/normals, [B, H, W]
    int32 input labels and the [B, H, W] int32 seed rank grid
    (ops/seeds.py). ``impl="plain"`` forces the epoch and flood kernels'
    plain versions (tests and the smoke script only).

    ``backend`` (a :class:`GrowerBackend`, parallel/sharded.py) grows a
    column shard: W is then the local column count, the slot tables come
    out replicated, and the grower takes JAX's sharded branches: tile
    winners from per-shard minima, stage A on the full grid (no patches)
    and the flood epochs at any K (never the epoch kernel)."""
    b, h, w = points.shape[:3]   # w: the LOCAL column count
    bk = backend if backend is not None else GrowerBackend(impl)
    w_total = w if bk.w_total is None else bk.w_total
    col0 = bk.col0
    hw = h * w
    dev = points.device
    dtype = points.dtype
    k_cap = config.max_regions
    tau = config.max_plane_distance
    period = int(config.plane_model_reestimation_period)
    bidx = torch.arange(b, device=dev)[:, None]

    finite_pts = nansafe.all_finite(points)
    eligible0 = (labels == UNLABELED) & finite_pts
    cell_ok = eligible0 & nansafe.all_finite(normals)
    rank_grid = torch.where(cell_ok, seed_rank_grid, INF_RANK) \
        .to(torch.int32)
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    pts_safe = nansafe.sanitize(points)
    feat = _moment_features(pts_safe[..., 0], pts_safe[..., 1],
                            pts_safe[..., 2]).reshape(b, hw, 10)

    hint0 = torch.zeros((b, k_cap, 3), dtype=dtype, device=dev)
    hint0[..., 0] = 1.0
    slots = _Slots(
        seed_idx=torch.zeros((b, k_cap), dtype=torch.int32, device=dev),
        rank=torch.full((b, k_cap), INF_RANK, dtype=torch.int32, device=dev),
        alive=torch.zeros((b, k_cap), dtype=torch.bool, device=dev),
        plane=torch.zeros((b, k_cap, 4), dtype=dtype, device=dev),
        hint=hint0,
        members=torch.zeros((b, k_cap, h, w), dtype=torch.bool, device=dev),
        fit_count=torch.zeros((b, k_cap), dtype=torch.int32, device=dev))

    def gather_cells(lin_idx):
        """(points, normals) [B, K, 3] at col-major ``lin_idx`` [B, K]."""
        return bk.gather_cells(points, normals, lin_idx)

    def solve_with_hint(sums, hint):
        m = plane_fit.PlaneMoments(s2=sums[..., :6], s1=sums[..., 6:9],
                                   w=sums[..., 9], normal_hint=hint)
        return m, plane_fit.solve(m)

    def apply_refit(slots, counts, sol):
        """The 30-inlier re-estimation cadence (planar_region.h:172-177):
        refit only when the count crosses a multiple of the period; a
        degenerate fit recentres the sticky normal on the centroid."""
        crossing = slots.alive & (torch.div(counts, period, rounding_mode="floor")
                                  > torch.div(slots.fit_count, period,
                                              rounding_mode="floor"))
        recentered = geom.plane_from_normal_point(slots.hint, sol.centroid)
        fit_plane = _where(sol.valid, sol.plane, recentered)
        return slots._replace(
            plane=_where(crossing, fit_plane, slots.plane),
            hint=_where(crossing & sol.valid, sol.normal, slots.hint),
            fit_count=torch.where(crossing, counts, slots.fit_count))

    def reanchor(slots, alive, member_rank, new_seed_idx):
        """Slot update after claims: rank := best member seed rank, the
        anchor moves to that seed; the hint and seed plane re-anchor only
        when the founder changed."""
        anchor_changed = alive & (new_seed_idx != slots.seed_idx)
        a_pt, a_nm = gather_cells(new_seed_idx)
        anchor_n = _where(anchor_changed, a_nm, slots.hint)
        seed_plane = geom.plane_from_normal_point(anchor_n, a_pt)
        return slots._replace(
            alive=alive,
            rank=torch.where(alive, member_rank, INF_RANK),
            seed_idx=new_seed_idx, hint=anchor_n,
            plane=_where(anchor_changed, seed_plane, slots.plane),
            fit_count=torch.where(anchor_changed, 0, slots.fit_count))

    # --- founders: best uncovered seed per 8x8 tile of the grid ----------
    th = -(-h // N_TILES_AXIS)
    tw = -(-w_total // N_TILES_AXIS)
    n_tiles = N_TILES_AXIS * N_TILES_AXIS
    hp, wp = N_TILES_AXIS * th, N_TILES_AXIS * tw
    rows_g = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    # global columns (a shard's start at col0)
    cols_g = torch.arange(w, dtype=torch.int32, device=dev)[None, :] + col0
    lin_grid = cols_g * h + rows_g
    tile_id = ((rows_g // th) * N_TILES_AXIS + cols_g // tw) \
        .reshape(-1).long().expand(b, hw)

    def tile_winners(avail_rank):
        """Per tile, the (rank, col-major index) of its best seed:
        ([B, 64], [B, 64])."""
        if backend is not None:
            # per-shard minima over the global tiles, combined with pmin;
            # the rank holder is unique, so the min index among the cells
            # attaining the tile's rank is the winner's cell
            def smin(vals, fill):
                out = torch.full((b, n_tiles), fill, dtype=torch.int32,
                                 device=dev)
                return bk.pmin(out.scatter_reduce(1, tile_id, vals, "amin"))
            flat = avail_rank.reshape(b, hw)
            val = smin(flat, INF_RANK)
            att = torch.where(flat == torch.gather(val, 1, tile_id),
                              lin_grid.reshape(1, hw), BIG_LIN)
            return val, smin(att, BIG_LIN)

        def tmin(g, fill):
            gp = torch.nn.functional.pad(g, (0, wp - w, 0, hp - h),
                                         value=fill)
            return gp.reshape(b, N_TILES_AXIS, th, N_TILES_AXIS, tw) \
                .amin(dim=(2, 4))
        val_t = tmin(avail_rank, INF_RANK)
        val_b = val_t.repeat_interleave(th, 1).repeat_interleave(tw, 2)[
            :, :h, :w]
        idx_t = tmin(torch.where(avail_rank == val_b, lin_grid, BIG_LIN),
                     BIG_LIN)
        return val_t.reshape(b, -1), idx_t.reshape(b, -1)

    def pick_founders(slots, covered):
        """Dead slots take the best-ranked uncovered seeds of distinct
        tiles, best tiles first. Returns (newly [B, K], seed, rank)."""
        avail_rank = torch.where(covered, INF_RANK, rank_grid)
        cand_rank_t, cand_idx_t = tile_winners(avail_rank)
        order = torch.argsort(cand_rank_t, dim=1, stable=True)
        cand_rank = torch.gather(cand_rank_t, 1, order)
        cand_idx = torch.gather(cand_idx_t, 1, order)
        free = ~slots.alive
        free_pos = torch.cumsum(free.to(torch.int32), 1, dtype=torch.int32) - 1
        take = free & (free_pos < n_tiles)
        pick = free_pos.clamp(0, n_tiles - 1).long()
        newly = take & (torch.gather(cand_rank, 1, pick) < INF_RANK)
        new_seed = torch.where(newly, torch.gather(cand_idx, 1, pick),
                               slots.seed_idx)
        new_rank = torch.where(newly, torch.gather(cand_rank, 1, pick),
                               slots.rank)
        return newly, new_seed, new_rank

    def found(slots, newly, new_seed, new_rank):
        npt, nnm = gather_cells(new_seed)
        plane0 = geom.plane_from_normal_point(nnm, npt)
        return slots._replace(
            seed_idx=new_seed, rank=new_rank, alive=slots.alive | newly,
            plane=_where(newly, plane0, slots.plane),
            hint=_where(newly, nnm, slots.hint),
            fit_count=torch.where(newly, 0, slots.fit_count))

    def onehot(lin_idx):
        """[B, K, H, W] one-hot of global col-major cells (nothing where
        a shard does not own the cell)."""
        oh = torch.zeros((b, k_cap, h, w), dtype=torch.bool, device=dev)
        kk = torch.arange(k_cap, device=dev)[None]
        c = (lin_idx // h).clamp(0, w_total - 1) - col0
        oh[bidx, kk, (lin_idx % h).long(), c.clamp(0, w - 1).long()] = \
            (c >= 0) & (c < w)
        return oh

    # --- full-grid stage A (small grids) ---------------------------------
    def claims_of(members, rank):
        """Per pixel the member slot with min rank: (claim [B, H, W] in
        [0, K] (K = none), members')."""
        rg = torch.where(members, rank[..., None, None], INF_RANK)
        best, claim = rg.min(dim=1)
        claim = torch.where(best < INF_RANK, claim, k_cap).to(torch.int32)
        kk = torch.arange(k_cap, dtype=torch.int32, device=dev)
        return claim, members & (claim[:, None] == kk[None, :, None, None])

    def refit_moments(slots):
        mask = slots.members.reshape(b, k_cap, hw)
        sums = _masked_moments(mask, feat) if backend is None \
            else _masked_moments(mask, feat, bk.psum)
        return solve_with_hint(sums, slots.hint)

    def settle(slots, new_members):
        _, new_members = claims_of(new_members, slots.rank)
        counts = bk.psum(new_members.sum(dim=(2, 3), dtype=torch.int32))
        masked_rank = torch.where(new_members, rank_grid[:, None], INF_RANK)
        local_min, best_flat = masked_rank.reshape(b, k_cap, hw).min(dim=2)
        member_rank = bk.pmin(local_min)
        alive = slots.alive & (counts > 0) & (member_rank < INF_RANK)
        br = torch.div(best_flat, w, rounding_mode="floor")
        bc = best_flat % w + col0
        # the rank holder is unique: exactly one shard attains the min
        anchor_lin = bk.pmin(torch.where(
            (local_min == member_rank) & (member_rank < INF_RANK),
            bc * h + br, BIG_LIN).to(torch.int32))
        new_seed_idx = torch.where(alive, anchor_lin, slots.seed_idx)
        slots = reanchor(slots, alive, member_rank, new_seed_idx)
        slots = slots._replace(members=new_members & alive[..., None, None])
        _, sol = refit_moments(slots)
        return apply_refit(slots, counts, sol)

    def assign(slots):
        """Founders for the dead slots; a new founder's members are its
        one-hot."""
        newly, new_seed, new_rank = pick_founders(slots,
                                                  slots.members.any(dim=1))
        slots = found(slots, newly, new_seed, new_rank)
        return slots._replace(members=_where(newly, onehot(new_seed),
                                             slots.members))

    def slot_gate(slots):
        """[B, K, H, W] inlier gates: within tau of the slot's plane,
        eligible, not claimed by a better-ranked slot, slot alive; members
        always pass (membership is monotone)."""
        members = slots.members
        claim_rank = torch.where(members, slots.rank[..., None, None],
                                 INF_RANK).amin(dim=1)
        dist = _plane_dist(slots.plane, px[:, None], py[:, None], pz[:, None])
        return ((dist < tau) & eligible0[:, None]
                & (claim_rank[:, None] >= slots.rank[..., None, None])
                & slots.alive[..., None, None]) | members

    def generation(slots):
        slots = assign(slots)
        gate = slot_gate(slots)
        m = bk.dilate_rings(slots.members | onehot(slots.seed_idx), gate,
                            STAGE_A_RINGS)
        return settle(slots, m)

    def flood_epoch(slots, radius):
        """One closure epoch for K > 32, or at any K with a backend (JAX's
        ``epoch``): the gates cut to the Chebyshev box of ``radius`` around
        each anchor (members always pass), flooded from the anchors on
        packed word planes, then settled."""
        slots = assign(slots)
        ar = (slots.seed_idx % h)[..., None, None]
        ac = (slots.seed_idx // h).clamp(0, w_total - 1)[..., None, None]
        inbox = ((rows_g - ar).abs() <= radius) & ((cols_g - ac).abs()
                                                   <= radius)
        gate = slot_gate(slots) & (inbox | slots.members)
        return settle(slots, bk.flood(gate, onehot(slots.seed_idx),
                                      FLOOD_ROUNDS))

    # --- patched stage A (grids >= 64x64 and >= 4 patches) ---------------
    span = STAGE_A_GENS * STAGE_A_RINGS
    use_patches = (backend is None and h >= PATCH and w >= PATCH
                   and hw >= 4 * PATCH * PATCH
                   and PATCH // 2 - span - STAGE_A_RINGS >= 1)

    def stage_a_patched(slots):
        half = PATCH // 2
        ar_p = torch.arange(PATCH, device=dev)
        kk = torch.arange(k_cap, device=dev)[None]

        def patch_index(orr, orc):
            """([B, K, P, 1], [B, K, 1, P]) grid rows/cols of each patch."""
            return ((orr[..., None] + ar_p)[..., :, None].long(),
                    (orc[..., None] + ar_p)[..., None, :].long())

        def gather(grid, orr, orc):
            r, c = patch_index(orr, orc)
            return grid[bidx[..., None, None], r, c]

        def stamp_owner(orr, orc, mem_p, rank, alive):
            """[B, H, W] min rank over the slots' patch members (min is
            order-free, so one scatter_reduce replaces JAX's sequential
            per-slot window stamps)."""
            r, c = patch_index(orr, orc)
            flat = (bidx[..., None, None] * hw + r * w + c)
            vals = torch.where(mem_p & alive[..., None, None],
                               rank[..., None, None], INF_RANK)
            owner = torch.full((b * hw,), INF_RANK, dtype=torch.int32,
                               device=dev)
            owner.scatter_reduce_(0, flat.reshape(-1), vals.reshape(-1),
                                  "amin")
            return owner.reshape(b, h, w)

        orr = torch.zeros((b, k_cap), dtype=torch.int32, device=dev)
        orc = torch.zeros_like(orr)
        mem_p = torch.zeros((b, k_cap, PATCH, PATCH), dtype=torch.bool,
                            device=dev)
        for _ in range(STAGE_A_GENS):
            owner = stamp_owner(orr, orc, mem_p, slots.rank, slots.alive)
            newly, new_seed, new_rank = pick_founders(slots, owner < INF_RANK)
            nr = new_seed % h
            nc = (new_seed // h).clamp(0, w - 1)
            slots = found(slots, newly, new_seed, new_rank)
            orr = torch.where(newly, (nr - half).clamp(0, h - PATCH), orr)
            orc = torch.where(newly, (nc - half).clamp(0, w - PATCH), orc)
            oh = torch.zeros_like(mem_p)
            oh[bidx, kk, (nr - orr).clamp(0, PATCH - 1).long(),
               (nc - orc).clamp(0, PATCH - 1).long()] = newly
            mem_p = _where(newly, oh, mem_p)

            pts_p = gather(points, orr, orc)           # [B, K, P, P, 3]
            elig_p = gather(eligible0, orr, orc)
            rank_p = gather(rank_grid, orr, orc)
            owner_p = gather(owner, orr, orc)
            dist = _plane_dist(slots.plane, pts_p[..., 0], pts_p[..., 1],
                               pts_p[..., 2])
            gate = ((dist < tau) & elig_p
                    & (owner_p >= slots.rank[..., None, None])
                    & slots.alive[..., None, None]) | mem_p

            ar = slots.seed_idx % h - orr
            ac = (slots.seed_idx // h).clamp(0, w - 1) - orc
            a_ok = (ar >= 0) & (ar < PATCH) & (ac >= 0) & (ac < PATCH)
            aoh = torch.zeros_like(mem_p)
            aoh[bidx, kk, ar.clamp(0, PATCH - 1).long(),
                ac.clamp(0, PATCH - 1).long()] = a_ok
            m = mem_p | (aoh & gate)
            for _ in range(STAGE_A_RINGS):
                m = m | (_dilate4(m) & gate)

            owner2 = stamp_owner(orr, orc, m, slots.rank, slots.alive)
            new_mem = m & (gather(owner2, orr, orc)
                           == slots.rank[..., None, None])
            counts = new_mem.sum(dim=(2, 3), dtype=torch.int32)
            masked_rank = torch.where(new_mem, rank_p, INF_RANK)
            member_rank, best_flat = masked_rank.reshape(
                b, k_cap, PATCH * PATCH).min(dim=2)
            alive = slots.alive & (counts > 0) & (member_rank < INF_RANK)
            br = orr + torch.div(best_flat, PATCH, rounding_mode="floor")
            bc = orc + best_flat % PATCH
            new_seed_idx = torch.where(alive, (bc * h + br).to(torch.int32),
                                       slots.seed_idx)
            slots = reanchor(slots, alive, member_rank, new_seed_idx)
            new_mem = new_mem & alive[..., None, None]

            pp = nansafe.sanitize(pts_p)
            feat_p = _moment_features(pp[..., 0], pp[..., 1], pp[..., 2]) \
                .reshape(b, k_cap, PATCH * PATCH, 10)
            sums = _masked_moments(new_mem.reshape(b, k_cap, -1), feat_p)
            _, sol = solve_with_hint(sums, slots.hint)
            slots = apply_refit(slots, counts, sol)
            mem_p = new_mem

        r, c = patch_index(orr, orc)
        members = torch.zeros((b, k_cap, h, w), dtype=torch.bool, device=dev)
        members[bidx[..., None, None], kk[..., None, None], r, c] = \
            mem_p & slots.alive[..., None, None]
        return slots._replace(members=members)

    if use_patches:
        slots = stage_a_patched(slots)
    else:
        for _ in range(STAGE_A_GENS):
            slots = generation(slots)

    # --- stage B: closure epochs ------------------------------------------
    radius = 2 * span
    radii = []
    while radius < max(h, w_total):
        radii.append(radius)
        radius = (radius * 4) // 3
    radii += [max(h, w_total)] * (CLOSURE_EPOCHS + 1)
    if k_cap <= 32 and backend is None:
        slots = run_word_epochs(
            slots, radii, points=points, rank_grid=rank_grid,
            eligible0=eligible0, pick_founders=pick_founders, found=found,
            reanchor=reanchor, solve_with_hint=solve_with_hint,
            apply_refit=apply_refit, tau=tau, impl=impl)
    else:
        first_full = _first_full(radii, h, w_total)
        active = torch.ones(b, dtype=torch.bool, device=dev)
        for i, radius in enumerate(radii):
            if i > 0 and not bool(active.any()):
                break
            new = flood_epoch(slots, radius)
            # replicated across the shards, so their loops stay in step
            stable = bk.psum((new.members != slots.members).flatten(1)
                             .sum(dim=1, dtype=torch.int32)) == 0
            slots = _select_frames(active, new, slots)
            if i >= first_full:
                active = active & ~stable

    # --- degenerate-attempt resolution -----------------------------------
    _, sol_r = refit_moments(slots)
    robust = slots.alive & sol_r.valid & (sol_r.mid_ratio >= 3e-3)
    mem_f = slots.members.reshape(b, k_cap, hw).to(torch.float64)
    counts_f = torch.clamp_min(bk.psum(mem_f.sum(dim=2)).to(torch.float32),
                               1.0)
    dil = bk.dilate4(slots.members).reshape(b, k_cap, hw).to(torch.float64)
    adj = bk.psum(torch.bmm(dil, mem_f.transpose(1, 2))) > 0
    band = (_plane_dist(slots.plane, px[:, None], py[:, None], pz[:, None])
            < tau).reshape(b, k_cap, hw).to(torch.float64)
    # cover[l, w] = share of loser l's members within tau of w's plane
    cover = bk.psum(torch.bmm(mem_f, band.transpose(1, 2))) \
        .to(torch.float32) / counts_f[..., None]
    loser = slots.alive & ~robust
    pair = loser[:, :, None] & robust[:, None, :] & adj & (cover >= 0.9)
    win = torch.where(pair, slots.rank[:, None, :], INF_RANK).min(dim=2)[1]
    has_win = pair.any(dim=2)
    kk = torch.arange(k_cap, device=dev)
    transfer = (win[:, None, :] == kk[None, :, None]) & has_win[:, None, :]
    gained = torch.bmm(transfer.to(torch.float64),
                       slots.members.reshape(b, k_cap, hw).to(torch.float64)
                       ).reshape(b, k_cap, h, w) > 0
    dissolved = loser & has_win
    slots = slots._replace(
        members=_where(robust, slots.members | gained, slots.members)
        & ~dissolved[..., None, None],
        alive=slots.alive & ~dissolved)

    # --- final claims, acceptance, dense ids in rank order ---------------
    claim, members = claims_of(slots.members, slots.rank)
    counts = bk.psum(members.sum(dim=(2, 3), dtype=torch.int32))
    accepted = slots.alive & (counts >= config.min_region_inliers)
    order = torch.argsort(torch.where(accepted, slots.rank, INF_RANK), dim=1,
                          stable=True)
    acc_sorted = torch.gather(accepted, 1, order)
    dense = torch.cumsum(acc_sorted.to(torch.int32), 1, dtype=torch.int32) - 1
    slot_id = torch.full((b, k_cap), -1, dtype=torch.int32, device=dev)
    slot_id.scatter_(1, order, torch.where(acc_sorted, dense, -1))
    num_regions = accepted.sum(dim=1, dtype=torch.int32)
    claim_id = torch.where(
        claim < k_cap,
        torch.gather(slot_id, 1, claim.clamp(0, k_cap - 1).reshape(b, -1)
                     .long()).reshape(b, h, w), -1)
    new_labels = torch.where(claim_id >= 0, claim_id, labels)

    # the reported plane is the fit of the final members
    # (planar_region.h:195-196); degenerate fits recentre on the centroid
    m, sol = refit_moments(slots)
    final_plane = _where(sol.valid, sol.plane,
                         geom.plane_from_normal_point(slots.hint,
                                                      sol.centroid))
    gidx = torch.argsort(torch.where(slot_id >= 0, slot_id, k_cap), dim=1,
                         stable=True)

    def take(a):
        idx = gidx
        while idx.dim() < a.dim():
            idx = idx[..., None]
        return torch.gather(a, 1, idx.expand_as(a))

    return PlanarRegions(
        labels=new_labels, num_regions=num_regions,
        planes=take(final_plane), centroids=take(sol.centroid),
        curvatures=take(sol.curvature), counts=take(counts),
        seed_indices=take(slots.seed_idx),
        moments=plane_fit.PlaneMoments(
            s2=take(m.s2), s1=take(m.s1), w=take(m.w),
            normal_hint=take(m.normal_hint)),
        overflow=bk.psum(((rank_grid < INF_RANK) & ~members.any(dim=1))
                         .sum(dim=(1, 2), dtype=torch.int32)) > 0)


def _first_full(radii, h, w):
    """Index of the first unboxed epoch: from there on a frame whose
    members an epoch leaves unchanged stops."""
    return next((j for j, r in enumerate(radii) if r >= max(h, w)),
                len(radii) - 1)


def run_word_epochs(slots, radii, *, points, rank_grid, eligible0,
                    pick_founders, found, reanchor,
                    solve_with_hint, apply_refit, tau, impl):
    """Stage B: one epoch-kernel call per epoch on the packed member word,
    with the slot-table updates between calls (JAX's run_word_epochs). A
    frame freezes once an unboxed epoch leaves its word unchanged."""
    b, h, w = points.shape[:3]
    k_cap = slots.rank.shape[1]
    dev = points.device
    bidx = torch.arange(b, device=dev)[:, None]
    px, py, pz = (points[..., i].contiguous() for i in range(3))
    elig_i32 = eligible0.to(torch.int32)
    kbits = torch.tensor([(1 << k) - (1 << 32 if k == 31 else 0)
                          for k in range(k_cap)], dtype=torch.int32,
                         device=dev)
    word = flood_packed.pack_bits(slots.members)[:, 0]
    slots = slots._replace(members=None)
    first_full = _first_full(radii, h, w)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    for i, radius in enumerate(radii):
        if i > 0 and not bool(active.any()):
            break
        prev_slots, prev_word = slots, word
        # founders: their cells are uncovered and distinct, so adding the
        # slot bits sets exactly the new founder bits
        newly, new_seed, new_rank = pick_founders(slots, word != 0)
        s = found(slots, newly, new_seed, new_rank)
        nr = (new_seed % h).long()
        nc = (new_seed // h).clamp(0, w - 1).long()
        add = torch.where(newly, kbits[None], 0)
        wflat = word.reshape(-1).clone()
        wflat.scatter_add_(0, (bidx * (h * w) + nr * w + nc).reshape(-1),
                           add.reshape(-1))
        wd = wflat.reshape(b, h, w)
        ar = (s.seed_idx % h).to(torch.int32)
        ac = (s.seed_idx // h).clamp(0, w - 1).to(torch.int32)
        new_word, counts, member_rank, anchor_lin, mom = epoch_word.epoch_word(
            px, py, pz, rank_grid, elig_i32, wd, s.rank.contiguous(),
            s.alive.to(torch.int32), s.plane.contiguous(), ar, ac,
            torch.full((b,), radius, dtype=torch.int32, device=dev), tau,
            FLOOD_ROUNDS, impl=impl)
        alive = s.alive & (counts > 0) & (member_rank < INF_RANK)
        # distinct bits sum without carry (bit 31 is the sign, no overflow)
        keep = torch.where(alive, kbits[None], 0).sum(dim=1,
                                                      dtype=torch.int32)
        wd = new_word & keep[:, None, None]
        s = reanchor(s, alive, member_rank,
                     torch.where(alive, anchor_lin, s.seed_idx))
        _, sol = solve_with_hint(mom, s.hint)
        s = apply_refit(s, counts, sol)
        slots = _select_frames(active, s, prev_slots)
        word = torch.where(active[:, None, None], wd, prev_word)
        if i >= first_full:
            stable = (word == prev_word).all(dim=2).all(dim=1)
            active = active & ~stable
    return slots._replace(members=flood_packed.unpack_bits(word[:, None],
                                                           k_cap))
