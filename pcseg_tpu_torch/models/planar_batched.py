"""Batched planar region growing — all regions of all frames at once (port
of pcseg_tpu.models.planar_batched, single-device path).

K = ``max_regions`` slots per frame; each holds a founder seed, its pop
rank, a plane, a sticky orientation hint and a member mask. Region identity
follows the seed rank grid: a slot's rank is the best rank among its
members' seed cells and conflicts resolve to the best rank (see the JAX
module for the full semantics map to segmentation.h / planar_region.h).

  * Stage A: ``stage_a_gens`` generations (13) of ``stage_a_rings`` (2)
    gated 4-neighbourhood rings with a refit at every 30-inlier crossing.
    On grids of at least 64x64 and 16384 cells it runs on 64x64 patches
    around each slot's founder (``_stage_a_patched``); below that on the
    full grid (``generation``/``settle``) — the same switch as JAX. On a
    card the patched stage replays as one CUDA graph per shape
    (``_stage_a_replayed``): the same launches on the same data, captured
    at the shape's first call.
  * Stage B: one loop (``_closure``) of closure epochs under Chebyshev
    boxes growing by 4/3 per epoch, then ``closure_epochs`` + 1 unboxed
    epochs (3); every flood stops at its fixed point or after
    ``flood_rounds`` rounds (64). A frame freezes once an unboxed epoch
    leaves its members unchanged (JAX's while_loop under vmap); frozen
    frames keep their state while the others go on. The loop runs one of
    two epoch steps. With K <= 32 on one device the word step
    (``_word_closure``): one call of the epoch kernel
    (kernels/epoch_word.py) on the packed member word, as JAX runs it on a
    TPU; it runs every scheduled epoch with the freeze on the device, and
    on a card replays as CUDA graphs between the kernel's calls
    (``_closure_replayed``). With K > 32 (more slots than a word has bits),
    or with a sharded backend, the flood step: it builds the slots' gates,
    floods them from the anchors on packed word planes
    (kernels/flood_packed.py) and settles the claims, as JAX's ``epoch``;
    its loop ends when every frame froze. Both end in the same slot update
    as stage A's generations (``_SlotOps.after_claims``).
  * Tail: degenerate (collinear) slots dissolve into an adjacent robust
    slot covering >= 90% of their members; final claims, acceptance and
    dense ids in rank order.

The public functions take JAX's single frame ([H, W, 3] points, [H, W]
grids, [S] seed vectors) or a batch with a leading frame axis ``B``
(ops/frames.py); the shapes below are the batch's.
"""

from __future__ import annotations

import threading
from typing import Callable, NamedTuple

import torch

from pcseg_tpu_torch.kernels import epoch_word, flood_packed
from pcseg_tpu_torch.kernels.common import shift2
from pcseg_tpu_torch.models.config import UNLABELED, PlanarRegionConfig
from pcseg_tpu_torch.ops import geom, nansafe, plane_fit
from pcseg_tpu_torch.ops.frames import takes_frames
from pcseg_tpu_torch.utils import profiling

# Rank sentinel for "not a seed" / dead slot (== ops.seeds.SEED_RANK_INF).
INF_RANK = 2 ** 30
BIG_LIN = 2 ** 30
N_TILES_AXIS = 8
PATCH = 64


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
    members: torch.Tensor    # [B, K, H, W] bool; the packed member word
    #                          [B, H, W] int32 in the word epochs
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


@takes_frames(seed_indices=1, seed_valid=1)
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


@takes_frames(gate=3, sources=3)
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
    b, k, h, w = gate.shape
    nw = -(-k // 32)
    reach = flood_packed.flood_packed(
        flood_packed.pack_bits(gate).reshape(b * nw, h, w),
        flood_packed.pack_bits(sources & gate).reshape(b * nw, h, w),
        rounds, impl=impl)
    return flood_packed.unpack_bits(reach.reshape(b, nw, h, w), k)


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


def _empty_slots(b, k_cap, dtype, dev, members=None) -> _Slots:
    """K dead slots a frame (their members as given)."""
    hint0 = torch.zeros((b, k_cap, 3), dtype=dtype, device=dev)
    hint0[..., 0] = 1.0
    return _Slots(
        seed_idx=torch.zeros((b, k_cap), dtype=torch.int32, device=dev),
        rank=torch.full((b, k_cap), INF_RANK, dtype=torch.int32, device=dev),
        alive=torch.zeros((b, k_cap), dtype=torch.bool, device=dev),
        plane=torch.zeros((b, k_cap, 4), dtype=dtype, device=dev),
        hint=hint0, members=members,
        fit_count=torch.zeros((b, k_cap), dtype=torch.int32, device=dev))


class _SlotOps(NamedTuple):
    """The slot-table updates the grower's stages share (:func:`_slot_ops`)."""
    solve_with_hint: Callable
    pick_founders: Callable
    found: Callable
    after_claims: Callable


def _slot_ops(points, normals, rank_grid, bk, period) -> _SlotOps:
    """The slot-table updates over one call's [B, H, W] grids (a column
    shard's under a sharded backend, one with ``w_total``: tile winners
    then combine the shards' minima). Every tensor they read is an
    argument or made here, so a stage built on them can be captured as a
    CUDA graph."""
    b, h, w = points.shape[:3]   # w: the LOCAL column count
    hw = h * w
    w_total = w if bk.w_total is None else bk.w_total
    col0 = bk.col0
    dev = points.device

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

    def after_claims(slots, counts, member_rank, anchor, moments):
        """The slot update after the claims, from each slot's member count,
        best member seed rank and that seed's col-major cell ``anchor``
        [B, K]: a slot lives on while it holds members and a seed, moves
        its anchor to that seed (the members a table carries are cleared
        for the slots that died) and refits from ``moments(slots)``, the
        moment sums [B, K, 10] of its members."""
        alive = slots.alive & (counts > 0) & (member_rank < INF_RANK)
        slots = reanchor(slots, alive, member_rank,
                         torch.where(alive, anchor, slots.seed_idx))
        if slots.members is not None:
            slots = slots._replace(members=slots.members
                                   & alive[..., None, None])
        _, sol = solve_with_hint(moments(slots), slots.hint)
        return apply_refit(slots, counts, sol)

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
        if bk.w_total is not None:
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

    return _SlotOps(solve_with_hint, pick_founders, found, after_claims)


def _stage_a_patched(points, normals, eligible0, rank_grid, *, k_cap, tau,
                     period, gens, rings) -> _Slots:
    """Stage A on one device, on 64x64 patches around each slot's founder:
    ``gens`` generations of ``rings`` gated rings from K dead slots a
    frame over [B, H, W] grids. Returns the slot table with its
    [B, K, H, W] members."""
    b, h, w = points.shape[:3]
    hw = h * w
    dev = points.device
    ops = _slot_ops(points, normals, rank_grid, GrowerBackend(), period)
    slots = _empty_slots(b, k_cap, points.dtype, dev)
    bidx = torch.arange(b, device=dev)[:, None]
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
    for _ in range(gens):
        owner = stamp_owner(orr, orc, mem_p, slots.rank, slots.alive)
        newly, new_seed, new_rank = ops.pick_founders(slots,
                                                      owner < INF_RANK)
        nr = new_seed % h
        nc = (new_seed // h).clamp(0, w - 1)
        slots = ops.found(slots, newly, new_seed, new_rank)
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
        for _ in range(rings):
            m = m | (_dilate4(m) & gate)

        owner2 = stamp_owner(orr, orc, m, slots.rank, slots.alive)
        new_mem = m & (gather(owner2, orr, orc)
                       == slots.rank[..., None, None])
        counts = new_mem.sum(dim=(2, 3), dtype=torch.int32)
        masked_rank = torch.where(new_mem, rank_p, INF_RANK)
        member_rank, best_flat = masked_rank.reshape(
            b, k_cap, PATCH * PATCH).min(dim=2)
        br = orr + torch.div(best_flat, PATCH, rounding_mode="floor")
        bc = orc + best_flat % PATCH
        pp = nansafe.sanitize(pts_p)
        feat_p = _moment_features(pp[..., 0], pp[..., 1], pp[..., 2]) \
            .reshape(b, k_cap, PATCH * PATCH, 10)
        slots = ops.after_claims(
            slots._replace(members=new_mem), counts, member_rank,
            (bc * h + br).to(torch.int32),
            lambda s: _masked_moments(s.members.reshape(b, k_cap, -1),
                                      feat_p))
        mem_p = slots.members

    r, c = patch_index(orr, orc)
    members = torch.zeros((b, k_cap, h, w), dtype=torch.bool, device=dev)
    members[bidx[..., None, None], kk[..., None, None], r, c] = \
        mem_p & slots.alive[..., None, None]
    return slots._replace(members=members)


class _Capturing(threading.local):
    hook = None  # the eager calls' hook of the _Graph this thread captures


_capturing = _Capturing()


def _eager(thunk):
    """``thunk()``'s tensors: a call that a :class:`_Graph` keeps out of
    its graphs (a kernel's wrapper, which then launches it at every replay
    as an eager run does). Outside a graph's warm-up and capture it is just
    the call."""
    hook = _capturing.hook
    return thunk() if hook is None else hook(thunk)


class _Graph:
    """``fn(*inputs, **params)`` captured once as CUDA graphs over static
    input buffers (:func:`_stage_a_patched`, :func:`_word_closure`). A
    replay copies a call's inputs in, launches the graphs and copies the
    outputs out, so nothing it returns aliases the graphs' memory.

    Each :func:`_eager` call of ``fn`` ends one graph and begins the next,
    all in one memory pool; a replay runs its thunk between the two, on
    the tensors it captured, and copies the results into the buffers the
    next graph reads. Every thunk's results share those buffers, so they
    match in shapes and dtypes and ``fn`` reads them before its next eager
    call. What the captured code counts (``profiling.count``), each replay
    counts."""

    def __init__(self, fn, inputs, params):
        self.inputs = [x.clone() for x in inputs]
        self.results = None
        self.thunks = []
        dev = inputs[0].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        # captured on the inputs' card (torch's default capture stream
        # lives on the card of the process's first capture)
        try:
            with torch.cuda.stream(side):
                # warm-up outside the capture: cuBLAS workspaces, kernels
                # loaded on their first launch, the results' buffers
                _capturing.hook = self._warm
                fn(*self.inputs, **params)
                self.pool = torch.cuda.graph_pool_handle()
                self.graphs = [torch.cuda.CUDAGraph()]
                _capturing.hook = self._split
                with profiling.diverted() as self.counts:
                    self.graphs[0].capture_begin(pool=self.pool)
                    try:
                        self.outputs = fn(*self.inputs, **params)
                    finally:
                        self.graphs[-1].capture_end()
        finally:
            _capturing.hook = None
        torch.cuda.current_stream(dev).wait_stream(side)

    def _warm(self, thunk):
        out = thunk()
        if self.results is None:
            self.results = [torch.empty_like(r) for r in out]
        return out

    def _split(self, thunk):
        self.graphs[-1].capture_end()
        self.thunks.append(thunk)
        self.graphs.append(torch.cuda.CUDAGraph())
        self.graphs[-1].capture_begin(pool=self.pool)
        return self.results

    def run(self):
        """The graphs on the current inputs, the eager calls between
        them."""
        self.graphs[0].replay()
        for thunk, graph in zip(self.thunks, self.graphs[1:]):
            for buf, r in zip(self.results, thunk()):
                buf.copy_(r)
            graph.replay()
        for name, n in self.counts.items():
            profiling.count(name, n)

    def replay(self, inputs) -> _Slots:
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.run()
        return _Slots(*[o.clone() for o in self.outputs])


# one graph per stage, device, input shapes and dtypes and parameters, for
# the process's life; the lock keeps a call's copies in, replay and copies
# out together when threads share a card's stream
_GRAPHS = {}
_GRAPH_LOCK = threading.Lock()


def _replayed(stage, fn, inputs, params) -> _Slots:
    """``fn(*inputs, **params)`` on a card as its :class:`_Graph`. The
    first call for a key (the stage, the device, the inputs' shapes and
    dtypes, every parameter) captures it, a host sync
    (``grower.<stage>_capture``); counters ``grower.<stage>_graph_captures``
    and ``grower.<stage>_graph_replays``."""
    dev = inputs[0].device
    key = (stage, dev, *[(x.shape, x.dtype) for x in inputs],
           *sorted(params.items()))
    with _GRAPH_LOCK, torch.cuda.device(dev):
        graph = _GRAPHS.get(key)
        if graph is None:
            with profiling.blocking(f"grower.{stage}_capture"):
                graph = _GRAPHS[key] = _Graph(fn, inputs, params)
            profiling.count(f"grower.{stage}_graph_captures")
        profiling.count(f"grower.{stage}_graph_replays")
        return graph.replay(inputs)


def _stage_a_replayed(points, normals, eligible0, rank_grid,
                      **params) -> _Slots:
    """:func:`_stage_a_patched` on a card: a few hundred small launches a
    generation, which the host cannot launch as fast as the card runs them,
    so they replay as one CUDA graph."""
    return _replayed("stage_a", _stage_a_patched,
                     (points, normals, eligible0, rank_grid), params)


# bit k of a cell's member word is slot k's membership
_KBITS = {}


def _kbits(dev):
    """[32] int32: entry k holds bit k alone (entry 31 the sign bit), made
    on ``dev`` once per device."""
    bits = _KBITS.get(dev)
    if bits is None:
        k = torch.arange(32, dtype=torch.int64, device=dev)
        bits = _KBITS.setdefault(dev, (
            torch.bitwise_left_shift(torch.ones_like(k), k)
            - torch.where(k == 31, 1 << 32, 0)).to(torch.int32))
    return bits


def _word_closure(points, normals, eligible0, rank_grid, *table, tau, period,
                  flood_rounds, span, size, closure_epochs,
                  impl=None) -> _Slots:
    """Stage B's word step (K <= 32 on one device; B1, JAX's
    ``run_word_epochs``) over the slot table ``table`` (a :class:`_Slots`'
    fields, [B, K, H, W] members): the members packed into one int32 word
    a cell, :func:`_closure` over every scheduled epoch with the freeze on
    the device, the members unpacked. B1's call is :func:`_eager`."""
    slots = _Slots(*table)
    b, h, w = points.shape[:3]
    hw = h * w
    k_cap = slots.rank.shape[1]
    dev = points.device
    ops = _slot_ops(points, normals, rank_grid, GrowerBackend(impl), period)
    kbits = _kbits(dev)[:k_cap]
    pxyz = [points[..., i].contiguous() for i in range(3)]
    elig_i32 = eligible0.to(torch.int32)
    bidx = torch.arange(b, device=dev)[:, None]

    def word_epoch(slots, radius):
        """Founders into the packed member word (the table's ``members``),
        one epoch-kernel call, the slot update."""
        word = slots.members
        # founders: their cells are uncovered and distinct, so adding the
        # slot bits sets exactly the new founder bits
        newly, new_seed, new_rank = ops.pick_founders(slots, word != 0)
        s = ops.found(slots._replace(members=None), newly, new_seed,
                      new_rank)
        nr = (new_seed % h).long()
        nc = (new_seed // h).clamp(0, w - 1).long()
        wflat = word.reshape(-1).clone()
        wflat.scatter_add_(0, (bidx * hw + nr * w + nc).reshape(-1),
                           torch.where(newly, kbits[None], 0).reshape(-1))
        args = (*pxyz, rank_grid, elig_i32, wflat.reshape(b, h, w),
                s.rank.contiguous(), s.alive.to(torch.int32),
                s.plane.contiguous(), (s.seed_idx % h).to(torch.int32),
                (s.seed_idx // h).clamp(0, w - 1).to(torch.int32),
                torch.full((b,), radius, dtype=torch.int32, device=dev))
        new_word, counts, member_rank, anchor, mom = _eager(
            lambda: epoch_word.epoch_word(*args, tau, flood_rounds,
                                          impl=impl))
        s = ops.after_claims(s, counts, member_rank, anchor, lambda _: mom)
        # distinct bits sum without carry (bit 31 is the sign, no overflow)
        new_word = new_word & torch.where(s.alive, kbits[None], 0) \
            .sum(dim=1, dtype=torch.int32)[:, None, None]
        return (s._replace(members=new_word),
                (new_word != word).flatten(1).any(dim=1))

    slots = _closure(slots._replace(members=flood_packed.pack_bits(
        slots.members)[:, 0]), word_epoch, span=span, size=size,
        closure_epochs=closure_epochs, host_freeze=False)
    return slots._replace(members=flood_packed.unpack_bits(
        slots.members[:, None], k_cap))


def _closure_replayed(points, normals, eligible0, rank_grid, *table,
                      **params) -> _Slots:
    """:func:`_word_closure` on a card: ~530 small launches an epoch
    around its B1 call, which the host cannot launch as fast as the card
    runs them, so they replay as CUDA graphs; B1 stays eager between them,
    launched by its wrapper."""
    return _replayed("closure", _word_closure,
                     (points, normals, eligible0, rank_grid, *table), params)


@takes_frames(points=3, normals=3, labels=2, seed_indices=1, seed_valid=1,
              seed_rank_grid=2)
def grow_planar_regions_batched(
        points: torch.Tensor, normals: torch.Tensor, labels: torch.Tensor,
        seed_indices, seed_valid,
        config: PlanarRegionConfig = PlanarRegionConfig(),
        initial_id_offset: int = 0,
        stage_a_gens: int = 13,
        stage_a_rings: int = 2,
        closure_epochs: int = 2,
        seed_rank_grid: torch.Tensor = None,
        flood_rounds: int = 64,
        backend: GrowerBackend = None,
        impl=None) -> PlanarRegions:
    """Batched planar growth over [B, H, W, 3] points/normals and [B, H, W]
    int32 input labels (JAX's ``grow_planar_regions_batched``, its
    parameters in its order). The seeds are the [B, H, W] int32 rank grid
    ``seed_rank_grid`` (ops/seeds.py) or, without it, the ranked seed
    vectors ``seed_indices``/``seed_valid`` [B, S] (popped back to front;
    ignored when the grid is given). ``initial_id_offset`` is added to the
    labels the grower assigns. The schedule: ``stage_a_gens`` generations
    of ``stage_a_rings`` rings, then the boxed epochs and
    ``closure_epochs`` + 1 unboxed ones; each flood runs at most
    ``flood_rounds`` rounds. ``impl="plain"`` forces the epoch and flood
    kernels' plain versions (tests and the smoke script only).

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
    if seed_rank_grid is None:
        seed_rank_grid = rank_grid_from_seed_vector(
            seed_indices, seed_valid, h, w_total, w_local=w, col0=col0)
    cell_ok = eligible0 & nansafe.all_finite(normals)
    rank_grid = torch.where(cell_ok, seed_rank_grid, INF_RANK) \
        .to(torch.int32)
    px, py, pz = points[..., 0], points[..., 1], points[..., 2]
    pts_safe = nansafe.sanitize(points)
    feat = _moment_features(pts_safe[..., 0], pts_safe[..., 1],
                            pts_safe[..., 2]).reshape(b, hw, 10)
    ops = _slot_ops(points, normals, rank_grid, bk, period)
    rows_g = torch.arange(h, dtype=torch.int32, device=dev)[:, None]
    cols_g = torch.arange(w, dtype=torch.int32, device=dev)[None, :] + col0

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

    def member_moments(slots):
        """[B, K, 10] moment sums of the slots' members (all shards')."""
        mask = slots.members.reshape(b, k_cap, hw)
        return _masked_moments(mask, feat) if backend is None \
            else _masked_moments(mask, feat, bk.psum)

    def refit_moments(slots):
        return ops.solve_with_hint(member_moments(slots), slots.hint)

    def settle(slots, new_members):
        _, new_members = claims_of(new_members, slots.rank)
        counts = bk.psum(new_members.sum(dim=(2, 3), dtype=torch.int32))
        masked_rank = torch.where(new_members, rank_grid[:, None], INF_RANK)
        local_min, best_flat = masked_rank.reshape(b, k_cap, hw).min(dim=2)
        member_rank = bk.pmin(local_min)
        br = torch.div(best_flat, w, rounding_mode="floor")
        bc = best_flat % w + col0
        # the rank holder is unique: exactly one shard attains the min
        anchor = bk.pmin(torch.where(
            (local_min == member_rank) & (member_rank < INF_RANK),
            bc * h + br, BIG_LIN).to(torch.int32))
        return ops.after_claims(slots._replace(members=new_members), counts,
                                member_rank, anchor, member_moments)

    def assign(slots):
        """Founders for the dead slots; a new founder's members are its
        one-hot."""
        newly, new_seed, new_rank = ops.pick_founders(
            slots, slots.members.any(dim=1))
        slots = ops.found(slots, newly, new_seed, new_rank)
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
                            stage_a_rings)
        return settle(slots, m)

    def flood_epoch(slots, radius):
        """The flood step, for K > 32 or at any K with a backend (B3, JAX's
        ``epoch``): the gates cut to the Chebyshev box of ``radius`` around
        each anchor (members always pass), flooded from the anchors on
        packed word planes, then settled. A frame changed where any member
        cell did, on any shard: summed across the shards, so their loops
        stay in step."""
        s = assign(slots)
        ar = (s.seed_idx % h)[..., None, None]
        ac = (s.seed_idx // h).clamp(0, w_total - 1)[..., None, None]
        inbox = ((rows_g - ar).abs() <= radius) & ((cols_g - ac).abs()
                                                   <= radius)
        gate = slot_gate(s) & (inbox | s.members)
        s = settle(s, bk.flood(gate, onehot(s.seed_idx), flood_rounds))
        return s, bk.psum((s.members != slots.members).flatten(1)
                          .sum(dim=1, dtype=torch.int32)) != 0

    # --- stage A: on 64x64 patches on grids >= 64x64 of >= 4 patches, as
    # one CUDA graph on a card; else on the full grid ---------------------
    span = stage_a_gens * stage_a_rings
    use_patches = (backend is None and h >= PATCH and w >= PATCH
                   and hw >= 4 * PATCH * PATCH
                   and PATCH // 2 - span - stage_a_rings >= 1)
    with profiling.stage("grower.stage_a"):
        if use_patches:
            stage_a = _stage_a_replayed if dev.type == "cuda" \
                else _stage_a_patched
            slots = stage_a(points, normals, eligible0, rank_grid,
                            k_cap=k_cap, tau=tau, period=period,
                            gens=stage_a_gens, rings=stage_a_rings)
        else:
            slots = _empty_slots(b, k_cap, dtype, dev, torch.zeros(
                (b, k_cap, h, w), dtype=torch.bool, device=dev))
            for _ in range(stage_a_gens):
                slots = generation(slots)

    # --- stage B: closure epochs, the word step or the flood step --------
    with profiling.stage("grower.closure"):
        schedule = dict(span=span, size=max(h, w_total),
                        closure_epochs=closure_epochs)
        if k_cap <= 32 and backend is None:
            word_closure = _closure_replayed \
                if dev.type == "cuda" and impl is None else _word_closure
            slots = word_closure(points, normals, eligible0, rank_grid,
                                 *slots, tau=tau, period=period,
                                 flood_rounds=flood_rounds, impl=impl,
                                 **schedule)
        else:
            slots = _closure(slots, flood_epoch, **schedule)

    # --- degenerate-attempt resolution -----------------------------------
    with profiling.stage("grower.tail"):
        _, sol_r = refit_moments(slots)
        robust = slots.alive & sol_r.valid & (sol_r.mid_ratio >= 3e-3)
        mem_f = slots.members.reshape(b, k_cap, hw).to(torch.float64)
        counts_f = torch.clamp_min(
            bk.psum(mem_f.sum(dim=2)).to(torch.float32), 1.0)
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
        gained = torch.bmm(
            transfer.to(torch.float64),
            slots.members.reshape(b, k_cap, hw).to(torch.float64)
        ).reshape(b, k_cap, h, w) > 0
        dissolved = loser & has_win
        slots = slots._replace(
            members=_where(robust, slots.members | gained, slots.members)
            & ~dissolved[..., None, None],
            alive=slots.alive & ~dissolved)

        # --- final claims, acceptance, dense ids in rank order -----------
        claim, members = claims_of(slots.members, slots.rank)
        counts = bk.psum(members.sum(dim=(2, 3), dtype=torch.int32))
        accepted = slots.alive & (counts >= config.min_region_inliers)
        order = torch.argsort(torch.where(accepted, slots.rank, INF_RANK),
                              dim=1, stable=True)
        acc_sorted = torch.gather(accepted, 1, order)
        dense = torch.cumsum(acc_sorted.to(torch.int32), 1,
                             dtype=torch.int32) - 1
        slot_id = torch.full((b, k_cap), -1, dtype=torch.int32, device=dev)
        slot_id.scatter_(1, order, torch.where(acc_sorted, dense, -1))
        num_regions = accepted.sum(dim=1, dtype=torch.int32)
        claim_id = torch.where(
            claim < k_cap,
            torch.gather(slot_id, 1, claim.clamp(0, k_cap - 1).reshape(b, -1)
                         .long()).reshape(b, h, w), -1)
        new_labels = torch.where(claim_id >= 0, claim_id + initial_id_offset,
                                 labels)

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


def _closure(slots, epoch, *, span, size, closure_epochs,
             host_freeze=True) -> _Slots:
    """Stage B's one loop: epochs under Chebyshev boxes of radius
    2 * ``span`` growing by 4/3 an epoch while below ``size`` (the grid's
    longer side), then ``closure_epochs`` + 1 unboxed ones. An epoch step
    ``epoch(slots, radius)`` returns the next table and, per frame, whether
    it changed the members. A frame freezes once an unboxed epoch leaves it
    unchanged and keeps its table while the others go on. With
    ``host_freeze`` the loop ends when every frame froze (a host sync
    before every epoch but the first); without it every scheduled epoch
    runs and the freeze stays on the device, with the same tables: epochs
    after every frame froze keep every frame's."""
    radii = []
    radius = 2 * span
    while radius < size:
        radii.append(radius)
        radius = (radius * 4) // 3
    first_full = len(radii)
    radii += [size] * (closure_epochs + 1)
    profiling.count("grower.epochs_scheduled", len(radii))
    active = torch.ones(slots.rank.shape[0], dtype=torch.bool,
                        device=slots.rank.device)
    for i, radius in enumerate(radii):
        if host_freeze and i > 0:
            with profiling.blocking("grower.freeze"):
                if not bool(active.any()):
                    break
        profiling.count("grower.epochs")
        new, changed = epoch(slots, radius)
        slots = _select_frames(active, new, slots)
        if i >= first_full:
            active = active & changed
    return slots
