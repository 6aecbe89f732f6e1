"""The last public surface of the JAX package in the port, against JAX on
the CPU: ``flood_fill_static`` (B3's public entry),
``connected_components_mask``, ``classify_planes_batched``,
``eigh3x3_smallest``, ``gather_region_indices``, ``utils/profiling`` and
the graft entry points (``graft_entry``: the forward and the sharded dry
run).
Inputs are made from numpy seeds; comparisons are exact unless a case says
otherwise. The ``cuda`` cases hold the card against the CPU.
"""

import ast
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as jentry
from pcseg_tpu.models import classify as jclassify
from pcseg_tpu.models import cluster as jcluster
from pcseg_tpu.models import planar_batched as jpb
from pcseg_tpu.ops import connectivity as jconnectivity
from pcseg_tpu.ops import geom as jgeom

from pcseg_tpu_torch import graft_entry
from pcseg_tpu_torch.models import classify, cluster, config, extract
from pcseg_tpu_torch.models import pipeline, planar_batched
from pcseg_tpu_torch.ops import connectivity, geom, xla_order
from pcseg_tpu_torch.utils import profiling
from tests.test_torch_grower import assert_planes
from tests.test_torch_ops import _covariances

# One intra-op thread: the suite runs in parallel worker processes, and
# OpenMP teams spinning across them slow every small op by orders of
# magnitude.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    return torch.device("cuda")


# -- flood_fill_static (B3) ------------------------------------------------


def flood_case(seed=3):
    """K = 3 slots on 24x32: bool gates and sparse sources."""
    rng = np.random.default_rng(seed)
    gate = rng.random((3, 24, 32)) < 0.6
    return gate, gate & (rng.random(gate.shape) < 0.02)


@pytest.mark.parametrize("rounds", [1, 2, 64])
def test_flood_fill_static_matches_jax(monkeypatch, rounds):
    """Against JAX's XLA flood, with the round cap binding (1, 2) and free
    (64)."""
    monkeypatch.setattr(jpb, "FLOOD_IMPL", "xla")
    gate, src = flood_case()
    want = np.asarray(jpb.flood_fill_static(jnp.asarray(gate),
                                            jnp.asarray(src), rounds))
    got = planar_batched.flood_fill_static(torch.from_numpy(gate),
                                           torch.from_numpy(src), rounds)
    assert got.dtype == torch.bool and got.shape == gate.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert want.sum() > 3 * src.sum()  # the flood spread


def test_flood_fill_static_batch_is_per_frame(monkeypatch):
    """[B, K, H, W] floods each frame as JAX floods it alone, and ignores
    ``max_run`` where it bounds every run (JAX's promise)."""
    monkeypatch.setattr(jpb, "FLOOD_IMPL", "xla")
    frames = [flood_case(s) for s in (4, 5)]
    gate = np.stack([f[0] for f in frames])
    src = np.stack([f[1] for f in frames])
    got = planar_batched.flood_fill_static(
        torch.from_numpy(gate), torch.from_numpy(src), 64, max_run=32)
    for f in range(2):
        want = np.asarray(jpb.flood_fill_static(
            jnp.asarray(gate[f]), jnp.asarray(src[f]), 64, max_run=32))
        np.testing.assert_array_equal(got[f].numpy(), want)


def test_grower_backend_floods_through_flood_fill_static(monkeypatch):
    """The grower's flood hook is the public entry point."""
    seen = []
    real = planar_batched.flood_fill_static

    def spy(*args, **kw):
        seen.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(planar_batched, "flood_fill_static", spy)
    gate, src = flood_case()
    out = planar_batched.GrowerBackend().flood(
        torch.from_numpy(gate)[None], torch.from_numpy(src)[None], 64)
    assert seen == [(1, 3, 24, 32)]
    np.testing.assert_array_equal(out[0].numpy(), real(
        torch.from_numpy(gate), torch.from_numpy(src), 64).numpy())


# -- connected_components_mask ----------------------------------------------


def serpentine(h=24, w=32):
    """A one-cell-wide path through every other row, joined at alternate
    ends: one component whose fixed point needs many rounds."""
    m = np.zeros((h, w), bool)
    m[::2] = True
    for r in range(1, h, 2):
        m[r, w - 1 if (r // 2) % 2 == 0 else 0] = True
    return m


def mask_case(name):
    if name == "serpentine":
        return serpentine()
    density = {"p30": 0.3, "p60": 0.6}[name]
    return np.random.default_rng(7).random((24, 32)) < density


@pytest.mark.parametrize("max_iters", [64, 4])
@pytest.mark.parametrize("num_jumps", [0, 2])
@pytest.mark.parametrize("neighborhood4", [True, False])
@pytest.mark.parametrize("name", ["p30", "p60", "serpentine"])
def test_connected_components_mask_matches_jax(name, neighborhood4,
                                               num_jumps, max_iters):
    mask = mask_case(name)
    kw = dict(max_iters=max_iters, num_jumps=num_jumps,
              neighborhood4=neighborhood4)
    want = np.asarray(jconnectivity.connected_components_mask(
        jnp.asarray(mask), **kw))
    got = connectivity.connected_components_mask(torch.from_numpy(mask),
                                                 **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_connected_components_mask_cap_binds_on_the_serpentine():
    """At 4 rounds the serpentine is not at its fixed point (so the cap
    cases above test a binding cap), and the batch form gives each frame
    JAX's labels under it."""
    masks = np.stack([mask_case(n) for n in ("p30", "p60", "serpentine")])
    got = connectivity.connected_components_mask(torch.from_numpy(masks),
                                                 max_iters=4, num_jumps=0)
    free = connectivity.connected_components_mask(
        torch.from_numpy(masks[2]), max_iters=10_000, num_jumps=0)
    assert not torch.equal(got[2], free)
    assert int(free[masks[2]].max()) == 0  # one component at the fixed point
    for f in range(3):
        want = np.asarray(jconnectivity.connected_components_mask(
            jnp.asarray(masks[f]), max_iters=4, num_jumps=0))
        np.testing.assert_array_equal(got[f].numpy(), want)


# -- classify_planes_batched ------------------------------------------------

CLASSIFY = config.PlaneClassificationConfig(
    floor_params=config.ClassifyHorizontalPlaneParams(
        max_up_direction_delta_angle_degrees=0.0, floor_offset=0.0,
        max_floor_offset_deviation=0.05, min_area=0.5, max_area=50.0),
    coffee_table_params=config.ClassifyHorizontalPlaneParams(
        max_up_direction_delta_angle_degrees=10.0, floor_offset=-0.45,
        max_floor_offset_deviation=0.1, min_area=0.1, max_area=2.0),
    wall_params=config.ClassifyWallParams(
        max_horizontal_delta_angle_degrees=10.0, min_height=0.6))


def f32_edges(x):
    """x in f32 and one ulp either side."""
    x = np.float32(x)
    return [np.nextafter(x, np.float32(-np.inf)), x,
            np.nextafter(x, np.float32(np.inf))]


def order_edges(up, count=3):
    """Up to ``count`` normals on the wall cone's edge whose dot with
    ``up`` falls inside the cone in one f32 order and outside in the other:
    XLA:CPU's fused order (jitted) against the products rounded first and
    summed in turn (an eager call). None exist for an axis ``up``."""
    rng = np.random.default_rng(13)
    cos_wall = np.float32(np.cos(np.radians(80.0)))
    u = up.astype(np.float64)
    perp = rng.normal(size=(4096, 3))
    perp -= (perp @ u)[:, None] * u
    perp /= np.linalg.norm(perp, axis=1, keepdims=True)
    n = (cos_wall * u + np.sqrt(1 - float(cos_wall) ** 2) * perp).astype(
        np.float32)
    fused = xla_order.fma_sum3(torch.from_numpy(n),
                               torch.from_numpy(up)).numpy()
    p = n * up
    eager = (p[:, 0] + p[:, 1]) + p[:, 2]
    flip = (np.abs(fused) <= cos_wall) != (np.abs(eager) <= cos_wall)
    return n[flip][:count]


def classify_inputs(up):
    """R = 64 planes with the knife edges of every gate: normals exactly
    ``up`` and an ulp off it, floor offsets at the floor and table
    deviation bounds, areas at min_area and max_area, walls at the cone
    edge (also where the f32 order decides, :func:`order_edges`) and hull
    heights at min_height; the rest random."""
    rng = np.random.default_rng(11)
    up = np.asarray(up, np.float32)
    fp = np.float32([0.0, 0.0, -1.0])
    r = 64
    n = rng.normal(size=(r, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:24] = up
    n[1, 2] = np.nextafter(up[2], np.float32(0))  # an ulp off up
    n[2, 2] = np.nextafter(up[2], np.float32(2))
    cos_wall = np.float32(np.cos(np.radians(80.0)))
    for i, z in enumerate(f32_edges(cos_wall) + f32_edges(-cos_wall)):
        n[24 + i] = [np.sqrt(np.float32(1) - z * z), 0, z]
    # offsets: -n.fp - floor_offset +- deviation, an ulp either side
    dot = (n * fp).sum(1, dtype=np.float32)
    d = rng.normal(scale=0.5, size=r).astype(np.float32)
    edges = (f32_edges(0.05) + f32_edges(-0.05)
             + [np.float32(0.45) + e for e in f32_edges(0.1)])
    for i, e in enumerate(edges):
        d[3 + i] = np.float32(e) - dot[3 + i]
    d[:3] = -dot[:3]
    d[12:18] = -dot[12:18]                      # floor's offset
    d[18:24] = np.float32(0.45) - dot[18:24]    # the table's
    areas = rng.uniform(0, 60, r).astype(np.float32)
    areas[:9] = 10.0
    areas[9:12] = 1.0
    areas[12:24] = (f32_edges(0.5) + f32_edges(50.0)
                    + f32_edges(0.1) + f32_edges(2.0))
    heights = rng.uniform(0, 2, r).astype(np.float32)
    heights[24:30] = 1.0
    heights[30:33] = f32_edges(0.6)
    n[30:33] = [1, 0, 0]
    planes = np.concatenate([n, d[:, None]], 1).astype(np.float32)
    planes[40] = np.nan  # a padded row
    flips = order_edges(up)
    planes[41:41 + len(flips), :3] = flips
    heights[41:41 + len(flips)] = 1.0
    return planes, areas, heights, up, fp


@pytest.mark.parametrize("kind", ["axis", "tilted"])
def test_classify_planes_batched_matches_jax(kind):
    """Against JAX's function jitted, as its pipeline would call it (the
    length-3 dots fused). With the axis ``up`` every class appears; with
    the tilted one, rows 41-43 are walls for the jitted call and not for
    an eager one, so the port follows the fused order."""
    up = np.float32([0.0, 0.0, 1.0] if kind == "axis" else [0.02, -0.03, 1])
    up = (up / np.linalg.norm(up)).astype(np.float32)
    args = classify_inputs(up)
    want = np.asarray(jax.jit(
        lambda *a: jclassify.classify_planes_batched(*a, CLASSIFY))(*args))
    got = classify.classify_planes_batched(
        *[torch.from_numpy(np.asarray(a)) for a in args], CLASSIFY)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if kind == "axis":
        assert set(want.tolist()) == {int(c) for c in config.PlaneClass}
    else:
        eager = np.asarray(jclassify.classify_planes_batched(*args, CLASSIFY))
        assert (eager != want).sum() == 3


def test_classify_planes_batched_zero_degree_gate():
    """The 0 degree floor gate passes only an up component of exactly 1:
    rows 0 and 2 (up, and an ulp past it) can be floor, row 1 (an ulp
    short) cannot."""
    args = classify_inputs([0.0, 0.0, 1.0])
    got = classify.classify_planes_batched(
        *[torch.from_numpy(np.asarray(a)) for a in args], CLASSIFY).numpy()
    floor = int(config.PlaneClass.FLOOR)
    assert got[0] == floor and got[2] == floor and got[1] != floor


# -- eigh3x3_smallest --------------------------------------------------------


def matrices(kind, n=256):
    rng = np.random.default_rng(3)
    if kind == "spd":
        comps, _ = _covariances("random", n=n)
        c00, c01, c02, c11, c12, c22 = comps
        return np.stack([np.stack([c00, c01, c02], -1),
                         np.stack([c01, c11, c12], -1),
                         np.stack([c02, c12, c22], -1)], -2)
    if kind == "rank1":
        v = rng.normal(size=(n, 3)).astype(np.float32)
        return (v[:, :, None] * v[:, None, :]).astype(np.float32)
    scale = rng.uniform(1e-3, 10, n).astype(np.float32)
    return (scale[:, None, None] * np.eye(3, dtype=np.float32))


@pytest.mark.parametrize("hint", [False, True])
@pytest.mark.parametrize("kind", ["spd", "rank1", "identity"])
def test_eigh3x3_smallest_matches_c_form_and_jax(kind, hint):
    """Equal to the port's component form; against JAX at the bar of
    tests/test_torch_ops.py::test_eigh3x3_smallest_c (XLA:CPU's
    transcendentals differ from PyTorch's in the last ulp)."""
    cov = matrices(kind)
    prev = (np.random.default_rng(4).normal(size=(cov.shape[0], 3))
            .astype(np.float32) if hint else None)
    tprev = None if prev is None else torch.from_numpy(prev)
    ev, vec = geom.eigh3x3_smallest(torch.from_numpy(cov), tprev)
    c = torch.from_numpy(cov)
    ev_c, vec_c = geom.eigh3x3_smallest_c(
        c[:, 0, 0], c[:, 0, 1], c[:, 0, 2], c[:, 1, 1], c[:, 1, 2],
        c[:, 2, 2], tprev)
    assert torch.equal(ev, ev_c) and torch.equal(vec, vec_c)
    jev, jvec = jgeom.eigh3x3_smallest(
        jnp.asarray(cov), None if prev is None else jnp.asarray(prev))
    jev, jvec = np.asarray(jev), np.asarray(jvec)
    np.testing.assert_allclose(ev.numpy(), jev, rtol=0,
                               atol=1e-6 * max(1.0, float(np.abs(jev).max())))
    trace = np.abs(jev).sum(-1) + 1e-30
    separated = (jev[:, 1] - jev[:, 0]) >= 1e-2 * trace
    np.testing.assert_allclose(vec.numpy()[separated], jvec[separated],
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(vec.numpy(), jvec, rtol=0, atol=1e-4)


# -- gather_region_indices --------------------------------------------------


def test_gather_region_indices_matches_jax():
    """The one home is models/cluster.py; extract imports it there."""
    labels = np.random.default_rng(5).integers(-3, 6, (37, 53)).astype(
        np.int32)
    assert extract.gather_region_indices is cluster.gather_region_indices
    for rid in range(-3, 7):
        want = jcluster.gather_region_indices(labels, rid, order="colmajor")
        np.testing.assert_array_equal(
            cluster.gather_region_indices(labels, rid), want)
        np.testing.assert_array_equal(cluster.gather_region_indices(
            torch.from_numpy(labels), rid, order="colmajor"), want)


# -- utils/profiling ---------------------------------------------------------


def test_stage_names_appear_in_a_profiler_trace(tmp_path):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.stage("surface.outer"):
            with profiling.stage("surface.inner"):
                torch.ones(64).cumsum(0)
    names = {e.key for e in prof.key_averages()}
    assert {"surface.outer", "surface.inner"} <= names


def test_timer_summary_is_the_min():
    timer = profiling.Timer()
    timer.times = {"b": [0.5, 0.2, 0.3]}
    out = torch.zeros(3)
    for _ in range(2):
        with timer.measure("a", sync_value={"x": (out, [out]), "y": None}):
            out += 1
    assert len(timer.times["a"]) == 2
    assert timer.summary() == {"a": min(timer.times["a"]), "b": 0.2}


def test_trace_to_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with profiling.trace_to(str(log_dir)) as path:
        with profiling.stage("surface.traced"):
            torch.ones(64).sum()
    assert os.path.dirname(path) == str(log_dir)
    with open(path) as f:
        trace = json.load(f)
    assert any(e.get("name") == "surface.traced"
               for e in trace["traceEvents"])


# -- the graft entry points --------------------------------------------------


def test_entry_inputs_are_jax_s():
    _, (pts, origin) = graft_entry.entry(device="cpu")
    _, (jpts, jorigin) = jentry.entry()
    assert pts.shape == (240, 320, 3) and pts.device.type == "cpu"
    np.testing.assert_array_equal(pts.numpy(), np.asarray(jpts))
    np.testing.assert_array_equal(origin.numpy(), np.asarray(jorigin))


def test_entry_forward_is_the_segmenter_s():
    forward, args = graft_entry.entry(device="cpu")
    got = forward(*args)
    want = pipeline.Segmenter(device="cpu").device_forward(*args)
    for a, b in zip([got[0], got[1], *got[2], *got[3]],
                    [want[0], want[1], *want[2], *want[3]]):
        if torch.is_tensor(a):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(got[2].num_regions) >= 3


@pytest.mark.slow
def test_entry_forward_matches_jax():
    """The QVGA forward against JAX's entry forward (~15 s of JAX)."""
    forward, args = graft_entry.entry(device="cpu")
    g_final, _, g_dev, g_cres = forward(*args)
    jforward, jargs = jentry.entry()
    w_final, _, w_dev, w_cres = jax.jit(jforward)(*jargs)
    np.testing.assert_array_equal(g_final.numpy(), np.asarray(w_final))
    assert int(g_dev.num_regions) == int(w_dev.num_regions)
    assert int(g_cres.num_regions) == int(w_cres.num_regions)
    pts = args[0].numpy()
    assert_planes(g_dev.planes.numpy()[None], np.asarray(w_dev.planes)[None],
                  g_dev.labels.numpy()[None], pts[None],
                  np.asarray(w_dev.num_regions)[None])


@pytest.mark.parametrize("n", [1, 2])
def test_dryrun_multichip_on_gloo_ranks_prints_jax_s_line(capsys, n):
    """n gloo ranks on the CPU, each a process of its own, print the line
    JAX's dry run prints over n devices (the same counts)."""
    jentry.dryrun_multichip(n)
    want = capsys.readouterr().out.strip().splitlines()[-1]
    graft_entry.dryrun_multichip(n, backend="gloo")
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want and got.startswith(f"dryrun_multichip ok: {n} devices")


def test_dryrun_multichip_raises_without_enough_cards():
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    with pytest.raises(RuntimeError, match="cards"):
        graft_entry.dryrun_multichip(cards + 1)
    with pytest.raises(ValueError, match="backend"):
        graft_entry.dryrun_multichip(1, backend="mpi")


# -- the def-by-def comparison -----------------------------------------------

# Public names of the JAX package the port does not carry under the same
# module and name, with the reason (ROADMAP "Not ported").
NOT_PORTED = {
    # the NumPy reference of the C++ semantics, which the tests use from
    # the JAX package
    "oracle": "*",
    # JAX's mesh and jax.Array plumbing; the port's ranks are a Comm
    # (distributed.make_group, local_columns, gather_columns)
    "parallel.distributed": {"make_global_mesh", "host_local_to_global",
                             "global_to_host_replicated"},
    "parallel.sharded": {"make_mesh"},
    # JAX's environment switches (read as PCSEG_*): the debug switches and
    # backend selectors of its XLA program (the port selects by impl=), the
    # stage-A schedule and the grower's debug escape hatches (the schedule
    # is the grower's stage_a_gens/stage_a_rings parameters; the box
    # factor stays 4/3, the default every JAX caller runs), and the host
    # library's cache directory (the port builds inside its checkout)
    "env": {"PCSEG_DEBUG_BATCHED", "PCSEG_DEBUG_TRACK", "PCSEG_GROW_SKIP",
            "PCSEG_EPOCH_IMPL", "PCSEG_FLOOD_IMPL", "PCSEG_CCL_IMPL",
            "PCSEG_STAGE_A", "PCSEG_STAGEA", "PCSEG_RADII_FACTOR",
            "PCSEG_NATIVE_CACHE"},
}


def public_names(package):
    """{module: public top-level def and class names} of a package's
    sources."""
    out = {}
    base = os.path.join(ROOT, package)
    for root, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(root, f)
                mod = os.path.relpath(path, base)[:-3].replace(os.sep, ".")
                with open(path) as fh:
                    tree = ast.parse(fh.read())
                out[mod] = {n.name for n in tree.body
                            if isinstance(n, (ast.FunctionDef, ast.ClassDef))
                            and not n.name.startswith("_")}
    return out


def test_every_public_name_of_the_jax_package_has_a_port_counterpart():
    import importlib
    missing = []
    for mod, names in sorted(public_names("pcseg_tpu").items()):
        skip = NOT_PORTED.get(mod, set())
        if skip == "*":
            continue
        port = importlib.import_module(f"pcseg_tpu_torch.{mod}")
        missing += [f"{mod}.{n}" for n in sorted(names - skip)
                    if not hasattr(port, n)]
    assert missing == []
    for counterpart in ("make_group", "local_columns", "gather_columns"):
        assert hasattr(importlib.import_module(
            "pcseg_tpu_torch.parallel.distributed"), counterpart)


def _switches(package):
    import re
    found = set()
    for root, _, files in os.walk(os.path.join(ROOT, package)):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f)) as fh:
                    found |= set(re.findall(r"PCSEG_[A-Z_]+", fh.read()))
    return found


def test_jax_environment_switches_are_listed_and_the_port_reads_none():
    assert _switches("pcseg_tpu") == NOT_PORTED["env"]
    assert _switches("pcseg_tpu_torch") == set()


# JAX parameters whose port counterpart has another name or default, or
# none: {function: ({JAX parameter: port parameter, or None}, reason)}.
# A parameter reads "name" or "name=default"; "*" stands for every
# parameter of the function.
RENAMED = {
    "ops.nansafe.all_finite": (
        {"axis=-1": "dim=-1"}, "torch names an axis dim"),
    "parallel.halo.exchange_halo": (
        {"axis_name": "comm", "axis=1": "dim=1"},
        "a rank's group is a Comm, not a mesh axis; torch names an axis dim"),
    "parallel.halo.crop_halo": ({"axis=1": "dim=1"},
                                "torch names an axis dim"),
    **{f"parallel.sharded.{fn}": ({"axis": "comm"},
                                  "a rank's group is a Comm, not a mesh axis")
       for fn in ("sharded_normals", "sharded_plane_support_seeds",
                  "sharded_plane_support_rank_grid",
                  "sharded_grow_planar_regions",
                  "sharded_grow_planar_regions_batched",
                  "sharded_connected_components")},
    "parallel.sharded.build_sharded_segment_step": (
        {"mesh": "comm", "axis='space'": None},
        "the Comm takes the place of the mesh and of its axis name"),
    "parallel.distributed.initialize": (
        "*", "torch.distributed's rendezvous (backend, init method, world "
        "size, rank) takes the place of JAX's coordinator parameters"),
    "models.unorganized.cluster_unorganized_mean_shift": (
        {"backend='auto'": "backend='device'"},
        "entry points run on the card unless the caller asks for the host"),
}


def _param(p):
    """A parameter as "name" or "name=default"; dtypes by their name, so
    jnp.float32 reads as torch.float32 does."""
    if p.default is p.empty:
        return p.name
    d = p.default
    name = getattr(d, "__name__", None) if isinstance(d, type) else None
    return f"{p.name}={name or str(d).replace('torch.', '')}" \
        if name or isinstance(d, torch.dtype) else f"{p.name}={d!r}"


def _params(fn):
    import inspect
    return [_param(p) for p in inspect.signature(fn).parameters.values()]


def public_callables(package_mod, names):
    """(qualified name, object) of the public functions, classes and
    class methods among ``names`` of a module."""
    import inspect
    for n in sorted(names):
        obj = getattr(package_mod, n)
        yield n, obj
        if inspect.isclass(obj) and not hasattr(obj, "_fields"):
            for m, v in vars(obj).items():
                if (m == "__init__" or not m.startswith("_")) and \
                        not isinstance(v, property) and callable(
                            getattr(obj, m)):
                    yield f"{n}.{m}", getattr(obj, m)


def test_every_jax_parameter_list_starts_the_port_s():
    """For every public function, class and method of the JAX package,
    JAX's parameter list (names, order, defaults) is the start of the
    port's, apart from RENAMED; the port's own parameters come after it.
    Where JAX has no default the port may have one: every JAX call passes
    that argument."""
    import importlib
    bad, used = [], set()
    for mod, names in sorted(public_names("pcseg_tpu").items()):
        skip = NOT_PORTED.get(mod, set())
        if skip == "*":
            continue
        jax_mod = importlib.import_module(f"pcseg_tpu.{mod}")
        port_mod = importlib.import_module(f"pcseg_tpu_torch.{mod}")
        port_objs = dict(public_callables(port_mod, names - skip))
        for qual, obj in public_callables(jax_mod, names - skip):
            if qual not in port_objs:
                bad.append(f"{mod}.{qual}: missing")
                continue
            try:
                want = _params(obj)
            except (TypeError, ValueError):
                continue  # no signature (a builtin)
            got = _params(port_objs[qual])
            renamed, _ = RENAMED.get(f"{mod}.{qual}", ({}, ""))
            if renamed:
                used.add(f"{mod}.{qual}")
            if renamed == "*":
                continue
            want = [renamed.get(p, p) for p in want]
            want = [p for p in want if p is not None]
            ok = len(got) >= len(want) and all(
                g == w or (g.split("=")[0] == w and "=" not in w)
                for g, w in zip(got, want))
            if not ok:
                bad.append(f"{mod}.{qual}: JAX {want}, port {got}")
    assert bad == []
    assert used == set(RENAMED)  # no stale row
    assert all(why for _, why in RENAMED.values())


# -- the field-by-field comparison ----------------------------------------------

# Every field of every public result type, with the tests that hold it to
# JAX and its bar: "exact", a named tolerance ("file::name"), another bar
# in words, or "not compared: <why>". A nested result (a NamedTuple or a
# dataclass field, or a list of them) is listed field by field.
# PlanarRegions is the result of both growers (models/planar.py returns
# the batched grower's type), tested each in its own case.
_G = "tests/test_torch_grower.py::"
_C = "tests/test_torch_jax_conventions.py::"
_F = "tests/test_torch_frame.py::"
_MS = "tests/test_torch_mean_shift.py::"
_U = "tests/test_torch_unorganized.py::"
GROWERS = (_G + "test_grower_matches_jax",
           _C + "test_grower_schedule_matches_jax",
           _C + "test_grower_schedule_matches_jax_golden_128x160",
           "tests/test_torch_planar_seq.py::test_grower_matches_jax",
           _C + "test_sequential_grower_single_frame")
SHARDED = ("tests/test_torch_sharded_grow.py::test_sharded_growers_match_jax",
           "tests/test_torch_sharded_grow.py::"
           "test_sharded_grower_under_a_binding_cap_matches_jax")
REGION_BARS = _G + "region_bars"
SOLVE = ("tests/test_torch_ops.py::test_plane_fit_solve",)
FRAME = (_F + "test_frame_matches_jax",)
EXACT_FRAME = "exact (frame_arrays)"
FIELD_TABLE = {
    **{f"PlanarRegions.{f}": (GROWERS + SHARDED, "exact")
       for f in ("labels", "num_regions", "counts", "seed_indices",
                 "overflow")},
    "PlanarRegions.planes": (GROWERS + SHARDED, _G + "plane_tolerance"),
    **{f"PlanarRegions.{f}": (GROWERS, REGION_BARS)
       for f in ("centroids", "curvatures", "moments.s2", "moments.s1",
                 "moments.w", "moments.normal_hint")},
    "PlaneSolution.plane": (SOLVE, "rtol 1e-6, atol 1e-5 off the FLT_MIN "
                                   "validity edge"),
    "PlaneSolution.normal": (SOLVE, "rtol 1e-6, atol 1e-5 off the edge"),
    "PlaneSolution.centroid": (SOLVE, "rtol 1e-6, atol 1e-6"),
    "PlaneSolution.curvature": (SOLVE, "rtol 1e-4, atol 1e-6 off the edge"),
    "PlaneSolution.mid_ratio": (SOLVE, "rtol 1e-4, atol 1e-6 off the edge"),
    "PlaneSolution.valid": (SOLVE, "exact off the edge"),
    **{f"RankedSeeds.{f}": ((_C + "test_plane_support_seeds_single_frame",),
                            "exact")
       for f in ("indices", "valid", "count", "rank_grid")},
    **{f"SeedMask.{f}": ((_C + "test_average_normal_seeds_single_frame",
                          "tests/test_torch_avg_seeds.py::"
                          "test_average_normal_seeds_match_jax"), "exact")
       for f in ("mask", "seed_index", "score")},
    **{f"NormalSupport.{f}": ((_C + "test_normals_single_frame",), "exact")
       for f in ("count", "center_valid", "moments.s2", "moments.s1",
                 "moments.w", "moments.normal_hint")},
    **{f"ClusterResult.{f}": ((_C + "test_segment_clusters_single_frame",
                               _MS + "test_segment_clusters_while_matches_jax"),
                              "exact")
       for f in ("labels", "num_regions", "region_sizes", "roots")},
    **{f"MeanShiftState.{f}": ((_C + "test_mean_shift_single_frame",
                                _MS + "test_mean_shift_modes_match_jax"),
                               "exact")
       for f in ("pos", "idx", "valid", "intensity", "is_seed")},
    **{f"MeanShiftRegion.{f}": ((_MS + "test_growth_from_jax_modes_matches_jax",
                                 _MS + "test_sliding_mean_shift_matches_jax"),
                                "exact")
       for f in ("label_id", "inlier_indices", "seed")},
    **{f"FrameResult.{f}": (FRAME, EXACT_FRAME)
       for f in ("labels", "cluster_sizes")},
    "FrameResult.num_clusters": (FRAME, "exact"),
    "FrameResult.normals": ((), "not compared: None in both packages (the "
                                "normals stay on the device; the test "
                                "asserts None)"),
    **{f"FrameResult.metrics.{f}": (FRAME, EXACT_FRAME)
       for f in pipeline.FrameMetrics._fields},
    "FrameResult.classification_summary.total_considered": (FRAME, "exact"),
    **{f"FrameResult.classification_summary.{side}.{f}": (FRAME, "exact")
       for side in ("floor_rejections", "coffee_table_rejections")
       for f in ("rejected_for_angle", "rejected_for_distance",
                 "rejected_for_size")},
    **{f"FrameResult.planar_regions.{f}": (FRAME, EXACT_FRAME)
       for f in ("count", "seed_point_index", "boundary_indices",
                 "discontinuous_boundary_indices", "plane_class")},
    "FrameResult.planar_regions.label_id": (FRAME, "exact"),
    "FrameResult.planar_regions.plane": (FRAME, _G + "plane_tolerance"),
    "FrameResult.planar_regions.centroid": (FRAME, _G + "plane_tolerance"),
    "FrameResult.planar_regions.curvature": (FRAME, REGION_BARS),
    "FrameResult.planar_regions.area": (FRAME, _F + "AREA_RTOL"),
    "FrameResult.planar_regions.projected_boundary_points": (
        FRAME, _F + "polygon_tolerance"),
    **{f"FrameResult.objects.{f}": (FRAME, "exact")
       for f in ("object_class", "points",
                 "discontinuous_boundary_positions")},
    **{f"FrameResult.objects.{f}": (FRAME, _G + "plane_tolerance")
       for f in ("centroid", "plane")},
    **{f"UnorganizedClusterResult.{f}": (
        (_U + "test_cluster_unorganized_matches_jax",), "exact")
       for f in ("point_labels", "grid_labels", "num_regions",
                 "region_sizes")},
    **{f"VoxelGrid.{f}": ((_U + "test_voxelize_matches_jax",), "exact")
       for f in ("counts", "point_cell", "origin", "cell_size")},
    "VoxelGrid.points": ((_U + "test_voxelize_matches_jax",),
                         "2 f32 ulps (JAX's f32 cell sums in point order)"),
}


def result_types():
    """{name: class} of the public result types the table covers."""
    from pcseg_tpu_torch.models import mean_shift, planar, unorganized
    from pcseg_tpu_torch.ops import normals, plane_fit, seeds, voxelize
    assert planar.PlanarRegions is planar_batched.PlanarRegions
    return {c.__name__: c for c in (
        planar_batched.PlanarRegions, plane_fit.PlaneSolution,
        seeds.RankedSeeds, seeds.SeedMask, normals.NormalSupport,
        cluster.ClusterResult, mean_shift.MeanShiftState,
        mean_shift.MeanShiftRegion, pipeline.FrameResult,
        unorganized.UnorganizedClusterResult, voxelize.VoxelGrid)}


def field_paths(cls, prefix):
    """Dotted paths of every field of a NamedTuple or dataclass, nested
    results (and lists of them) expanded."""
    import dataclasses
    import typing
    names = cls._fields if hasattr(cls, "_fields") else \
        [f.name for f in dataclasses.fields(cls)]
    hints = typing.get_type_hints(cls)
    out = []
    for name in names:
        hint = hints.get(name)
        if typing.get_origin(hint) in (list, typing.List):
            hint = typing.get_args(hint)[0]
        if isinstance(hint, type) and (hasattr(hint, "_fields") or
                                       dataclasses.is_dataclass(hint)):
            out += field_paths(hint, f"{prefix}{name}.")
        else:
            out.append(prefix + name)
    return out


def _defined(ref):
    """Whether "file::name" names a top-level def or assignment there."""
    path, name = ref.split("::")
    full = os.path.join(ROOT, path)
    if not os.path.exists(full):
        return False
    with open(full) as fh:
        tree = ast.parse(fh.read())
    return any(getattr(n, "name", None) == name or
               any(getattr(t, "id", None) == name
                   for t in getattr(n, "targets", ()))
               for n in tree.body)


def field_table_problems(table, types):
    """What is wrong with ``table`` against the result ``types``: fields
    with no row, rows of no field, tests or named bars that do not exist,
    rows with no test that are not marked as not compared."""
    fields = {p for name, cls in types.items()
              for p in field_paths(cls, name + ".")}
    problems = [f"no row: {f}" for f in sorted(fields - set(table))]
    problems += [f"no such field: {f}" for f in sorted(set(table) - fields)]
    for row, (tests, bar) in sorted(table.items()):
        problems += [f"{row}: no test {t}" for t in tests if not _defined(t)]
        if "::" in bar and not _defined(bar):
            problems.append(f"{row}: no bar {bar}")
        if not tests and not bar.startswith("not compared: "):
            problems.append(f"{row}: no test")
    return problems


def test_every_field_of_every_public_result_is_compared():
    """FIELD_TABLE lists every field of every public result type, each
    with the tests that compare it against JAX and its bar."""
    assert field_table_problems(FIELD_TABLE, result_types()) == []


def test_field_table_check_finds_drift():
    """The check above fails on a field with no row, on a row of no field
    and on a test or bar that no longer exists."""
    types = result_types()
    table = dict(FIELD_TABLE)
    del table["PlanarRegions.curvatures"]
    table["PlanarRegions.flatness"] = table["PlanarRegions.labels"]
    table["RankedSeeds.count"] = ((_C + "test_gone",), "exact")
    table["VoxelGrid.points"] = (SOLVE, _G + "gone_tolerance")
    assert field_table_problems(table, types) == [
        "no row: PlanarRegions.curvatures",
        "no such field: PlanarRegions.flatness",
        f"RankedSeeds.count: no test {_C}test_gone",
        f"VoxelGrid.points: no bar {_G}gone_tolerance"]


# -- on the card -------------------------------------------------------------


@pytest.mark.cuda
def test_surface_on_the_card_matches_the_cpu(cuda_device):
    """flood_fill_static launches B3 once and equals the plain version;
    the mask CCL and the classification equal the CPU."""
    gate, src = (torch.from_numpy(a) for a in flood_case())
    launches = profiling.total("launches.flood_packed")
    got = planar_batched.flood_fill_static(gate.to(cuda_device),
                                           src.to(cuda_device), 64)
    assert profiling.total("launches.flood_packed") == launches + 1
    assert torch.equal(got.cpu(), planar_batched.flood_fill_static(
        gate, src, 64))
    for name in ("p30", "serpentine"):
        mask = torch.from_numpy(mask_case(name))
        for cap in (64, 4):
            assert torch.equal(connectivity.connected_components_mask(
                mask.to(cuda_device), max_iters=cap).cpu(),
                connectivity.connected_components_mask(mask, max_iters=cap))
    args = [torch.from_numpy(np.asarray(a))
            for a in classify_inputs([0.0, 0.0, 1.0])]
    assert torch.equal(classify.classify_planes_batched(
        *[a.to(cuda_device) for a in args], CLASSIFY).cpu(),
        classify.classify_planes_batched(*args, CLASSIFY))
