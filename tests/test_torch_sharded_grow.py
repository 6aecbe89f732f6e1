"""The port's sharded growers against JAX's on the CPU: the batched grower
with the sharded hooks (models/planar_batched.GrowerBackend) and the
sequential wavefront grower, at 2 and 4 ranks (processes on a gloo group,
tests/torch_sharded_worker.py) against JAX's functions on meshes of as
many virtual CPU devices, on tests/test_sharded.py's 48x64 room: labels,
region counts, region sizes and seed cells exact, planes within the
port's plane tolerance (tests/test_torch_sharded_step.py).

Under a binding flood cap the batched grower at 2 ranks is held to JAX's
sharded grower from a committed golden, ``jax_sharded_cap_48x64.npz``
(rewrite with ``JAX_PLATFORMS=cpu python -m tests.test_torch_sharded_grow``,
~30 s). On the room itself no cap binds: a shard's cap counts per local
flood, and JAX's sharded flood repeats the capped local flood for up to 16
rounds of halo exchanges in every closure epoch, which the room's convex
surfaces never need. So the golden's scene is the room with a serpentine
carved into it (rows of NaN walls across both blocks, three-column gaps at
alternating ends) and one seed in its first corridor: at cap 1 the region
stops short of the serpentine's end (the golden holds the free cap's
labels too, and the case asserts they differ).
"""

import functools
import os

if __name__ == "__main__":  # the golden's generator: 2 virtual CPU devices
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + (
        " --xla_force_host_platform_device_count=8")).strip()

import jax  # noqa: E402
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from pcseg_tpu import oracle
from pcseg_tpu.models import planar as jplanar
from pcseg_tpu.models.config import UNLABELED, PlanarRegionConfig
from pcseg_tpu.ops import plane_fit as jplane_fit
from pcseg_tpu.ops import seeds as jseeds
from pcseg_tpu.parallel import sharded as jsharded
from pcseg_tpu.utils.synthetic import synthetic_room_cloud

from pcseg_tpu_torch.models import pipeline
from pcseg_tpu_torch.ops import unproject
from tests.test_torch_kernels import cuda_device  # noqa: F401
from tests.test_torch_pipeline import GOLDEN as STREAM_GOLDEN
from tests.test_torch_sharded_step import H, RANKS, W, assert_planes
from tests.torch_sharded_worker import run_ranks

torch.set_num_threads(1)

_CACHE = {}
CAP = 1
CAP_GOLDEN = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pcseg_tpu_torch", "testdata", "jax_sharded_cap_48x64.npz")
CAP_FIELDS = ("labels", "num_regions", "planes", "counts", "seed_indices",
              "overflow")


def grower_inputs():
    pts, origin = synthetic_room_cloud(H, W, f=float(H), seed=9)
    nrm = oracle.compute_normals_organized(pts, origin).astype(np.float32)
    bg = jseeds.seeds_from_plane_support(jnp.asarray(pts), jnp.asarray(nrm))
    sq = jseeds.seeds_from_plane_support(jnp.asarray(pts), jnp.asarray(nrm),
                                         transposed_parity=False)
    return dict(room_pts=pts, room_nrm=nrm,
                bg_seed_idx=np.asarray(bg.indices),
                bg_seed_valid=np.asarray(bg.valid),
                sq_seed_idx=np.asarray(sq.indices),
                sq_seed_valid=np.asarray(sq.valid))


def serpentine_inputs():
    """The 48x64 room with a serpentine carved into it (see the module
    docstring), its normals and a seed vector of one cell."""
    pts, origin = synthetic_room_cloud(H, W, f=float(H), seed=9)
    pts = pts.copy()
    for r in range(3, H, 4):
        gap = range(3) if (r // 4) % 2 else range(W - 3, W)
        pts[r, [c for c in range(W) if c not in gap]] = np.nan
    nrm = oracle.compute_normals_organized(pts, origin).astype(np.float32)
    return dict(cap_pts=pts, cap_nrm=nrm, cap_seed_idx=np.int32([5 * H + 1]),
                cap_seed_valid=np.array([True]), cap_rounds=np.int32(CAP))


def jax_cap_golden():
    """JAX's sharded batched grower at 2 devices on the serpentine, at the
    binding cap (``cap_*``) and at a free one (``free_labels``)."""
    inp = serpentine_inputs()
    keyed = dict(room_pts=inp["cap_pts"], room_nrm=inp["cap_nrm"],
                 cap_seed_idx=inp["cap_seed_idx"],
                 cap_seed_valid=inp["cap_seed_valid"])
    out = {}
    for cap, prefix in ((CAP, "cap_"), (64, "free_")):
        fn = functools.partial(jsharded.sharded_grow_planar_regions_batched,
                               flood_rounds=cap)
        res = jax_grower(fn, 2, keyed, "cap_", PlanarRegionConfig())
        out.update({prefix + f: np.asarray(getattr(res, f))
                    for f in (CAP_FIELDS if cap == CAP else ("labels",))})
    return out


def jax_grower(fn, n, inp, prefix, cfg, *extra):
    spec = jplanar.PlanarRegions(
        labels=P(None, "space"), num_regions=P(), planes=P(),
        centroids=P(), curvatures=P(), counts=P(), seed_indices=P(),
        moments=jplane_fit.PlaneMoments(s2=P(), s1=P(), w=P(),
                                        normal_hint=P()),
        overflow=P())
    out = jax.jit(jax.shard_map(
        lambda p, q, si, sv: fn(
            p, q, jnp.full((H, W // n), UNLABELED, jnp.int32), si, sv, cfg,
            H, W, "space", 0, *extra),
        mesh=jsharded.make_mesh(n),
        in_specs=(P(None, "space", None), P(None, "space", None), P(), P()),
        out_specs=spec, check_vma=False))(
        jnp.asarray(inp["room_pts"]), jnp.asarray(inp["room_nrm"]),
        jnp.asarray(inp[prefix + "seed_idx"]),
        jnp.asarray(inp[prefix + "seed_valid"]))
    return out


@pytest.mark.parametrize("n", RANKS)
@pytest.mark.parametrize("grower", ["batched", "sequential"])
def test_sharded_growers_match_jax(tmp_path_factory, n, grower):
    inp = grower_inputs()
    got = growers_on_ranks(tmp_path_factory, n, inp)
    if grower == "batched":
        prefix, fn, cfg, extra = ("bg_", jsharded.
                                  sharded_grow_planar_regions_batched,
                                  PlanarRegionConfig(), ())
    else:
        prefix, fn, cfg, extra = ("sq_", jsharded.sharded_grow_planar_regions,
                                  PlanarRegionConfig(max_regions=16), (32,))
    want = jax_grower(fn, n, inp, prefix, cfg, *extra)
    num = int(want.num_regions)
    assert num >= 3 and int(got["R:" + prefix + "num_regions"]) == num
    np.testing.assert_array_equal(got["L:" + prefix + "labels"],
                                  np.asarray(want.labels))
    for f in ("counts", "seed_indices"):
        np.testing.assert_array_equal(got[f"R:{prefix}{f}"][:num],
                                      np.asarray(getattr(want, f))[:num],
                                      err_msg=f)
    assert bool(got[f"R:{prefix}overflow"]) == bool(want.overflow)
    assert_planes(got["R:" + prefix + "planes"], np.asarray(want.planes),
                  np.asarray(want.labels), inp["room_pts"], num)


def growers_on_ranks(tmp_path_factory, n, inp):
    """The worker's growers on ``n`` ranks, run once per n; at 2 ranks also
    the batched grower under the binding cap on the serpentine."""
    if n not in _CACHE:
        if n == 2:
            inp = dict(inp, **serpentine_inputs())
        _CACHE[n] = run_ranks("growers", n, inp,
                              tmp_path_factory.mktemp(f"growers{n}"))
    return _CACHE[n]


def test_sharded_grower_under_a_binding_cap_matches_jax(tmp_path_factory):
    """The batched grower at 2 ranks with ``flood_rounds=1`` equals JAX's
    sharded grower at the same cap (the golden): labels, region count,
    sizes, seed cells and overflow exact, planes within the plane
    tolerance. The cap binds: JAX's labels at a free cap differ."""
    gold = np.load(CAP_GOLDEN)
    assert (gold["cap_labels"] != gold["free_labels"]).sum() > 50
    got = growers_on_ranks(tmp_path_factory, 2, grower_inputs())
    num = int(gold["cap_num_regions"])
    assert num >= 1 and int(got["R:cap_num_regions"]) == num
    np.testing.assert_array_equal(got["L:cap_labels"], gold["cap_labels"])
    for f in ("counts", "seed_indices"):
        np.testing.assert_array_equal(got[f"R:cap_{f}"][:num],
                                      gold[f"cap_{f}"][:num], err_msg=f)
    assert bool(got["R:cap_overflow"]) == bool(gold["cap_overflow"])
    assert_planes(got["R:cap_planes"], gold["cap_planes"], gold["cap_labels"],
                  serpentine_inputs()["cap_pts"], num)


@pytest.mark.cuda
def test_grower_without_backend_holds_the_stream_golden(cuda_device):
    """``backend=None`` is the single-device grower as it was: on the card
    the 128x160 stream golden (jax_stream_128x160.npz: the epoch kernel at
    32 slots, the CCL kernel) comes out exactly, labels and counts."""
    gold = np.load(STREAM_GOLDEN)
    h, w = gold["depth"].shape[1:]
    rays = torch.from_numpy(unproject.camera_ray_table(h, w, f=float(h)))
    labels, npl, ncl, _ = pipeline.Segmenter(
        device=cuda_device).device_forward_stream(
        torch.from_numpy(gold["depth"]).to(cuda_device),
        rays.to(cuda_device), torch.zeros(3, device=cuda_device))
    np.testing.assert_array_equal(labels.cpu().numpy(), gold["labels"])
    np.testing.assert_array_equal(npl.cpu().numpy(), gold["num_planar"])
    np.testing.assert_array_equal(ncl.cpu().numpy(), gold["num_clusters"])


if __name__ == "__main__":
    np.savez_compressed(CAP_GOLDEN, **jax_cap_golden())
    print("wrote", CAP_GOLDEN, os.path.getsize(CAP_GOLDEN), "bytes")
