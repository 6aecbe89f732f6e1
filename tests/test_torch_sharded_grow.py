"""The port's sharded growers against JAX's on the CPU: the batched grower
with the sharded hooks (models/planar_batched.GrowerBackend) and the
sequential wavefront grower, at 2 and 4 ranks (processes on a gloo group,
tests/torch_sharded_worker.py) against JAX's functions on meshes of as
many virtual CPU devices, on tests/test_sharded.py's 48x64 room: labels,
region counts, region sizes and seed cells exact, planes within the
port's plane tolerance (tests/test_torch_sharded_step.py).
"""

import jax
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
    if n not in _CACHE:
        _CACHE[n] = run_ranks("growers", n, inp,
                              tmp_path_factory.mktemp(f"growers{n}"))
    got = _CACHE[n]
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
