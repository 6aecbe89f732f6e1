"""Ranks of the port's sharded tests (tests/test_torch_sharded*.py).

``run_ranks(suite, n, inputs, tmp)`` starts ``n`` processes of this file,
each one rank of a gloo process group on CPU tensors that meets over a
FileStore under ``tmp`` (no fixed ports), with a timeout on the group and
on each process. Every rank runs the suite on its column block of the
inputs and writes its results; ``run_ranks`` returns them merged: keys
``"L:<name>"`` hold column blocks (concatenated along axis 1, or the axis
after the name's ``@``), keys ``"R:<name>"`` replicated values (every rank
must hold the same bytes). The ``env`` suite joins the group from
torchrun's environment variables instead of the store; the ``gather``
suite gathers each rank's slice of the inputs' ``cases`` through
``Comm.all_gather`` and through the list form of ``all_gather``.

Child usage: python tests/torch_sharded_worker.py <rank> <world> <store>
<inputs.npz> <out prefix> <suite>
"""

import os
import socket
import subprocess
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(suite, n, inputs, tmp):
    """Run ``suite`` on ``n`` ranks; returns the merged results dict."""
    tmp = str(tmp)
    inp = os.path.join(tmp, f"{suite}_{n}_inputs.npz")
    np.savez(inp, **inputs)
    prefix = os.path.join(tmp, f"{suite}_{n}_out")
    store = os.path.join(tmp, f"{suite}_{n}_store")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    if suite == "env":
        env.update(MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
                   WORLD_SIZE=str(n))
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(r), str(n), store,
         inp, prefix, suite], env=dict(env, RANK=str(r)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for r in range(n)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} of {n} failed:\n{out[-4000:]}"
    per_rank = [dict(np.load(f"{prefix}_{r}.npz")) for r in range(n)]
    merged = {}
    for key in per_rank[0]:
        vals = [d[key] for d in per_rank]
        if key.startswith("R:"):
            for r, v in enumerate(vals[1:], 1):
                assert v.tobytes() == vals[0].tobytes(), \
                    f"{key} differs between rank 0 and rank {r}"
            merged[key] = vals[0]
        else:
            axis = int(key.split("@")[1]) if "@" in key else 1
            merged[key] = np.concatenate(vals, axis=axis)
    return merged


def _suite(name, comm, data, res):
    import torch

    from pcseg_tpu_torch.models.config import (
        UNLABELED, ComputeNormalsParams, PlanarRegionConfig,
        SeedsFromPlaneSupportParams)
    from pcseg_tpu_torch.parallel import distributed, halo, sharded

    def local(key):
        return distributed.local_columns(data[key], comm)

    def block(key, arr, axis=1):
        arr = arr.cpu().numpy()
        res[f"L:{key}" + (f"@{axis}" if axis != 1 else "")] = \
            arr.astype(np.uint8) if arr.dtype == bool else arr

    def repl(key, arr):
        res[f"R:{key}"] = np.asarray(arr.cpu().numpy() if torch.is_tensor(arr)
                                     else arr)

    def region_table(prefix, regions):
        block(prefix + "labels", regions.labels)
        for f in ("num_regions", "planes", "centroids", "counts",
                  "seed_indices", "overflow"):
            repl(prefix + f, getattr(regions, f))

    if name == "blocks":
        src = local("halo_src")
        for k in data["halo_ks"].tolist():
            block(f"halo_k{k}", halo.exchange_halo(src, k, comm))
        pts, origin = local("room_pts"), torch.as_tensor(data["room_origin"])
        block("normals", sharded.sharded_normals(
            pts, origin, ComputeNormalsParams(max_scan_steps=8), comm))
        h, w = data["room_pts"].shape[:2]
        nrm = local("room_nrm")
        params = SeedsFromPlaneSupportParams()
        idx, valid = sharded.sharded_plane_support_seeds(pts, nrm, params, h,
                                                         w, comm)
        repl("seed_idx", idx)
        repl("seed_valid", valid)
        block("rank_grid", sharded.sharded_plane_support_rank_grid(
            pts, nrm, params, h, w, comm))
        gate = distributed.local_columns(
            torch.as_tensor(data["flood_gate"]).permute(1, 2, 0), comm) \
            .permute(2, 0, 1).bool()
        srcs = distributed.local_columns(
            torch.as_tensor(data["flood_src"]).permute(1, 2, 0), comm) \
            .permute(2, 0, 1).bool()
        for cap in data["flood_caps"].tolist():
            block(f"flood_cap{cap}", sharded._sharded_flood_packed(
                gate, srcs, comm, cap), axis=2)
        for key in ("ccl16", "ccl_clut"):
            p = local(key + "_pts")
            block(key, sharded.sharded_connected_components(
                p, local(key + "_elig").bool(), 1.0, 1,
                p.shape[0], data[key + "_pts"].shape[1], comm))
    elif name == "growers":
        pts, nrm = local("room_pts"), local("room_nrm")
        h, w = data["room_pts"].shape[:2]
        lab0 = torch.full(pts.shape[:2], UNLABELED, dtype=torch.int32)
        region_table("bg_", sharded.sharded_grow_planar_regions_batched(
            pts, nrm, lab0, torch.as_tensor(data["bg_seed_idx"]),
            torch.as_tensor(data["bg_seed_valid"]), PlanarRegionConfig(),
            h, w, comm))
        region_table("sq_", sharded.sharded_grow_planar_regions(
            pts, nrm, lab0, torch.as_tensor(data["sq_seed_idx"]),
            torch.as_tensor(data["sq_seed_valid"]),
            PlanarRegionConfig(max_regions=16), h, w, comm,
            max_attempts=32))
        if "cap_rounds" in data:  # the batched grower under a flood cap
            region_table("cap_", sharded.sharded_grow_planar_regions_batched(
                local("cap_pts"), local("cap_nrm"), lab0,
                torch.as_tensor(data["cap_seed_idx"]),
                torch.as_tensor(data["cap_seed_valid"]),
                PlanarRegionConfig(), h, w, comm,
                flood_rounds=int(data["cap_rounds"])))
    elif name == "gather":
        # Comm.all_gather (one buffer) against the list form it replaced
        for key in data["cases"].tolist():
            x = torch.as_tensor(data[key][comm.rank])
            y = (x.to(torch.uint8) if x.dtype == torch.bool else x) \
                .contiguous()
            parts = [torch.empty_like(y) for _ in range(comm.size)]
            torch.distributed.all_gather(parts, y)
            old = torch.stack(parts)
            repl("new_" + key, comm.all_gather(x))
            repl("old_" + key, old.to(x.dtype))
            if x.dtype != torch.bool:
                repl("psum_" + key, comm.psum(x))
    elif name in ("step", "golden", "env"):
        for scene in data["scenes"].tolist():
            kw = {} if name == "golden" else dict(
                normals_params=ComputeNormalsParams(max_scan_steps=8),
                seed_params=SeedsFromPlaneSupportParams(max_seeds=4096),
                planar_config=PlanarRegionConfig(max_regions=16),
                max_attempts=32)
            step = sharded.build_sharded_segment_step(comm, **kw)
            out = step(local(scene + "_pts"), data[scene + "_origin"])
            if name == "env":
                # the gathered grid, as JAX's global_to_host_replicated
                repl(scene + "_labels", distributed.gather_columns(
                    out.labels, comm))
            else:
                block(scene + "_labels", out.labels)
                block(scene + "_normals", out.normals)
            repl(scene + "_num_regions", out.planar.num_regions)
            repl(scene + "_num_clusters", out.num_clusters)
            repl(scene + "_planes", out.planar.planes)
    else:
        raise ValueError(f"unknown suite {name!r}")


def main():
    rank, world, store, inp, prefix, suite = sys.argv[1:7]
    rank, world = int(rank), int(world)
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from pcseg_tpu_torch.parallel import distributed

    if suite == "env":
        assert distributed.initialize("gloo", timeout_s=TIMEOUT_S)
    else:
        fs = torch.distributed.FileStore(store, world)
        assert distributed.initialize("gloo", store=fs, world_size=world,
                                      rank=rank, timeout_s=TIMEOUT_S)
    # a second call keeps the group
    assert distributed.initialize("gloo")
    comm = distributed.make_group(device="cpu")
    assert (comm.rank, comm.size, comm.transport) == (rank, world, "gloo")
    res = {}
    with np.load(inp) as data:
        _suite(suite, comm, data, res)
    np.savez(f"{prefix}_{rank}.npz", **res)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
