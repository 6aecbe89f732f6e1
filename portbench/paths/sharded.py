"""The column-sharded step: ``parallel/sharded.build_sharded_segment_step``
on one rank of a ``torch.distributed`` group, one rank per card. Every
rank makes the same frames from the seed (f32 points, unprojected on the
host) and hands the step its own block of columns; the step's labels
block, planar and cluster counts and planes come back to the host."""

from __future__ import annotations

from portbench.bench import compare
from portbench.paths.common import REFERENCE, Driver, modules
from portbench.traffic import scenes


class Path(Driver):
    profile_requests = 3

    def __init__(self, torch, cell, seed, device, program, comm=None):
        super().__init__(torch, cell, seed, device, program)
        self.comm = comm
        self.points = [scenes.unproject_range_np(
            d[0], self.rays, self.frame["depth_scale"])
            for d in self.requests]

    @property
    def points_per_request(self) -> int:
        return self.frame["rows"] * self.frame["cols"]

    def _step(self, package, comm):
        (sharded,) = modules(package, "parallel.sharded")
        c = self.segmenter_config(package)
        return sharded.build_sharded_segment_step(
            comm, normals_params=c.normals,
            seed_params=c.plane_support_seeds, planar_config=c.planar,
            cluster_config=c.cluster)

    def setup(self):
        (self.dist,) = modules(self.program, "parallel.distributed")
        self.step = self._step(self.program, self.comm)
        for i in range(2):
            self.request(i)

    def _run(self, step, dist, comm, p):
        res = step(dist.local_columns(self.points[p], comm), self.origin)
        return (res.labels.cpu().numpy(),
                int(res.planar.num_regions), int(res.num_clusters),
                res.planar.planes.cpu().numpy())

    def request(self, i):
        return self._run(self.step, self.dist, self.comm,
                         self.pool_index(i))

    def release(self):
        self.step = None

    def reference(self) -> dict:
        halo, dist = modules(REFERENCE, "parallel.halo",
                             "parallel.distributed")
        comm = halo.Comm(None, device=self.device)
        step = self._step(REFERENCE, comm)
        return {p: self._run(step, dist, comm, p) for p in self.sample}

    tally = staticmethod(compare.sharded_tally)
    compare = staticmethod(compare.compare_sharded)
