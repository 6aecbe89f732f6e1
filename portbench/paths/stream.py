"""The serving path: ``Segmenter.device_forward_stream`` on [B, H, W] u16
frames from host memory; its labels, planar and cluster counts and planes
come back to the host on every request."""

from __future__ import annotations

from portbench.bench import compare
from portbench.paths.common import REFERENCE, Driver, modules


class Path(Driver):
    profile_requests = 2

    def _segmenter(self, package):
        (pipeline,) = modules(package, "models.pipeline")
        return pipeline.Segmenter(self.segmenter_config(package),
                                  device=self.device)

    def setup(self):
        torch = self.torch
        self.rays_d = torch.from_numpy(self.rays).to(self.device)
        self.origin_d = torch.from_numpy(self.origin).to(self.device)
        self.seg = self._segmenter(self.program)
        for i in range(2):
            self.request(i)

    def _run(self, seg, depth):
        out = seg.device_forward_stream(depth, self.rays_d, self.origin_d,
                                        self.frame["depth_scale"])
        return tuple(t.cpu().numpy() for t in out)

    def request(self, i):
        return self._run(self.seg, self.requests[self.pool_index(i)])

    def release(self):
        self.seg = None

    def reference(self) -> dict:
        seg = self._segmenter(REFERENCE)
        return {p: self._run(seg, self.requests[p]) for p in self.sample}

    tally = staticmethod(compare.stream_tally)
    compare = staticmethod(compare.compare_stream)
