"""One robot's loop: ``Segmenter.segment_frame_stream`` on one [H, W] u16
frame at a time, giving the full ``FrameResult`` (classified planar
records, clusters, detected objects) on the host."""

from __future__ import annotations

from portbench.bench import compare
from portbench.paths.common import REFERENCE, Driver, modules


def arrays(result) -> dict:
    """A FrameResult as the flat arrays the check compares: the reference
    copy's ``frame_arrays`` plus each detected object's class, points,
    centroid, plane and discontinuous positions."""
    (pipeline,) = modules(REFERENCE, "models.pipeline")
    out = pipeline.frame_arrays(result)
    out["objects"] = [(o.object_class, o.points, o.centroid, o.plane,
                       o.discontinuous_boundary_positions)
                      for o in result.objects]
    return out


class Path(Driver):
    profile_requests = 3

    def _segmenter(self, package):
        (pipeline,) = modules(package, "models.pipeline")
        return pipeline.Segmenter(self.segmenter_config(package),
                                  device=self.device)

    def setup(self):
        self.seg = self._segmenter(self.program)
        for i in range(2):
            self.request(i)

    def _run(self, seg, depth):
        return seg.segment_frame_stream(depth[0], self.rays, self.origin,
                                        self.frame["depth_scale"])

    def request(self, i):
        return self._run(self.seg, self.requests[self.pool_index(i)])

    def release(self):
        self.seg = None

    def reference(self) -> dict:
        seg = self._segmenter(REFERENCE)
        return {p: arrays(self._run(seg, self.requests[p]))
                for p in self.sample}

    tally = staticmethod(compare.frame_tally)

    @staticmethod
    def compare(t, got, want):
        compare.compare_frame(t, arrays(got), want)
