"""One robot's loop with the mean shift: ``frame``'s path
(``Segmenter.segment_frame_stream`` on one [H, W] u16 frame at a time) for
a configuration whose ``cluster.cluster_method`` is ``MEAN_SHIFT``.

The program side is ``frame``'s. The reference's ``Segmenter`` is
``models/pipeline_mean_shift.py`` of the plain copy, whose finalize takes
the mean-shift branch (the control runs it in the program's place)."""

from __future__ import annotations

from portbench.paths import frame
from portbench.paths.common import REFERENCE, modules


class Path(frame.Path):

    def _segmenter(self, package):
        if package != REFERENCE:
            return super()._segmenter(package)
        (pipeline,) = modules(REFERENCE, "models.pipeline_mean_shift")
        return pipeline.Segmenter(self.segmenter_config(REFERENCE),
                                  device=self.device)
