"""The reference's pipeline with the mean shift: ``models/pipeline.py``'s
``Segmenter``, whose host finalize takes the mean-shift branch
(``cluster.cluster_method = MEAN_SHIFT``) where the copy raises.

The planar half of the finalize is the copy's own, run without
clustering; the mean shift (``models/mean_shift.py``) then clusters the
cells it left UNLABELED, region ids following the planar ids, and each
accepted region becomes a detected object of class ``SEMANTIC_UNKNOWN``,
as in the program's finalize.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench.reference.port_plain.models import extract, mean_shift
from portbench.reference.port_plain.models import pipeline
from portbench.reference.port_plain.models.config import SEMANTIC_UNKNOWN


class Segmenter(pipeline.Segmenter):

    def _host_finalize(self, points_np, payload, rot_robot, recluster):
        cfg = self.config
        if not cfg.run_clustering or self._dev_cluster():
            return super()._host_finalize(points_np, payload, rot_robot,
                                          recluster)
        self.config = dataclasses.replace(cfg, run_clustering=False)
        try:
            planar = super()._host_finalize(points_np, payload, rot_robot,
                                            recluster)
        finally:
            self.config = cfg
        num_planar = len(planar.planar_regions)
        labels = planar.labels.copy()
        sizes = mean_shift.sliding_mean_shift(
            points_np, labels, cfg.cluster.min_region_inliers,
            cfg.mean_shift_iterations, num_planar, cfg.mean_shift,
            self.device)
        indexer = extract.RegionIndexer(labels)
        objects = planar.objects + [
            extract.cluster_detected_object(points_np, labels,
                                            num_planar + cid,
                                            SEMANTIC_UNKNOWN, indexer=indexer)
            for cid in range(len(sizes))]
        return dataclasses.replace(
            planar, labels=labels, num_clusters=len(sizes),
            cluster_sizes=np.asarray(sizes, np.int32), objects=objects,
            metrics=planar.metrics._replace(num_clusters=len(sizes)))
