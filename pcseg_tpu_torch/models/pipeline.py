"""The device forward of the segmentation pipeline (port of
pcseg_tpu.models.pipeline: ``device_forward``, ``device_forward_batched``
and the serving path ``device_forward_stream``).

normals -> plane-support seed ranks -> batched planar growth -> euclidean
cluster closure, with cluster ids following the planar ids. Frames are a
real batch axis; everything runs on ``device``. The host finalize
(``segment_frame*``) is not ported yet.
"""

from __future__ import annotations

import torch

from pcseg_tpu_torch.models import cluster, planar_batched
from pcseg_tpu_torch.models.config import UNLABELED, SegmenterConfig
from pcseg_tpu_torch.ops import normals as normals_op
from pcseg_tpu_torch.ops import seeds as seeds_op
from pcseg_tpu_torch.ops import unproject


class Segmenter:
    """Stateless device pipeline over organized [B, H, W] clouds.

    ``impl="plain"`` makes every kernel on the path take its plain PyTorch
    version (for tests and the smoke script's comparisons only)."""

    def __init__(self, config: SegmenterConfig = SegmenterConfig(),
                 device="cpu", impl=None):
        if config.seed_method != "plane_support":
            raise NotImplementedError("only plane_support seeds are ported")
        if config.planar.growth_mode != "batched":
            raise NotImplementedError("only the batched grower is ported")
        self.config = config
        self.device = torch.device(device)
        self.impl = impl

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _forward(self, points, sensor_origin, labels0=None, need_sizes=True):
        """[B, H, W, 3] points -> (final labels, normals, planar regions,
        cluster result), all batched."""
        cfg = self.config
        b, h, w = points.shape[:3]
        nrm = normals_op.compute_normals_organized(points, sensor_origin,
                                                   cfg.normals)
        ranked = seeds_op.seeds_from_plane_support(points, nrm,
                                                   cfg.plane_support_seeds)
        if labels0 is None:
            labels0 = torch.full((b, h, w), UNLABELED, dtype=torch.int32,
                                 device=points.device)
        dev = planar_batched.grow_planar_regions_batched(
            points, nrm, labels0, ranked.rank_grid, cfg.planar,
            impl=self.impl)
        cres = cluster.segment_clusters(points, dev.labels, cfg.cluster,
                                        need_sizes=need_sizes,
                                        impl=self.impl)
        final = torch.where((cres.labels >= 0) & (dev.labels == UNLABELED),
                            cres.labels + dev.num_regions[:, None, None],
                            cres.labels)
        return final, nrm, dev, cres

    def device_forward(self, points, sensor_origin, input_mask=None):
        """One [H, W, 3] frame -> (labels [H, W], normals, regions, cluster
        result) without the frame axis. ``input_mask`` ([H, W] int32)
        carries MASKED_* sentinels that growth and clustering never claim.
        """
        pts = self._tensor(points, torch.float32)[None]
        origin = self._tensor(sensor_origin, torch.float32)
        mask = None if input_mask is None else \
            self._tensor(input_mask, torch.int32)[None]
        final, nrm, dev, cres = self._forward(pts, origin, mask)
        return (final[0], nrm[0], type(dev)(*[_first(x) for x in dev]),
                type(cres)(*[_first(x) for x in cres]))

    def device_forward_batched(self, points_batch, sensor_origins):
        """[B, H, W, 3] frames and [B, 3] origins -> batched
        (labels, normals, regions, cluster result with sizes)."""
        return self._forward(self._tensor(points_batch, torch.float32),
                             self._tensor(sensor_origins, torch.float32))

    def device_forward_stream(self, depth_batch_u16, rays, sensor_origin,
                              depth_scale=unproject.DEFAULT_DEPTH_SCALE):
        """Serving path: [B, H, W] u16 range frames -> ([B, H, W] uint8
        labels (255 = unlabeled), num_planar [B], num_clusters [B],
        planes [B, K, 4]). 2 bytes/px in, 1 byte/px out.

        Like the JAX path, the uint8 cast wraps ids >= 256 (cluster ids are
        not capped)."""
        depth = self._tensor(depth_batch_u16)
        points = unproject.unproject_range(
            depth, self._tensor(rays, torch.float32), depth_scale)
        final, _, dev, cres = self._forward(
            points, self._tensor(sensor_origin, torch.float32),
            need_sizes=False)
        labels_u8 = torch.where(final >= 0, final, 255).to(torch.uint8)
        return labels_u8, dev.num_regions, cres.num_regions, dev.planes


def _first(x):
    if isinstance(x, tuple):
        return type(x)(*[_first(v) for v in x])
    return x[0]
