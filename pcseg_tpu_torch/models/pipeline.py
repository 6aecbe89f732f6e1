"""The segmentation pipeline (port of pcseg_tpu.models.pipeline).

  * the device forward: ``device_forward``, ``device_forward_batched`` and
    the serving path ``device_forward_stream`` (normals -> plane-support
    seed ranks -> batched planar growth -> euclidean cluster closure, with
    cluster ids following the planar ids; frames are a real batch axis);
  * the full pipeline of one frame: ``segment_frame`` (f32 points) and
    ``segment_frame_stream`` (u16 range frame): the device program
    (growth, clusters on the device labels, the discontinuity flags), then
    the host finalize (boundary, hull and area gates, classification,
    clustering again if the finalize rejected a region, or the mean shift,
    detected objects).

Seeds come from the plane-support rank grid or, with
``seed_method="average_normals"``, from the average-normal seed vector,
grown through the same rank grid; ``growth_mode="wavefront"`` and
``"hybrid"`` grow the seed vector one region at a time (models/planar.py).
``segment_frame(prev_regions=...)`` adds the previous frame's regions as
temporal seeds, which pop first.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from pcseg_tpu_torch import native
from pcseg_tpu_torch.models import (boundary, classify, cluster, extract,
                                    mean_shift, planar, planar_batched)
from pcseg_tpu_torch.models.config import (
    SEMANTIC_UNKNOWN, UNLABELED, ClusterMethod, SegmenterConfig)
from pcseg_tpu_torch.ops import discontinuity, geom
from pcseg_tpu_torch.ops import normals as normals_op
from pcseg_tpu_torch.ops import seeds as seeds_op
from pcseg_tpu_torch.ops import unproject


class FrameMetrics(NamedTuple):
    """Per-stage counters."""
    num_seeds: int
    num_device_planar_regions: int
    num_planar_regions: int
    num_clusters: int
    planar_overflow: bool


@dataclasses.dataclass
class FrameResult:
    labels: np.ndarray                 # [H, W] int32 final label grid
    # None: the normals stay on the device (the discontinuity stencil, their
    # only host consumer, runs there)
    normals: Optional[np.ndarray]
    planar_regions: List               # boundary.PlanarRegionRecord
    num_clusters: int
    cluster_sizes: np.ndarray
    objects: List[extract.DetectedObject]
    metrics: FrameMetrics
    classification_summary: classify.ClassificationDebugSummary


class Segmenter:
    """Stateless pipeline over organized [B, H, W] clouds on ``device``:
    the CUDA card unless the caller passes ``device="cpu"`` (which the
    tests do; a CPU run takes every kernel's plain version).

    ``impl="plain"`` makes every kernel on the path take its plain PyTorch
    version (for tests and the smoke script's comparisons only)."""

    def __init__(self, config: SegmenterConfig = SegmenterConfig(),
                 device=None, impl=None):
        if config.seed_method not in ("plane_support", "average_normals"):
            raise ValueError(f"unknown seed_method {config.seed_method!r}")
        if config.planar.growth_mode not in ("batched", "wavefront",
                                             "hybrid"):
            raise ValueError(
                f"unknown growth_mode {config.planar.growth_mode!r}")
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError("no CUDA device: the pipeline runs on the "
                                   "card; pass device='cpu' to run it on the "
                                   "CPU")
            device = "cuda"
        self.config = config
        self.device = torch.device(device)
        self.impl = impl
        self._rays = None  # (host ray table, its device copy)

    def _tensor(self, x, dtype=None):
        return torch.as_tensor(x, dtype=dtype, device=self.device)

    def _sequential(self):
        return self.config.planar.growth_mode != "batched"

    def _rank_seeds(self, points, normals):
        """(seed rank grid [B, H, W], indices, valid) from the plane-support
        finder (the [B, S] seed vector only for the sequential grower, else
        None), or (None, indices, valid) from the average-normal finder's
        seed vector, in the reference's emit order."""
        cfg = self.config
        if cfg.seed_method == "plane_support":
            ranked = seeds_op.seeds_from_plane_support(
                points, normals, cfg.plane_support_seeds,
                seed_vector=self._sequential())
            return ranked.rank_grid, ranked.indices, ranked.valid
        mask = seeds_op.seeds_from_average_normals(normals,
                                                   cfg.average_normal_seeds)
        idx, valid = seeds_op.average_normal_seed_list(
            mask, cfg.plane_support_seeds.max_seeds)
        return None, idx, valid

    def _planar(self, points, sensor_origin, labels0=None, temporal=None):
        """[B, H, W, 3] points -> (normals, seed count [B], planar regions).

        ``temporal``: the previous regions' (centroids, normals, counts,
        valid) tables [B, R, ...] and the geom.Pose from the previous frame
        into this one; their seeds join the rank grid below every
        per-frame rank, or are appended to the seed vector. The seed count
        is JAX's: the rank grid's seeds, or with a seed vector the found
        temporal seeds plus the valid entries of the appended vector.

        The batched grower takes the rank grid (built from the seed vector
        for average-normal seeds); the sequential grower (``growth_mode``
        "wavefront" or "hybrid") takes the seed vector, as in JAX, where
        plane-support temporal seeds join only the rank grid, which the
        sequential grower does not read (ROADMAP Queue 3)."""
        cfg = self.config
        b, h, w = points.shape[:3]
        nrm = normals_op.compute_normals_organized(points, sensor_origin,
                                                   cfg.normals)
        rank_grid, idx, valid = self._rank_seeds(points, nrm)
        num_seeds = 0
        if temporal is not None:
            t_idx, t_found = seeds_op.seeds_from_last_regions(
                points, nrm, *temporal,
                cfg.planar.max_distance_for_seed_point,
                cfg.planar.max_normal_difference_angle_for_seed_point)
            if rank_grid is None:
                num_seeds = t_found.sum(dim=1, dtype=torch.int32)
                idx = torch.cat([idx, t_idx], dim=1)
                valid = torch.cat([valid, t_found], dim=1)
            else:
                rank_grid = seeds_op.append_temporal_to_rank_grid(
                    rank_grid, t_idx, t_found)
        if rank_grid is None:
            num_seeds = num_seeds + valid.sum(dim=1, dtype=torch.int32)
        else:
            num_seeds = (rank_grid < seeds_op.SEED_RANK_INF).sum(
                dim=(1, 2), dtype=torch.int32)
        if labels0 is None:
            labels0 = torch.full((b, h, w), UNLABELED, dtype=torch.int32,
                                 device=points.device)
        if self._sequential():
            dev = planar.grow_planar_regions(
                points, nrm, labels0, idx, valid, cfg.planar,
                initial_id_offset=0, max_attempts=cfg.max_region_attempts)
            return nrm, num_seeds, dev
        if rank_grid is None:
            rank_grid = planar_batched.rank_grid_from_seed_vector(
                idx, valid, h, w)
        dev = planar_batched.grow_planar_regions_batched(
            points, nrm, labels0, rank_grid, cfg.planar, impl=self.impl)
        return nrm, num_seeds, dev

    def _clusters(self, points, labels, need_sizes=True):
        # every point seeds, popped in ascending col-major order (the
        # canonical sweep, which that path never reads)
        return cluster.segment_clusters(
            points, labels, None,
            self.config.cluster, initial_id_offset=0, canonical_seeds=True,
            need_sizes=need_sizes, impl=self.impl)

    def _forward(self, points, sensor_origin, labels0=None, need_sizes=True):
        """[B, H, W, 3] points -> (final labels, normals, planar regions,
        cluster result), all batched."""
        nrm, _, dev = self._planar(points, sensor_origin, labels0)
        cres = self._clusters(points, dev.labels, need_sizes)
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

    # -- full pipeline ------------------------------------------------------

    def _dev_cluster(self):
        """True when the euclidean cluster stage runs in the device program
        (not with the mean shift, which runs in the host finalize)."""
        cfg = self.config
        return cfg.run_clustering and \
            cfg.cluster.cluster_method != ClusterMethod.MEAN_SHIFT

    def _payload(self, points, sensor_origin, labels0, rot_robot,
                 temporal=None):
        """The device program of one frame ([1, H, W, 3] points): planar
        growth (with temporal seeds if given, see :meth:`_planar`), clusters
        on the device labels (kept when the host finalize accepts every
        device region), the discontinuity flags. Labels stay int32 (no
        narrowing for the host link, so cluster ids never wrap)."""
        cfg = self.config
        nrm, num_seeds, dev = self._planar(points, sensor_origin, labels0,
                                           temporal)
        rot = self._tensor(np.eye(3, dtype=np.float32) if rot_robot is None
                           else np.asarray(rot_robot, np.float32))
        out = dict(
            dev_labels=dev.labels, planes=dev.planes,
            centroids=dev.centroids, curvatures=dev.curvatures,
            counts=dev.counts, seed_indices=dev.seed_indices,
            num_regions=dev.num_regions, overflow=dev.overflow,
            num_seeds=num_seeds,
            disc=discontinuity.discontinuity_flags(points, nrm, dev.labels,
                                                   rot, cfg.planar))
        if self._dev_cluster():
            cres = self._clusters(points, dev.labels)
            out.update(cres_labels=cres.labels, cres_num=cres.num_regions,
                       cres_sizes=cres.region_sizes)
        return out

    def segment_frame(self, points, sensor_origin,
                      rot_robot: Optional[np.ndarray] = None,
                      prev_regions: Optional[List] = None,
                      pose_cur_prev=None,
                      input_mask: Optional[np.ndarray] = None) -> FrameResult:
        """Full pipeline on one [H, W, 3] f32 frame.

        ``rot_robot``: optional 3x3 robot-frame rotation for the
        discontinuity z checks. ``prev_regions``: optional planar records
        of the previous frame (the first ``planar.max_regions``), whose
        centroids and normals seed this frame
        (FindSeedPointsFromLastPlanarRegions, planar_region.h:478-519);
        needs ``planar.max_distance_for_seed_point`` > 0 (the angle gate is
        in radians). ``pose_cur_prev``: the geom.Pose (or any object with
        ``quat`` wxyz and ``trans`` arrays) from the previous frame into
        this one; the identity if None. ``input_mask``: optional [H, W]
        int32 initial label grid carrying MASKED_EGO / MASKED_OUT sentinels
        (segmentation.h:36-45); masked cells are never claimed and survive
        into the output."""
        points_np = np.asarray(points, np.float32)
        pts = self._tensor(points_np)[None]
        labels0 = None if input_mask is None else \
            self._tensor(input_mask, torch.int32)[None]
        temporal = None
        if prev_regions:
            temporal = self._temporal_tables(prev_regions, pose_cur_prev)
        payload = self._payload(pts, self._tensor(sensor_origin,
                                                  torch.float32),
                                labels0, rot_robot, temporal)
        return self._host_finalize(points_np, payload, rot_robot,
                                   lambda labels: self._clusters(pts, labels))

    def _temporal_tables(self, prev_regions, pose_cur_prev):
        """The previous records packed as JAX packs them: [1, K] tables of
        centroids, plane normals, counts and valid (K = planar.max_regions,
        records past K dropped), and the pose on this device."""
        cap = self.config.planar.max_regions
        cents = np.zeros((cap, 3), np.float32)
        norms = np.zeros((cap, 3), np.float32)
        counts = np.zeros((cap,), np.int32)
        valid = np.zeros((cap,), bool)
        for i, rec in enumerate(prev_regions[:cap]):
            cents[i] = np.asarray(rec.centroid, np.float32)
            norms[i] = np.asarray(rec.plane[:3], np.float32)
            counts[i] = int(rec.count)
            valid[i] = True
        if pose_cur_prev is None:
            pose = geom.Pose.identity(device=self.device)
        elif isinstance(pose_cur_prev, geom.Pose):
            pose = pose_cur_prev.to(self.device)
        else:
            pose = geom.Pose.from_arrays(pose_cur_prev.quat,
                                         pose_cur_prev.trans, self.device)
        return (self._tensor(cents)[None], self._tensor(norms)[None],
                self._tensor(counts)[None], self._tensor(valid)[None], pose)

    def segment_frame_stream(self, depth_u16, rays, sensor_origin,
                             depth_scale: float = None,
                             rot_robot: Optional[np.ndarray] = None
                             ) -> FrameResult:
        """Full pipeline from one [H, W] u16 range frame: the device
        unprojects it against ``rays`` [H, W, 3] (kept on the device between
        calls with the same table) and the host rebuilds the identical f32
        points (``unproject_range_np``, the same IEEE multiply chain). Same
        result contract as :meth:`segment_frame`; no temporal seeds and no
        input mask, as in JAX."""
        if depth_scale is None:
            depth_scale = unproject.DEFAULT_DEPTH_SCALE
        if self._rays is None or self._rays[0] is not rays:
            self._rays = (rays, self._tensor(rays, torch.float32))
        depth_np = np.asarray(depth_u16)
        pts = unproject.unproject_range(self._tensor(depth_np)[None],
                                        self._rays[1], depth_scale)
        payload = self._payload(pts, self._tensor(sensor_origin,
                                                  torch.float32),
                                None, rot_robot)
        points_np = unproject.unproject_range_np(
            depth_np, np.asarray(rays, np.float32), float(depth_scale))
        return self._host_finalize(points_np, payload, rot_robot,
                                   lambda labels: self._clusters(pts, labels))

    def _host_finalize(self, points_np, payload, rot_robot, recluster):
        """Host half of one frame: ``payload`` is :meth:`_payload`'s dict
        (frame axis of 1); ``recluster`` runs the cluster stage on the
        device for a corrected [1, H, W] int32 label grid."""
        cfg = self.config
        host = {k: v[0].cpu().numpy() for k, v in payload.items()}
        dev = planar_batched.PlanarRegions(
            labels=host["dev_labels"], num_regions=host["num_regions"],
            planes=host["planes"], centroids=host["centroids"],
            curvatures=host["curvatures"], counts=host["counts"],
            seed_indices=host["seed_indices"], moments=None,
            overflow=host["overflow"])
        labels, records = boundary.finalize_planar_regions(
            points_np, None, dev, cfg.planar, 0, rot_robot,
            disc_flags=host["disc"])
        summary = classify.ClassificationDebugSummary()
        classify.classify_regions(records, cfg.classification,
                                  cfg.up_direction, cfg.known_floor_point,
                                  summary)

        num_planar = len(records)
        num_clusters = 0
        cluster_sizes = np.zeros((0,), np.int32)
        labels_final = labels
        if cfg.run_clustering and not self._dev_cluster():
            # the mean shift (mean_shift_segmentation.h:207-330): region ids
            # follow the planar ids; the host-ops library runs modes and
            # growth in one call, the device growth without it
            labels_final = labels.copy()
            growth = "native" if native.load_hostops() is not None \
                else "device"
            regions = mean_shift.sliding_mean_shift(
                points_np, labels_final, cfg.cluster,
                cfg.mean_shift_iterations, num_planar, cfg.mean_shift,
                growth=growth, device=self.device)
            num_clusters = len(regions)
            cluster_sizes = np.asarray(
                [len(r.inlier_indices) for r in regions], np.int32)
        elif cfg.run_clustering:
            cl, num_clusters, sizes = (host["cres_labels"],
                                       int(host["cres_num"]),
                                       host["cres_sizes"])
            if num_planar != int(dev.num_regions):
                # the finalize rejected a device-accepted region: its cells
                # reverted to UNLABELED and are clusterable (the reference's
                # quarantine-then-reset), so cluster the corrected grid
                c2 = recluster(self._tensor(labels, torch.int32)[None])
                cl = c2.labels[0].cpu().numpy()
                num_clusters = int(c2.num_regions[0])
                sizes = c2.region_sizes[0].cpu().numpy()
            # cluster ids follow the planar ids
            mask = (cl >= 0) & (labels == UNLABELED)
            labels_final = labels.copy()
            labels_final[mask] = cl[mask] + num_planar
            cluster_sizes = sizes[:num_clusters]

        objects: List[extract.DetectedObject] = []
        indexer = extract.RegionIndexer(labels_final) \
            if (records or num_clusters) else None
        for rec in records:
            objects.append(extract.planar_detected_object_from_labels(
                points_np, labels_final, rec, indexer=indexer))
        for cid in range(num_clusters):
            objects.append(extract.cluster_detected_object(
                points_np, labels_final, num_planar + cid,
                SEMANTIC_UNKNOWN, indexer=indexer))

        metrics = FrameMetrics(
            num_seeds=int(host["num_seeds"]),
            num_device_planar_regions=int(dev.num_regions),
            num_planar_regions=num_planar,
            num_clusters=num_clusters,
            planar_overflow=bool(dev.overflow))
        return FrameResult(labels=labels_final, normals=None,
                           planar_regions=records,
                           num_clusters=num_clusters,
                           cluster_sizes=cluster_sizes,
                           objects=objects, metrics=metrics,
                           classification_summary=summary)


def frame_arrays(result) -> dict:
    """A FrameResult (of either package) as flat numpy arrays, the form
    the JAX goldens are stored in: the label grid, the metrics, the cluster
    sizes and the planar record table, with each record's boundary and its
    sorted discontinuous indices concatenated (lengths in ``*_len``)."""
    recs = result.planar_regions

    def cat(lists):
        return np.asarray([i for seq in lists for i in seq], np.int32)

    def table(field, dtype, width=None):
        vals = np.asarray([np.asarray(getattr(r, field)) for r in recs], dtype)
        return vals if width is None else vals.reshape(-1, width)

    return dict(
        labels=np.asarray(result.labels, np.int32),
        metrics=np.asarray(tuple(result.metrics), np.int64),
        cluster_sizes=np.asarray(result.cluster_sizes, np.int32),
        planes=table("plane", np.float32, 4),
        centroids=table("centroid", np.float32, 3),
        counts=table("count", np.int32),
        areas=table("area", np.float64),
        plane_class=table("plane_class", np.int32),
        seed_indices=table("seed_point_index", np.int32),
        boundary=cat(r.boundary_indices for r in recs),
        boundary_len=np.asarray([len(r.boundary_indices) for r in recs],
                                np.int32),
        disc=cat(sorted(r.discontinuous_boundary_indices) for r in recs),
        disc_len=np.asarray([len(r.discontinuous_boundary_indices)
                             for r in recs], np.int32))


def _first(x):
    if isinstance(x, tuple):
        return type(x)(*[_first(v) for v in x])
    return x[0]
