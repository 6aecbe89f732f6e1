"""pcseg_tpu_torch — the PyTorch / CUDA port of pcseg_tpu.

A second package beside the JAX one (which stays the reference). It holds
the segmentation pipeline for NVIDIA Hopper cards: the serving path (u16
range frames in, u8 labels, region counts and planes out,
``models.pipeline.Segmenter.device_forward_stream``) and the full pipeline
of one frame with its host finalize (``Segmenter.segment_frame_stream`` and
``segment_frame``: classified planar records with hulls and areas,
clusters, detected objects). The three kernels on those paths are
hand-written CUDA for sm_90a (``csrc/``), each with a plain PyTorch version
in its ``kernels/`` module; CPU tensors take the plain versions. The
``Segmenter`` runs on the card unless given ``device="cpu"``. The package
never imports JAX.
"""

from pcseg_tpu_torch.models.config import (  # noqa: F401
    UNLABELED, SegmenterConfig, config_from_dict)
from pcseg_tpu_torch.models.pipeline import Segmenter  # noqa: F401

__version__ = "0.2.0"
