"""pcseg_tpu_torch — the PyTorch / CUDA port of pcseg_tpu.

A second package beside the JAX one (which stays the reference). It holds
the device forward of the segmentation pipeline for NVIDIA Hopper cards:
u16 range frames in, u8 labels, region counts and planes out
(``models.pipeline.Segmenter.device_forward_stream``). The two kernels on
that path are hand-written CUDA for sm_90a (``csrc/``), each with a plain
PyTorch version in its ``kernels/`` module; CPU tensors take the plain
versions. The package never imports JAX.
"""

from pcseg_tpu_torch.models.config import (  # noqa: F401
    UNLABELED, SegmenterConfig, config_from_dict)
from pcseg_tpu_torch.models.pipeline import Segmenter  # noqa: F401

__version__ = "0.1.0"
