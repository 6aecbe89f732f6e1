"""The precision of this copy's plane-fit moment sums.

The port states f32 products summed in f64 and rounded to f32. The
benchmark's control (``portbench/reference/control.py``) sets
``MOMENT_SUM_DTYPE`` to ``torch.float32``, the nearest precision below,
and must then come out as not correct.
"""

import torch

MOMENT_SUM_DTYPE = torch.float64
