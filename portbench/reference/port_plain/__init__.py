"""A frozen copy of the plain path of ``pcseg_tpu_torch``, the benchmark's
reference.

Copied from the port at commit 9e5028f (``pcseg_tpu_torch/``, the modules
under the same relative paths here), imports renamed to this package.
Edits made in the copy, and nothing else:

* ``kernels/{epoch_word,ccl_gated,flood_packed}.py`` keep only their plain
  PyTorch versions (no CUDA library is built or launched), and
  ``kernels/common.py`` loses the launch helpers;
* ``native.py`` is a stand-in without the host-ops library, so the
  finalize takes its NumPy paths;
* ``models/pipeline.py`` keeps the batched grower and the euclidean
  clusters only (no sequential grower, no mean shift), and
  ``models/extract.py`` has no proto codec;
* the plane-fit moment sums read their dtype from ``precision.py``, which
  the control lowers.

It imports nothing of ``pcseg_tpu_torch``, ``pcseg_tpu`` or JAX, so a
later change to the program cannot move the yardstick.
"""
