"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions. Kernels build at first use (``build.py``)."""
