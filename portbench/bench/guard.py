"""The check that the process running the port never loaded JAX or the
JAX package: top-level module names compared whole (``pcseg_tpu_torch``
begins with ``pcseg_tpu`` and is allowed)."""

from __future__ import annotations

import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "pcseg_tpu")


def forbidden_modules(modules=None) -> list:
    """Sorted top-level names of loaded modules that are forbidden."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))
