"""One frame or a batch of frames, and the input rule of the public ops.

The JAX package's public functions take one frame ([H, W, 3] points,
[H, W] grids, [S] seed vectors) and batch through ``vmap``. The port's
take the same shapes, and also a leading batch axis, which is the port's
counterpart of ``vmap`` (the ``Segmenter``, the stream and the sharded
step use it). :func:`takes_frames` tells the two apart by the rank of one
argument, adds the batch axis to a single frame's arguments and strips it
from the result, so each function is written once, for the batch.

It also applies one input rule to every argument of the function:

- tensors in, on the device to run on: an array that is not a
  ``torch.Tensor`` (a NumPy array, a list, a ``jax.Array``) raises a
  TypeError that names the function and the argument. JAX places such an
  array on its default device; the port's ops have no device parameter
  (nor have JAX's), so converting would choose a device without saying so.
  The ``Segmenter`` entry points convert their inputs onto their device.
- 64-bit narrowed as JAX does with x64 off (``dtypes.canonicalize_dtype``):
  float64 to float32, int64 to int32; every other dtype as given. A 64-bit
  call therefore returns the 32-bit call's result, bit for bit.
- the rank decides, always: an argument of no rank, or of a rank that is
  neither one frame's nor a batch's, raises; it is never taken for a batch.
"""

from __future__ import annotations

import functools
import inspect

import numpy as np
import torch

_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def frame0(tree):
    """Frame 0 of a batched result: every tensor of a (nested) tuple or
    NamedTuple loses its leading axis; anything else is kept."""
    if isinstance(tree, torch.Tensor):
        return tree[0]
    if isinstance(tree, tuple):
        return _rebuild(tree, [frame0(t) for t in tree])
    return tree


def _rebuild(x, items):
    """A (Named)tuple of ``x``'s type holding ``items``."""
    return type(x)(*items) if hasattr(x, "_fields") else tuple(items)


def _is_array(x):
    """An array that is not a tensor: a NumPy array (not a NumPy scalar),
    a list, or anything else that converts to one (``__array__``, as a
    ``jax.Array``)."""
    return isinstance(x, (np.ndarray, list)) or (
        hasattr(x, "__array__") and not isinstance(x, np.generic))


def _type_name(x):
    t = type(x)
    return t.__qualname__ if t.__module__ == "builtins" \
        else f"{t.__module__.split('.')[0]}.{t.__qualname__}"


def _tensor_input(x, fn_name, name):
    """``x`` under the input rule (module docstring): tensors narrowed to
    32 bits, in (Named)tuples and in records of tensor slots (geom.Pose)
    too; an array of another type raises TypeError."""
    if isinstance(x, torch.Tensor):
        return x.to(_NARROW[x.dtype]) if x.dtype in _NARROW else x
    if isinstance(x, tuple):
        fields = getattr(x, "_fields", range(len(x)))
        return _rebuild(x, [_tensor_input(v, fn_name, f"{name}.{f}")
                            for f, v in zip(fields, x)])
    if _is_array(x):
        raise TypeError(f"{fn_name}: {name} must be a torch.Tensor on the "
                        f"device to run on, got {_type_name(x)}")
    slots = getattr(type(x), "__slots__", ())
    if slots and all(isinstance(getattr(x, s, None), torch.Tensor)
                     for s in slots):
        return type(x)(*[_tensor_input(getattr(x, s), fn_name,
                                      f"{name}.{s}") for s in slots])
    return x


def _rank(x):
    """Rank of a tensor, or of the first tensor of a (Named)tuple; None if
    there is none."""
    if isinstance(x, torch.Tensor):
        return x.dim()
    if isinstance(x, tuple):
        return next((r for r in map(_rank, x) if r is not None), None)
    return None


def _add_axis(x, rank, name):
    """``x`` with a leading batch axis of one, checking that it is one
    frame of ``rank`` dimensions."""
    if isinstance(x, tuple):
        return _rebuild(x, [_add_axis(t, None, name) for t in x])
    if not isinstance(x, torch.Tensor):
        return x
    if rank is not None and x.dim() != rank:
        raise ValueError(f"{name}: one frame is {rank}-D here, got shape "
                         f"{tuple(x.shape)}")
    return x[None]


def takes_frames(**frame_ranks):
    """Decorator: the input rule (module docstring) on every argument;
    then the named arguments take one frame, of the rank given, or a
    batch, of one rank more. The first name decides; a single frame's
    named arguments gain a batch axis of one (None stays None), and every
    tensor of the result loses it again. Without names only the input
    rule applies (functions of any rank)."""
    lead = next(iter(frame_ranks), None)

    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            for name, value in bound.arguments.items():
                bound.arguments[name] = _tensor_input(value, fn.__name__,
                                                     name)
            if lead is None:
                return fn(*bound.args, **bound.kwargs)
            rank, want = _rank(bound.arguments[lead]), frame_ranks[lead]
            if rank == want + 1:
                return fn(*bound.args, **bound.kwargs)
            if rank != want:
                got = "no tensor" if rank is None else f"{rank}-D"
                raise ValueError(
                    f"{fn.__name__}: {lead} is one {want}-D frame or a "
                    f"{want + 1}-D batch, got {got}")
            for name, r in frame_ranks.items():
                if bound.arguments.get(name) is not None:
                    bound.arguments[name] = _add_axis(
                        bound.arguments[name], r, name)
            return frame0(fn(*bound.args, **bound.kwargs))
        return call
    return wrap
