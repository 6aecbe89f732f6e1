"""One frame or a batch of frames.

The JAX package's public functions take one frame ([H, W, 3] points,
[H, W] grids, [S] seed vectors) and batch through ``vmap``. The port's
take the same shapes, and also a leading batch axis, which is the port's
counterpart of ``vmap`` (the ``Segmenter``, the stream and the sharded
step use it). :func:`takes_frames` tells the two apart by the rank of one
argument, adds the batch axis to a single frame's arguments and strips it
from the result, so each function is written once, for the batch.
"""

from __future__ import annotations

import functools
import inspect

import torch


def frame0(tree):
    """Frame 0 of a batched result: every tensor of a (nested) tuple or
    NamedTuple loses its leading axis; anything else is kept."""
    if isinstance(tree, torch.Tensor):
        return tree[0]
    if isinstance(tree, tuple):
        items = [frame0(t) for t in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") \
            else tuple(items)
    return tree


def _rank(x):
    """Rank of a tensor, or of the first tensor of a (Named)tuple."""
    if isinstance(x, torch.Tensor):
        return x.dim()
    if isinstance(x, tuple):
        return next(_rank(t) for t in x if isinstance(t, (torch.Tensor,
                                                          tuple)))
    return None


def _add_axis(x, rank, name):
    """``x`` with a leading batch axis of one, checking that it is one
    frame of ``rank`` dimensions."""
    if isinstance(x, tuple):
        items = [_add_axis(t, None, name) for t in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    if not isinstance(x, torch.Tensor):
        return x
    if rank is not None and x.dim() != rank:
        raise ValueError(f"{name}: one frame is {rank}-D here, got shape "
                         f"{tuple(x.shape)}")
    return x[None]


def takes_frames(**frame_ranks):
    """Decorator: the named arguments take one frame, of the rank given,
    or a batch, of one rank more. The first name decides; a single frame's
    named arguments gain a batch axis of one (None stays None), and every
    tensor of the result loses it again."""
    lead = next(iter(frame_ranks))

    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            bound = sig.bind(*args, **kwargs)
            if _rank(bound.arguments[lead]) != frame_ranks[lead]:
                return fn(*args, **kwargs)
            for name, rank in frame_ranks.items():
                if bound.arguments.get(name) is not None:
                    bound.arguments[name] = _add_axis(
                        bound.arguments[name], rank, name)
            return frame0(fn(*bound.args, **bound.kwargs))
        return call
    return wrap
