"""The control: the reference put in the program's place with its
plane-fit moment sums in float32, the precision below the float64 the
port states (``port_plain/precision.py``). Its set-up and requests run
lowered; the reference that judges them runs as stated."""

from __future__ import annotations

from contextlib import contextmanager

import torch

from portbench.reference.port_plain import precision


@contextmanager
def lowered():
    saved = precision.MOMENT_SUM_DTYPE
    precision.MOMENT_SUM_DTYPE = torch.float32
    try:
        yield
    finally:
        precision.MOMENT_SUM_DTYPE = saved


class Control:
    """A path driver whose ``setup`` and ``request`` run lowered."""

    def __init__(self, path):
        self._path = path

    def __getattr__(self, name):
        return getattr(self._path, name)

    def setup(self):
        with lowered():
            self._path.setup()

    def request(self, i):
        with lowered():
            return self._path.request(i)
