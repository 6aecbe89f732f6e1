"""The reference (the frozen plain copy) against the port's plain CPU run
at a small size: the same outputs bit for bit, on every path."""

import numpy as np
import torch

from portbench.paths.common import PROGRAM, REFERENCE
from portbench.tests.helpers import small_cell


def outputs(path_mod, cell, package, seed=2 ** 31 + 77, n=2):
    path = path_mod.Path(torch, cell, seed, "cpu", package)
    path.setup()
    return [path.request(i) for i in range(n)]


def test_stream_reference_equals_the_port():
    """At 32 slots (the word-epoch closure, B1's path) and at 64 (the
    flood-epoch closure, B3's)."""
    from portbench.paths import stream
    for wl in ("stream_cluttered", "stream_room", "stream_cartons_k64"):
        cell = small_cell(wl, batch=2)
        for got, want in zip(outputs(stream, cell, PROGRAM),
                             outputs(stream, cell, REFERENCE)):
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w)


def test_frame_reference_equals_the_port():
    from portbench.paths import frame
    cell = small_cell("frame_cluttered")
    got = outputs(frame, cell, PROGRAM)
    want = outputs(frame, cell, REFERENCE)
    for g, w in zip(got, want):
        a, b = frame.arrays(g), frame.arrays(w)
        assert a["metrics"][2] >= 3
        for k in a:
            if k == "objects":
                assert len(a[k]) == len(b[k]) > 0
                for x, y in zip(a[k], b[k]):
                    assert x[0] == y[0]
                    for i in range(1, 5):
                        np.testing.assert_array_equal(x[i], y[i])
            else:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_sharded_reference_equals_the_port_on_one_rank():
    from pcseg_tpu_torch.parallel import halo
    from portbench.paths import sharded
    from portbench.reference.port_plain.parallel import halo as ref_halo
    cell = small_cell("sharded_cluttered_4", ranks=1)
    runs = []
    for package, comm in ((PROGRAM, halo.Comm(device="cpu")),
                          (REFERENCE, ref_halo.Comm(device="cpu"))):
        path = sharded.Path(torch, cell, 5, "cpu", package, comm)
        path.setup()
        runs.append(path.request(0))
    for g, w in zip(*runs):
        np.testing.assert_array_equal(g, w)
