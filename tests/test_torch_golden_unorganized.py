"""The committed JAX goldens of BASELINE config 3, the unorganized clouds,
which the card run (chip_smoke.py) holds the port to:

  * ``jax_unorganized_1m.npz``: four Gaussian blobs of 250,000 points
    (``utils/synthetic.gaussian_blobs``, seed 0), the euclidean call
    (``cluster_unorganized``, min 1,000 points, 0.5 m cells, 256x256) with
    its grid labels, region count and sizes (``euclid__``), and the
    mean-shift call on the host backend (0.125 m cells, 512x512, 5
    iterations) with its grid labels and region count (``ms__``);
  * ``jax_unorganized_small.npz``: the same calls on blobs of 8,000 points.

Each must equal what JAX computes now, and the port on the CPU must give
them. The 1M-point checks are marked slow (a 1M-point JAX call each), so
tier-1 checks the small golden. Rewrite them after a deliberate change of
the JAX reference with:

    JAX_PLATFORMS=cpu python -m tests.test_torch_golden_unorganized
"""

import hashlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from pcseg_tpu.models import config as jconfig
from pcseg_tpu.models import unorganized as junorganized

from pcseg_tpu_torch.models import config, unorganized
from pcseg_tpu_torch.utils.synthetic import gaussian_blobs

TESTDATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "pcseg_tpu_torch", "testdata")
SIZES = {"1m": chip_smoke.UNORG_POINTS_PER_BLOB, "small": 8_000}


def golden_path(size):
    return os.path.join(TESTDATA, f"jax_unorganized_{size}.npz")


def golden_case(size):
    pts = gaussian_blobs(n_per=SIZES[size], seed=0)
    cfg, kw = chip_smoke.unorganized_case(jconfig, "euclid")
    e = jax.jit(lambda p: junorganized.cluster_unorganized(p, cfg, **kw))(
        jnp.asarray(pts))
    cfg, kw = chip_smoke.unorganized_case(jconfig, "mean_shift")
    m = junorganized.cluster_unorganized_mean_shift(pts, cfg, backend="host",
                                                    **kw)
    return dict(
        cloud_sha256=np.frombuffer(hashlib.sha256(pts.tobytes()).digest(),
                                   np.uint8),
        euclid__grid_labels=np.asarray(e.grid_labels),
        euclid__num_regions=np.asarray(e.num_regions),
        euclid__region_sizes=np.asarray(e.region_sizes),
        ms__grid_labels=np.asarray(m.grid_labels),
        ms__num_regions=np.asarray(m.num_regions))


SIZE_PARAMS = [pytest.param("1m", marks=pytest.mark.slow), "small"]


@pytest.mark.parametrize("size", SIZE_PARAMS)
def test_committed_unorganized_golden_is_current(size):
    want = golden_case(size)
    gold = np.load(golden_path(size))
    assert set(gold.files) == set(want)
    for key, arr in want.items():
        np.testing.assert_array_equal(gold[key], arr, err_msg=key)


@pytest.mark.parametrize("size", SIZE_PARAMS)
def test_port_meets_the_unorganized_golden(size):
    """The port on the CPU: the euclidean device path and the mean-shift
    host backend give the golden exactly."""
    import torch
    torch.set_num_threads(1)
    gold = np.load(golden_path(size))
    pts = gaussian_blobs(n_per=SIZES[size], seed=0)
    cfg, kw = chip_smoke.unorganized_case(config, "euclid")
    e = unorganized.cluster_unorganized(pts, cfg, device="cpu", **kw)
    for f in ("grid_labels", "num_regions", "region_sizes"):
        np.testing.assert_array_equal(getattr(e, f).numpy(),
                                      gold["euclid__" + f], err_msg=f)
    assert int(e.num_regions) == 4
    cfg, kw = chip_smoke.unorganized_case(config, "mean_shift")
    m = unorganized.cluster_unorganized_mean_shift(pts, cfg, backend="host",
                                                   **kw)
    np.testing.assert_array_equal(m.grid_labels, gold["ms__grid_labels"])
    assert int(m.num_regions) == int(gold["ms__num_regions"])


if __name__ == "__main__":
    for size in SIZES:
        np.savez_compressed(golden_path(size), **golden_case(size))
        print("wrote", golden_path(size), os.path.getsize(golden_path(size)),
              "bytes")
