"""One rank per card: the NCCL binding of parallel/distributed.py, the
one-buffer gather of ``halo.Comm``, and kernel launches on the card of
their tensors.

On the CPU: ``initialize("nccl")`` raises, and starts no process group,
without a card or without torchrun's ``LOCAL_RANK``; the env-to-device
mapping (``rank_device``) and ``make_group()``'s default device under
NCCL; ``Comm.all_gather`` at 2 gloo ranks (tests/torch_sharded_worker.py)
gives the bytes of the list form of ``all_gather`` it replaced, for bool,
int32, int64 and f64 tensors (NaN payloads, -0.0, subnormals, the int64
extremes), scalars and empty tensors, and ``psum`` gives the bytes of the
ranks' sum (NaN + NaN may keep either payload).

The ``cuda`` cases need two cards and skip otherwise: with card 0
current, B1, B2 and B3 on ``cuda:1`` equal their ``cuda:0`` runs and their
plain versions, and ``Segmenter(device="cuda:1")`` gives card 0's stream.
Nothing here imports JAX, so on a machine with cards the file runs
without the JAX conftest: ``python3 -m pytest --noconftest
tests/test_torch_multicard.py``.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pcseg_tpu_torch.kernels import ccl_gated, epoch_word, flood_packed
from pcseg_tpu_torch.models import config, pipeline
from pcseg_tpu_torch.ops import connectivity, unproject
from pcseg_tpu_torch.parallel import distributed
from pcseg_tpu_torch.utils import profiling
from pcseg_tpu_torch.utils.synthetic import (synthetic_cluttered_room_cloud,
                                             synthetic_room_cloud)
from tests.torch_sharded_worker import run_ranks

torch.set_num_threads(1)

INF = 2 ** 30
# B1's moments: f32 products summed in f64 in two orders, then rounded
MOM_RTOL, MOM_ATOL = 1e-6, 1e-5


def _torchrun_env(monkeypatch, **extra):
    """A one-rank torchrun environment that would reach
    init_process_group if nothing stopped it first."""
    for k, v in dict(WORLD_SIZE="1", RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT="1", **extra).items():
        monkeypatch.setenv(k, v)


def test_initialize_nccl_raises_without_a_card(monkeypatch):
    _torchrun_env(monkeypatch, LOCAL_RANK="0")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        distributed.initialize("nccl")
    assert not dist.is_initialized()


@pytest.mark.parametrize("local_rank", [None, "4"])
def test_initialize_nccl_raises_without_its_card(monkeypatch, local_rank):
    """No LOCAL_RANK, or one past the cards there are (4 here)."""
    _torchrun_env(monkeypatch)
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)

    def no_bind(dev):
        raise AssertionError(f"bound card {dev} before the check")

    monkeypatch.setattr(torch.cuda, "set_device", no_bind)
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        distributed.initialize("nccl")
    assert not dist.is_initialized()


@pytest.mark.parametrize("local_rank", ["0", "1", "3"])
def test_rank_device_is_the_local_rank_card_under_nccl(local_rank):
    env = {"LOCAL_RANK": local_rank, "RANK": "7", "WORLD_SIZE": "8"}
    assert distributed.rank_device("nccl", env) == \
        torch.device("cuda", int(local_rank))
    assert distributed.rank_device("gloo", env) == torch.device("cuda")
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        distributed.rank_device("nccl", {"RANK": "0"})


def test_make_group_defaults_to_the_bound_card_under_nccl(monkeypatch):
    """make_group() of an NCCL job (rank 2 of 4) lives on cuda:2 and
    gathers on the card; no card is touched to build it."""
    monkeypatch.setenv("LOCAL_RANK", "2")
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    comm = distributed.make_group()
    assert comm.device == torch.device("cuda", 2)
    assert (comm.rank, comm.size, comm.transport, comm.staged) == \
        (2, 4, "nccl", False)


def _gather_cases(n):
    """{case: [n, ...] array}, one slice a rank."""
    rng = np.random.default_rng(11)
    raw = rng.integers(-2 ** 63, 2 ** 63 - 1, size=(n, 40), dtype=np.int64)
    special = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, 5e-324,
                        -2.2250738585072014e-308, 1 / 3])
    f64 = np.concatenate([raw.view(np.float64), np.tile(special, (n, 1))],
                         axis=1)
    f64[:, 0] = np.array([0x7FF8_0000_DEAD_BEEF + r for r in range(n)],
                         np.uint64).view(np.float64)  # NaN payloads
    i64 = raw.copy()
    i64[:, :2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    return {
        "f64": f64.reshape(n, 8, 6),
        "i64": i64,
        "i32": rng.integers(-2 ** 31, 2 ** 31 - 1, size=(n, 3, 5, 2),
                            dtype=np.int32),
        "bool": rng.random((n, 7, 3)) < 0.5,
        "f64_scalar": rng.standard_normal(n),
        "i64_empty": np.zeros((n, 0, 4), np.int64),
    }


@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    cases = _gather_cases(2)
    got = run_ranks("gather", 2, dict(cases, cases=np.array(list(cases))),
                    tmp_path_factory.mktemp("gather"))
    return cases, got


@pytest.mark.parametrize("case", ["f64", "i64", "i32", "bool", "f64_scalar",
                                  "i64_empty"])
def test_all_gather_bytes_equal_the_list_form(gathered, case):
    cases, got = gathered
    want = cases[case]
    new, old = got[f"R:new_{case}"], got[f"R:old_{case}"]
    assert new.dtype == old.dtype == want.dtype
    assert new.shape == old.shape == want.shape
    assert new.tobytes() == old.tobytes() == want.tobytes()
    if case != "bool":
        # NaN + NaN keeps either payload, as the vector path picks
        psum = got[f"R:psum_{case}"]
        add = np.asarray(want[0] + want[1], want.dtype)
        nan = np.isnan(add)
        assert psum.dtype == want.dtype
        assert np.array_equal(np.isnan(psum), nan)
        assert psum[~nan].tobytes() == add[~nan].tobytes()


# -- two cards ---------------------------------------------------------------

@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards; the kernels have no CPU mode")
    assert torch.cuda.current_device() == 0
    return torch.device("cuda", 0), torch.device("cuda", 1)


def _epoch_case():
    """A closure-epoch state on a 48x64 room (K = 8; disjoint member
    boxes around live anchors, floor and wall planes through them)."""
    b, h, w, k_cap = 2, 48, 64, 8
    rng = np.random.default_rng(3)
    rays = unproject.camera_ray_table(h, w, f=float(h))
    pts = np.stack([unproject.unproject_range_np(unproject.encode_range(
        synthetic_room_cloud(h, w, f=float(h), seed=4 + i)[0]), rays)
        for i in range(b)])
    elig = np.isfinite(pts).all(-1)
    rank = rng.permutation(b * h * w).reshape(b, h, w).astype(np.int32)
    word = np.zeros((b, h, w), np.int64)
    srank = np.full((b, k_cap), INF, np.int32)
    alive = np.zeros((b, k_cap), np.int32)
    plane = np.zeros((b, k_cap, 4), np.float32)
    ar = np.zeros((b, k_cap), np.int32)
    ac = np.zeros((b, k_cap), np.int32)
    for f in range(b):
        cells = rng.permutation(np.argwhere(elig[f]))
        for k in range(k_cap):
            r, c = cells[k]
            box = (slice(max(r - 1, 0), r + 2), slice(max(c - 1, 0), c + 2))
            word[f][box] |= np.where((word[f][box] == 0) & elig[f][box],
                                     1 << k, 0)
            word[f, r, c] |= 1 << k
            srank[f, k], alive[f, k] = rng.integers(0, INF // 2), 1
            ar[f, k], ac[f, k] = r, c
            n = np.float32([0, 0, 1]) if k % 2 else np.float32([1, 0, 0])
            plane[f, k] = [*n, -n @ pts[f, r, c]]
    args = [pts[..., 0], pts[..., 1], pts[..., 2], rank,
            elig.astype(np.int32), word.astype(np.int32), srank, alive,
            plane, ar, ac, np.array([6, 64], np.int32)]
    return ([torch.from_numpy(np.ascontiguousarray(a)) for a in args]
            + [0.05, 64]), epoch_word.epoch_word


def _ccl_case():
    clut = synthetic_cluttered_room_cloud(48, 64, f=48.0, seed=1)[0]
    pts = torch.from_numpy(clut)[None]
    elig = torch.isfinite(pts).all(-1)
    offs = connectivity.window_offsets(1)
    gate = connectivity._gate_bits(pts, elig, 1.0, offs)
    lab0 = torch.where(elig, connectivity.colmajor_index_grid(48, 64),
                       48 * 64).to(torch.int32)
    return [gate, lab0, offs, 24, 48 * 64], ccl_gated.ccl_gated


def _flood_case():
    rng = np.random.default_rng(5)
    gate = rng.random((40, 48, 64)) < 0.62
    src = gate & (rng.random(gate.shape) < 0.01)
    g = flood_packed.pack_bits(torch.from_numpy(gate)[None])[0]
    r0 = flood_packed.pack_bits(torch.from_numpy(src)[None])[0]
    return [g, r0, 64], flood_packed.flood_packed


KERNEL_CASES = {"epoch_word": _epoch_case, "ccl_gated": _ccl_case,
                "flood_packed": _flood_case}


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", list(KERNEL_CASES))
def test_kernel_on_the_second_card(two_cards, kernel):
    """With card 0 current, the kernel on cuda:1 equals its cuda:0 run
    (bytes) and its plain version (B1's moments within MOM_RTOL/ATOL)."""
    args, fn = KERNEL_CASES[kernel]()
    outs = {}
    for dev in ("cpu", *two_cards):
        before = profiling.total("launches." + kernel)
        res = fn(*[a.to(dev) if torch.is_tensor(a) else a for a in args])
        res = res if isinstance(res, tuple) else (res,)
        outs[str(dev)] = [t.cpu() for t in res]
        assert profiling.total("launches." + kernel) == \
            before + (str(dev) != "cpu")
        assert torch.cuda.current_device() == 0
    for a, b in zip(outs["cuda:1"], outs["cuda:0"]):
        assert a.numpy().tobytes() == b.numpy().tobytes()
    for i, (a, b) in enumerate(zip(outs["cuda:0"], outs["cpu"])):
        if kernel == "epoch_word" and i == 4:
            torch.testing.assert_close(a, b, rtol=MOM_RTOL, atol=MOM_ATOL)
        else:
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [32, 64])
def test_segmenter_on_the_second_card(two_cards, slots):
    """Segmenter(device="cuda:1").device_forward_stream on a 96x128
    cluttered batch of 2 equals card 0's, bytes and launch counts."""
    h, w = 96, 128
    rays = unproject.camera_ray_table(h, w, f=float(h))
    d16 = np.stack([unproject.encode_range(synthetic_cluttered_room_cloud(
        h, w, f=float(h), seed=s)[0]) for s in (1, 2)])
    cfg = config.SegmenterConfig(
        planar=config.PlanarRegionConfig(max_regions=slots))
    names = ["launches." + k for k in ("epoch_word", "ccl_gated",
                                       "flood_packed")]
    got = {}
    for dev in two_cards:
        before = [profiling.total(n) for n in names]
        out = pipeline.Segmenter(cfg, device=dev).device_forward_stream(
            d16, rays, np.zeros(3, np.float32))
        got[dev.index] = ([t.cpu().numpy().tobytes() for t in out],
                          [profiling.total(n) - b
                           for n, b in zip(names, before)])
        assert torch.cuda.current_device() == 0
    assert got[1] == got[0]
    assert got[0][1][1] == 1 and got[0][1][0 if slots == 32 else 2] > 0
