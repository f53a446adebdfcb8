"""The pull of a fit's result fields to the host (``utils/pull.py``):
``to_host`` and the paths its rule picks.

On any machine: a CPU tensor comes back as its own numpy view, the rule
picks the path from the device and the byte size alone, every pinned
copy of a call is queued before the one wait a stream, and the counter
counts fields and bytes by path (the CUDA copy stood in for on the CPU).
The tests marked ``cuda`` need an NVIDIA GPU and skip without one: the
pinned path's bytes against ``.cpu().numpy()``, fits whose ``lam``
arrays never share memory, an array that outlives its ``Model``, a
freed block taken by the next fit, and ``DeviceField``'s
``np.asarray``. This file imports neither JAX nor circuitmap_tpu, so on
a machine with the card it runs on its own:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_pull.py
"""

import gc

import numpy as np
import pytest
import torch

from circuitmap_torch import Model, simulate
from circuitmap_torch.model import DeviceField
from circuitmap_torch.utils import pull
from circuitmap_torch.utils.pull import (PINNED_MIN_BYTES, plan, reset_pulls,
                                         to_host)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the pinned path copies from one)")
    return torch.device("cuda")


@pytest.fixture
def counts():
    reset_pulls()
    yield to_host
    reset_pulls()


class _Stream:
    """Stands in for a CUDA stream: counts its waits."""

    def __init__(self):
        self.waits = 0

    def synchronize(self):
        self.waits += 1


FLOOR = 4096  # the stand-in's floor, so that CPU fits stay small


@pytest.fixture
def stand_in(monkeypatch):
    """CPU tensors take the rule's CUDA paths under a floor of ``FLOOR``
    bytes: those at or above it a stand-in pinned copy (a clone, queued
    on one stand-in stream), the others ``.cpu()``."""
    stream = _Stream()
    queued = []
    monkeypatch.setattr(pull, "PINNED_MIN_BYTES", FLOOR)

    def fake_plan(device, nbytes):
        return plan(torch.device("cuda"), nbytes)

    def fake_copy(t):
        queued.append(stream.waits)
        return t.clone(), stream

    monkeypatch.setattr(pull, "plan", fake_plan)
    monkeypatch.setattr(pull, "pinned_copy", fake_copy)
    return stream, queued


def test_a_cpu_tensor_comes_back_as_its_numpy_view(counts):
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4)
    host = np.ones(3)
    out = to_host({"t": t, "grad": t.clone().requires_grad_(),
                   "n": 7, "host": host, "none": None})
    assert np.shares_memory(out["t"], t.numpy())
    np.testing.assert_array_equal(out["grad"], t.numpy())
    assert out["n"] == 7 and out["host"] is host and out["none"] is None
    assert list(out) == ["t", "grad", "n", "host", "none"]
    assert counts.plans == {} and counts.plan_bytes == {}


@pytest.mark.parametrize("device,nbytes,path", [
    ("cpu", 0, "host"),
    ("cpu", 1 << 30, "host"),
    ("cuda", 4, "pageable"),
    ("cuda", PINNED_MIN_BYTES - 1, "pageable"),
    ("cuda", PINNED_MIN_BYTES, "pinned"),
    ("cuda", 320_000_000, "pinned"),
    ("meta", 1 << 30, "pageable"),
])
def test_the_rule_picks_the_path_from_device_and_size(device, nbytes, path):
    assert plan(torch.device(device), nbytes) == path


def test_scalars_and_vectors_stay_on_the_pageable_path():
    # the [N] vectors of a 32,000-candidate map in float64, and phi_cov
    assert plan(torch.device("cuda"), 32_000 * 8) == "pageable"
    assert plan(torch.device("cuda"), 2000 * 4 * 4) == "pageable"
    # the benchmark maps' lam, float32
    for n, k in ((1000, 20_000), (2000, 40_000)):
        assert plan(torch.device("cuda"), n * k * 4) == "pinned"


def test_the_counter_counts_fields_and_bytes_by_path(counts, stand_in):
    stream, queued = stand_in
    big = FLOOR // 4
    fields = {"mu": torch.zeros(100), "lam": torch.rand(2, big),
              "z": torch.rand(big, dtype=torch.float64), "shape": 1.5,
              "beta": torch.ones(100, dtype=torch.float64)}
    out = to_host(fields)
    assert counts.plans == {"pageable": 2, "pinned": 2}
    assert counts.plan_bytes == {"pageable": 100 * 4 + 100 * 8,
                                 "pinned": 2 * big * 4 + big * 8}
    # both pinned copies queued before the one wait on their stream
    assert queued == [0, 0] and stream.waits == 1
    for k in ("mu", "lam", "z", "beta"):
        np.testing.assert_array_equal(out[k], fields[k].numpy())
        assert out[k].dtype == fields[k].numpy().dtype
    assert out["shape"] == 1.5
    to_host({"lam": fields["lam"]})
    assert counts.plans == {"pageable": 2, "pinned": 3}
    reset_pulls()
    assert counts.plans == {} and counts.plan_bytes == {}


def test_a_call_without_a_pinned_field_waits_on_nothing(counts, stand_in):
    stream, queued = stand_in
    to_host({"mu": torch.zeros(10), "n": 3})
    assert queued == [] and stream.waits == 0
    assert counts.plans == {"pageable": 1}


def test_model_pulls_every_field_in_one_call(counts, stand_in):
    stream, queued = stand_in
    np.random.seed(1)
    sim = simulate(N=8, trials=300, H=2, connection_prob=0.5,
                   verbose=False, device="cpu")
    m = Model(8).fit(sim["psc"], sim["stim_matrix"], device="cpu",
                     fit_options={"iters": 1, "verbose": False})
    # lam [8, 300] crosses the floor, the [8] and [300] fields do not
    assert counts.plans["pinned"] == 1 and stream.waits == 1
    assert counts.plans["pageable"] >= 3 and len(queued) == 1
    assert isinstance(m.state["lam"], np.ndarray)
    assert m.state["lam"].shape == (8, sim["stim_matrix"].shape[1])


def test_device_fields_stay_on_the_device_until_asked(counts, stand_in):
    stream, _ = stand_in
    m = Model(4)
    m._materialize = {"mu"}
    lam = torch.rand(4, FLOOR // 16)
    out = m._pull({"mu": torch.ones(4), "lam": lam, "shape": 2.0})
    assert isinstance(out["mu"], np.ndarray) and out["shape"] == 2.0
    assert isinstance(out["lam"], DeviceField)
    assert counts.plans == {"pageable": 1}
    host = np.asarray(out["lam"])
    np.testing.assert_array_equal(host, lam.numpy())
    assert counts.plans == {"pageable": 1, "pinned": 1}
    assert stream.waits == 1
    assert np.asarray(out["lam"], dtype=np.float64).dtype == np.float64


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _fit(cuda, seed=0, N=60, K=6000):
    """A short CAVIaR fit whose lam ([N, K] float32) takes the pinned
    path."""
    np.random.seed(seed)
    sim = simulate(N=N, trials=K, H=4, connection_prob=0.1, verbose=False,
                   device=cuda)
    return Model(N).fit(sim["psc"], sim["stim_matrix"], device=cuda,
                        fit_options={"iters": 3, "verbose": False})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(3,), (1000, 40), (2000, 400),
                                   (512, 1024, 2)])
def test_pinned_fields_equal_the_pageable_copy_bit_for_bit(cuda, counts,
                                                           dtype, shape):
    g = torch.Generator(device=cuda).manual_seed(3)
    t = torch.randn(shape, dtype=dtype, device=cuda, generator=g)
    t[..., 0] = float("nan")
    out = to_host({"t": t, "tt": t.mT if t.dim() > 1 else t})
    ref = t.cpu().numpy()
    for k, want in (("t", ref), ("tt", ref.swapaxes(-1, -2) if t.dim() > 1
                                else ref)):
        a = out[k]
        assert a.dtype == want.dtype and a.shape == want.shape
        assert a.flags.writeable
        assert a.tobytes() == want.tobytes()
    path = plan(cuda, t.nbytes)
    if path == "pinned":
        assert out["tt"].flags.c_contiguous
    assert counts.plans == {path: 2}


@pytest.mark.cuda
def test_fits_return_lam_arrays_that_never_alias(cuda, counts):
    a = _fit(cuda, seed=0)
    lam_a = a.state["lam"]
    keep = lam_a.copy()
    b = _fit(cuda, seed=1)
    lam_b = b.state["lam"]
    assert not np.shares_memory(lam_a, lam_b)
    np.testing.assert_array_equal(lam_a, keep)
    assert not np.array_equal(lam_a, lam_b)
    assert counts.plans["pinned"] >= 2
    assert counts.plan_bytes["pinned"] >= 2 * lam_a.nbytes


@pytest.mark.cuda
def test_an_array_outlives_its_model(cuda, counts):
    model = _fit(cuda, seed=2)
    lam = model.state["lam"]
    keep = lam.copy()
    del model
    gc.collect()
    torch.cuda.synchronize()
    # a later pull of the same size may not take lam's block
    other = to_host({"x": torch.full(lam.shape, 7.0, device=cuda)})["x"]
    assert not np.shares_memory(lam, other)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(lam, keep)


@pytest.mark.cuda
def test_a_freed_block_takes_the_next_fit(cuda, counts):
    model = _fit(cuda, seed=3)
    ptr = model.state["lam"].ctypes.data
    del model
    gc.collect()
    again = _fit(cuda, seed=4)
    assert again.state["lam"].ctypes.data == ptr
    assert counts.plans["pinned"] >= 2


@pytest.mark.cuda
def test_device_field_asarray_takes_the_pull(cuda, counts):
    np.random.seed(5)
    sim = simulate(N=60, trials=6000, H=4, connection_prob=0.1,
                   verbose=False, device=cuda)
    m = Model(60).fit(sim["psc"], sim["stim_matrix"], device=cuda,
                      fit_options={"iters": 3, "verbose": False},
                      _materialize=("mu",))
    lam = m.state["lam"]
    assert isinstance(lam, DeviceField) and lam.device.type == "cuda"
    before = dict(counts.plans)
    host = np.asarray(lam)
    assert counts.plans.get("pinned", 0) == before.get("pinned", 0) + 1
    assert host.tobytes() == lam.as_subclass(torch.Tensor).cpu().numpy(
    ).tobytes()
