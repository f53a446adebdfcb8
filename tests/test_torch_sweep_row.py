"""The port's plain strictly sequential sweeps against the JAX package's
Pallas row kernels, in interpret mode.

``sweep_spikes_row_torch`` (the plain version the CPU path runs) is held
against ``sweep_spikes_pallas`` and ``sweep_spikes_pallas_dma`` (the two
pipelines of one function); ``sweep_spikes_row_batched_torch`` against
``sweep_spikes_pallas_batched`` at B=3 with a row order and an
``msrmp_eff`` per experiment; ``sweep_spikes_blocked_batched_torch``
against ``sweep_spikes_pallas_dma_blocked_batched``. N=29 and K=300 (not
a multiple of 128, so the DMA kernels pad). Both sides run float32 on
the same numpy inputs, summing in another order: rtol 1e-4 / atol 1e-5,
and with the gate on the same rows gated off.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from circuitmap_tpu.ops.sweep_pallas import (
    sweep_spikes_pallas, sweep_spikes_pallas_batched, sweep_spikes_pallas_dma,
    sweep_spikes_pallas_dma_blocked_batched)
from circuitmap_torch.ops import sweep_cuda, sweep_row_cuda

N, K, B = 29, 300, 3
POWERS = (45.0, 55.0, 65.0)
TOL = dict(rtol=1e-4, atol=1e-5)
SIG, MIN_COUNT = 0.1, 3.0
ARRAYS = ("y", "stim", "mu", "beta", "lam")


def _inputs(seed, lead=()):
    """Sweep inputs with optional leading experiment dims, made with
    numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    stim = np.zeros((*lead, N, K), np.float32)
    flat = stim.reshape(-1, N, K)
    for s in flat:
        s[rng.integers(0, N, 3 * K), np.repeat(np.arange(K), 3)] = \
            rng.choice(POWERS, 3 * K)
    lam = np.where(stim > 0, rng.uniform(0, 1, stim.shape), 0).astype(
        np.float32)
    mu = np.where(rng.random((*lead, N)) < 0.3,
                  rng.uniform(5, 20, (*lead, N)), 0).astype(np.float32)
    spikes = (rng.random(stim.shape) < lam).astype(np.float32)
    y = (np.einsum("...n,...nk->...k", mu, spikes)
         + rng.normal(0, 1, (*lead, K))).astype(np.float32)
    return dict(
        y=y, stim=stim, mu=mu,
        beta=rng.uniform(0.5, 2, (*lead, N)).astype(np.float32), lam=lam,
        m0=rng.uniform(0.2, 0.25, (*lead, N)).astype(np.float32),
        m1=rng.uniform(10, 15, (*lead, N)).astype(np.float32),
        lam_mask=(rng.random((*lead, K)) > 0.05).astype(np.float32),
        powers=np.asarray(POWERS, np.float32),
        power_counts=np.stack([(stim == p).sum(-1) for p in POWERS],
                              -1).astype(np.float32))


def _args(d, conv, order, sig, msrmp, gate):
    return (*(conv(d[k]) for k in ARRAYS), sig, conv(d["m0"]), conv(d["m1"]),
            conv(d["lam_mask"]), conv(d["powers"]), conv(d["power_counts"]),
            order, msrmp, MIN_COUNT, gate)


def _torch(d, order, sig, msrmp, gate):
    return _args(d, torch.from_numpy, torch.from_numpy(order), sig, msrmp,
                 gate)


def _jax(d, order, sig, msrmp, gate):
    return _args(d, jnp.asarray, jnp.asarray(order, jnp.int32), sig, msrmp,
                 gate)


def _gated_off(out, lam):
    """Rows whose output is all zero where the input row was not."""
    out = np.asarray(out)
    return (out.sum(-1) == 0) & (np.asarray(lam).sum(-1) > 0)


@pytest.mark.parametrize("gate", [0.0, 1.0], ids=["gate_off", "gate_on"])
@pytest.mark.parametrize("kernel", [sweep_spikes_pallas,
                                    sweep_spikes_pallas_dma],
                         ids=["grid", "dma"])
def test_row_sweep_matches_pallas_kernels(kernel, gate):
    d = _inputs(0)
    order = np.random.default_rng(1).permutation(N)
    got = sweep_row_cuda.sweep_spikes_row_torch(
        *_torch(d, order, SIG, 0.5, gate)).numpy()
    want = np.asarray(kernel(*_jax(d, order, SIG, 0.5, gate),
                             interpret=True))
    np.testing.assert_array_equal(_gated_off(got, d["lam"]),
                                  _gated_off(want, d["lam"]))
    np.testing.assert_allclose(got, want, **TOL)
    if gate:  # the gate really cut rows in this case
        assert _gated_off(got, d["lam"]).any()


@pytest.mark.parametrize("gate", [0.0, 1.0], ids=["gate_off", "gate_on"])
def test_batched_row_sweep_matches_pallas_batched_kernel(gate):
    d = _inputs(2, lead=(B,))
    rng = np.random.default_rng(3)
    order = np.stack([rng.permutation(N) for _ in range(B)])
    sig = np.float32([0.1, 0.15, 0.08])
    msrmp = np.float32([0.3, 0.5, 0.7])  # msrmp + spont_rate per map
    got = sweep_row_cuda.sweep_spikes_row_batched_torch(
        *_torch(d, order, torch.from_numpy(sig), torch.from_numpy(msrmp),
                gate)).numpy()
    want = np.asarray(sweep_spikes_pallas_batched(
        *_jax(d, order, jnp.asarray(sig), jnp.asarray(msrmp), gate),
        interpret=True))
    np.testing.assert_array_equal(_gated_off(got, d["lam"]),
                                  _gated_off(want, d["lam"]))
    np.testing.assert_allclose(got, want, **TOL)
    # each experiment equals its own single sweep
    for b in range(B):
        one = sweep_row_cuda.sweep_spikes_row_torch(
            *_torch({k: (v if k == "powers" else v[b]) for k, v in d.items()},
                    order[b], float(sig[b]), float(msrmp[b]), gate))
        np.testing.assert_allclose(one.numpy(), got[b], rtol=0, atol=1e-6)


@pytest.mark.parametrize("gate", [0.0, 1.0], ids=["gate_off", "gate_on"])
def test_batched_blocked_sweep_matches_pallas_kernel(gate):
    d = _inputs(4, lead=(B,))
    nb = -(-N // 8)  # a partial padding block
    rng = np.random.default_rng(5)
    border = np.stack([rng.permutation(nb) for _ in range(B)])
    sig = np.float32([0.1, 0.12, 0.09])
    msrmp = np.float32([0.4, 0.5, 0.6])
    got = sweep_cuda.sweep_spikes_blocked_batched_torch(
        *_torch(d, border, torch.from_numpy(sig), torch.from_numpy(msrmp),
                gate)).numpy()
    want = np.asarray(sweep_spikes_pallas_dma_blocked_batched(
        *_jax(d, border, jnp.asarray(sig), jnp.asarray(msrmp), gate),
        interpret=True))
    np.testing.assert_array_equal(_gated_off(got, d["lam"]),
                                  _gated_off(want, d["lam"]))
    np.testing.assert_allclose(got, want, **TOL)


def test_float64_matches_float32():
    # the plain version is dtype-generic: float64 agrees with float32 to
    # float32 rounding (no gate flips at these inputs)
    d = _inputs(6)
    order = np.random.default_rng(7).permutation(N)
    got32 = sweep_row_cuda.sweep_spikes_row_torch(
        *_torch(d, order, SIG, 0.5, 1.0))
    d64 = {k: v.astype(np.float64) for k, v in d.items()}
    got64 = sweep_row_cuda.sweep_spikes_row_torch(
        *_torch(d64, order, SIG, 0.5, 1.0))
    assert got64.dtype == torch.float64
    np.testing.assert_allclose(got32.numpy(), got64.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_wrappers_take_plain_versions_on_cpu(batched):
    lead = (B,) if batched else ()
    d = _inputs(8, lead=lead)
    rng = np.random.default_rng(9)
    order = np.stack([rng.permutation(N) for _ in range(B)]) if batched \
        else rng.permutation(N)
    fn, plain = ((sweep_row_cuda.sweep_spikes_row_batched,
                  sweep_row_cuda.sweep_spikes_row_batched_torch) if batched
                 else (sweep_row_cuda.sweep_spikes_row,
                       sweep_row_cuda.sweep_spikes_row_torch))
    before = fn.launches
    got = fn(*_torch(d, order, SIG, 0.5, 1.0))
    assert fn.launches == before
    np.testing.assert_array_equal(
        got.numpy(), plain(*_torch(d, order, SIG, 0.5, 1.0)).numpy())
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a
            for a in _torch(d, order, SIG, 0.5, 1.0)]
    with pytest.raises(ValueError, match="no row-sweep kernel"):
        fn(*meta)


def test_blocked_batched_wrapper_takes_plain_version_on_cpu():
    d = _inputs(10, lead=(B,))
    rng = np.random.default_rng(11)
    border = np.stack([rng.permutation(-(-N // 8)) for _ in range(B)])
    fn = sweep_cuda.sweep_spikes_blocked_batched
    before = fn.launches
    got = fn(*_torch(d, border, SIG, 0.5, 1.0))
    assert fn.launches == before
    np.testing.assert_array_equal(
        got.numpy(), sweep_cuda.sweep_spikes_blocked_batched_torch(
            *_torch(d, border, SIG, 0.5, 1.0)).numpy())
    # one experiment of the batch equals the single blocked sweep
    one = sweep_cuda.sweep_spikes_blocked_torch(*_torch(
        {k: (v if k == "powers" else v[1]) for k, v in d.items()},
        border[1], SIG, 0.5, 1.0))
    np.testing.assert_allclose(one.numpy(), got[1].numpy(), rtol=0,
                               atol=1e-6)
