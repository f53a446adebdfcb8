"""circuitmap_torch.ops against circuitmap_tpu.ops on the same numpy inputs.

The JAX side runs in float32 (the suite does not enable x64), so every
comparison with it is held to a float32 tolerance whatever the port's
dtype; float64 runs of the port are also held tightly to a numpy
float64 oracle.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.special import ndtr

from circuitmap_tpu.ops import charge as jcharge
from circuitmap_tpu.ops import monotone as jmono
from circuitmap_tpu.ops import pava as jpava
from circuitmap_tpu.ops import spike_rates as jrates
from circuitmap_tpu.ops import truncnorm as jtn
from circuitmap_tpu.utils.metrics import r2_score as jax_r2_score
from circuitmap_tpu.ops import masks as jmasks
from circuitmap_torch.ops import (charge, masks, monotone, pava, spike_rates,
                                  truncnorm)
from circuitmap_torch.utils.metrics import r2_score

DTYPES = [torch.float32, torch.float64]
F32 = dict(rtol=1e-5, atol=1e-6)


def _t(a, dtype):
    return torch.as_tensor(np.asarray(a), dtype=dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_charge_and_activity_mask(dtype):
    rng = np.random.default_rng(0)
    psc = rng.normal(0, 0.01, (40, 900))
    psc[:5] *= 20.0  # a few active trials
    q, m = charge.prepare_observations(_t(psc, dtype), 1e-2)
    jq, jm = jcharge.prepare_observations(jnp.asarray(psc, jnp.float32), 1e-2)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    if dtype == torch.float64:
        np.testing.assert_allclose(q.numpy(), np.trapezoid(psc, axis=-1),
                                   rtol=1e-12)
        np.testing.assert_array_equal(m.numpy(), (psc ** 2).sum(-1) > 1e-2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("start", [0, 1, 500])
def test_monotone_decay_filter(dtype, start):
    x = np.random.default_rng(1).normal(size=(6, 900))
    got = monotone.monotone_decay_filter(_t(x, dtype), start=start).numpy()
    want = np.asarray(jmono.monotone_decay_filter(jnp.asarray(x, jnp.float32),
                                                  start=start))
    np.testing.assert_allclose(got, want, **F32)
    oracle = x.copy()
    s = max(start - 1, 0)
    np.minimum.accumulate(oracle[:, s:], axis=1, out=oracle[:, s:])
    np.testing.assert_allclose(got, oracle, rtol=1e-6 if dtype == torch.float32
                               else 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_isotonic_fit_at_max(dtype):
    y = np.random.default_rng(2).uniform(0, 1, (50, 5))
    got = pava.isotonic_fit_at_max_batched(_t(y, dtype)).numpy()
    want = np.asarray(jpava.isotonic_fit_at_max_batched(jnp.asarray(y, jnp.float32)))
    np.testing.assert_allclose(got, want, **F32)
    one = pava.isotonic_fit_at_max(_t(y[0], dtype)).item()
    assert one == pytest.approx(float(jpava.isotonic_fit_at_max(
        jnp.asarray(y[0], jnp.float32))), rel=1e-6)
    # the full isotonic regression's last value (JAX PAVA) is the oracle
    full = np.asarray(jpava.isotonic_regression_batched(
        jnp.asarray(y, jnp.float32), 1.0))[:, -1]
    np.testing.assert_allclose(got, full, rtol=1e-5, atol=1e-6)


def _pava_rows(seed, T=5):
    """Random rows plus the hard cases: decreasing, constant, ties and
    one long violation at the end."""
    rng = np.random.default_rng(seed)
    y = rng.uniform(0, 1, (120, T))
    y[0] = np.linspace(1, 0, T)
    y[1] = 0.5
    y[2, :5] = [0.2, 0.2, 0.1, 0.1, 0.9]
    y[3, -1] = -5.0
    return y


@pytest.mark.parametrize("gamma", [1.0, 0.9])
def test_isotonic_regression_matches_jax_in_float64(gamma):
    y = _pava_rows(int(gamma * 10))
    with jax.enable_x64(True):
        want = np.asarray(jpava.isotonic_regression_batched(jnp.asarray(y),
                                                            gamma))
        want0 = np.asarray(jpava.isotonic_regression(jnp.asarray(y[0]),
                                                     gamma))
    got = pava.isotonic_regression_batched(_t(y, torch.float64), gamma)
    assert got.dtype == torch.float64 and got.shape == y.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    one = pava.isotonic_regression(_t(y[0], torch.float64), gamma).numpy()
    np.testing.assert_allclose(one, want0, rtol=0, atol=1e-12)
    if gamma == 1.0:  # a non-decreasing fit that keeps the sum
        assert (np.diff(got.numpy(), axis=1) >= -1e-12).all()
        np.testing.assert_allclose(got.numpy().sum(1), y.sum(1), atol=1e-12)


@pytest.mark.parametrize("T", [1, 2, 4, 8])
def test_isotonic_regression_float32_matches_jax(T):
    y = np.random.default_rng(T).uniform(0, 1, (60, T))
    y[0] = np.linspace(1, 0, T)
    want = np.asarray(jpava.isotonic_regression_batched(
        jnp.asarray(y, jnp.float32), 1.0))
    got = pava.isotonic_regression_batched(_t(y, torch.float32), 1.0)
    np.testing.assert_allclose(got.numpy(), want, **F32)


def test_get_mask_matches_jax():
    np.testing.assert_array_equal(masks.get_mask(5).numpy(),
                                  np.asarray(jmasks.get_mask(5)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_spike_rates_by_power(dtype):
    rng = np.random.default_rng(3)
    stim = rng.choice([0.0, 45.0, 55.0, 65.0], (20, 300))
    stim[0] = np.where(stim[0] == 55.0, 0.0, stim[0])  # an empty bucket
    lam = rng.uniform(0, 1, (20, 300))
    powers = np.array([45.0, 55.0, 65.0])
    got = spike_rates.spike_rates_by_power(_t(stim, dtype), _t(lam, dtype),
                                           _t(powers, dtype)).numpy()
    want = np.asarray(jrates.spike_rates_by_power_batched(
        jnp.asarray(stim, jnp.float32), jnp.asarray(lam, jnp.float32),
        jnp.asarray(powers, jnp.float32)))
    np.testing.assert_allclose(got, want, **F32)
    assert got[0, 1] == 0.0


@pytest.mark.parametrize("dtype", DTYPES)
def test_truncated_normal_mean(dtype):
    # includes the deep negative tail where 1 - ndtr(alpha) cancels and
    # the Mills-ratio asymptote takes over in float32
    mean = np.array([0.5, -0.2, -3.0, -8.0, -20.0, 2.0, 0.1])
    sd = np.array([1.0, 0.3, 0.5, 1.0, 1.0, 0.1, 1e-3])
    got = truncnorm.truncated_normal_mean(_t(mean, dtype), _t(sd, dtype)).numpy()
    assert np.all(got > 0) and np.all(np.isfinite(got))
    if dtype == torch.float32:
        # same float32 arithmetic as the JAX package, tail cases included
        want = np.asarray(jtn.truncated_normal_mean(
            jnp.asarray(mean, jnp.float32), jnp.asarray(sd, jnp.float32)))
        np.testing.assert_allclose(got, want, rtol=1e-4)
    else:
        # float64 resolves the tail that float32 (either package) only
        # approximates, so it is held to the float64 oracle instead
        alpha = -mean / sd
        pdf = np.exp(-0.5 * alpha ** 2) / np.sqrt(2 * np.pi)
        oracle = mean + sd * pdf / ndtr(-alpha)
        np.testing.assert_allclose(got, oracle, rtol=1e-8)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sample_truncated_normal(dtype):
    # torch.Generator cannot reproduce jax.random: compare distributions
    mean = _t([0.1, 5.0, -1.0], dtype)
    sd = _t([0.1, 1.0, 0.5], dtype)
    gen = torch.Generator().manual_seed(0)
    s = truncnorm.sample_truncated_normal(gen, mean, sd, 20000)
    assert s.shape == (20000, 3) and s.dtype == dtype
    assert torch.all(s > 0) and torch.all(torch.isfinite(s))
    exact = truncnorm.truncated_normal_mean(mean, sd)
    np.testing.assert_allclose(s.mean(0).numpy(), exact.numpy(), rtol=2e-2)
    gen2 = torch.Generator().manual_seed(0)
    assert torch.equal(s, truncnorm.sample_truncated_normal(gen2, mean, sd, 20000))


@pytest.mark.parametrize("case", ["1d", "2d", "constant_truth"])
def test_r2_score_matches_the_jax_package(case):
    rng = np.random.default_rng(4)
    truth = rng.normal(size=(50,) if case == "1d" else (50, 3))
    if case == "constant_truth":
        truth = np.zeros(50)
    pred = truth + rng.normal(0, 0.3, truth.shape)
    assert r2_score(truth, pred) == jax_r2_score(truth, pred)
    assert r2_score(truth, truth) == jax_r2_score(truth, truth) == 1.0
