"""The port's MBCS-ARD and CoSaMP baseline against the JAX package's, on
the same numpy inputs.

ARD: float64 on both sides (the JAX fit under ``jax.enable_x64``); each
port iteration is driven with the permutation ``jax.random`` gives the
JAX fit for the same key, and every output is held at rtol 1e-6 after 3
iterations. CoSaMP is host numpy in both packages: equal outputs.
"""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import circuitmap_torch as cm
from circuitmap_tpu.simulation import simulate

ja = importlib.import_module("circuitmap_tpu.solvers.experimental")
te = importlib.import_module("circuitmap_torch.solvers.experimental")
jcos = importlib.import_module("circuitmap_tpu.solvers.cosamp")
tcos = importlib.import_module("circuitmap_torch.solvers.cosamp")

ARD = ("mu", "beta", "relevance", "lam", "sigma2", "z")


def _sim(seed=0, N=40, K=400):
    np.random.seed(seed)
    return simulate(N=N, trials=K, H=4, connection_prob=0.1, verbose=False)


@pytest.fixture(scope="module")
def ard():
    sim, seed, iters = _sim(), 5, 3
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in ja.mbcs_ard(
            sim["psc"], sim["stim_matrix"], iters=iters, seed=seed,
            dtype=jnp.float64, verbose=False)]
        key, orders = jax.random.PRNGKey(seed), []
        for _ in range(iters):  # the key split of the JAX iteration
            key, k_order = jax.random.split(key)
            orders.append(np.array(jax.random.permutation(k_order, 40)))
    data, state = te._ard_inputs(sim["psc"], sim["stim_matrix"], 0.75,
                                 torch.float64, torch.device("cpu"))
    static = dict(relevance_cap=1e4, outlier_penalty=10.0,
                  spike_prior_logit=float(np.log(0.75 / 0.25)))
    for order in orders:
        state = te._iteration(state, data, static, torch.from_numpy(order))
    return want, [s.numpy() for s in state]


@pytest.mark.parametrize("i,name", list(enumerate(ARD)))
def test_ard_iterations_match_jax_in_float64(ard, i, name):
    want, got = ard
    assert got[i].dtype == np.float64 and got[i].shape == want[i].shape
    np.testing.assert_allclose(got[i], want[i], rtol=1e-6, atol=1e-10,
                               err_msg=name)


def test_mbcs_ard_on_cpu_is_seeded_and_prunes():
    sim = _sim(seed=1)

    def fit(seed):
        return cm.mbcs_ard(sim["psc"], sim["stim_matrix"], iters=8,
                           seed=seed, verbose=False, device="cpu")

    a, b = fit(0), fit(0)
    for name, x, y in zip(ARD, a, b):
        assert torch.isfinite(x).all(), name
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    mu, relevance = a[0], a[2]
    assert (relevance <= 1e4).all()
    w = sim["weights"]
    kept = (mu.abs() > 0.5).numpy()
    assert kept[w > 0].mean() > kept[w == 0].mean()


def test_sweep_takes_one_level_with_its_counts():
    """The row sweep reads no level with the gate off but takes 1..8 of
    them: ARD passes the largest, with its trial counts."""
    stim = np.array([[0, 45, 65, 65, 0, 0], [65, 0, 0, 45, 0, 65]], float)
    data, _ = te._ard_inputs(np.ones((6, 20)), stim, 0.75, torch.float64,
                             torch.device("cpu"))
    powers, counts = data[3], data[4]
    assert powers.tolist() == [65.0]
    assert counts[:, 0].tolist() == [2.0, 2.0]


@pytest.mark.parametrize("k", [3, 6])
def test_cosamp_matches_jax(k):
    rng = np.random.default_rng(k)
    A = (rng.random((300, 40)) < 0.1).astype(float)
    x = np.where(rng.random(40) < 0.1, rng.uniform(5, 20, 40), 0.0)
    y = A @ x + rng.normal(0, 0.1, 300)
    got, _ = tcos.cosamp(A, y, k)
    want, _ = jcos.cosamp(A, y, k)
    np.testing.assert_array_equal(got, want)
    assert (got != 0).sum() <= k
