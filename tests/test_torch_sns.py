"""The port's CAVI-SnS against the JAX package's, on the same numpy inputs.

float64 on both sides: the JAX functions run under ``jax.enable_x64``
(a context; the suite's float32 default is restored after it). The
whole fit uses ``update_order="identity"`` and ``analytic_mc=True``
(``torch.Generator`` cannot reproduce ``jax.random``) and is held at
rtol 1e-6 on every posterior and history; single sweeps are driven with
one row order on both sides and held at rtol 1e-9.
"""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from circuitmap_torch import Model, default_priors
from circuitmap_tpu.model import default_priors as jax_default_priors
from circuitmap_tpu.simulation import simulate
from circuitmap_tpu.utils.metrics import r2_score

jsns = importlib.import_module("circuitmap_tpu.solvers.cavi_sns")
tsns = importlib.import_module("circuitmap_torch.solvers.cavi_sns")

NAMES = ["mu", "beta", "alpha", "lam", "shape", "rate", "phi", "phi_cov"]
FIT_RTOL = dict(rtol=1e-6, atol=1e-10)
SWEEP_RTOL = dict(rtol=1e-9, atol=1e-12)


def _sim(N=40, K=400, seed=0):
    np.random.seed(seed)
    return simulate(N=N, trials=K, H=4, connection_prob=0.1, verbose=False)


@pytest.fixture(scope="module")
def fits():
    sim = _sim()
    p = jax_default_priors(40)
    args = (sim["psc"], sim["stim_matrix"], p["mu"], p["beta"], p["alpha"],
            p["shape"], p["rate"], p["phi"], p["phi_cov"])
    kw = dict(iters=12, update_order="identity", analytic_mc=True,
              verbose=False, save_histories=True)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jsns.cavi_sns(*args, dtype=jnp.float64,
                                                     **kw)]
    got = tsns.cavi_sns(*args, dtype=torch.float64, device="cpu", **kw)
    return want, got


@pytest.mark.parametrize("i,name", list(enumerate(
    NAMES + ["history_" + n for n in NAMES])))
def test_whole_fit_matches_jax_in_float64(fits, i, name):
    want, got = fits
    assert len(got) == len(want) == 16
    g = got[i].numpy() if torch.is_tensor(got[i]) else got[i]
    assert g.dtype == np.float64 and g.shape == want[i].shape, name
    np.testing.assert_allclose(g, want[i], err_msg=name, **FIT_RTOL)


def test_random_order_fit_matches_jax_on_its_row_orders(monkeypatch):
    """A random-order fit handed the row orders that the JAX package
    draws at the same seed (each iteration splits its key in five and
    permutes the rows with the first three parts) is the JAX package's
    fit: float64, exact power-curve means, rtol 1e-6."""
    N, iters, seed = 30, 8, 3
    sim = _sim(N=N, K=300, seed=2)
    p = jax_default_priors(N)
    args = (sim["psc"], sim["stim_matrix"], p["mu"], p["beta"], p["alpha"],
            p["shape"], p["rate"], p["phi"], p["phi_cov"])
    kw = dict(iters=iters, seed=seed, analytic_mc=True, verbose=False,
              save_histories=False)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jsns.cavi_sns(
            *args, dtype=jnp.float64, **kw)[:8]]
        key, orders = jax.random.PRNGKey(seed), []
        for _ in range(iters):
            key, *parts = jax.random.split(key, 5)
            orders += [np.asarray(jax.random.permutation(k, N))
                       for k in parts[:3]]
    queue = [torch.as_tensor(o, dtype=torch.int64) for o in orders]
    monkeypatch.setattr(torch, "randperm",
                        lambda n, generator=None, device=None: queue.pop(0))
    got = tsns.cavi_sns(*args, dtype=torch.float64, device="cpu", **kw)[:8]
    assert not queue
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), w, err_msg=name, **FIT_RTOL)


def _sweep_state(N=30, K=300, seed=3):
    rng = np.random.default_rng(seed)
    stim = np.zeros((N, K))
    stim[rng.integers(0, N, 3 * K), np.repeat(np.arange(K), 3)] = rng.choice(
        [45.0, 55.0, 65.0], 3 * K)
    lam = np.where(stim > 0, rng.uniform(0, 1, (N, K)), 0.0)
    mu = np.where(rng.random(N) < 0.4, rng.uniform(5, 20, N), 0.0)
    y = mu @ (rng.random((N, K)) < lam) + rng.normal(0, 1, K)
    return dict(
        y=y, stim=stim, lam=lam, mu=mu, beta=rng.uniform(0.5, 2, N),
        alpha=rng.uniform(0.05, 0.999, N), m0=rng.uniform(0.15, 0.25, N),
        m1=rng.uniform(8, 12, N), lam_mask=np.ones(K),
        mu_prior=np.zeros(N), beta_prior=np.full(N, 10.0),
        alpha_prior=np.full(N, 0.25),
        order=rng.permutation(N))


def _run_both(fn_name, d, keys, *extra):
    with jax.enable_x64(True):
        want = getattr(jsns, fn_name)(*(jnp.asarray(d[k]) for k in keys),
                                      *extra)
        want = np.asarray(want)
    got = getattr(tsns, fn_name)(*(torch.as_tensor(d[k]) for k in keys),
                                 *extra)
    return got.numpy(), want


@pytest.mark.parametrize("min_count", [0.0, 3.0, 15.0])
def test_sweep_spikes_sns_matches_jax(min_count):
    d = _sweep_state()
    sig = 0.2
    with jax.enable_x64(True):
        want = np.asarray(jsns.sweep_spikes_sns(
            *(jnp.asarray(d[k]) for k in ("y", "stim", "mu", "beta", "alpha",
                                          "lam")), sig,
            jnp.asarray(d["m0"]), jnp.asarray(d["m1"]),
            jnp.asarray(d["lam_mask"]), jnp.asarray(d["order"]), min_count))
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    got = tsns.sweep_spikes_sns(
        t["y"], t["stim"], t["mu"], t["beta"], t["alpha"], t["lam"],
        torch.tensor(sig, dtype=torch.float64), t["m0"], t["m1"],
        t["lam_mask"], t["order"], min_count).numpy()
    np.testing.assert_allclose(got, want, **SWEEP_RTOL)
    gated = (got.sum(1) == 0) & (d["stim"] > 0).any(1)
    if min_count == 15.0:  # the threshold gates some rows off, not all
        assert 0 < gated.sum() < len(gated)
    if min_count == 0.0:
        assert not gated.any()


def test_sweep_means_matches_jax():
    d = _sweep_state(seed=4)
    keys = ("y", "mu", "beta", "alpha", "lam")
    with jax.enable_x64(True):
        want = np.asarray(jsns.sweep_means(
            *(jnp.asarray(d[k]) for k in keys), 0.3,
            jnp.asarray(d["mu_prior"]), jnp.asarray(d["beta_prior"]),
            jnp.asarray(d["order"])))
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    got = tsns.sweep_means(*(t[k] for k in keys), torch.tensor(0.3, dtype=torch.float64),
                           t["mu_prior"], t["beta_prior"], t["order"])
    np.testing.assert_allclose(got.numpy(), want, **SWEEP_RTOL)
    assert not np.array_equal(got.numpy(), d["mu"])


def test_sweep_connection_probs_matches_jax():
    d = _sweep_state(seed=5)
    keys = ("y", "mu", "beta", "alpha", "lam")
    with jax.enable_x64(True):
        want = np.asarray(jsns.sweep_connection_probs(
            *(jnp.asarray(d[k]) for k in keys), 0.01,
            jnp.asarray(d["alpha_prior"]), jnp.asarray(d["order"])))
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    got = tsns.sweep_connection_probs(
        *(t[k] for k in keys), torch.tensor(0.01, dtype=torch.float64),
        t["alpha_prior"], t["order"])
    np.testing.assert_allclose(got.numpy(), want, **SWEEP_RTOL)
    assert ((got.numpy() > 0) & (got.numpy() < 1)).all()


def test_slab_scale_and_noise_match_jax():
    d = _sweep_state(seed=6)
    shape, rate = 101.0, 37.5
    with jax.enable_x64(True):
        j = {k: jnp.asarray(v) for k, v in d.items()}
        want_beta = np.asarray(jsns.update_slab_scale(
            j["alpha"], j["lam"], shape, rate, j["beta_prior"]))
        want_noise = [np.asarray(a) for a in jsns.update_noise_sns(
            j["y"], j["mu"], j["beta"], j["alpha"], j["lam"], 1.0, 0.1)]
    t = {k: torch.as_tensor(v) for k, v in d.items()}
    got_beta = tsns.update_slab_scale(
        t["alpha"], t["lam"], torch.tensor(shape, dtype=torch.float64),
        torch.tensor(rate, dtype=torch.float64), t["beta_prior"])
    got_noise = tsns.update_noise_sns(
        t["y"], t["mu"], t["beta"], t["alpha"], t["lam"],
        torch.tensor(1.0, dtype=torch.float64),
        torch.tensor(0.1, dtype=torch.float64))
    np.testing.assert_allclose(got_beta.numpy(), want_beta, rtol=1e-12)
    for g, w in zip(got_noise, want_noise):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-12)


def test_weight_recovery():
    """The JAX suite's recovery check (tests/test_solvers.py::TestCaviSns)
    through the port's ``Model.fit``: the same map and options."""
    np.random.seed(42)
    sim = simulate(N=60, trials=600, H=6, connection_prob=0.1,
                   spont_prob=0.02, verbose=False)
    model = Model(60).fit(
        sim["psc"], sim["stim_matrix"], method="cavi_sns", device="cpu",
        fit_options={"iters": 25, "verbose": False, "save_histories": False,
                     "seed": 1})
    s = model.state
    assert r2_score(sim["weights"], s["mu"] * s["alpha"]) > 0.5
    assert s["alpha"].shape == (60,) and s["lam"].shape == (60, 600)
    assert s["alpha"].min() >= 0.0 and s["alpha"].max() <= 1.0


def test_random_order_fit_is_seeded_and_finite():
    sim = _sim(N=30, K=300, seed=2)
    p = default_priors(30)

    def fit(seed):
        return Model(30, priors=p).fit(
            sim["psc"], sim["stim_matrix"], method="cavi_sns", device="cpu",
            fit_options={"iters": 5, "seed": seed, "verbose": False})

    a, b, c = fit(1), fit(1), fit(2)
    for key in NAMES:
        assert np.isfinite(a.state[key]).all(), key
        np.testing.assert_array_equal(a.state[key], b.state[key])
    assert not np.array_equal(a.state["lam"], c.state["lam"])
