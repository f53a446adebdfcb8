"""The port's MBCS against the JAX package's, on the same numpy inputs.

float64 on both sides (the JAX functions under ``jax.enable_x64``). The
whole fit is deterministic with ``learn_lam=False`` and
``analytic_noise=True``: rtol 1e-6 on every output, with the same zero
pattern in mu. With ``learn_lam=True`` the port's iteration is driven
with the row orders ``jax.random`` gives the JAX fit. The sweep, the
lasso and the outlier update take the same inputs and order: rtol 1e-8.
The Monte Carlo noise model cannot share the JAX stream; at 4000
samples it is held within 5% of its exact moments.
"""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from circuitmap_torch import Model
from circuitmap_tpu.model import default_priors as jax_default_priors
from circuitmap_tpu.simulation import simulate

jm = importlib.import_module("circuitmap_tpu.solvers.mbcs")
tm = importlib.import_module("circuitmap_torch.solvers.mbcs")

NAMES = ["mu", "beta", "lam", "shape", "rate", "z", "receptive_fields"]
HIST = ["mu", "beta", "lam", "shape", "rate", "z"]
FIT_RTOL = dict(rtol=1e-6, atol=1e-10)
UNIT_RTOL = dict(rtol=1e-8, atol=1e-12)


def _sim(seed=0):
    np.random.seed(seed)
    return simulate(N=40, trials=400, H=4, connection_prob=0.1, verbose=False)


def _args(sim):
    p = jax_default_priors(40)
    return (sim["psc"], sim["stim_matrix"], p["mu"], p["beta"], p["shape"],
            p["rate"])


@pytest.fixture(scope="module")
def fits():
    sim = _sim()
    kw = dict(iters=10, learn_lam=False, analytic_noise=True,
              save_histories=True)
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jm.mbcs(*_args(sim), dtype=jnp.float64,
                                               **kw)]
    got = tm.mbcs(*_args(sim), dtype=torch.float64, device="cpu", **kw)
    return want, [g.numpy() if torch.is_tensor(g) else g for g in got]


@pytest.mark.parametrize("i,name", list(enumerate(
    NAMES + ["history_" + n for n in HIST])))
def test_whole_fit_matches_jax_in_float64(fits, i, name):
    want, got = fits
    assert len(got) == len(want) == 13
    assert got[i].dtype == np.float64 and got[i].shape == want[i].shape
    np.testing.assert_allclose(got[i], want[i], err_msg=name, **FIT_RTOL)
    if name == "mu":
        np.testing.assert_array_equal(got[i] == 0, want[i] == 0)
        assert 0 < (got[i] != 0).sum() < got[i].size


def test_fit_with_the_jax_row_orders_matches_jax():
    """learn_lam=True: each port iteration takes the permutation the
    JAX fit draws (key split into order and noise keys, as _run_mbcs)."""
    sim, seed, iters = _sim(seed=1), 3, 6
    with jax.enable_x64(True):
        want = [np.asarray(a) for a in jm.mbcs(
            *_args(sim), iters=iters, seed=seed, analytic_noise=True,
            dtype=jnp.float64, save_histories=False)]
        key, orders = jax.random.PRNGKey(seed), []
        for _ in range(iters):
            key, k_order, _ = jax.random.split(key, 3)
            orders.append(np.array(jax.random.permutation(k_order, 40)))
    dt, dev = torch.float64, torch.device("cpu")
    p = jax_default_priors(40)
    y = torch.trapezoid(torch.as_tensor(sim["psc"]), dim=-1)
    lam_mask = torch.as_tensor(tm._activity_mask(sim["psc"], 0.05, 0.05))
    stim, _, _, pdev = tm.prepare_stim(sim["stim_matrix"], dt, dev)
    pw = torch.as_tensor(np.concatenate([[0.0], pdev]))
    mu0 = torch.as_tensor(np.random.default_rng(seed).lognormal(1, 1, 40))
    lam0 = (stim > 0).to(dt) * 0.75 * lam_mask
    K = y.shape[0]
    carry = (mu0, torch.as_tensor(p["beta"]), lam0,
             torch.full((K,), 1.0, dtype=dt), torch.full((K,), 0.1, dtype=dt),
             torch.zeros(K, dtype=dt), torch.tensor(0.0, dtype=dt), lam0)
    params = dict(
        penalty=5.0, scale_factor=0.5, max_penalty_iters=10,
        max_lasso_iters=100, constrain_weights="positive", learn_lam=True,
        delay_spont_estimation=1, minimum_spike_count=1,
        num_mc_samples_noise_model=10, orthogonal_outliers=True,
        analytic_noise=True, outlier_penalty=50.0,
        minimum_maximal_spike_prob=0.2, outlier_tol=0.05, noise_scale=0.5)
    data = (y, stim, lam_mask, pw, torch.as_tensor(p["beta"]))
    for it, order in enumerate(orders):
        carry, rf = tm._iteration(carry, it, data, params,
                                  torch.as_tensor(order), None)
    for got, w, name in zip((*carry[:6], rf), want, NAMES):
        np.testing.assert_allclose(got.numpy(), w, err_msg=name, **FIT_RTOL)
    assert (carry[0] != 0).sum() > 0


def _unit_state(N=30, K=300, seed=3):
    rng = np.random.default_rng(seed)
    stim = np.zeros((N, K))
    stim[rng.integers(0, N, 3 * K), np.repeat(np.arange(K), 3)] = rng.choice(
        [45.0, 55.0, 65.0], 3 * K)
    lam = np.where(stim > 0, rng.uniform(0, 1, (N, K)), 0.0)
    mu = np.where(rng.random(N) < 0.4, rng.uniform(5, 20, N), 0.0)
    y = mu @ (rng.random((N, K)) < lam) + rng.normal(0, 1, K)
    spont = rng.choice(K, K // 10, replace=False)
    y[spont] += rng.uniform(20, 40, spont.size)
    return dict(y=y, stim=stim, lam=lam, mu=mu, beta=rng.uniform(0.5, 2, N),
                shape=rng.uniform(0.5, 2, K), rate=rng.uniform(5, 20, K),
                lam_mask=(rng.random(K) > 0.05).astype(float),
                prior=rng.normal(0, 2, (N, K)), order=rng.permutation(N))


def _jt(d, keys):
    return ([jnp.asarray(d[k]) for k in keys],
            [torch.as_tensor(d[k]) for k in keys])


def test_sweep_spikes_mbcs_matches_jax():
    d = _unit_state()
    keys = ("y", "stim", "mu", "beta", "lam", "shape", "rate", "lam_mask",
            "prior", "order")
    with jax.enable_x64(True):
        j, t = _jt(d, keys)
        want = np.asarray(jm.sweep_spikes_mbcs(*j))
    got = tm.sweep_spikes_mbcs(*t).numpy()
    np.testing.assert_allclose(got, want, **UNIT_RTOL)
    off = d["mu"] == 0  # disconnected rows keep their lam
    np.testing.assert_array_equal(got[off], d["lam"][off])
    assert not np.allclose(got[~off], d["lam"][~off])


@pytest.mark.parametrize("positive", [True, False])
def test_fista_lasso_matches_jax(positive):
    d = _unit_state(seed=4)
    A, y = d["lam"].T, d["y"]
    x0 = np.full(A.shape[1], 1.0)
    with jax.enable_x64(True):
        want = np.asarray(jm._fista_lasso(jnp.asarray(A), jnp.asarray(y),
                                          jnp.asarray(x0), 0.5, max_iters=100,
                                          positive=positive))
    got = tm._fista_lasso(torch.as_tensor(A), torch.as_tensor(y),
                          torch.as_tensor(x0),
                          torch.tensor(0.5, dtype=torch.float64),
                          max_iters=100, positive=positive).numpy()
    np.testing.assert_allclose(got, want, **UNIT_RTOL)
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("constrain", ["positive", "negative", "none"])
def test_constrained_weight_update_matches_jax(constrain):
    d = _unit_state(seed=5)
    lam = d["lam"] * (-1.0 if constrain == "negative" else 1.0)
    keys = ("y", "mu", "shape", "rate")
    with jax.enable_x64(True):
        j, t = _jt(d, keys)
        want = np.asarray(jm.update_weights_constrained_l1(
            j[0], j[1], jnp.asarray(lam), j[2], j[3], penalty=5.0,
            constrain_weights=constrain))
    got = tm.update_weights_constrained_l1(
        t[0], t[1], torch.as_tensor(lam), t[2], t[3], penalty=5.0,
        constrain_weights=constrain).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("orthogonal", [True, False])
def test_update_outliers_matches_jax(orthogonal):
    d = _unit_state(seed=6)
    keys = ("y", "mu", "lam", "lam_mask")
    with jax.enable_x64(True):
        j, t = _jt(d, keys)
        want = np.asarray(jm.update_outliers(*j, penalty=50.0,
                                             orthogonal=orthogonal))
    got = tm.update_outliers(*t, penalty=50.0, orthogonal=orthogonal).numpy()
    np.testing.assert_allclose(got, want, **UNIT_RTOL)
    assert (got > 0).any()


def test_receptive_fields_and_filtering_match_jax():
    d = _unit_state(seed=7)
    pw = np.array([0.0, 45.0, 55.0, 65.0])
    with jax.enable_x64(True):
        j, _ = _jt(d, ("lam", "stim", "mu"))
        rf, prior = jm.update_receptive_fields(j[0], j[1], pw)
        want = [np.asarray(a) for a in (rf, prior, *jm.isotonic_filtering(
            j[2], j[0], rf, minimum_spike_count=4,
            minimum_maximal_spike_prob=0.45))]
    t = {k: torch.as_tensor(d[k]) for k in ("lam", "stim", "mu")}
    rf_t, prior_t = tm.update_receptive_fields(t["lam"], t["stim"], pw)
    got = (rf_t, prior_t, *tm.isotonic_filtering(
        t["mu"], t["lam"], rf_t, minimum_spike_count=4,
        minimum_maximal_spike_prob=0.45))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-12, atol=1e-15)
    assert 0 < (got[2].numpy() == 0).sum() < 30


def test_noise_models_match_jax_and_each_other():
    d = _unit_state(seed=8)
    keys = ("y", "mu", "beta", "lam")
    with jax.enable_x64(True):
        j, t = _jt(d, keys)
        want = [np.asarray(a) for a in jm.update_noise_analytic(*j)]
    exact = [a.numpy() for a in tm.update_noise_analytic(*t)]
    for g, w in zip(exact, want):
        np.testing.assert_allclose(g, w, rtol=1e-12)
    gen = torch.Generator().manual_seed(0)
    mc = [a.numpy() for a in tm.update_noise_mc(gen, *t,
                                                num_mc_samples=4000)]
    for g, w in zip(mc, exact):
        assert np.median(np.abs(g - w) / w) < 0.05
        np.testing.assert_allclose(g.mean(), w.mean(), rtol=0.05)


def test_device_tensor_traces_give_the_host_arrays_fit():
    sim = _sim(seed=2)
    args = _args(sim)
    kw = dict(iters=3, analytic_noise=True, dtype=torch.float64,
              device="cpu", save_histories=False)
    a = tm.mbcs(*args, **kw)
    b = tm.mbcs(torch.as_tensor(sim["psc"]), *args[1:], **kw)
    for x, y in zip(a[:7], b[:7]):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-12)


@pytest.mark.parametrize("analytic_noise", [False, True])
def test_model_mbcs_on_cpu_recovers_weights(analytic_noise):
    """The JAX package's recovery case (tests/test_mbcs.py) through the
    port's facade, Monte Carlo and exact noise model alike."""
    from circuitmap_torch.utils.metrics import r2_score

    np.random.seed(7)
    sim = simulate(N=30, trials=400, H=3, connection_prob=0.15,
                   spont_prob=0.0, gp_scale=1e-3, verbose=False)
    model = Model(30).fit(sim["psc"], sim["stim_matrix"], method="mbcs",
                          device="cpu",
                          fit_options={"iters": 10, "seed": 0,
                                       "analytic_noise": analytic_noise})
    assert r2_score(sim["weights"], model.state["mu"]) > 0.5
    assert model.state["receptive_fields"].shape == (30, 4)
    assert model.history["mu"].shape == (10, 30)
