"""The port's ELBO diagnostics and ``caviar(track_elbo=, elbo_tol=)``
against the JAX package's, on the same numpy inputs.

float64 on both sides (the JAX functions under ``jax.enable_x64``). The
bound's terms on one state: rtol 1e-9. Tracked fits use
``update_order="identity"`` and ``analytic_mc=True``: the bounds at
rtol 1e-6 and the same stopping iteration.
"""

import importlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from circuitmap_torch import Model
from circuitmap_tpu.model import default_priors
from circuitmap_tpu.simulation import simulate

jd = importlib.import_module("circuitmap_tpu.solvers.diagnostics")
td = importlib.import_module("circuitmap_torch.solvers.diagnostics")
jcav = importlib.import_module("circuitmap_tpu.solvers.caviar")
tcav = importlib.import_module("circuitmap_torch.solvers.caviar")

TERMS = ("elbo", "expected_loglik", "kl_weights", "kl_noise", "spike_prior",
         "spike_entropy")


def _sim(seed=0):
    np.random.seed(seed)
    return simulate(N=40, trials=400, H=4, connection_prob=0.1,
                    verbose=False)


def _args(sim):
    p = default_priors(40)
    return (sim["psc"], sim["stim_matrix"], p["mu"], p["beta"], p["shape"],
            p["rate"], p["phi"], p["phi_cov"])


def _state(seed=1, N=30, K=300):
    rng = np.random.default_rng(seed)
    stim = np.zeros((N, K))
    stim[rng.integers(0, N, 3 * K), np.repeat(np.arange(K), 3)] = rng.choice(
        [45.0, 55.0, 65.0], 3 * K)
    lam = np.where(stim > 0, rng.uniform(0, 1, (N, K)), 0.0)
    lam[0, stim[0] > 0] = 1.0  # exact 0/1 spikes take the entropy clamp
    state = dict(mu=rng.uniform(0, 20, N), beta=rng.uniform(0.01, 2, N),
                 lam=lam, shape=201.0, rate=37.5,
                 phi=np.column_stack([rng.uniform(0.05, 0.3, N),
                                      rng.uniform(2, 12, N)]),
                 z=np.where(rng.random(K) < 0.05, rng.uniform(1, 9, K), 0.0))
    y = state["mu"] @ (rng.random((N, K)) < lam) + rng.normal(0, 1, K)
    priors = dict(mu=np.zeros(N), beta=np.full(N, 10.0), shape=1.0,
                  rate=0.1)
    return y, stim, state, priors


@pytest.mark.parametrize("with_z", [True, False])
def test_elbo_components_match_jax(with_z):
    y, stim, state, priors = _state()
    if not with_z:
        del state["z"]
    with jax.enable_x64(True):
        want = jd.elbo_components(y, stim, state, priors)
    got = td.elbo_components(y, stim, state, priors)
    assert set(got) == set(want) == set(TERMS)
    for term in TERMS:
        np.testing.assert_allclose(got[term], want[term], rtol=1e-9,
                                   err_msg=term)


def test_elbo_device_matches_jax():
    y, stim, state, priors = _state(seed=2)
    hyper = tuple(np.asarray(priors[k], np.float64)
                  for k in ("mu", "beta", "shape", "rate")) + (None, None)
    with jax.enable_x64(True):
        js = jcav.CaviarState(**{k: jnp.asarray(v) for k, v in state.items()},
                              phi_cov=None, spont_rate=None, key=None)
        want = float(jd.elbo_device(jnp.asarray(y), jnp.asarray(stim), js,
                                    tuple(map(jnp.asarray, hyper[:4]))
                                    + hyper[4:], 300))
    ts = {k: torch.as_tensor(np.asarray(v, np.float64))
          for k, v in state.items()}
    got = td.elbo_device(torch.as_tensor(y), torch.as_tensor(stim), ts,
                         tuple(torch.as_tensor(h) for h in hyper[:4]), 300)
    assert got.dtype == torch.float64 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-9)


def test_elbo_trajectory_matches_jax():
    sim = _sim(seed=3)
    kw = dict(iters=4, update_order="identity", analytic_mc=True,
              verbose=False, save_histories=True)
    res = tcav.caviar(*_args(sim), dtype=torch.float64, device="cpu", **kw)
    names = ("mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z")
    history = dict(zip(names, res[9:]))
    y = np.trapezoid(sim["psc"], axis=-1)
    priors = default_priors(40)
    got = td.elbo_trajectory(y, sim["stim_matrix"], history, priors)
    with jax.enable_x64(True):
        want = jd.elbo_trajectory(y, sim["stim_matrix"], history, priors)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for term in TERMS:
            np.testing.assert_allclose(g[term], w[term], rtol=1e-9)


@pytest.fixture(scope="module")
def tracked():
    sim = _sim()
    out = {}
    for tol in (None, 1e-3, 1e-2):
        kw = dict(iters=15, update_order="identity", analytic_mc=True,
                  verbose=False, save_histories=True, track_elbo=True,
                  elbo_tol=tol)
        with jax.enable_x64(True):
            want = jcav.caviar(*_args(sim), dtype=jnp.float64, **kw)
            want = [np.asarray(a) for a in want[:-1]] + [want[-1]]
        got = tcav.caviar(*_args(sim), dtype=torch.float64, device="cpu",
                          **kw)
        out[tol] = (want, got)
    return out


@pytest.mark.parametrize("tol", [None, 1e-3, 1e-2])
def test_tracked_fit_matches_jax_in_float64(tracked, tol):
    want, got = tracked[tol]
    assert len(got) == len(want) == 18
    (elbos_w, stop_w), (elbos_g, stop_g) = want[-1], got[-1]
    assert stop_g == int(stop_w)
    assert elbos_g.shape == (15,) and np.isfinite(elbos_g).all()
    np.testing.assert_allclose(elbos_g, np.asarray(elbos_w), rtol=1e-6)
    for i in (0, 1, 2, 5, 6, 7, *range(9, 17)):  # posteriors and histories
        g = got[i].numpy() if torch.is_tensor(got[i]) else got[i]
        np.testing.assert_allclose(g, want[i], rtol=1e-6, atol=1e-10)
    if tol == 1e-2:  # converges early: the rest of the run is frozen
        assert stop_g < 14
        assert (elbos_g[stop_g:] == elbos_g[stop_g]).all()
        lam_hist = got[11]
        assert (lam_hist[stop_g:] == lam_hist[stop_g]).all()
    if tol is None:
        assert stop_g == 15


def test_tracking_changes_no_state():
    sim = _sim(seed=4)
    kw = dict(iters=6, verbose=False, device="cpu", seed=3)
    plain = tcav.caviar(*_args(sim), **kw)
    tracked = tcav.caviar(*_args(sim), track_elbo=True, **kw)
    assert len(plain) == 17 and len(tracked) == 18
    for a, b in zip(plain[:8], tracked[:8]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_model_records_the_bound():
    sim = _sim(seed=5)
    model = Model(40).fit(sim["psc"], sim["stim_matrix"], device="cpu",
                          fit_options={"iters": 8, "verbose": False,
                                       "track_elbo": True, "elbo_tol": 1e-2,
                                       "save_histories": True})
    assert model.elbo.shape == (8,) and np.isfinite(model.elbo).all()
    assert model.history["elbo"] is model.elbo
    assert 0 < model.elbo_converged_at <= 8
    assert model.history["mu"].shape == (8, 40)
