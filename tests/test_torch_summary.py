"""Posterior summaries in the port against the JAX package's: the same
state through ``summarize``/``format_summary`` of both packages gives
equal dicts and equal text (host numpy in both, held exactly), and
``Model.summary`` of a port fit equals the JAX package's ``summarize``
of the same state."""

import numpy as np
import pytest

from circuitmap_tpu import summary as jsum
from circuitmap_torch import Model, format_summary, simulate, summarize


def _state(N=25, K=120, seed=0):
    rng = np.random.default_rng(seed)
    stim = np.zeros((N, K))
    stim[rng.integers(0, N, 3 * K), np.repeat(np.arange(K), 3)] = \
        rng.choice([45.0, 55.0, 65.0], 3 * K)
    mu = np.where(rng.random(N) < 0.3, rng.normal(10, 5, N), 0.0)
    return stim, {
        "mu": mu, "beta": rng.uniform(0.1, 2, N),
        "lam": np.where(stim > 0, rng.random((N, K)), 0.0),
        "shape": 12.0, "rate": 3.0, "z": np.where(rng.random(K) < 0.1,
                                                  rng.random(K), 0.0),
        "alpha": rng.random(N),
    }


def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("method", [None, "caviar", "cavi_sns"])
@pytest.mark.parametrize("with_stim", [False, True])
def test_summarize_and_format_match_jax(method, with_stim):
    stim, state = _state()
    kw = dict(stim=stim if with_stim else None, method=method)
    got = summarize(state, **kw)
    want = jsum.summarize(state, **kw)
    _equal(got, want)
    assert format_summary(got) == jsum.format_summary(want)
    assert format_summary(got, max_rows=2) == jsum.format_summary(
        want, max_rows=2)
    thr = summarize(state, weight_sd_threshold=3.0, **kw)
    _equal(thr, jsum.summarize(state, weight_sd_threshold=3.0, **kw))


def test_point_estimate_and_validation_match_jax():
    stim, state = _state(seed=1)
    point = {"mu": state["mu"], "beta": state["beta"]}
    _equal(summarize(point, stim=stim), jsum.summarize(point, stim=stim))
    for bad in ({"mu": np.zeros((2, 3))}, [1, 2]):
        with pytest.raises((ValueError, TypeError)):
            summarize(bad)
    with pytest.raises(ValueError, match="stim has shape"):
        summarize(state, stim=stim[:, :5])


def test_model_summary_matches_jax(capsys):
    np.random.seed(4)
    sim = simulate(N=20, trials=200, H=3, connection_prob=0.2,
                   verbose=False, device="cpu")
    model = Model(20).fit(sim["psc"], sim["stim_matrix"], device="cpu",
                          fit_options={"iters": 5, "verbose": False})
    got = model.summary(stim=sim["stim_matrix"])
    printed = capsys.readouterr().out
    want = jsum.summarize(model.state, stim=sim["stim_matrix"],
                          method="caviar")
    _equal(got, want)
    assert printed == jsum.format_summary(want)
    assert model.summary(verbose=False).keys() == jsum.summarize(
        model.state).keys()
    assert capsys.readouterr().out == ""
