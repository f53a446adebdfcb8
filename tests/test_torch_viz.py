"""The port's plots against the JAX package's: the same cell orders, and
both plots return a figure on the Agg backend for the same inputs."""

import numpy as np
import pytest

matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from circuitmap_tpu import viz as jviz  # noqa: E402
from circuitmap_torch import viz as tviz  # noqa: E402


def _state(rng, N=12, K=120):
    stim = np.zeros((N, K))
    stim[rng.integers(0, N, 2 * K), np.repeat(np.arange(K), 2)] = \
        rng.choice([45.0, 55.0, 65.0], 2 * K)
    mu = np.where(rng.random(N) < 0.4, rng.uniform(2, 20, N), 0.0)
    lam = np.where(stim > 0, rng.random((N, K)), 0.0)
    psc = rng.normal(0, 0.1, (K, 900)) + lam.T @ np.outer(
        mu, np.exp(-np.arange(900) / 200.0)) / 20.0
    return psc, stim, {"mu": mu, "lam": lam,
                       "z": np.where(rng.random(K) < 0.1, 1.0, 0.0)}


def test_cell_orders_match_jax():
    rng = np.random.default_rng(0)
    sets = [np.where(rng.random(15) < 0.4, rng.random(15), 0.0)
            for _ in range(3)]
    np.testing.assert_array_equal(tviz.cell_order_from_weights(sets),
                                  jviz.cell_order_from_weights(sets))
    np.testing.assert_array_equal(tviz.get_cell_order(sets),
                                  jviz.get_cell_order(weights=sets))


def test_plots_return_figures():
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(1)
    psc, stim, state = _state(rng)
    for viz in (tviz, jviz):
        fig = viz.plot_checkerboard(psc, stim, state, n_plots=5,
                                    max_trials_to_show=6)
        assert isinstance(fig, matplotlib.figure.Figure)
        plt.close(fig)
        other = dict(state, mu=state["mu"][::-1].copy())
        fig = viz.plot_spike_inference_comparison(
            psc, stim, [state, other], n_plots=4, max_trials_to_show=6)
        assert isinstance(fig, matplotlib.figure.Figure)
        plt.close(fig)
