"""The analysis pipelines (and the stacked denoiser) in the port against
the JAX package's.

The host numpy functions are the same code and are held exactly. The
positive ridge regression is float32 projected gradient in both (300
steps of 1/L from the spectral norm), with the products summed in
another order: waveforms at 1e-4 of their largest entry. The stacked
denoiser takes the JAX initialisation carried across: float32
convolutions at rtol 1e-4.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from circuitmap_tpu import pipelines as jp
from circuitmap_tpu.demix import stacked as jst
from circuitmap_torch import pipelines as tp
from circuitmap_torch.demix import stacked as tst


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _connections(rng, N=8, K=60, T=40):
    stim = (rng.random((N, K)) > 0.8) * 45.0
    lam = rng.random((N, K)) * (stim > 0)
    mu = np.zeros(N)
    mu[[1, 4, 6]] = [5.0, 9.0, 2.0]
    psc = np.abs(rng.normal(size=(K, T)))
    return psc, stim, {"mu": mu, "lam": lam}


def test_split_single_ensemble_matches_jax(rng):
    stim = (rng.random((6, 40)) > 0.8) * 45.0
    for got, want in zip(tp.split_single_ensemble(stim),
                         jp.split_single_ensemble(stim)):
        np.testing.assert_array_equal(got, want)


def test_positive_ridge_matches_jax(rng):
    K, n, T = 120, 3, 50
    X = (rng.random((K, n)) > 0.6).astype(np.float32)
    W_true = np.abs(rng.normal(size=(n, T))).astype(np.float32)
    Y = X @ W_true + 0.01 * rng.normal(size=(K, T)).astype(np.float32)
    got = tp._positive_ridge(torch.from_numpy(X), torch.from_numpy(Y),
                             1e-3).numpy()
    want = np.asarray(jp._positive_ridge(jnp.asarray(X), jnp.asarray(Y),
                                         jnp.asarray(1e-3, jnp.float32)))
    assert got.min() >= 0
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    assert np.corrcoef(got.ravel(), W_true.ravel())[0, 1] > 0.98


def test_connection_waveforms_matches_jax(rng):
    psc, stim, state = _connections(rng)
    cnx, wf = tp.connection_waveforms(psc, stim, state, device="cpu")
    jcnx, jwf = jp.connection_waveforms(psc, stim, state)
    np.testing.assert_array_equal(cnx, jcnx)
    np.testing.assert_allclose(wf, jwf, rtol=0,
                               atol=1e-4 * np.abs(jwf).max())
    # a trace tensor is taken as it is
    _, wf_t = tp.connection_waveforms(torch.from_numpy(psc), stim, state,
                                      device="cpu")
    np.testing.assert_array_equal(wf_t, wf)
    none = dict(state, mu=np.zeros_like(state["mu"]))
    cnx0, wf0 = tp.connection_waveforms(psc, stim, none, device="cpu")
    assert cnx0.size == 0 and wf0.shape == (0, psc.shape[1])


def test_duplicate_merging_matches_jax(rng):
    N, K, T = 3, 90, 30
    stim = np.zeros((N, K))
    stim[0, :30] = 45.0
    stim[1, 30:60] = 45.0
    stim[2, 60:] = 45.0
    lam = (stim > 0) * 0.9
    wf = np.zeros((N, T))
    wf[0, 10:20] = 1.0
    wf[1, 10:20] = 1.0
    wf[2, 5:25] = 2.0
    psc = lam.T @ wf + 0.001 * rng.normal(size=(K, T))
    targets = np.array([[50.0, 50.0, 10.0], [52.0, 51.0, 20.0],
                        [200.0, 200.0, 30.0]])
    state = {"mu": np.array([3.0, 3.1, 8.0]), "lam": lam}
    img = rng.random((1, 3, 256, 256))
    for kw in (dict(img=None), dict(img=img)):
        reps, clusters = tp.merge_duplicate_connections(
            psc, stim, state, targets, mse_threshold=0.5, device="cpu", **kw)
        jreps, jclusters = jp.merge_duplicate_connections(
            psc, stim, state, targets, mse_threshold=0.5, **kw)
        assert sorted(map(sorted, clusters)) == sorted(map(sorted, jclusters))
        assert sorted(reps.tolist()) == sorted(jreps.tolist())
    assert sorted(len(c) for c in clusters) == [1, 2]
    np.testing.assert_array_equal(tp._pairwise_sq_dist(targets),
                                  jp._pairwise_sq_dist(targets))
    planes = np.unique(targets[:, -1])
    np.testing.assert_array_equal(
        tp._plane_adjacency(targets[:, -1], planes),
        jp._plane_adjacency(targets[:, -1], planes))


def test_loose_patch_functions_match_jax(rng):
    N, K, T = 4, 30, 900
    stim = np.zeros((N, K))
    stim[0, :3] = 45.0
    stim[1, 3:6] = 55.0
    stim[3, 6:20] = 65.0
    stim[3, 20:] = 45.0
    psp = 0.01 * rng.normal(size=(K, T))
    psp[:20, 150:200] += 1.0
    spikes = tp.detect_lp_spikes(psp)
    np.testing.assert_array_equal(spikes, jp.detect_lp_spikes(psp))
    np.testing.assert_array_equal(
        tp.detect_lp_spikes(psp, 0.5, (0, 100)),
        jp.detect_lp_spikes(psp, 0.5, (0, 100)))
    assert tp.find_patched_cell(stim, psp) == jp.find_patched_cell(
        stim, psp) == 3
    lam = rng.random((N, 20))
    subset = np.arange(5, 25)
    got = tp.power_curve_comparison(stim, lam, spikes, 3,
                                    trial_subset=subset)
    want = jp.power_curve_comparison(stim, lam, spikes, 3,
                                     trial_subset=subset)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_psc_data_matches_jax(rng):
    x = rng.random((20, 30))
    for cls in (tst.PSCData, jst.PSCData):
        ds = cls(x, x * 2)
        assert len(ds) == 20
    got = list(tst.PSCData(x, 2 * x).batches(8, np.random.default_rng(1)))
    want = list(jst.PSCData(x, 2 * x).batches(8, np.random.default_rng(1)))
    assert len(got) == len(want) == 3
    for (a, b), (c, d) in zip(got, want):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    with pytest.raises(ValueError, match="shape"):
        tst.PSCData(x, x[:3])


def test_stacked_forward_matches_jax(rng):
    jparams = jst.init_stacked_params(jax.random.PRNGKey(0))
    params = [{k: torch.from_numpy(np.array(v)) for k, v in layer.items()}
              for layer in jparams]
    x = rng.normal(size=(3, 1, 200)).astype(np.float32)
    got = tst.stacked_forward(params, torch.from_numpy(x)).numpy()
    want = np.asarray(jst.stacked_forward(jparams, jnp.asarray(x)))
    assert got.shape == (3, 1, 200) and got.min() >= 0
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    fresh = tst.init_stacked_params(torch.Generator().manual_seed(0))
    for layer, jlayer in zip(fresh, jparams):
        for k in ("w", "b"):
            assert layer[k].shape == tuple(jlayer[k].shape)
            bound = 1.0 / np.sqrt(layer["w"].shape[1] * layer["w"].shape[2])
            assert layer[k].abs().max() <= bound
    with pytest.raises(ValueError, match="single-channel"):
        tst.init_stacked_params(torch.Generator(), channels=(16, 8, 2))
