"""The port's batched baselines (``sns_many``, ``mbcs_many``) against the
JAX package's and against the port's own single fits.

float64 on both sides, exact power-curve means (SnS) and exact noise
moments (MBCS). The JAX fits draw their row orders from ``jax.random``,
which a ``torch.Generator`` cannot reproduce, so the port's fits are
handed the orders each JAX experiment draws from its key (by the seed
of the experiment's generator): rtol 1e-6 on every output. Within the
port the batched loop equals the sequential one experiment by
experiment to float rounding (rtol 1e-6), at random row orders (each
experiment's own generator, in the single fit's sequence) and at the
identity order; a ragged list is each experiment's single fit, exactly.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from circuitmap_tpu.model import default_priors
from circuitmap_tpu.simulation import simulate
from circuitmap_tpu.solvers.batched import mbcs_many as jax_mbcs_many
from circuitmap_tpu.solvers.batched import sns_many as jax_sns_many
from circuitmap_torch.solvers.batched import mbcs_many, sns_many
from circuitmap_torch.solvers.cavi_sns import cavi_sns
from circuitmap_torch.solvers.mbcs import mbcs

N, B = 24, 3
P = default_priors(N)
SNS_PRIORS = (P["mu"], P["beta"], P["alpha"], P["shape"], P["rate"],
              P["phi"], P["phi_cov"])
MBCS_PRIORS = (P["mu"], P["beta"], P["shape"], P["rate"])
PORT = dict(dtype=torch.float64, device="cpu", verbose=False)
RTOL = dict(rtol=1e-6, atol=1e-10)


@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    """One torch and one BLAS thread while this file runs: the suite
    runs in parallel workers, and a pool of threads per worker
    oversubscribes the cores."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _sims(trials):
    out = []
    for seed, k in zip((41, 42, 43), trials):
        np.random.seed(seed)
        out.append(simulate(N=N, trials=k, H=3, connection_prob=0.2,
                            spont_prob=0.01, gp_scale=1e-3, verbose=False))
    return out


@pytest.fixture(scope="module")
def stack():
    sims = _sims((240, 240, 240))
    return (np.stack([s["psc"] for s in sims]),
            np.stack([s["stim_matrix"] for s in sims]))


@pytest.fixture(scope="module")
def ragged():
    sims = _sims((200, 280, 240))
    return [s["psc"] for s in sims], [s["stim_matrix"] for s in sims]


def _assert_fits(got, want, **tol):
    assert len(got) == len(want)
    for b, (g, w) in enumerate(zip(got, want)):
        assert set(g) == set(w)
        for k in w:
            np.testing.assert_allclose(np.asarray(g[k]), np.asarray(w[k]),
                                       err_msg=f"experiment {b}: {k}", **tol)


def _jax_orders(seeds, iters, per_iteration, n_split):
    """{seed: the row orders its JAX fit draws, in draw order}: each
    iteration splits the key in ``n_split`` and permutes the rows with
    the parts after the first, ``per_iteration`` of them."""
    orders = {}
    for s in seeds:
        key, q = jax.random.PRNGKey(int(s)), []
        for _ in range(iters):
            key, *parts = jax.random.split(key, n_split)
            q += [np.array(jax.random.permutation(k, N))
                  for k in parts[:per_iteration]]
        orders[int(s)] = q
    return orders


def _hand_over(monkeypatch, orders):
    """torch.randperm returns each generator's next JAX order (the
    generator is known by its seed)."""
    queues = {s: [torch.as_tensor(o) for o in q] for s, q in orders.items()}
    monkeypatch.setattr(
        torch, "randperm", lambda n, generator=None, device=None:
        queues[generator.initial_seed()].pop(0))
    return queues


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_sns_many_matches_jax(stack, mode, monkeypatch):
    iters, seeds = 5, (3, 5, 8)
    with jax.enable_x64(True):
        want = jax_sns_many(*stack, *SNS_PRIORS, iters=iters, seeds=seeds,
                            analytic_mc=True, dtype=jnp.float64,
                            verbose=False)
        orders = _jax_orders(seeds, iters, 3, 5)
    queues = _hand_over(monkeypatch, orders)
    got = sns_many(*stack, *SNS_PRIORS, iters=iters, seeds=seeds,
                   analytic_mc=True, compile_mode=mode, **PORT)
    assert not any(queues.values())
    _assert_fits(got, want, **RTOL)


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_mbcs_many_matches_jax(stack, mode, monkeypatch):
    iters, seeds = 5, (2, 4, 6)
    with jax.enable_x64(True):
        want = jax_mbcs_many(*stack, *MBCS_PRIORS, iters=iters, seeds=seeds,
                             analytic_noise=True, dtype=jnp.float64,
                             verbose=False)
        orders = _jax_orders(seeds, iters, 1, 3)
    queues = _hand_over(monkeypatch, orders)
    got = mbcs_many(*stack, *MBCS_PRIORS, iters=iters, seeds=seeds,
                    analytic_noise=True, compile_mode=mode, **PORT)
    assert not any(queues.values())
    _assert_fits(got, want, **RTOL)
    assert all(0 < (w["mu"] != 0).sum() < N for w in want)


@pytest.mark.parametrize("update_order", ["identity", "random"])
def test_sns_many_batched_equals_sequential(stack, update_order):
    kw = dict(iters=6, analytic_mc=update_order == "identity",
              update_order=update_order, **PORT)
    seq = sns_many(*stack, *SNS_PRIORS, compile_mode="sequential", **kw)
    bat = sns_many(*stack, *SNS_PRIORS, compile_mode="batched", **kw)
    _assert_fits(bat, seq, **RTOL)
    auto = sns_many(*stack, *SNS_PRIORS, **kw)
    _assert_fits(auto, seq, rtol=0, atol=0)


@pytest.mark.parametrize("analytic_noise", [True, False])
def test_mbcs_many_batched_equals_sequential(stack, analytic_noise):
    kw = dict(iters=6, analytic_noise=analytic_noise, **PORT)
    seq = mbcs_many(*stack, *MBCS_PRIORS, compile_mode="sequential", **kw)
    bat = mbcs_many(*stack, *MBCS_PRIORS, compile_mode="batched", **kw)
    _assert_fits(bat, seq, **RTOL)
    # the experiments stop their penalty loops and keep their cells apart
    assert len({int((r["mu"] != 0).sum()) for r in seq}) > 1


def test_ragged_lists_are_the_single_fits(ragged):
    ys, stims = ragged
    got = sns_many(ys, stims, *SNS_PRIORS, iters=4, seeds=(1, 2, 3), **PORT)
    for b, (y, s) in enumerate(zip(ys, stims)):
        one = cavi_sns(y, s, *SNS_PRIORS, iters=4, seed=b + 1,
                       save_histories=False, **PORT)
        assert got[b]["lam"].shape == (N, y.shape[0])
        for k, v in zip(("mu", "beta", "alpha", "lam", "shape", "rate",
                         "phi", "phi_cov"), one[:8]):
            np.testing.assert_array_equal(got[b][k], v.numpy(), err_msg=k)
    got = mbcs_many(ys, stims, *MBCS_PRIORS, iters=4, **PORT)
    for b, (y, s) in enumerate(zip(ys, stims)):
        one = mbcs(y, s, *MBCS_PRIORS, iters=4, seed=b, save_histories=False,
                   **PORT)
        for k, v in zip(("mu", "beta", "lam", "shape", "rate", "z",
                         "receptive_fields"), one[:7]):
            np.testing.assert_array_equal(got[b][k], v.numpy(), err_msg=k)


def test_ragged_guards(ragged):
    ys, stims = ragged
    for fn, priors in ((sns_many, SNS_PRIORS), (mbcs_many, MBCS_PRIORS)):
        with pytest.raises(ValueError, match="compile_mode='batched'"):
            fn(ys, stims, *priors, compile_mode="batched", **PORT)
        with pytest.raises(ValueError, match="mesh="):
            fn(ys, stims, *priors, mesh=object(), **PORT)
        with pytest.raises(ValueError, match="powers="):
            fn(ys, stims, *priors, powers=[45.0, 55.0, 65.0], **PORT)
        with pytest.raises(ValueError, match="matching list"):
            fn(ys, stims[0], *priors, **PORT)
    with pytest.raises(ValueError, match="trace_wire"):
        mbcs_many(ys, stims, *MBCS_PRIORS, trace_wire="int8", **PORT)


def test_same_shape_stack_mesh_and_mode_rejected(stack):
    from circuitmap_torch.parallel import trial_mesh

    with pytest.raises(TypeError, match="TrialMesh"):
        sns_many(*stack, *SNS_PRIORS, mesh=object(), **PORT)
    with pytest.raises(ValueError, match="sequential.*no mesh path"):
        mbcs_many(*stack, *MBCS_PRIORS, compile_mode="sequential",
                  mesh=trial_mesh(devices=["cpu"] * 2), **PORT)
    with pytest.raises(ValueError, match="compile_mode"):
        mbcs_many(*stack, *MBCS_PRIORS, compile_mode="vmap", **PORT)
