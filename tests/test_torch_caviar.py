"""The port's CAVIaR solver and Model facade against the JAX package's.

Single updates run in float32 on both sides from the same numpy inputs
and are compared at float32 tolerances (Cholesky and sums in another
order: rtol 1e-4). The whole fit is compared in float64, with
``update_order="identity"`` and ``analytic_mc=True`` (torch.Generator
cannot reproduce jax.random), in a subprocess because JAX's x64 switch
is process-global: rtol 1e-6.
"""

import importlib
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from circuitmap_torch import Model, default_priors
from circuitmap_torch.ops import sweep_cuda

# the modules, not the caviar() functions the solvers packages export
jcav = importlib.import_module("circuitmap_tpu.solvers.caviar")
tcav = importlib.import_module("circuitmap_torch.solvers.caviar")
tbat = importlib.import_module("circuitmap_torch.solvers.batched")
jax_caviar = jcav.caviar

REPO = Path(__file__).resolve().parent.parent
RTOL32 = dict(rtol=1e-4, atol=1e-5)


def _state(N=24, K=300, seed=0):
    rng = np.random.default_rng(seed)
    stim = np.zeros((N, K), np.float32)
    stim[rng.integers(0, N, 3 * K), np.repeat(np.arange(K), 3)] = rng.choice(
        [45.0, 55.0, 65.0], 3 * K)
    lam = np.where(stim > 0, rng.uniform(0, 1, (N, K)), 0).astype(np.float32)
    mu = np.where(rng.random(N) < 0.4, rng.uniform(5, 20, N), 0).astype(
        np.float32)
    y = (mu @ (rng.random((N, K)) < lam) + rng.normal(0, 1, K)).astype(
        np.float32)
    # spontaneous events on a few unexplained trials
    spont = rng.choice(K, K // 10, replace=False)
    y[spont] += rng.uniform(10, 30, spont.size).astype(np.float32)
    return dict(y=y, stim=stim, lam=lam, mu=mu,
                beta=rng.uniform(0.5, 2, N).astype(np.float32),
                lam_mask=(rng.random(K) > 0.05).astype(np.float32),
                mu_prior=np.zeros(N, np.float32),
                beta_prior=np.full(N, 10.0, np.float32))


def _both(d, *keys):
    return ([torch.from_numpy(d[k]) for k in keys],
            [jnp.asarray(d[k]) for k in keys])


def test_update_weights_matches_jax():
    d = _state()
    (y, lam, mp, bp), (jy, jlam, jmp, jbp) = _both(
        d, "y", "lam", "mu_prior", "beta_prior")
    mu, beta = tcav.update_weights(y, lam, torch.tensor(2.0),
                                   torch.tensor(0.5), mp, bp)
    jmu, jbeta = jcav.update_weights(jy, jlam, 2.0, 0.5, jmp, jbp)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu), **RTOL32)
    np.testing.assert_allclose(beta.numpy(), np.asarray(jbeta), **RTOL32)


def test_update_noise_matches_jax():
    d = _state(seed=1)
    (y, mu, beta, lam), jargs = _both(d, "y", "mu", "beta", "lam")
    shape, rate = tcav.update_noise(y, mu, beta, lam, 1.0, 0.1)
    jshape, jrate = jcav.update_noise(*jargs, 1.0, 0.1)
    assert float(shape) == float(jshape)
    np.testing.assert_allclose(float(rate), float(jrate), rtol=1e-5)


@pytest.mark.parametrize("it", [0, 5, 25])
def test_update_spontaneous_matches_jax(it):
    # it >= max_backtrack_iters (20) runs zero shrink steps: z stays
    d = _state(seed=2)
    rng = np.random.default_rng(it)
    z0 = np.where(rng.random(d["y"].size) < 0.05, 1.0, 0.0).astype(np.float32)
    (y, mu, lam, mask), (jy, jmu, jlam, jmask) = _both(
        d, "y", "mu", "lam", "lam_mask")
    z = tcav.update_spontaneous(y, mu, lam, torch.from_numpy(z0), it, 5.0,
                                mask, 0.75, 0.05, 0.1, 20)
    jz = jcav.update_spontaneous(jy, jmu, jlam, jnp.asarray(z0), it,
                                 jnp.asarray(5.0, jnp.float32), jmask, 0.75,
                                 0.05, 0.1, 20)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), **RTOL32)
    if it >= 20:
        np.testing.assert_array_equal(z.numpy(), z0)
    else:
        assert (z.numpy() != z0).any()


def test_powercurve_logit_means_analytic_matches_jax():
    rng = np.random.default_rng(3)
    phi = np.column_stack([rng.uniform(0.05, 0.3, 30),
                           rng.uniform(-2, 12, 30)]).astype(np.float32)
    cov = np.tile(np.float32([[1e-1, 0.0], [0.0, 1.0]]), (30, 1, 1))
    m0, m1 = tcav.powercurve_logit_means(None, torch.from_numpy(phi),
                                         torch.from_numpy(cov), 100, True)
    j0, j1 = jcav.powercurve_logit_means(None, jnp.asarray(phi),
                                         jnp.asarray(cov), 100, True)
    np.testing.assert_allclose(m0.numpy(), np.asarray(j0), rtol=1e-5)
    np.testing.assert_allclose(m1.numpy(), np.asarray(j1), rtol=1e-5)


def _reconnect_case():
    d = _state(N=20, K=400, seed=4)
    stim, lam = d["stim"], d["lam"]
    mu = d["mu"].copy()
    rng = np.random.default_rng(5)
    z = np.zeros(stim.shape[1], np.float32)
    for n in (3, 11):  # disconnected cells whose trials carry events
        mu[n] = 0.0
        hit = np.flatnonzero(stim[n] > 0)
        z[hit] = rng.uniform(5, 15, hit.size)
    pp = np.tile(np.float32([0.1, 5.0]), (20, 1))
    pc = np.tile(np.float32([[1e-1, 0.0], [0.0, 1.0]]), (20, 1, 1))
    return stim, lam, mu, d["beta"], z, pp, pc


def test_reconnect_and_refit_matches_jax():
    stim, lam, mu, beta, z, pp, pc = _reconnect_case()
    powers = np.float32([45.0, 55.0, 65.0])
    phi0 = pp * 1.5
    args = (stim, lam, mu, beta, z, powers, phi0, pc, pp, pc)
    got = tcav._reconnect_and_refit(*map(torch.from_numpy, args), 0.3, 3.0)
    want = jcav._reconnect_and_refit_device(*map(jnp.asarray, args), 0.3, 3.0)
    assert got[-1] == int(want[-1]) >= 2
    for name, g, w in zip(("mu", "beta", "lam", "z", "phi", "phi_cov"),
                          got[:-1], want[:-1]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-3,
                                   atol=1e-5, err_msg=name)


_FIT_SCRIPT = r"""
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch

from circuitmap_tpu.simulation import simulate
from circuitmap_tpu.model import default_priors
from circuitmap_tpu.solvers.caviar import caviar as jax_caviar
from circuitmap_torch.solvers.caviar import caviar as torch_caviar

block = int(sys.argv[1])
np.random.seed(0)
sim = simulate(N=40, trials=400, H=4, connection_prob=0.1, verbose=False)
p = default_priors(40)
args = (sim["psc"], sim["stim_matrix"], p["mu"], p["beta"], p["shape"],
        p["rate"], p["phi"], p["phi_cov"])
kw = dict(iters=12, update_order="identity", analytic_mc=True,
          verbose=False, sweep_block_size=block, save_histories=True)
a = jax_caviar(*args, dtype=jnp.float64, **kw)
b = torch_caviar(*args, dtype=torch.float64, device="cpu", **kw)
out = {}
names = ["mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z"]
for i, name in enumerate(names):
    x, y = np.asarray(a[i], np.float64), b[i].numpy()
    same_nan = bool(np.array_equal(np.isnan(x), np.isnan(y)))
    ok = np.isfinite(x)
    err = float(np.max(np.abs(x[ok] - y[ok]) / (np.abs(x[ok]) + 1e-9)))
    out[name] = [err, same_nan, str(y.dtype)]
for i, name in enumerate(names):
    x, y = np.asarray(a[9 + i], np.float64), b[9 + i]
    out["history_" + name] = [float(np.nanmax(np.abs(x - y) / (np.abs(x) + 1e-9))),
                              list(x.shape) == list(y.shape), str(y.dtype)]
out["n_outputs"] = [len(a), len(b)]
out["n_connected"] = int((np.asarray(b[0]) != 0).sum())
print(json.dumps(out))
"""


@pytest.mark.parametrize("block", [1, 8])
def test_whole_fit_matches_jax_in_float64(block):
    proc = subprocess.run([sys.executable, "-c", _FIT_SCRIPT, str(block)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("n_outputs") == [17, 17]
    assert out.pop("n_connected") > 0
    for name, (err, same, dtype) in out.items():
        assert same, name
        assert dtype == "float64", name
        assert err < 1e-6, (name, err)


# ---------------------------------------------------------------------------
# The Model facade
# ---------------------------------------------------------------------------


def _tiny():
    rng = np.random.default_rng(6)
    N, K = 12, 160
    stim = np.zeros((N, K))
    stim[rng.integers(0, N, 2 * K), np.repeat(np.arange(K), 2)] = rng.choice(
        [45.0, 55.0, 65.0], 2 * K)
    psc = rng.normal(0, 0.01, (K, 120))
    psc[:, 30:60] += (stim[:4] > 0).sum(0)[:, None] * 0.5
    return N, psc, stim


def test_model_fit_on_cpu_fills_state_and_history():
    N, psc, stim = _tiny()
    iters = 4
    model = Model(N).fit(psc, stim, method="caviar", device="cpu",
                         fit_options={"iters": iters, "verbose": False,
                                      "save_histories": True, "seed": 1})
    for key in ("mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z"):
        assert isinstance(model.state[key], np.ndarray), key
    assert model.state["lam"].shape == (N, stim.shape[1])
    assert model.trial_count == stim.shape[1]
    assert model.history["mu"].shape == (iters, N)
    assert model.history["lam"].shape == (iters, N, stim.shape[1])
    assert model.history["shape"].shape == (iters, stim.shape[1])
    assert model.time is not None and model.state["receptive_fields"] is None


def test_fit_options_accept_every_jax_caviar_keyword():
    jax_params = set(inspect.signature(jax_caviar).parameters)
    port_params = set(inspect.signature(tcav.caviar).parameters)
    assert jax_params <= port_params
    assert port_params - jax_params == {"device"}


@pytest.mark.parametrize("module,name,extra", [
    ("cavi_sns", "cavi_sns", {"device"}),
    ("mbcs", "mbcs", {"device"}),
    ("experimental", "mbcs_ard", {"device"}),
    ("cosamp", "cosamp", set()),
    ("diagnostics", "elbo_components", set()),
    ("diagnostics", "elbo_trajectory", set()),
])
def test_solver_signatures_are_the_jax_packages(module, name, extra):
    """The same keywords in the same order, plus ``device`` where the
    solver runs on the GPU."""
    want = list(inspect.signature(getattr(importlib.import_module(
        f"circuitmap_tpu.solvers.{module}"), name)).parameters)
    got = list(inspect.signature(getattr(importlib.import_module(
        f"circuitmap_torch.solvers.{module}"), name)).parameters)
    assert [p for p in got if p not in extra] == want
    assert set(got) - set(want) == extra


METHODS = ["caviar", "cavi_sns", "mbcs", "cosamp"]


@pytest.mark.parametrize("method", METHODS)
def test_model_fit_runs_every_method_as_the_jax_facade(method):
    """State keys, types, shapes and the history layout of each method
    are the JAX facade's on the same inputs."""
    from circuitmap_tpu.model import Model as JaxModel

    N, psc, stim = _tiny()
    opts = {} if method == "cosamp" else {"iters": 3, "verbose": False,
                                          "save_histories": True}
    port = Model(N).fit(psc, stim, method=method, device="cpu",
                        fit_options=dict(opts))
    ref = JaxModel(N).fit(psc, stim, method=method, fit_options=dict(opts))
    assert port.fit_method == method and port.time is not None
    assert port.state.keys() == ref.state.keys()
    for key, want in ref.state.items():
        got = port.state[key]
        assert np.shape(got) == np.shape(want), key
        if isinstance(want, np.ndarray):
            assert isinstance(got, np.ndarray), key
            assert np.isfinite(got).all() or key == "beta", key
    assert port.history.keys() == ref.history.keys()
    for key, want in ref.history.items():
        assert np.shape(port.history[key]) == np.shape(want), key
    assert port.trial_count == ref.trial_count == stim.shape[1]


@pytest.mark.parametrize("method", METHODS)
def test_mesh_waits_for_a9_for_every_method(method):
    """Since A9 every method but CoSaMP fits over a trial mesh (its
    sharded solver, the single fit's state layout); CoSaMP raises the
    JAX facade's error."""
    from circuitmap_torch.parallel import trial_mesh

    N, psc, stim = _tiny()
    mesh = trial_mesh(devices=["cpu"] * 2)
    if method == "cosamp":
        with pytest.raises(ValueError, match="no mesh path"):
            Model(N).fit(psc, stim, method=method, device="cpu",
                         fit_options={"mesh": mesh})
        return
    opts = {"iters": 2, "verbose": False}
    sharded = Model(N).fit(psc, stim, method=method,
                           fit_options={**opts, "mesh": mesh})
    single = Model(N).fit(psc, stim, method=method, device="cpu",
                          fit_options=opts)
    assert sharded.state.keys() == single.state.keys()
    assert sharded.history.keys() == single.history.keys()
    for key, want in single.state.items():
        assert np.shape(sharded.state[key]) == np.shape(want), key
    assert sharded.trial_count == stim.shape[1]


def test_unknown_method_raises():
    N, psc, stim = _tiny()
    with pytest.raises(ValueError, match="unknown method"):
        Model(N).fit(psc, stim, method="nope", device="cpu")


@pytest.mark.parametrize("opts,exc,match", [
    ({"mesh": object()}, TypeError, "TrialMesh"),
    ({"sweep_impl": "pallas_interpret"}, ValueError, "auto.*cuda"),
    ({"laplace_impl": "pallas_interpret"}, ValueError, "auto.*cuda"),
    ({"sweep_impl": "pallas"}, ValueError, "auto.*cuda"),
    ({"sweep_impl": "pallas_blocked"}, ValueError, "auto.*cuda"),
    ({"sweep_impl": "xla"}, ValueError, "auto.*cuda"),
    ({"laplace_impl": "pallas"}, ValueError, "auto.*cuda"),
    ({"laplace_impl": "xla"}, ValueError, "auto.*cuda"),
    ({"update_order": "reverse"}, ValueError, "update_order"),
])
def test_fit_option_contracts(opts, exc, match):
    N, psc, stim = _tiny()
    with pytest.raises(exc, match=match):
        Model(N).fit(psc, stim, method="caviar", device="cpu",
                     fit_options={"verbose": False, **opts})


def test_sweep_block_size_resolution():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert tcav._resolve_sweep("auto", "auto", cpu) == 1
    assert tcav._resolve_sweep("auto", "auto", gpu) == 8
    assert tcav._resolve_sweep("cuda", 8, cpu) == 8
    # every pinned size is honoured on CUDA, as in the JAX package: 1 is
    # the strictly sequential schedule, 2..32 rows a kernel step, and a
    # longer block runs as sub-steps of at most one warp's rows
    for block in (*range(1, 34), 48, 64, 125, 1000):
        assert tcav._resolve_sweep("auto", block, gpu) == block
        assert tcav._resolve_sweep("auto", block, cpu) == block
    assert [sweep_cuda.sub_steps(b) for b in (1, 8, 32, 33, 48, 64, 125)] \
        == [(1, 1), (1, 8), (1, 32), (2, 17), (2, 24), (2, 32), (4, 32)]
    with pytest.raises(ValueError, match=">= 1"):
        tcav._resolve_sweep("auto", 0, cpu)
    with pytest.raises(ValueError, match=">= 1"):
        tcav._resolve_sweep("auto", 0, gpu)


def _blockwise_counts(N, K, H, P, seed=0):
    """[N, P] trials per neuron per power of a blockwise design (passes
    over a random partition of the N neurons into H-spot holograms,
    each swept over the P powers, cut at K trials): H * K / N
    stimulations per neuron on average."""
    rng = np.random.default_rng(seed)
    n_holo = N // H
    passes = -(-K // (P * n_holo))
    targets = np.concatenate(
        [np.tile(rng.permutation(N).reshape(n_holo, H), (P, 1))
         for _ in range(passes)])[:K]
    level = np.tile(np.repeat(np.arange(P), n_holo), passes)[:K]
    counts = np.zeros((N, P))
    np.add.at(counts, (targets, level[:, None]), 1.0)
    return counts


@pytest.mark.parametrize("K,warns", [(40000, False), (19000, True)])
def test_data_thin_preflight_at_two_thousand_neurons(K, warns):
    """N=2000 is where the preflight arms. The benchmark's 2,000-neuron
    map (K=40,000, H=10: 200 stimulations per neuron, as the N=1000 map
    has) stays silent; at 95 a neuron, under the ~100 floor, it warns."""
    import warnings

    from circuitmap_torch.solvers import _common

    counts = _blockwise_counts(2000, K, 10, 3)
    assert counts.sum(1).mean() == 10 * K / 2000
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _common.warn_data_thin_design(counts, K, what="caviar()")
    thin = [w for w in caught
            if issubclass(w.category, _common.DataThinDesignWarning)]
    assert len(thin) == int(warns)
    if warns:
        assert "~95 times" in str(thin[0].message)


def test_cuda_fit_with_more_levels_than_the_kernels_raises_at_resolution():
    """The CUDA kernels take any number of power levels (1..16 fixed at
    compile time, more at run time), so resolving the levels of a stim
    for any fit raises only where the JAX package's ``_levels`` does:
    above 1024 distinct levels derived from the stim; ``powers=`` may
    name any number."""
    from circuitmap_torch.solvers import _common
    from circuitmap_tpu.solvers._common import _levels as jax_levels

    rng = np.random.default_rng(0)
    for n in (17, 24, 1024):
        levels = 30.0 + 0.05 * np.arange(n)
        stim = np.zeros((20, 3000))
        stim[rng.integers(0, 20, 3000), np.arange(3000)] = levels[
            np.arange(3000) % n]
        plan = _common.stim_upload_plan(stim, None)[1]
        assert plan[0].size == n
        np.testing.assert_array_equal(plan[0], jax_levels(stim)[0])
        assert _common._levels(stim, levels)[0].size == n
        assert tbat._validate_shared_levels(stim[None], None).size == n
    many = np.zeros((20, 1100))
    many[0] = 1.0 + np.arange(1100)
    with pytest.raises(ValueError, match="1100 distinct"):
        _common._levels(many)
    assert _common._levels(many, 1.0 + np.arange(1100))[0].size == 1100


def test_default_priors_match_jax():
    from circuitmap_tpu.model import default_priors as jax_default_priors

    a, b = default_priors(7), jax_default_priors(7)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
