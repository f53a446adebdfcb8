"""The port's batched CAVIaR (``caviar_many``) against its own single
fits and against the JAX package.

Float32 comparisons with the port's ``caviar(seed=b)``: the sequential
mode runs the single fit's loop and equals it exactly; the batched mode
sums in other orders (batched Cholesky and products), rtol 1e-5 /
atol 1e-5 after 10 iterations with ``analytic_mc=True`` and a pinned
block size. A ragged stack pads with inert columns, whose sums round
differently: the same tolerance. The deterministic parity with the JAX
package runs the batched loop in float64 with ``update_order=
"identity"`` and ``analytic_mc=True`` against JAX ``caviar`` per
experiment, in a subprocess because JAX's x64 switch is process-global:
rtol 1e-6.
"""

import importlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from circuitmap_tpu.model import default_priors
from circuitmap_tpu.simulation import simulate
from circuitmap_torch import caviar_many
from circuitmap_torch.utils.metrics import r2_score

tcav = importlib.import_module("circuitmap_torch.solvers.caviar")
tbat = importlib.import_module("circuitmap_torch.solvers.batched")

REPO = Path(__file__).resolve().parent.parent
N = 24
P = default_priors(N)
PRIORS = (P["mu"], P["beta"], P["shape"], P["rate"], P["phi"], P["phi_cov"])
TOL = dict(rtol=1e-5, atol=1e-5)
CPU = dict(device="cpu", verbose=False)


def _sims(trials):
    out = []
    for seed, k in zip((31, 32, 33), trials):
        np.random.seed(seed)
        out.append(simulate(N=N, trials=k, H=3, connection_prob=0.2,
                            spont_prob=0.01, gp_scale=1e-3, verbose=False))
    return out


@pytest.fixture(scope="module")
def sims():
    return _sims((240, 240, 240))


@pytest.fixture(scope="module")
def ragged():
    return _sims((192, 320, 256))


def _stack(sims):
    return (np.stack([s["psc"] for s in sims]),
            np.stack([s["stim_matrix"] for s in sims]))


def _lists(sims):
    return [s["psc"] for s in sims], [s["stim_matrix"] for s in sims]


def _single(s, b, **kw):
    out = tcav.caviar(s["psc"], s["stim_matrix"], *PRIORS, seed=b, **CPU,
                      **kw)
    return dict(zip(tbat.FIELDS, (v.numpy() for v in out[:8])))


def _assert_close(got, want, tol=TOL, fields=tbat.FIELDS):
    for name in fields:
        np.testing.assert_allclose(got[name], want[name], **tol,
                                   err_msg=name)


@pytest.mark.parametrize("block", [1, 8])
@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_matches_single_fits(sims, mode, block):
    kw = dict(iters=10, fn_scan=False, analytic_mc=True,
              sweep_block_size=block)
    batch = caviar_many(*_stack(sims), *PRIORS, seeds=[0, 1, 2],
                        compile_mode=mode, **CPU, **kw)
    assert len(batch) == 3
    for b, s in enumerate(sims):
        want = _single(s, b, **kw)
        if mode == "sequential":  # the single fit's own loop
            _assert_close(batch[b], want, dict(rtol=0, atol=0))
        else:
            _assert_close(batch[b], want)
        assert batch[b]["lam"].shape == (N, 240)
        assert np.shape(batch[b]["shape"]) == ()


def test_modes_agree_under_auto_with_monte_carlo(sims):
    # the default Monte Carlo means: each experiment's generator draws the
    # same sequence in both modes
    kw = dict(iters=8, fn_scan=False, seeds=[3, 4, 5], **CPU)
    seq = caviar_many(*_stack(sims), *PRIORS, compile_mode="sequential",
                      **kw)
    bat = caviar_many(*_stack(sims), *PRIORS, compile_mode="batched", **kw)
    for b in range(3):
        _assert_close(bat[b], seq[b], fields=("mu", "lam", "phi"))


def test_recovery_per_map_with_reconnection(sims):
    batch = caviar_many(*_stack(sims), *PRIORS, iters=12,
                        compile_mode="batched", **CPU)
    for b, s in enumerate(sims):
        assert r2_score(s["weights"], batch[b]["mu"]) > 0.7


def test_reconnected_maps_refit_in_one_call(sims, monkeypatch):
    """Reconnections in experiments 0 and 2 refit both power curves in
    one batched call, equal to each experiment's own refit."""
    real_scan = tbat._reconnect_scan_device

    def fake_scan(stim, lam, *args):
        b = fake_scan.calls
        fake_scan.calls += 1
        mu, beta, lam, z, _ = real_scan(stim, lam, *args)
        if b in (0, 2):
            row = int(torch.nonzero((stim > 0).sum(1) > 3)[0])
            lam[row, stim[row] > 0] = 0.9
            return mu, beta, lam, z, 1
        return mu, beta, lam, z, 0

    fake_scan.calls = 0
    calls = []
    real_refit = tbat.laplace_phi_update

    def counting_refit(*args, **kw):
        calls.append(tuple(args[0].shape))
        return real_refit(*args, **kw)

    monkeypatch.setattr(tbat, "_reconnect_scan_device", fake_scan)
    monkeypatch.setattr(tbat, "laplace_phi_update", counting_refit)
    batch = caviar_many(*_stack(sims), *PRIORS, iters=6, analytic_mc=True,
                        seeds=[0, 1, 2], **CPU)
    assert calls == [(2, N, 240)]
    for b in (0, 2):
        stim = torch.as_tensor(sims[b]["stim_matrix"], dtype=torch.float32)
        phi, cov = real_refit(torch.from_numpy(batch[b]["lam"]), stim,
                              *(torch.as_tensor(P[k], dtype=torch.float32)
                                for k in ("phi", "phi_cov")))
        np.testing.assert_allclose(batch[b]["phi"], phi.numpy(), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(batch[b]["phi_cov"], cov.numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_ragged_list_matches_each_fit_alone(ragged, mode):
    kw = dict(iters=10, fn_scan=False, analytic_mc=True, sweep_block_size=1)
    batch = caviar_many(*_lists(ragged), *PRIORS, seeds=[0, 1, 2],
                        compile_mode=mode, **CPU, **kw)
    for b, s in enumerate(ragged):
        k_b = s["psc"].shape[0]
        assert batch[b]["lam"].shape == (N, k_b)
        assert batch[b]["z"].shape == (k_b,)
        _assert_close(batch[b], _single(s, b, **kw))


def test_ragged_reconnection_and_recovery(ragged):
    batch = caviar_many(*_lists(ragged), *PRIORS, iters=15,
                        analytic_mc=True, compile_mode="batched",
                        seeds=[0, 1, 2], **CPU)
    for b, s in enumerate(ragged):
        assert batch[b]["lam"].shape[1] == s["psc"].shape[0]
        assert r2_score(s["weights"], batch[b]["mu"]) > 0.9


def _padded(ragged, k_pad=384, fill=7.7):
    ys, sts = _lists(ragged)
    ks = [y.shape[0] for y in ys]
    y_pad = np.full((3, k_pad, ys[0].shape[1]), fill, np.float32)
    s_pad = np.zeros((3, N, k_pad), np.float32)
    for b in range(3):
        y_pad[b, :ks[b]] = ys[b]
        s_pad[b, :, :ks[b]] = sts[b]
    return y_pad, s_pad, ks


def test_k_trues_on_a_padded_stack_matches_the_list(ragged):
    # garbage in the padded trace columns is masked out on the device
    kw = dict(iters=8, fn_scan=False, analytic_mc=True, seeds=[0, 1, 2],
              compile_mode="batched", **CPU)
    ref = caviar_many(*_lists(ragged), *PRIORS, **kw)
    y_pad, s_pad, ks = _padded(ragged)
    out = caviar_many(y_pad, s_pad, *PRIORS, k_trues=ks, **kw)
    for b in range(3):
        assert out[b]["lam"].shape == (N, ks[b])
        _assert_close(out[b], ref[b], fields=("mu", "lam", "z", "phi"))


def test_k_trues_validation(ragged):
    y_pad, s_pad, ks = _padded(ragged, fill=0.0)
    with pytest.raises(ValueError, match="k_trues must be"):
        caviar_many(y_pad, s_pad, *PRIORS, k_trues=[1, 2], **CPU)
    with pytest.raises(ValueError, match="k_trues must be"):
        caviar_many(y_pad, s_pad, *PRIORS, k_trues=[192, 320, 999], **CPU)
    bad = s_pad.copy()
    bad[1, :, 350:] = 55.0  # power levels in the padding
    with pytest.raises(ValueError, match="must be zero"):
        caviar_many(y_pad, bad, *PRIORS, k_trues=ks, **CPU)
    with pytest.raises(ValueError, match="not both"):
        caviar_many(*_lists(ragged), *PRIORS, k_trues=ks, **CPU)


def test_ragged_list_validation(ragged):
    ys, sts = _lists(ragged)
    with pytest.raises(ValueError, match="matching list"):
        caviar_many(ys, np.stack([s[:, :192] for s in sts]), *PRIORS, **CPU)
    with pytest.raises(ValueError, match="stim must be"):
        caviar_many(ys, [sts[0], sts[0], sts[2]], *PRIORS, **CPU)
    with pytest.raises(ValueError, match="traces must be"):
        caviar_many([ys[0], ys[1][:, :-1], ys[2]], sts, *PRIORS, **CPU)
    with pytest.raises(ValueError, match="host trace arrays"):
        caviar_many([torch.from_numpy(ys[0]), ys[1], ys[2]], sts, *PRIORS,
                    **CPU)


def test_option_validation(sims):
    args = (*_stack(sims), *PRIORS)
    with pytest.raises(ValueError, match="compile_mode"):
        caviar_many(*args, compile_mode="bogus", **CPU)
    from circuitmap_torch.parallel import trial_mesh

    with pytest.raises(TypeError, match="TrialMesh"):
        caviar_many(*args, mesh=object(), **CPU)
    with pytest.raises(ValueError, match="sequential.*no mesh path"):
        caviar_many(*args, mesh=trial_mesh(devices=["cpu"] * 2),
                    compile_mode="sequential", **CPU)
    with pytest.raises(ValueError, match="auto.*cuda"):
        caviar_many(*args, laplace_impl="pallas", **CPU)
    stims = _stack(sims)[1].copy()
    stims[1] = stims[1] * 2.0  # other power levels
    with pytest.raises(ValueError, match="share the same power levels"):
        caviar_many(_stack(sims)[0], stims, *PRIORS, iters=2, **CPU)


def test_device_tensor_input_matches_host_input(sims):
    kw = dict(iters=4, fn_scan=False, analytic_mc=True, seeds=[0, 1, 2],
              **CPU)
    host, stims = _stack(sims)
    a = caviar_many(host.astype(np.float32), stims, *PRIORS, **kw)
    b = caviar_many(torch.from_numpy(host.astype(np.float32)), stims,
                    *PRIORS, **kw)
    for ra, rb in zip(a, b):
        _assert_close(ra, rb, dict(rtol=0, atol=0))


def test_trace_wire_keeps_the_support(sims):
    kw = dict(iters=10, fn_scan=False, analytic_mc=True, seeds=[0, 1, 2],
              **CPU)
    plain = caviar_many(*_stack(sims), *PRIORS, **kw)
    wired = caviar_many(*_stack(sims), *PRIORS, trace_wire="int4d2", **kw)
    for b in range(3):
        np.testing.assert_array_equal(plain[b]["mu"] != 0,
                                      wired[b]["mu"] != 0)


def test_signature_is_the_jax_one_plus_device():
    import inspect

    from circuitmap_tpu.solvers.batched import caviar_many as jax_many

    jax_params = list(inspect.signature(jax_many).parameters)
    port_params = list(inspect.signature(caviar_many).parameters)
    # update_order as caviar() takes it, so that a stack of folds can be
    # fit as a function of its inputs
    assert port_params == jax_params + ["update_order", "device"]


@pytest.fixture(scope="module")
def folds():
    """Four cross-validation folds of one experiment, fold f holding out
    the f-th contiguous quarter of its 320 trials: ([4, 240, T] traces,
    [4, N, 240] stims)."""
    np.random.seed(34)
    s = simulate(N=N, trials=320, H=3, connection_prob=0.2, spont_prob=0.01,
                 gp_scale=1e-3, verbose=False)
    keeps = [np.r_[0:f * 80, (f + 1) * 80:320] for f in range(4)]
    return (np.stack([s["psc"][k] for k in keeps]),
            np.stack([s["stim_matrix"][:, k] for k in keeps]))


@pytest.mark.parametrize("block", [1, 8])
@pytest.mark.parametrize("mode", ["sequential", "batched", "mesh"])
def test_identity_order_folds_match_their_single_fits(folds, mode, block):
    """With ``update_order="identity"`` and exact power-curve means each
    fold's fit is a function of its inputs: in float64 the sequential
    mode is the single fit's own loop (equal), and the batched mode, also
    on two CPU shards, sums in other orders (batched Cholesky and
    products; measured 4e-14)."""
    from circuitmap_torch.parallel import trial_mesh

    kw = dict(iters=10, analytic_mc=True, sweep_block_size=block,
              update_order="identity", dtype=torch.float64, **CPU)
    batch = caviar_many(
        *folds, *PRIORS, **kw,
        **(dict(compile_mode="batched", mesh=trial_mesh(devices=["cpu"] * 2))
           if mode == "mesh" else dict(compile_mode=mode)))
    tol = (dict(rtol=0, atol=0) if mode == "sequential"
           else dict(rtol=1e-10, atol=1e-10))
    for f in range(4):
        out = tcav.caviar(folds[0][f], folds[1][f], *PRIORS, **kw)
        want = dict(zip(tbat.FIELDS, (v.numpy() for v in out[:8])))
        _assert_close(batch[f], want, tol)
        assert batch[f]["lam"].dtype == np.float64


@pytest.mark.parametrize("mode", ["sequential", "batched"])
def test_zero_iterations_give_each_folds_single_fit(folds, mode):
    """A loop that runs no iteration leaves every fold at the priors'
    state, shaped as a fold's (a stack once returned the shared [N]
    priors and a scalar noise, which no fold could be cut from)."""
    kw = dict(iters=0, analytic_mc=True, update_order="identity",
              dtype=torch.float64, **CPU)
    batch = caviar_many(*folds, *PRIORS, compile_mode=mode, **kw)
    for f in range(4):
        out = tcav.caviar(folds[0][f], folds[1][f], *PRIORS, **kw)
        want = dict(zip(tbat.FIELDS, (v.numpy() for v in out[:8])))
        _assert_close(batch[f], want, dict(rtol=1e-12, atol=1e-12))


def test_unknown_update_order_is_refused(folds):
    with pytest.raises(ValueError, match="update_order"):
        caviar_many(*folds, *PRIORS, update_order="reverse", **CPU)


def test_auto_sweep_falls_back_to_the_row_kernel_above_max_k():
    """The rule that replaced ROADMAP C's fallback: the cluster kernel
    takes any K, so 'auto' on CUDA is 8 at every K (the old blocked
    kernel stopped at K = 56,064 and 'auto' fell back to the row kernel
    above it); the CPU stays at 1 and a pinned 1 or 8 is honoured at any
    K. The resolver reads only the device's type."""
    gpu, cpu = torch.device("cuda"), torch.device("cpu")
    for k in (56064, 60000, 1_000_000):
        assert tcav._resolve_sweep("auto", "auto", gpu, k=k) == 8
        assert tcav._resolve_sweep("auto", "auto", cpu, k=k) == 1
        assert tcav._resolve_sweep("cuda", 1, gpu, k=k) == 1
        assert tcav._resolve_sweep("auto", 8, gpu, k=k) == 8


def test_host_reconnect_scan_matches_jax():
    """The port's ``reconnect_from_spontaneous`` (the device scan that
    the fits run, here on the CPU) against the JAX package's host scan
    on the same numpy inputs: the same reconnected set, rtol 1e-6."""
    from circuitmap_tpu.solvers.caviar import (
        reconnect_from_spontaneous as jax_scan)

    rng = np.random.default_rng(5)
    K = 400
    stim = np.zeros((20, K), np.float32)
    stim[rng.integers(0, 20, 3 * K), np.repeat(np.arange(K), 3)] = \
        rng.choice([45.0, 55.0, 65.0], 3 * K)
    lam = np.where(stim > 0, rng.uniform(0, 1, stim.shape), 0).astype(
        np.float32)
    mu = np.where(rng.random(20) < 0.4, rng.uniform(5, 20, 20), 0).astype(
        np.float32)
    beta = rng.uniform(0.5, 2, 20).astype(np.float32)
    z = np.zeros(K, np.float32)
    for n in (3, 11):  # disconnected cells whose trials carry events
        mu[n] = 0.0
        hit = np.flatnonzero(stim[n] > 0)
        z[hit] = rng.uniform(5, 15, hit.size)
    args = dict(msrmp=0.3, minimum_spike_count=3,
                powers=np.float32([45.0, 55.0, 65.0]))
    want = jax_scan(None, stim, lam, mu, beta, z, **args)
    got = tcav.reconnect_from_spontaneous(None, stim, lam, mu, beta, z,
                                          **args)
    assert got[-1] and want[-1]
    for name, g, w in zip(("mu", "beta", "lam", "z"), got[:4], want[:4]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=1e-6,
                                   err_msg=name)
    # a tensor lam is updated on its device, to the same values
    got_t = tcav.reconnect_from_spontaneous(
        None, stim, torch.from_numpy(lam), mu, beta, z, **args)
    np.testing.assert_array_equal(got_t[2].numpy(), got[2])


_PARITY_SCRIPT = r"""
import importlib, json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import jax.numpy as jnp
import numpy as np
import torch

from circuitmap_tpu.simulation import simulate
from circuitmap_tpu.model import default_priors
from circuitmap_tpu.solvers.caviar import caviar as jax_caviar

tcav = importlib.import_module("circuitmap_torch.solvers.caviar")
tbat = importlib.import_module("circuitmap_torch.solvers.batched")

ragged = sys.argv[1] == "ragged"
trials = (192, 320, 256) if ragged else (240, 240, 240)
sims = []
for seed, k in zip((31, 32, 33), trials):
    np.random.seed(seed)
    sims.append(simulate(N=24, trials=k, H=3, connection_prob=0.2,
                         spont_prob=0.01, gp_scale=1e-3, verbose=False))
p = default_priors(24)
priors = (p["mu"], p["beta"], p["shape"], p["rate"], p["phi"], p["phi_cov"])
kw = dict(iters=10, num_mc_samples=100, minimum_spike_count=3,
          delay_spont_est=1, msrmp=0.3, scale_factor=0.75, penalty=5.0,
          max_backtrack_iters=20, tol=0.05, spont_orthogonality=0.1,
          analytic_mc=True)
ks = [s["psc"].shape[0] for s in sims]
K = max(ks)
y = np.zeros((3, K, sims[0]["psc"].shape[1]))
st = np.zeros((3, 24, K))
for b, s in enumerate(sims):
    y[b, :ks[b]] = s["psc"]
    st[b, :, :ks[b]] = s["stim_matrix"]
cpu = torch.device("cpu")
powers_np = tbat._validate_shared_levels(st, None)
ys, stim, masks, lam0, powers, kts = tbat._device_stack(
    y, st, ks if ragged else None, powers_np, 1e-2, torch.float64, None, cpu)
hyper = tuple(torch.as_tensor(np.asarray(a, np.float64)) for a in priors)
final = tcav._run_caviar(
    ys, stim, lam0, masks, powers,
    tcav.power_counts_of(stim, powers, torch.float64), hyper,
    [tcav.seeded_generator(b, cpu) for b in range(3)], k_true=kts,
    save_histories=False, sweep_block_size=1, update_order="identity",
    **kw)[0]
out = {}
for b, s in enumerate(sims):
    a = jax_caviar(s["psc"], s["stim_matrix"], *priors, dtype=jnp.float64,
                   update_order="identity", fn_scan=False, verbose=False,
                   sweep_block_size=1, seed=b, **kw)
    for i, name in enumerate(tbat.FIELDS):
        x = np.asarray(a[i], np.float64)
        g = final[i][b].numpy()
        if name == "lam":
            g = g[:, :ks[b]]
        if name == "z":
            g = g[:ks[b]]
        err = float(np.max(np.abs(x - g) / (np.abs(x) + 1e-9)))
        out[f"{b}_{name}"] = [err, str(g.dtype)]
out["n_connected"] = int(sum((final[0][b] != 0).sum() for b in range(3)))
print(json.dumps(out))
"""


@pytest.mark.parametrize("kind", ["same_shape", "ragged"])
def test_batched_loop_matches_jax_in_float64(kind):
    proc = subprocess.run([sys.executable, "-c", _PARITY_SCRIPT, kind],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out.pop("n_connected") > 0
    for name, (err, dtype) in out.items():
        assert dtype == "float64", name
        assert err < 1e-6, (name, err)
