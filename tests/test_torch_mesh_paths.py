"""Every ``mesh=`` entry point of the port on CPU shards: the
experiment-sharded ``*_many``, ``caviar_resumable``, ``OnlineCaviar``,
the demixer, ``Model.fit`` and the fit server.

The experiment-sharded fits are held against the port's own unsharded
batched fits (the same experiments, the same random streams); the
resumable and streaming fits and ``Model.fit`` against the JAX package's
mesh runs on the conftest's virtual CPU mesh, float64 on both sides with
exact power-curve means (the resumable fit takes the row orders the JAX
fit draws from its key); the demixer's meshed call against its
unsharded call.
"""

import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from circuitmap_tpu.model import default_priors
from circuitmap_tpu.parallel import trial_mesh as jax_trial_mesh
from circuitmap_tpu.simulation import simulate
from circuitmap_torch import serve as ts
from circuitmap_torch.demix.demixer import NeuralDemixer, mesh_compatible
from circuitmap_torch.parallel import caviar_sharded, trial_mesh
from circuitmap_torch.solvers.batched import caviar_many, mbcs_many, sns_many
from circuitmap_torch.solvers.online import OnlineCaviar
from circuitmap_torch.solvers.resumable import caviar_resumable

N, K = 30, 360
F64 = dict(dtype=torch.float64, verbose=False)
FIELDS = ("mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z")
DEMIXER = "demixers/nwd_ie_ChroME2f.npz"


@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    """One torch and one BLAS thread while this file runs: the suite
    runs in parallel workers."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim():
    np.random.seed(13)
    return simulate(N=N, trials=K, H=4, connection_prob=0.15,
                    spont_prob=0.01, gp_scale=1e-3, verbose=False)


def _p(*names):
    p = default_priors(N)
    return tuple(p[k] for k in names)


CAVIAR_PRIORS = ("mu", "beta", "shape", "rate", "phi", "phi_cov")


def _cpu(D):
    return trial_mesh(devices=["cpu"] * D)


def _close(got, want, keys, rtol=1e-6, atol=1e-9):
    for k in keys:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=rtol, atol=atol, err_msg=k)


def _folds(sim, B=3):
    k = K // B
    return (np.stack([sim["psc"][b * k:(b + 1) * k] for b in range(B)]),
            np.stack([sim["stim_matrix"][:, b * k:(b + 1) * k]
                      for b in range(B)]))


@pytest.mark.parametrize("name", ["caviar_many", "sns_many", "mbcs_many"])
def test_many_mesh_matches_unsharded_batched(sim, name):
    """3 experiments over 2 shards (a padded chunk): each shard runs the
    batched loop on its chunk with the experiments' own streams, so the
    results are the unsharded batched fit's."""
    fn, priors = {
        "caviar_many": (caviar_many, _p(*CAVIAR_PRIORS)),
        "sns_many": (sns_many, _p("mu", "beta", "alpha", "shape", "rate",
                                  "phi", "phi_cov")),
        "mbcs_many": (mbcs_many, _p("mu", "beta", "shape", "rate")),
    }[name]
    ys, sts = _folds(sim)
    want = fn(ys, sts, *priors, iters=3, compile_mode="batched",
              device="cpu", **F64)
    got = fn(ys, sts, *priors, iters=3, mesh=_cpu(2), **F64)
    for g, w in zip(got, want):
        _close(g, w, w.keys())


@pytest.mark.parametrize("name", ["caviar_many", "sns_many", "mbcs_many"])
def test_one_experiment_stack_runs_batched(sim, name):
    """A stack of one experiment (batched mode, or a mesh chunk of one)
    draws its random stream as a stack: it used to be taken for a single
    fit's, and the batched loop raised. It equals the sequential fit."""
    fn, priors = {
        "caviar_many": (caviar_many, _p(*CAVIAR_PRIORS)),
        "sns_many": (sns_many, _p("mu", "beta", "alpha", "shape", "rate",
                                  "phi", "phi_cov")),
        "mbcs_many": (mbcs_many, _p("mu", "beta", "shape", "rate")),
    }[name]
    ys, sts = _folds(sim, B=1)
    want = fn(ys, sts, *priors, iters=3, compile_mode="sequential",
              device="cpu", **F64)
    got = fn(ys, sts, *priors, iters=3, compile_mode="batched",
             device="cpu", **F64)
    _close(got[0], want[0], want[0].keys())


def test_ragged_caviar_many_over_a_mesh(sim):
    ys = [sim["psc"][:100], sim["psc"][100:220], sim["psc"][220:]]
    sts = [sim["stim_matrix"][:, :100], sim["stim_matrix"][:, 100:220],
           sim["stim_matrix"][:, 220:]]
    want = caviar_many(ys, sts, *_p(*CAVIAR_PRIORS), iters=3,
                       compile_mode="batched", device="cpu", **F64)
    got = caviar_many(ys, sts, *_p(*CAVIAR_PRIORS), iters=3, mesh=_cpu(4),
                      **F64)
    for g, w, k in zip(got, want, (100, 120, 140)):
        assert g["lam"].shape == (N, k)
        _close(g, w, FIELDS)


def _jax_orders(seed, iters):
    """The row orders a JAX sharded CAVIaR fit draws from its key."""
    key, out = jax.random.PRNGKey(seed), []
    for _ in range(iters):
        key, k_order, _ = jax.random.split(key, 3)
        out.append(np.asarray(jax.random.permutation(k_order, N)))
    return out


def test_resumable_mesh_matches_jax_and_resumes_on_another_mesh(
        sim, tmp_path, monkeypatch):
    from circuitmap_tpu.solvers.resumable import (
        caviar_resumable as jax_resumable)

    args = (sim["psc"], sim["stim_matrix"], *_p(*CAVIAR_PRIORS))
    kw = dict(iters=6, checkpoint_every=2, seed=2, analytic_mc=True)
    with jax.enable_x64(True):
        want = jax_resumable(*args, str(tmp_path / "jax.npz"),
                             mesh=jax_trial_mesh(4), dtype=jnp.float64,
                             verbose=False, **kw)
        want = dict(zip(FIELDS, (np.asarray(a) for a in want[:8])))
    orders = _jax_orders(2, 6)
    feed = iter(orders)
    monkeypatch.setattr(torch, "randperm", lambda n, **k: torch.as_tensor(
        next(feed).copy(), device=k.get("device")))
    straight = caviar_resumable(*args, str(tmp_path / "a.npz"), mesh=_cpu(4),
                                **kw, **F64)
    _close(dict(zip(FIELDS, straight[:8])), want, FIELDS)
    # interrupted after 4 iterations, resumed on another mesh size
    feed = iter(orders)
    caviar_resumable(*args, str(tmp_path / "b.npz"), mesh=_cpu(4),
                     **dict(kw, iters=4), fn_scan=False, **F64)
    resumed = caviar_resumable(*args, str(tmp_path / "b.npz"), mesh=_cpu(3),
                               **kw, **F64)
    # another shard count sums in another grouping: equal to rounding
    _close(dict(zip(FIELDS, resumed[:8])), dict(zip(FIELDS, straight[:8])),
           FIELDS)


def test_online_mesh_stream_matches_jax(sim, tmp_path):
    from circuitmap_tpu.solvers.online import OnlineCaviar as JaxOnline

    kw = dict(powers=[45.0, 55.0, 65.0], capacity=64,
              update_order="identity", analytic_mc=True)
    edges = (0, 100, 250, K)
    with jax.enable_x64(True):
        jo = JaxOnline(N, dtype=jnp.float64, mesh=jax_trial_mesh(4), **kw)
        for a, b in zip(edges[:-1], edges[1:]):
            jo.update(sim["psc"][a:b], sim["stim_matrix"][:, a:b], iters=3)
        want = jo.result()
    oc = OnlineCaviar(N, dtype=torch.float64, mesh=_cpu(4), **kw)
    for a, b in zip(edges[:-1], edges[1:]):
        oc.update(sim["psc"][a:b], sim["stim_matrix"][:, a:b], iters=3)
    assert oc._C % 4 == 0 and len(oc._bufs[0]) == 4
    got = oc.result()
    _close(got, want, ("mu", "beta", "lam", "z", "shape", "rate", "phi",
                       "phi_cov", "spont_rate"))
    # a checkpoint reloads on a mesh whose shard count does not divide
    # its capacity (grown with inert columns)
    oc.save(str(tmp_path / "s.npz"))
    back = OnlineCaviar.load(str(tmp_path / "s.npz"), dtype=torch.float64,
                             mesh=_cpu(3), **kw)
    assert back._C % 3 == 0
    _close(back.result(), got, ("mu", "lam", "z", "phi"), rtol=1e-12,
           atol=0)


def test_model_fit_mesh_matches_jax_model(sim):
    from circuitmap_tpu.model import Model as JaxModel
    from circuitmap_torch import Model

    opts = dict(iters=4, analytic_mc=True, update_order="identity",
                sweep_block_size=4, save_histories=True)
    with jax.enable_x64(True):
        want = JaxModel(N).fit(sim["psc"], sim["stim_matrix"],
                               fit_options=dict(opts, dtype=jnp.float64,
                                                mesh=jax_trial_mesh(8)))
    got = Model(N).fit(sim["psc"], sim["stim_matrix"],
                       fit_options=dict(opts, mesh=_cpu(8), **F64))
    _close(got.state, want.state, FIELDS)
    _close(got.history, want.history, FIELDS)


def test_demixer_mesh_rule_and_meshed_call(sim):
    assert not mesh_compatible(None)
    assert all(mesh_compatible(_cpu(d)) for d in (1, 2, 4, 8))
    assert not mesh_compatible(_cpu(3))
    dm = NeuralDemixer(DEMIXER, device="cpu")
    raw = np.asarray(sim["psc"][:37])
    want = dm(raw, verbose=False, chunk_size=16)
    got = dm(raw, verbose=False, chunk_size=16, mesh=_cpu(4))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    dev = dm(raw, verbose=False, mesh=_cpu(2), keep_on_device=True,
             transfer_dtype="int8")
    assert isinstance(dev, torch.Tensor) and dev.shape == raw.shape
    with pytest.raises(ValueError, match="power-of-two"):
        dm(raw, verbose=False, mesh=_cpu(3))


@pytest.fixture(scope="module")
def mesh_svc():
    return ts.FitService(mesh_devices=2, device="cpu")


def _npz(sim, k):
    return ts._npz_bytes(psc=sim["psc"][:k], stim=sim["stim_matrix"][:, :k])


def test_mesh_server_fits_sharded_and_opts_out(mesh_svc, sim):
    opts = {"iters": 3, "demix": False, "analytic_mc": True,
            "update_order": "identity"}
    got = ts._load_npz(mesh_svc.do_fit(_npz(sim, 200), json.dumps(opts))[1])
    want = caviar_sharded(sim["psc"][:200], sim["stim_matrix"][:, :200],
                          *_p(*CAVIAR_PRIORS), mesh=_cpu(2), iters=3,
                          analytic_mc=True, update_order="identity",
                          verbose=False)
    _close(got, dict(zip(FIELDS, want[:8])), FIELDS)
    assert json.loads(mesh_svc.do_health()[1])["mesh_devices"] == 2
    single = ts._load_npz(mesh_svc.do_fit(
        _npz(sim, 200), json.dumps(dict(opts, sharded=False)))[1])
    assert single["lam"].shape == got["lam"].shape
    with pytest.raises(ts._BadRequest, match="cosamp has no sharded"):
        mesh_svc.do_fit(_npz(sim, 200), json.dumps(
            {"method": "cosamp", "sharded": True, "demix": False}))
    many = ts._load_npz(mesh_svc.do_fit_many(ts._npz_bytes(
        pscs=np.stack([sim["psc"][:120]] * 2),
        stims=np.stack([sim["stim_matrix"][:, :120]] * 2)),
        json.dumps({"iters": 2, "demix": False}))[1])
    assert np.asarray(many["lam"]).shape[0] == 2


def test_unmeshed_server_refuses_a_sharded_fit(sim):
    svc = ts.FitService(device="cpu")
    with pytest.raises(ts._BadRequest, match="has no mesh"):
        svc.do_fit(_npz(sim, 64), json.dumps({"sharded": True,
                                              "demix": False}))
