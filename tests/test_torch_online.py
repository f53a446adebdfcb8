"""The port's streaming CAVIaR (``OnlineCaviar``) against its own batch
fit and against the JAX package's stream.

All fits run in float64 on the CPU. One update over all trials, with
fewer cumulative iterations than ``max_backtrack_iters`` (where the
spontaneous update's seed cap is not yet active) and into buffers grown
to the block's width, is the batch ``caviar()`` fit bit for bit.
Against the JAX package's ``OnlineCaviar`` (float64 under
``jax.enable_x64``), a 3-block stream with the per-update
reconnection scan at ``update_order="identity"`` and exact power-curve
means is held at rtol 1e-6: the two packages pad their capacity buffers
differently (the port to 4 columns, the JAX package to 128), and inert
columns change only the order of the sums. A stream's capacity growth,
its checkpoint and a failed update change nothing: exact equality.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from circuitmap_tpu.model import default_priors
from circuitmap_tpu.simulation import simulate
from circuitmap_tpu.solvers.online import OnlineCaviar as JaxOnlineCaviar
from circuitmap_torch.solvers import online
from circuitmap_torch.solvers.caviar import caviar
from circuitmap_torch.solvers.online import OnlineCaviar
from circuitmap_torch.utils.metrics import r2_score

N, K = 40, 480
EDGES = (0, 150, 330, 480)
PORT = dict(dtype=torch.float64, device="cpu")
FIELDS = ("mu", "beta", "lam", "z", "shape", "rate", "phi", "phi_cov",
          "spont_rate")


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


@pytest.fixture(scope="module")
def sim():
    np.random.seed(21)
    return simulate(N=N, trials=K, H=4, connection_prob=0.15,
                    spont_prob=0.01, gp_scale=1e-3, verbose=False)


def _stream(sim, edges=EDGES, iters=4, **kw):
    oc = OnlineCaviar(N, **{**PORT, **kw})
    for a, b in zip(edges, edges[1:]):
        oc.update(sim["psc"][a:b], sim["stim_matrix"][:, a:b], iters=iters)
    return oc


def _assert_same(got, want, rtol=0.0, fields=FIELDS):
    for f in fields:
        np.testing.assert_allclose(got[f], want[f], rtol=rtol, atol=0.0,
                                   err_msg=f)


@pytest.mark.parametrize("fn_scan", [False, True])
def test_one_block_equals_the_batch_fit(sim, fn_scan):
    p = default_priors(N)
    out = caviar(sim["psc"], sim["stim_matrix"], p["mu"], p["beta"],
                 p["shape"], p["rate"], p["phi"], p["phi_cov"], iters=15,
                 fn_scan=fn_scan, verbose=False, **PORT)
    # the buffers grow to hold the block exactly: the same shapes as the
    # batch fit's, so the same sums in the same order
    oc = OnlineCaviar(N, capacity=4, **PORT)
    oc.update(sim["psc"], sim["stim_matrix"], iters=15, fn_scan=False)
    assert oc._C == K
    res = oc.result(fn_scan=fn_scan)
    assert res["trial_count"] == K and res["iterations"] == 15
    for i, f in enumerate(("mu", "beta", "lam", "shape", "rate", "phi",
                           "phi_cov", "z")):
        np.testing.assert_array_equal(res[f], out[i].numpy(), err_msg=f)


def test_stream_matches_jax_in_float64(sim):
    kw = dict(update_order="identity", analytic_mc=True, capacity=128)
    with jax.enable_x64(True):
        ref = JaxOnlineCaviar(N, dtype=jnp.float64, **kw)
        for a, b in zip(EDGES, EDGES[1:]):
            ref.update(sim["psc"][a:b], sim["stim_matrix"][:, a:b], iters=5)
        want = ref.result()
        want_post = ref.posterior()
    got = _stream(sim, iters=5, **kw)
    assert got.it == ref.it == 15 and got.k == ref.k == K
    _assert_same(got.result(), want, rtol=1e-6)
    _assert_same(got.posterior(), want_post, rtol=1e-6,
                 fields=("mu", "beta", "phi", "phi_cov", "shape", "rate"))
    assert 0 < (want["mu"] != 0).sum() < N


def test_capacity_padding_is_inert(sim):
    """A stream whose buffers hold 1000 columns for 480 trials, against
    one grown to just fit: the inert columns change no value."""
    wide = _stream(sim, capacity=1000)
    tight = _stream(sim, capacity=4)
    assert wide._C == 1000 and tight._C < 1000
    _assert_same(wide.result(), tight.result(), rtol=1e-12)


def test_growth_mid_stream(sim):
    oc = OnlineCaviar(N, capacity=100, **PORT)
    caps = []
    for a, b in zip(EDGES, EDGES[1:]):
        oc.update(sim["psc"][a:b], sim["stim_matrix"][:, a:b], iters=4)
        caps.append(oc._C)
    # doubling (to a multiple of 4) once a block does not fit
    assert caps == [200, 400, 800]
    assert oc._bufs[1].shape == (N, 800) and oc._state.lam.shape == (N, 800)
    assert not oc._bufs[1][:, K:].any() and not oc._state.lam[:, K:].any()
    _assert_same(oc.result(), _stream(sim, capacity=1024).result(),
                 rtol=1e-12)
    r2 = r2_score(sim["weights"], oc.result()["mu"])
    assert r2 > 0.8, r2


def test_save_load_is_exact(sim, tmp_path):
    full = _stream(sim)
    part = _stream(sim, edges=EDGES[:3])
    path = tmp_path / "stream.npz"
    part.save(path)
    restored = OnlineCaviar.load(path, **PORT)
    assert (restored.k, restored.it, restored._C) == (part.k, part.it,
                                                      part._C)
    a, b = EDGES[2], EDGES[3]
    restored.update(sim["psc"][a:b], sim["stim_matrix"][:, a:b], iters=4)
    _assert_same(restored.result(), full.result())
    with pytest.raises(ValueError, match="N=40"):
        OnlineCaviar.load(path, N=41, **PORT)


def test_jax_stream_checkpoint_rejected(sim, tmp_path):
    ref = JaxOnlineCaviar(N)
    ref.update(sim["psc"][:64], sim["stim_matrix"][:, :64], iters=1)
    ref.save(tmp_path / "jax.npz")
    with pytest.raises(ValueError, match="written by the JAX package"):
        OnlineCaviar.load(tmp_path / "jax.npz", **PORT)


def test_failed_update_rolls_back(sim, monkeypatch):
    oc = _stream(sim, edges=EDGES[:2])
    k0, it0, state0 = oc.k, oc.it, oc._state
    lam0 = state0.lam.clone()
    rng0 = oc._generator.get_state()
    calls = []

    def boom(*args, **kw):
        calls.append(1)
        torch.randperm(N, generator=oc._generator)  # the stream moved on
        raise RuntimeError("injected fit failure")

    monkeypatch.setattr(online, "_run_caviar", boom)
    a, b = EDGES[1], EDGES[2]
    with pytest.raises(RuntimeError, match="injected"):
        oc.update(sim["psc"][a:b], sim["stim_matrix"][:, a:b], iters=4)
    assert calls and oc.k == k0 and oc.it == it0
    assert oc._state is state0 and torch.equal(oc._state.lam, lam0)
    assert torch.equal(oc._generator.get_state(), rng0)
    monkeypatch.undo()
    # the stream goes on as one that never failed
    oc.update(sim["psc"][a:b], sim["stim_matrix"][:, a:b], iters=4)
    _assert_same(oc.result(), _stream(sim, edges=EDGES[:3]).result())


def test_failed_first_update_rolls_back_the_level_table(sim):
    oc = OnlineCaviar(N, **PORT)
    with pytest.raises(ValueError, match="trace_wire"):
        oc.update(sim["psc"][:64], sim["stim_matrix"][:, :64], iters=2,
                  trace_wire="int5")
    assert oc._levels_np is None and oc.k == 0
    stim2 = sim["stim_matrix"][:, 64:128] * 2.0
    oc.update(sim["psc"][64:128], stim2, iters=2)
    assert oc.k == 64
    np.testing.assert_array_equal(oc._powers_np, [90.0, 110.0, 130.0])


def test_unseen_level_raises(sim):
    oc = OnlineCaviar(N, powers=[45.0], **PORT)
    with pytest.raises(ValueError, match="not covered"):
        oc.update(sim["psc"][:64], sim["stim_matrix"][:, :64], iters=1)
    assert oc.k == 0 and oc._bufs is None
    # a table fixed from the first block refuses a later block's new level
    oc = _stream(sim, edges=EDGES[:2])
    with pytest.raises(ValueError, match="not covered"):
        oc.update(sim["psc"][150:200], sim["stim_matrix"][:, 150:200] * 2,
                  iters=1)
    assert oc.k == 150


def test_empty_zero_and_shape_mismatch_errors(sim):
    oc = OnlineCaviar(N, **PORT)
    with pytest.raises(RuntimeError, match="update"):
        oc.posterior()
    with pytest.raises(RuntimeError, match="update"):
        oc.result()
    with pytest.raises(ValueError, match="empty"):
        oc.update(sim["psc"][:0], sim["stim_matrix"][:, :0], iters=1)
    with pytest.raises(ValueError, match="powers"):
        oc.update(sim["psc"][:32], np.zeros_like(sim["stim_matrix"][:, :32]),
                  iters=1)
    with pytest.raises(ValueError, match="trials"):
        oc.update(sim["psc"][:64], sim["stim_matrix"][:, :32], iters=1)
    with pytest.raises(ValueError, match="neurons"):
        oc.update(sim["psc"][:64], sim["stim_matrix"][:30, :64], iters=1)
    with pytest.raises(ValueError, match="iters"):
        oc.update(sim["psc"][:64], sim["stim_matrix"][:, :64], iters=0)
    oc.update(sim["psc"][:64], sim["stim_matrix"][:, :64], iters=2)
    assert oc.trial_count == 64 and oc.iteration == 2
    assert oc.last_reconnected >= 0


def test_mesh_raises():
    """A mesh must be a TrialMesh of this process (a stream over a
    process group has no per-process feeding contract)."""
    with pytest.raises(TypeError, match="TrialMesh"):
        OnlineCaviar(N, mesh=object(), **PORT)
