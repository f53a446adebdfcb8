"""The port's checkpointed CAVIaR (``caviar_resumable``) and its
checkpoint format against its own one-shot fit and the JAX package.

Within the port a segmented fit, interrupted or not, is the one-shot
``caviar()`` fit bit for bit: the segments number their iterations
globally and continue one ``torch.Generator``, whose state the
checkpoint keeps. Against the JAX package, float64 on both sides with
exact power-curve means, the port's fit takes the row orders that the
JAX fit draws from its key (``jax.random`` cannot be reproduced by a
``torch.Generator``): rtol 1e-6 on every output. The ``.npz`` format is
the JAX package's: each side reads the other's files; a JAX checkpoint
holds no generator state, and the port refuses to resume one.
"""

import os

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from circuitmap_tpu.model import default_priors
from circuitmap_tpu.simulation import simulate
from circuitmap_tpu.solvers.resumable import (
    caviar_resumable as jax_caviar_resumable)
from circuitmap_tpu.utils.checkpoint import load_state as jax_load_state
from circuitmap_torch.solvers.caviar import caviar
from circuitmap_torch.solvers.resumable import caviar_resumable
from circuitmap_torch.utils import checkpoint

N, K = 30, 300
NAMES = ["mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z"]
PORT = dict(dtype=torch.float64, device="cpu", verbose=False)


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
    np.random.seed(11)
    return simulate(N=N, trials=K, H=3, connection_prob=0.15,
                    spont_prob=0.01, gp_scale=1e-3, verbose=False)


def _args(sim):
    p = default_priors(N)
    return (sim["psc"], sim["stim_matrix"], p["mu"], p["beta"], p["shape"],
            p["rate"], p["phi"], p["phi_cov"])


@pytest.fixture(scope="module")
def one_shot(sim):
    return caviar(*_args(sim), iters=12, seed=4, **PORT)


def _assert_same(got, want, rtol=0.0):
    for name, g, w in zip(NAMES, got[:8], want[:8]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=0.0, err_msg=name)


def test_segmented_equals_one_shot(sim, one_shot, tmp_path):
    seg = caviar_resumable(*_args(sim), str(tmp_path / "fit.npz"), iters=12,
                           checkpoint_every=5, seed=4, **PORT)
    assert len(seg) == 17 and all(h is None for h in seg[8:])
    _assert_same(seg, one_shot)
    ck = checkpoint.load_state(tmp_path / "fit.npz")
    assert int(ck["completed_iters"]) == 12
    assert ck[checkpoint.GENERATOR_KEY].dtype == np.uint8


def test_resume_from_partial_file(sim, one_shot, tmp_path):
    path = str(tmp_path / "fit.npz")
    caviar_resumable(*_args(sim), path, iters=5, checkpoint_every=5, seed=4,
                     **PORT)
    assert int(checkpoint.load_state(path)["completed_iters"]) == 5
    # a new call (another "process": a fresh generator from the seed)
    # resumes after iteration 5 with the checkpoint's generator state
    resumed = caviar_resumable(*_args(sim), path, iters=12,
                               checkpoint_every=5, seed=4, **PORT)
    _assert_same(resumed, one_shot)
    assert int(checkpoint.load_state(path)["completed_iters"]) == 12


def test_suffixless_path_resumes(sim, one_shot, tmp_path):
    path = str(tmp_path / "fit_ckpt")
    caviar_resumable(*_args(sim), path, iters=7, checkpoint_every=7, seed=4,
                     **PORT)
    assert os.path.exists(path + ".npz") and not os.path.exists(path)
    resumed = caviar_resumable(*_args(sim), path, iters=12,
                               checkpoint_every=3, seed=4, **PORT)
    _assert_same(resumed, one_shot)


def test_bad_segmenting_and_mesh_rejected(sim, tmp_path):
    path = str(tmp_path / "a")
    with pytest.raises(ValueError, match="checkpoint_every"):
        caviar_resumable(*_args(sim), path, iters=4, checkpoint_every=0,
                         **PORT)
    with pytest.raises(ValueError, match="iters"):
        caviar_resumable(*_args(sim), path, iters=0, **PORT)
    with pytest.raises(TypeError, match="TrialMesh"):
        caviar_resumable(*_args(sim), path, iters=4, mesh=object(), **PORT)
    assert not os.listdir(tmp_path)


def test_checkpoint_of_another_fit_shape_raises(sim, tmp_path):
    path = str(tmp_path / "fit.npz")
    caviar_resumable(*_args(sim), path, iters=2, **PORT)
    psc, stim, *priors = _args(sim)
    with pytest.raises(ValueError, match="N=30, K=200"):
        caviar_resumable(psc[:200], stim[:, :200], *priors, path, iters=4,
                         **PORT)


def test_atomic_write(tmp_path, monkeypatch):
    path = tmp_path / "state.npz"
    checkpoint.save_state(path, {"a": np.arange(5), "t": torch.ones(3)})
    checkpoint.save_state(path, {"a": np.arange(9), "b": {"c": None}})
    out = checkpoint.load_state(path)
    assert out["a"].shape == (9,) and out["b"] == {"c": None}
    assert not list(tmp_path.glob("*.tmp*"))

    def torn(name, **arrays):  # a write that dies half way
        with open(str(name) + ".npz", "wb") as f:
            f.write(b"PK\x03\x04 torn")
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint.np, "savez", torn)
    with pytest.raises(OSError, match="disk full"):
        checkpoint.save_state(path, {"a": np.arange(3)})
    np.testing.assert_array_equal(checkpoint.load_state(path)["a"],
                                  np.arange(9))
    assert not list(tmp_path.glob("*.tmp*"))


def test_matches_jax_resumable_in_float64(sim, tmp_path, monkeypatch):
    """The JAX package's segmented fit (float64, exact means, random
    order, with its reconnection scan) against the port's, given the
    row orders the JAX fit draws: each iteration splits the state's key
    in three and permutes the rows with the second part; the key
    carries across segments."""
    iters, seed = 9, 2
    kw = dict(iters=iters, checkpoint_every=4, seed=seed, analytic_mc=True,
              verbose=False)
    with jax.enable_x64(True):
        want = jax_caviar_resumable(*_args(sim), str(tmp_path / "jax.npz"),
                                    dtype=jnp.float64, **kw)
        want = [np.asarray(a) for a in want[:8]]
        key, orders = jax.random.PRNGKey(seed), []
        for _ in range(iters):
            key, k_order, _ = jax.random.split(key, 3)
            orders.append(np.array(jax.random.permutation(k_order, N)))
    queue = [torch.as_tensor(o, dtype=torch.int64) for o in orders]
    monkeypatch.setattr(torch, "randperm",
                        lambda n, generator=None, device=None: queue.pop(0))
    got = caviar_resumable(*_args(sim), str(tmp_path / "port.npz"),
                           dtype=torch.float64, device="cpu", **kw)
    assert not queue
    _assert_same(got, want, rtol=1e-6)
    assert 0 < (want[0] != 0).sum() < N


def test_jax_checkpoint_rejected_by_name(sim, tmp_path):
    path = str(tmp_path / "jax.npz")
    jax_caviar_resumable(*_args(sim), path, iters=2, checkpoint_every=1,
                         verbose=False)
    assert "key" in checkpoint.load_state(path)
    with pytest.raises(ValueError, match="written by the JAX package"):
        caviar_resumable(*_args(sim), path, iters=4, **PORT)


def test_port_checkpoint_reads_back_in_jax(sim, tmp_path):
    path = str(tmp_path / "port.npz")
    caviar_resumable(*_args(sim), path, iters=3, **PORT)
    mine, theirs = checkpoint.load_state(path), jax_load_state(path)
    assert set(mine) == set(theirs) >= {
        "mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z",
        "spont_rate", "completed_iters", checkpoint.GENERATOR_KEY}
    for k in mine:
        np.testing.assert_array_equal(mine[k], theirs[k], err_msg=k)
    assert theirs["lam"].shape == (N, K)
    assert theirs["lam"].dtype == np.float64
