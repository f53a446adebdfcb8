"""The port's trial-sharded solvers (``circuitmap_torch.parallel``)
against the JAX package's on the conftest's virtual 8-device CPU mesh.

Same numpy inputs (N=40, K=501: not divisible by the shard counts, so
the padding is exercised), float64 on both sides, ``update_order=
"identity"`` and exact power-curve means (``analytic_mc=True``): the
variance-reduced protocol, under which the two packages compute the same
function and agree to rtol 1e-6 at D = 2, 4 and 8 shards
(``trial_mesh(devices=["cpu"] * D)`` against ``trial_mesh(D)``). MBCS's
random row orders are handed to the port from the JAX fit's key
(``torch.randperm`` patched), with the exact noise moments.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from circuitmap_tpu.model import default_priors
from circuitmap_tpu.parallel import (caviar_sharded as jax_caviar_sharded,
                                     cavi_sns_sharded as jax_sns_sharded,
                                     mbcs_sharded as jax_mbcs_sharded,
                                     trial_mesh as jax_trial_mesh)
from circuitmap_tpu.simulation import simulate
from circuitmap_torch.parallel import (TrialMesh, caviar_sharded,
                                       cavi_sns_sharded, mbcs_sharded,
                                       trial_mesh)
from circuitmap_torch.parallel import sharded
from circuitmap_torch.solvers.caviar import caviar

N, K = 40, 501
RTOL, ATOL = 1e-6, 1e-9
CAVIAR = ("mu", "beta", "lam", "shape", "rate", "phi", "phi_cov", "z")
SNS = ("mu", "beta", "alpha", "lam", "shape", "rate", "phi", "phi_cov")
MBCS = ("mu", "beta", "lam", "shape", "rate", "z", "receptive_fields")
EXACT = dict(analytic_mc=True, update_order="identity", verbose=False)


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
    np.random.seed(5)
    return simulate(N=N, trials=K, H=5, connection_prob=0.1, verbose=False,
                    spont_prob=0.01, gp_scale=1e-3)


def _priors(*names):
    p = default_priors(N)
    return tuple(p[k] for k in names)


def _args(sim):
    return (sim["psc"], sim["stim_matrix"],
            *_priors("mu", "beta", "shape", "rate", "phi", "phi_cov"))


def _cpu(D):
    return trial_mesh(devices=["cpu"] * D)


def _close(got, want, names, rtol=RTOL, atol=ATOL):
    for name, g, w in zip(names, got, want):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), rtol=rtol,
                                   atol=atol, err_msg=name)


def _jax64(fn, *args, **kw):
    with jax.enable_x64(True):
        out = fn(*args, dtype=jnp.float64, **kw)
        return [None if a is None else np.asarray(a) for a in out[:17]] + \
            list(out[17:])


@pytest.mark.parametrize("D", [2, 4, 8])
@pytest.mark.parametrize("block", [1, 4, 8])
def test_caviar_sharded_matches_jax(sim, D, block):
    kw = dict(iters=5, seed=0, sweep_block_size=block, **EXACT)
    want = _jax64(jax_caviar_sharded, *_args(sim), mesh=jax_trial_mesh(D),
                  **kw)
    got = caviar_sharded(*_args(sim), mesh=_cpu(D), dtype=torch.float64,
                         **kw)
    assert got[2].shape == (N, K) and got[7].shape == (K,)
    _close(got[:8], want[:8], CAVIAR)


@pytest.mark.parametrize("D", [2, 4, 8])
def test_cavi_sns_sharded_matches_jax(sim, D):
    args = (sim["psc"], sim["stim_matrix"],
            *_priors("mu", "beta", "alpha", "shape", "rate", "phi",
                     "phi_cov"))
    kw = dict(iters=4, seed=1, save_histories=D == 2, **EXACT)
    want = _jax64(jax_sns_sharded, *args, mesh=jax_trial_mesh(D), **kw)
    got = cavi_sns_sharded(*args, mesh=_cpu(D), dtype=torch.float64, **kw)
    _close(got[:8], want[:8], SNS)
    _close(got[8:], want[8:], [f"history_{n}" for n in SNS])


def _jax_mbcs_orders(seed, iters):
    """The row orders the JAX sharded MBCS draws from its key."""
    key, orders = jax.random.PRNGKey(seed), []
    for _ in range(iters):
        key, k_order, _ = jax.random.split(key, 3)
        orders.append(np.asarray(jax.random.permutation(k_order, N)))
    return orders


@pytest.mark.parametrize("D", [2, 4, 8])
def test_mbcs_sharded_matches_jax(sim, D, monkeypatch):
    args = (sim["psc"], sim["stim_matrix"],
            *_priors("mu", "beta", "shape", "rate"))
    kw = dict(iters=4, seed=0, analytic_noise=True, save_histories=D == 4)
    want = _jax64(jax_mbcs_sharded, *args, mesh=jax_trial_mesh(D), **kw)
    orders = iter(_jax_mbcs_orders(0, 4))
    monkeypatch.setattr(torch, "randperm", lambda n, **k: torch.as_tensor(
        next(orders).copy(), device=k.get("device")))
    got = mbcs_sharded(*args, mesh=_cpu(D), dtype=torch.float64, **kw)
    _close(got[:7], want[:7], MBCS)
    _close(got[7:], want[7:], [f"history_{n}" for n in MBCS[:6]])


def test_track_elbo_and_histories_match_jax(sim):
    kw = dict(iters=5, seed=0, sweep_block_size=4, save_histories=True,
              track_elbo=True, elbo_tol=1e-3, **EXACT)
    want = _jax64(jax_caviar_sharded, *_args(sim), mesh=jax_trial_mesh(4),
                  **kw)
    got = caviar_sharded(*_args(sim), mesh=_cpu(4), dtype=torch.float64,
                         **kw)
    _close(got[:8], want[:8], CAVIAR)
    _close(got[9:17], want[9:17], [f"history_{n}" for n in CAVIAR])
    assert got[11].shape == (5, N, K) and got[12].shape == (5, K)
    (elbos, stop), (jax_elbos, jax_stop) = got[17], want[17]
    assert stop == int(jax_stop)
    np.testing.assert_allclose(elbos, np.asarray(jax_elbos), rtol=RTOL)


def test_ragged_powers_match_jax(sim):
    """``powers=`` with a level the stim never uses (an empty bucket)
    skips the level scan, as in the JAX package."""
    kw = dict(iters=3, seed=0, powers=[45.0, 55.0, 65.0, 75.0], **EXACT)
    want = _jax64(jax_caviar_sharded, *_args(sim), mesh=jax_trial_mesh(8),
                  **kw)
    got = caviar_sharded(*_args(sim), mesh=_cpu(8), dtype=torch.float64,
                         **kw)
    _close(got[:8], want[:8], CAVIAR)


@pytest.mark.parametrize("block", [1, 8])
def test_one_shard_is_the_single_fit(sim, block):
    """At one shard the sharded loop is ``caviar()``'s fit at the same
    block size: the same random stream (row or block orders, Monte
    Carlo means), the same schedule and the same updates. Since the
    block schedule is the single fit's, a random-order sharded fit is
    the unsharded fit up to the reassociation of its sums."""
    kw = dict(iters=4, seed=3, verbose=False, dtype=torch.float64,
              sweep_block_size=block)
    single = caviar(*_args(sim), device="cpu", **kw)
    got = caviar_sharded(*_args(sim), mesh=_cpu(1), **kw)
    # block 1: the same algebra (1e-9); block 8: the residual's update
    # summed as a matrix-vector product, rounding apart
    _close(got[:8], single[:8], CAVIAR, rtol=1e-9 if block == 1 else RTOL,
           atol=1e-12)


@pytest.mark.parametrize("block,expected", [(1, N), (4, N // 4), (7, 6)])
def test_sweep_psums_once_a_block(block, expected):
    """The blocked sweep issues ceil(N/B) collectives a sweep (one
    [B, P+1] psum a block), the counterpart of the JAX package's
    trip-count check."""
    mesh = _cpu(4)
    rng = np.random.default_rng(0)
    ks = 16
    powers = torch.tensor([45.0, 55.0, 65.0], dtype=torch.float64)
    stim = torch.as_tensor(rng.choice([0.0, 45.0, 55.0, 65.0], (N, 4 * ks)))
    lam = torch.as_tensor(rng.uniform(0, 1, (N, 4 * ks))) * (stim > 0)
    rep = mesh.replicate
    sp = mesh.split(torch.cat([stim, torch.zeros(1, 4 * ks,
                                                 dtype=stim.dtype)]))
    args = (mesh.split(torch.as_tensor(rng.normal(0, 1, 4 * ks))), sp,
            rep(torch.as_tensor(rng.uniform(0, 3, N))),
            rep(torch.ones(N, dtype=torch.float64)), mesh.split(lam),
            rep(torch.tensor(1.0, dtype=torch.float64)),
            rep(torch.full((N,), 0.2, dtype=torch.float64)),
            rep(torch.full((N,), 10.0, dtype=torch.float64)),
            mesh.split(torch.ones(4 * ks, dtype=torch.float64)),
            rep(powers), rep(torch.stack([(stim == p).sum(1)
                                          for p in powers], 1).double()),
            rep(torch.arange(-(-N // block))),
            rep(torch.tensor(0.3, dtype=torch.float64)))
    mesh.reset_counts()
    out = sharded.sweep_spikes(mesh, *args, 3.0, True, block_size=block)
    assert mesh.psums == expected
    assert torch.cat(out, 1).shape == (N, 4 * ks)
    mesh.reset_counts()
    sharded.sweep_spikes(mesh, *args, 3.0, False, block_size=block)
    assert mesh.psums == 0  # gate off: no statistics are reduced


def test_mesh_contract(one_rank_group):
    """Equality and hashing follow the device list; psum sums in shard
    order and shares one tensor among the shards of a device; trial_mesh
    without devices keeps the device rule and JAX's count error."""
    a, b = _cpu(3), trial_mesh(devices=["cpu", "cpu", "cpu"])
    assert a == b and hash(a) == hash(b) and a != _cpu(2)
    assert a.size == 3 and a.distinct == (torch.device("cpu"),)
    parts = [torch.tensor([1.0, 2.0]) * (s + 1) for s in range(3)]
    out = a.psum(parts)
    assert all(o is out[0] for o in out)
    assert out[0].tolist() == [6.0, 12.0] and a.psums == 1
    assert a.gather(a.split(torch.arange(12.0))).tolist() == list(
        range(12))
    with pytest.raises(ValueError, match="split evenly"):
        a.split(torch.arange(10.0))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            trial_mesh(2)
    with pytest.raises(ValueError, match="one process"):
        caviar_sharded(*([None] * 8), mesh=TrialMesh(["cpu"], group=_Group()))


class _Group:
    """A stand-in process group of one rank (a mesh that names one is
    refused by the single-process entry points)."""


@pytest.fixture
def one_rank_group(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 0)


def test_float64_resolves_on_cuda_shards(sim):
    mesh = TrialMesh.__new__(TrialMesh)
    mesh.devices = (torch.device("cuda", 0),)
    assert sharded._fit_dtype(mesh, torch.float64) == torch.float64
    assert sharded._fit_dtype(mesh, "float64") == torch.float64
    assert sharded._fit_dtype(mesh, np.float32) == torch.float32
    with pytest.raises(TypeError, match="float32 or float64"):
        sharded._fit_dtype(mesh, torch.float16)
    mesh.devices = (torch.device("cpu"),)
    assert sharded._fit_dtype(mesh, torch.float16) == torch.float16
