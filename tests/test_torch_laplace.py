"""The port's Laplace power-curve refit against the JAX package's.

``laplace_from_stats_torch`` (the plain version the CPU path runs) is
held against the XLA ``laplace_from_stats`` and against the Pallas
kernel it ports, ``laplace_from_stats_pallas(..., interpret=True)``, at
N=37 and P+1 in {2, 4, 6}; ``powercurve_stats`` against its JAX form
with and without ``counts=``/``total_trials=``.

Tolerance. Both packages run the same float32 algebra in another order
of operations. The 2x2 Hessian of closely spaced power levels is
ill-conditioned, which amplifies float32 rounding: on these inputs the
Pallas kernel itself sits up to 2.1e-4 (phi) and 4.4e-4 (cov) from the
float64 result, and the two JAX forms differ from each other by as
much. phi and cov are therefore compared per neuron, relative to the
neuron's largest entry, at PHI_RTOL = 5e-4 and COV_RTOL = 2e-3.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from circuitmap_tpu.ops.laplace_pallas import laplace_from_stats_pallas
from circuitmap_tpu.solvers import _laplace as jlap
from circuitmap_torch.ops import laplace_cuda
from circuitmap_torch.solvers import _laplace as tlap

N = 37
PHI_RTOL, COV_RTOL = 5e-4, 2e-3


def _stats(P1, seed=0):
    """Bucket statistics as a sweep produces them: C trials per bucket,
    S their summed spike posteriors near sigmoid(phi0 L - phi1)."""
    rng = np.random.default_rng(seed)
    levels = np.concatenate([[0.0], 45.0 + 10.0 * np.arange(P1 - 1)])
    C = rng.integers(20, 400, (N, P1)).astype(np.float64)
    C[:, 0] = rng.integers(2000, 8000, N)
    phi0 = rng.uniform(0.15, 0.3, N)
    phi1 = rng.uniform(8, 16, N)
    p = 1 / (1 + np.exp(-(phi0[:, None] * levels - phi1[:, None])))
    S = np.clip(C * p + rng.normal(0, 2, (N, P1)), 0, C)
    S[:3] *= 0.0  # never-spiking neurons pull phi against the barrier
    pp = np.tile([0.1, 5.0], (N, 1))
    pc = np.tile([[1e-1, 0.0], [0.0, 1e0]], (N, 1, 1))
    return [a.astype(np.float32) for a in (S, C, levels, pp, pc)]


def _rel(got, want, n=N):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want).reshape(n, -1).max(1)
    return d / np.abs(want).reshape(n, -1).max(1)


@pytest.mark.parametrize("P1", [2, 4, 6])
def test_plain_matches_xla_and_pallas_kernel(P1):
    args = _stats(P1, seed=P1)
    phi, cov = laplace_cuda.laplace_from_stats_torch(
        *map(torch.from_numpy, args))
    j = [jnp.asarray(a) for a in args]
    for name, (jphi, jcov) in {
            "xla": jlap.laplace_from_stats(*j),
            "pallas_interpret": laplace_from_stats_pallas(*j, interpret=True),
    }.items():
        assert _rel(phi, jphi).max() < PHI_RTOL, name
        assert _rel(cov, jcov).max() < COV_RTOL, name
    assert np.all(np.isfinite(phi.numpy())) and np.all(phi.numpy() > 0)


@pytest.mark.parametrize("P1", [2, 4, 6])
def test_plain_float64_matches_xla(P1):
    # float64 removes most of the rounding: the port in float64 sits
    # within float32 resolution of the JAX float32 result and agrees
    # with the port in float32 at the same per-neuron tolerance
    args = _stats(P1, seed=10 + P1)
    phi64, cov64 = laplace_cuda.laplace_from_stats_torch(
        *(torch.from_numpy(a.astype(np.float64)) for a in args))
    assert phi64.dtype == torch.float64
    jphi, jcov = jlap.laplace_from_stats(*map(jnp.asarray, args))
    assert _rel(phi64, jphi).max() < PHI_RTOL
    assert _rel(cov64, jcov).max() < COV_RTOL


def test_plain_matches_pallas_kernel_on_armijo_edge_cases():
    # lanes whose first accepted Armijo step spans every class the CUDA
    # kernel's lane-parallel search takes apart, up to no acceptance
    from test_torch_kernels import armijo_classes_present, armijo_lanes

    args = armijo_lanes()
    assert all(armijo_classes_present(args).values())
    phi, cov = laplace_cuda.laplace_from_stats_torch(*args)
    jphi, jcov = laplace_from_stats_pallas(
        *(jnp.asarray(a.numpy()) for a in args), interpret=True)
    n = args[0].shape[0]
    assert _rel(phi, jphi, n).max() < PHI_RTOL
    assert _rel(cov, jcov, n).max() < COV_RTOL


def test_batch_dims_flatten_like_the_custom_vmap_rule():
    # a leading experiment axis solves B*N independent neurons
    a, b = _stats(4, seed=1), _stats(4, seed=2)
    stacked = [torch.from_numpy(np.stack([x, y])) for x, y in zip(a, b)]
    stacked[2] = torch.from_numpy(a[2])  # the level table is shared
    phi, cov = laplace_cuda.laplace_from_stats_torch(*stacked)
    assert phi.shape == (2, N, 2) and cov.shape == (2, N, 2, 2)
    for i, args in enumerate((a, b)):
        p1, c1 = laplace_cuda.laplace_from_stats_torch(
            *map(torch.from_numpy, args))
        np.testing.assert_allclose(phi[i].numpy(), p1.numpy(), rtol=1e-6)
        np.testing.assert_allclose(cov[i].numpy(), c1.numpy(), rtol=1e-5,
                                   atol=1e-9)


def _lam_stim(seed=0, K=250):
    rng = np.random.default_rng(seed)
    stim = np.zeros((N, K))
    stim[rng.integers(0, N, 4 * K), np.repeat(np.arange(K), 4)] = rng.choice(
        [45.0, 55.0, 65.0], 4 * K)
    lam = np.where(stim > 0, rng.uniform(0, 1, (N, K)), 0.0)
    return lam.astype(np.float32), stim.astype(np.float32)


@pytest.mark.parametrize("mode", ["plain", "counts", "total_trials",
                                  "counts_and_total"])
def test_powercurve_stats_matches_jax(mode):
    lam, stim = _lam_stim()
    powers = np.array([45.0, 55.0, 65.0], np.float32)
    counts = np.stack([(stim == p).sum(1) for p in powers], 1).astype(
        np.float32)
    kw_t, kw_j = {}, {}
    if mode in ("counts", "counts_and_total"):
        kw_t["counts"], kw_j["counts"] = torch.from_numpy(counts), \
            jnp.asarray(counts)
    if mode in ("total_trials", "counts_and_total"):
        # more real trials than columns: bucket 0 takes the difference
        kw_t["total_trials"] = kw_j["total_trials"] = 300
    S, C, lev = tlap.powercurve_stats(torch.from_numpy(lam),
                                      torch.from_numpy(stim),
                                      torch.from_numpy(powers), **kw_t)
    jS, jC, jlev = jlap.powercurve_stats(jnp.asarray(lam), jnp.asarray(stim),
                                         jnp.asarray(powers), **kw_j)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(C.numpy(), np.asarray(jC))
    np.testing.assert_array_equal(lev.numpy(), np.asarray(jlev))
    total = kw_t.get("total_trials", lam.shape[1])
    np.testing.assert_array_equal(C.numpy().sum(1), total)


def test_laplace_phi_update_matches_jax():
    lam, stim = _lam_stim(1)
    pp = np.tile(np.float32([0.1, 5.0]), (N, 1))
    pc = np.tile(np.float32([[1e-1, 0.0], [0.0, 1e0]]), (N, 1, 1))
    phi, cov = tlap.laplace_phi_update(*map(torch.from_numpy,
                                            (lam, stim, pp, pc)))
    jphi, jcov = jlap.laplace_phi_update(*map(jnp.asarray,
                                              (lam, stim, pp, pc)))
    assert _rel(phi, jphi).max() < PHI_RTOL
    assert _rel(cov, jcov).max() < COV_RTOL


def test_wrapper_takes_plain_version_on_cpu():
    args = [torch.from_numpy(a) for a in _stats(4, seed=3)]
    before = laplace_cuda.laplace_from_stats.launches
    got = laplace_cuda.laplace_from_stats(*args)
    want = laplace_cuda.laplace_from_stats_torch(*args)
    assert laplace_cuda.laplace_from_stats.launches == before
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


@pytest.mark.parametrize("impl", ["xla", "pallas", "pallas_interpret",
                                  "triton"])
def test_laplace_impl_names(impl):
    assert tlap.resolve_laplace_impl("auto") == "auto"
    assert tlap.resolve_laplace_impl("cuda") == "cuda"
    with pytest.raises(ValueError, match="auto.*cuda"):
        tlap.resolve_laplace_impl(impl)


def test_batched_refit_matches_the_pallas_vmap_rule():
    # [B, N] bucket statistics against the Pallas kernel's custom-vmap
    # rule (B*N lanes in one call), in interpret mode
    import jax

    from circuitmap_tpu.ops.laplace_pallas import (
        laplace_from_stats_pallas_interpret_v)

    per = [_stats(4, seed=20 + b) for b in range(3)]
    stacked = [np.stack(x) for x in zip(*per)]
    levels = per[0][2]
    phi, cov = laplace_cuda.laplace_from_stats(
        *(torch.from_numpy(a) for a in
          (stacked[0], stacked[1], levels, stacked[3], stacked[4])))
    jphi, jcov = jax.vmap(laplace_from_stats_pallas_interpret_v,
                          in_axes=(0, 0, None, 0, 0))(
        jnp.asarray(stacked[0]), jnp.asarray(stacked[1]), jnp.asarray(levels),
        jnp.asarray(stacked[3]), jnp.asarray(stacked[4]))
    assert phi.shape == (3, N, 2) and cov.shape == (3, N, 2, 2)
    for b in range(3):
        assert _rel(phi[b], jphi[b]).max() < PHI_RTOL
        assert _rel(cov[b], jcov[b]).max() < COV_RTOL


def test_batched_phi_update_counts_each_experiments_trials():
    # a ragged stack: experiment b holds K_b real trials padded with
    # inert columns to the stack's K; bucket 0 counts the real ones
    from circuitmap_tpu.solvers.batched import _laplace_refit_many_kt

    lams, stims = zip(*(_lam_stim(seed=30 + b) for b in range(3)))
    lam, stim = np.stack(lams), np.stack(stims)
    ks = np.array([250, 210, 170])
    for b, kb in enumerate(ks):
        lam[b, :, kb:] = 0.0
        stim[b, :, kb:] = 0.0
    powers = np.float32([45.0, 55.0, 65.0])
    pp = np.tile(np.float32([0.1, 5.0]), (N, 1))
    pc = np.tile(np.float32([[1e-1, 0.0], [0.0, 1e0]]), (N, 1, 1))
    phi, cov = tlap.laplace_phi_update(
        *map(torch.from_numpy, (lam, stim, pp, pc)),
        powers=torch.from_numpy(powers),
        total_trials=torch.from_numpy(ks.astype(np.float32)))
    S, C, _ = tlap.powercurve_stats(torch.from_numpy(lam),
                                    torch.from_numpy(stim),
                                    torch.from_numpy(powers),
                                    total_trials=torch.from_numpy(ks))
    np.testing.assert_array_equal(C.numpy().sum(-1),
                                  np.broadcast_to(ks[:, None], (3, N)))
    jphi, jcov = _laplace_refit_many_kt(
        *map(jnp.asarray, (lam, stim, pp, pc, powers)),
        jnp.asarray(ks, jnp.float32))
    for b in range(3):
        assert _rel(phi[b], jphi[b]).max() < PHI_RTOL
        assert _rel(cov[b], jcov[b]).max() < COV_RTOL
