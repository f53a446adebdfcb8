"""The port's plain spike sweeps against the JAX package's.

The blocked sweep (``circuitmap_torch.ops.sweep_cuda``'s plain version,
which the CPU path runs) is held against the Pallas kernel it ports,
``sweep_spikes_pallas_dma_blocked`` in interpret mode, and against the
XLA blocked sweep ``sweep_spikes(block_size=8)``; the block-1 sweep
against ``sweep_spikes(block_size=1)``. N=29 leaves a partial padding
block and K=300 is not a multiple of 128. Both sides run in float32 on
the same numpy inputs: only the order of the reductions differs, hence
rtol 1e-5 / atol 1e-6.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from circuitmap_tpu.ops.sweep_pallas import sweep_spikes_pallas_dma_blocked
from circuitmap_tpu.solvers.caviar import sweep_spikes as jax_sweep_spikes
from circuitmap_torch.ops import sweep_cuda
from circuitmap_torch.solvers.caviar import sweep_spikes

N, K = 29, 300
POWERS = (45.0, 55.0, 65.0)
NB = -(-N // 8)
TOL = dict(rtol=1e-5, atol=1e-6)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    stim = np.zeros((N, K), np.float32)
    stim[rng.integers(0, N, 3 * K), np.repeat(np.arange(K), 3)] = rng.choice(
        POWERS, 3 * K)
    lam = np.where(stim > 0, rng.uniform(0, 1, (N, K)), 0).astype(np.float32)
    mu = np.where(rng.random(N) < 0.3, rng.uniform(5, 20, N), 0).astype(
        np.float32)
    y = (mu @ (rng.random((N, K)) < lam) + rng.normal(0, 1, K)).astype(
        np.float32)
    return dict(
        y=y, stim=stim, mu=mu, beta=rng.uniform(0.5, 2, N).astype(np.float32),
        lam=lam, m0=rng.uniform(0.2, 0.25, N).astype(np.float32),
        m1=rng.uniform(10, 15, N).astype(np.float32),
        lam_mask=(rng.random(K) > 0.05).astype(np.float32),
        powers=np.asarray(POWERS, np.float32),
        power_counts=np.stack([(stim == p).sum(1) for p in POWERS],
                              1).astype(np.float32))


SIG, MSRMP, MIN_COUNT = 0.1, 0.5, 3.0
ARGS = ("y", "stim", "mu", "beta", "lam")
ARGS2 = ("m0", "m1", "lam_mask", "powers")


def _port_blocked(d, border, gate):
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    return sweep_cuda.sweep_spikes_blocked_torch(
        *(t[k] for k in ARGS), SIG, *(t[k] for k in ARGS2), t["power_counts"],
        torch.from_numpy(border), MSRMP, MIN_COUNT, gate).numpy()


def _border(kind, padding_last):
    """A block order: identity, or a numpy permutation that puts the
    partial padding block last or in the middle."""
    if kind == "identity":
        return np.arange(NB)
    perm = np.random.default_rng(7).permutation(NB - 1)
    if padding_last:
        return np.concatenate([perm, [NB - 1]])
    return np.insert(perm, 1, NB - 1)


@pytest.mark.parametrize("gate", [0.0, 1.0], ids=["gate_off", "gate_on"])
@pytest.mark.parametrize("border_kind", ["identity", "permuted"])
def test_blocked_sweep_matches_pallas_kernel(gate, border_kind):
    d = _inputs()
    border = _border(border_kind, padding_last=False)
    got = _port_blocked(d, border, gate)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    want = sweep_spikes_pallas_dma_blocked(
        *(j[k] for k in ARGS), SIG, *(j[k] for k in ARGS2), j["power_counts"],
        jnp.asarray(border, jnp.int32), MSRMP, MIN_COUNT, gate,
        interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if gate:  # the gate really cut rows in this case
        assert ((got.sum(1) == 0) & (d["lam"].sum(1) > 0)).any()


@pytest.mark.parametrize("gate", [0.0, 1.0], ids=["gate_off", "gate_on"])
@pytest.mark.parametrize("border_kind", ["identity", "permuted"])
def test_blocked_sweep_matches_xla_blocked_sweep(gate, border_kind):
    # the XLA form pads its row order at the end, so the partial block
    # goes last here
    d = _inputs(1)
    border = _border(border_kind, padding_last=True)
    got = _port_blocked(d, border, gate)
    rows = (border[:, None] * 8 + np.arange(8)).ravel()
    order = rows[rows < N]
    j = {k: jnp.asarray(v) for k, v in d.items()}
    want = jax_sweep_spikes(
        *(j[k] for k in ARGS), SIG, *(j[k] for k in ARGS2),
        jnp.asarray(order), MSRMP, MIN_COUNT, bool(gate), block_size=8)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # the solver-level entry point (row order in, blocks formed inside)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    via_solver = sweep_spikes(
        *(t[k] for k in ARGS), SIG, *(t[k] for k in ARGS2),
        torch.from_numpy(order), MSRMP, MIN_COUNT, gate, block_size=8)
    np.testing.assert_allclose(via_solver.numpy(), got, rtol=0, atol=0)


@pytest.mark.parametrize("gate", [0.0, 1.0], ids=["gate_off", "gate_on"])
@pytest.mark.parametrize("block", [7, 12, 16])
def test_pinned_block_sweep_matches_xla_blocked_sweep(block, gate):
    """Every pinned size of 1..32 runs the cluster kernel on CUDA; its
    plain version at 7, 12 and 16 rows a step against the JAX package's
    XLA blocked sweep at the same block size and row order (the blocks
    are consecutive rows in a random block order, the partial block
    last, as in the test above)."""
    d = _inputs(5 + block)
    nb = -(-N // block)
    border = np.concatenate([np.random.default_rng(block).permutation(nb - 1),
                             [nb - 1]])
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    got = sweep_cuda.sweep_spikes_blocked_torch(
        *(t[k] for k in ARGS), SIG, *(t[k] for k in ARGS2), t["power_counts"],
        torch.from_numpy(border), MSRMP, MIN_COUNT, gate,
        block_size=block).numpy()
    rows = (border[:, None] * block + np.arange(block)).ravel()
    order = rows[rows < N]
    j = {k: jnp.asarray(v) for k, v in d.items()}
    want = jax_sweep_spikes(
        *(j[k] for k in ARGS), SIG, *(j[k] for k in ARGS2),
        jnp.asarray(order), MSRMP, MIN_COUNT, bool(gate), block_size=block)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    via_solver = sweep_spikes(
        *(t[k] for k in ARGS), SIG, *(t[k] for k in ARGS2),
        torch.from_numpy(order), MSRMP, MIN_COUNT, gate, block_size=block)
    np.testing.assert_allclose(via_solver.numpy(), got, rtol=0, atol=0)


@pytest.mark.parametrize("gate", [0.0, 1.0], ids=["gate_off", "gate_on"])
@pytest.mark.parametrize("block,n_levels", [(8, 24), (64, 3), (48, 24),
                                            (1, 24)])
def test_many_levels_and_long_blocks_match_xla_blocked_sweep(
        block, n_levels, gate):
    """The plain sweep at more power levels than the kernel's compile-time
    instances (24) and at blocks of more than one warp's rows (48, 64;
    the CUDA kernel runs them as sub-steps against the block's residual)
    against the JAX package's XLA blocked sweep at the same block size
    and row order, as above; N=150 leaves a partial last block."""
    n, k = 150, 600
    powers = 30.0 + 0.5 * np.arange(n_levels)
    rng = np.random.default_rng(block + n_levels)
    stim = np.zeros((n, k), np.float32)
    stim[rng.integers(0, n, 5 * k), np.repeat(np.arange(k), 5)] = rng.choice(
        powers, 5 * k)
    lam = np.where(stim > 0, rng.uniform(0, 1, (n, k)), 0).astype(np.float32)
    mu = np.where(rng.random(n) < 0.2, rng.uniform(5, 20, n), 0).astype(
        np.float32)
    d = dict(
        y=(mu @ (rng.random((n, k)) < lam) + rng.normal(0, 1, k)).astype(
            np.float32),
        stim=stim, mu=mu, beta=rng.uniform(0.5, 2, n).astype(np.float32),
        lam=lam, m0=rng.uniform(0.05, 0.08, n).astype(np.float32),
        m1=rng.uniform(1, 3, n).astype(np.float32),
        lam_mask=(rng.random(k) > 0.05).astype(np.float32),
        powers=powers.astype(np.float32),
        power_counts=np.stack([(stim == p).sum(1) for p in powers],
                              1).astype(np.float32))
    nb = -(-n // block)
    border = np.concatenate([rng.permutation(nb - 1), [nb - 1]])
    rows = (border[:, None] * block + np.arange(block)).ravel()
    order = rows[rows < n]
    t = {kk: torch.from_numpy(v) for kk, v in d.items()}
    got = sweep_spikes(*(t[kk] for kk in ARGS), SIG, *(t[kk] for kk in ARGS2),
                       torch.from_numpy(order), MSRMP, MIN_COUNT, gate,
                       block_size=block).numpy()
    j = {kk: jnp.asarray(v) for kk, v in d.items()}
    want = jax_sweep_spikes(
        *(j[kk] for kk in ARGS), SIG, *(j[kk] for kk in ARGS2),
        jnp.asarray(order), MSRMP, MIN_COUNT, bool(gate), block_size=block)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    if gate:  # the gate cut some rows and kept others
        kept = got.sum(1) > 0
        assert kept.any() and (~kept & (lam.sum(1) > 0)).any()


@pytest.mark.parametrize("gate", [0.0, 1.0], ids=["gate_off", "gate_on"])
def test_row_sweep_matches_xla_block1(gate):
    d = _inputs(2)
    order = np.random.default_rng(3).permutation(N)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    got = sweep_spikes(*(t[k] for k in ARGS), SIG, *(t[k] for k in ARGS2),
                       torch.from_numpy(order), MSRMP, MIN_COUNT, gate,
                       block_size=1)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    want = jax_sweep_spikes(*(j[k] for k in ARGS), SIG, *(j[k] for k in ARGS2),
                            jnp.asarray(order), MSRMP, MIN_COUNT, bool(gate),
                            block_size=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_blocked_sweep_float64_matches_float32():
    # the plain version is dtype-generic: float64 agrees with float32 to
    # float32 rounding (no gate flips at these inputs)
    d = _inputs(4)
    border = _border("permuted", padding_last=False)
    got32 = _port_blocked(d, border, 1.0)
    d64 = {k: v.astype(np.float64) for k, v in d.items()}
    got64 = _port_blocked(d64, border, 1.0)
    assert got64.dtype == np.float64
    np.testing.assert_allclose(got32, got64, rtol=1e-5, atol=1e-6)


def test_wrapper_takes_plain_version_on_cpu():
    d = _inputs(5)
    border = _border("permuted", padding_last=False)
    t = {k: torch.from_numpy(v) for k, v in d.items()}
    before = sweep_cuda.sweep_spikes_blocked.launches
    got = sweep_cuda.sweep_spikes_blocked(
        *(t[k] for k in ARGS), SIG, *(t[k] for k in ARGS2), t["power_counts"],
        torch.from_numpy(border), MSRMP, MIN_COUNT, 1.0)
    assert sweep_cuda.sweep_spikes_blocked.launches == before
    np.testing.assert_array_equal(got.numpy(), _port_blocked(d, border, 1.0))
