"""CAVIaR: coordinate-ascent variational inference with isotonic
regularisation (port of ``circuitmap_tpu/solvers/caviar.py``).

Infers, from PSC charges ``y`` [K] and a stimulus matrix ``stim``
[N, K]: weight posterior means ``mu`` and covariance diagonals ``beta``
[N], spike posteriors ``lam`` [N, K], the gamma noise posterior
``shape, rate``, the power-curve posteriors ``phi, phi_cov`` and the
spontaneous activity ``z`` [K].

Each of the ``iters`` iterations runs, on the fit's device: the Gaussian
weight update (Cholesky plus one triangular solve), the truncated-normal
power-curve means, one spike sweep, the noise update, the bucket
statistics with the Laplace refit of phi, and the soft-threshold
spontaneous update. On CUDA the sweep is the cluster kernel at 8 rows
a step (ops/sweep_cuda.py) or, at block 1, at one row a step
(ops/sweep_row_cuda.py), and the refit the Laplace kernel
(ops/laplace_cuda.py); on the CPU their plain versions run, with the
reference's strictly sequential sweep (block 1) by default. The loop
needs no host read; the reconnection scan after it reads one flag per
reconnection.

The updates and the loop take one experiment ([K] charges, [N, K]
spikes) or a stack of independent experiments with a leading axis
([E, K], [E, N, K]): the batched fits (solvers/batched.py) run the same
loop, with one random stream per experiment and the batched kernels.

Random streams are a ``torch.Generator`` seeded from ``seed``; they
cannot reproduce ``jax.random``, so cross-package parity runs use
``update_order="identity"`` with ``analytic_mc=True``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from .._device import highest_matmul, resolve_device, torch_dtype
from ..ops.charge import prepare_observations
from ..ops.pava import isotonic_fit_at_max_batched
from ..ops.sweep_cuda import (_sweep_row_blocks,
                              sweep_spikes_blocked,
                              sweep_spikes_blocked_batched)
from ..ops.sweep_row_cuda import (sweep_spikes_row, sweep_spikes_row_batched,
                                  sweep_spikes_row_torch)
from ..ops.truncnorm import sample_truncated_normal, truncated_normal_mean
from ..utils.profiling import span
from ._common import (prepare_stim_and_init, prepare_traces,
                      stim_upload_plan, warn_data_thin_design,
                      warn_single_chip_envelope)
from ._laplace import laplace_phi_update, resolve_laplace_impl
from .diagnostics import elbo_device

SWEEP_IMPLS = ("auto", "cuda")
CUDA_BLOCK_SIZE = 8


class CaviarState(NamedTuple):
    """The fit loop's state after an iteration: the posteriors and the
    spontaneous rate that the next iteration's gate adds to ``msrmp``.
    One experiment, or a stack with a leading axis. The random stream is
    not part of it: it is the caller's ``torch.Generator``, which carries
    across calls."""
    mu: torch.Tensor
    beta: torch.Tensor
    lam: torch.Tensor
    shape: torch.Tensor
    rate: torch.Tensor
    phi: torch.Tensor
    phi_cov: torch.Tensor
    z: torch.Tensor
    spont_rate: torch.Tensor


# ---------------------------------------------------------------------------
# Individual CAVI updates
# ---------------------------------------------------------------------------


def _mv(A, x):
    """[..., N, K] @ [..., K] -> [..., N] in full float32; one
    experiment takes the plain matrix-vector product."""
    with highest_matmul():
        if x.dim() == 1:
            return A @ x
        return (A @ x[..., None])[..., 0]


def _each_expt(fn, *arrays):
    """``fn`` on each experiment's slices of [E, ...] arrays, stacked (a
    tuple of results stacks element by element): the single fit's own
    products and reductions, so a batched loop that takes them rounds as
    the sequential one does."""
    outs = [fn(*(a[b] for a in arrays)) for b in range(arrays[0].shape[0])]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(x) for x in zip(*outs))
    return torch.stack(outs)


def _vm(x, A):
    """[..., N] @ [..., N, K] -> [..., K] in full float32."""
    with highest_matmul():
        if x.dim() == 1:
            return x @ A
        return (x[..., None, :] @ A)[..., 0, :]


def update_weights(y, lam, shape, rate, mu_prior, beta_prior):
    """Blocked Gaussian update of all weights: solves the N x N normal
    equations by Cholesky; returns the posterior mean and the covariance
    diagonal. The Gram matrix runs in full float32 (no TF32)."""
    N = lam.shape[-2]
    sig = torch.as_tensor(shape / rate)[..., None]  # [..., 1]
    with highest_matmul():
        gram = lam @ lam.mT
    lam_y = _mv(lam, y)
    soft_var = torch.sum(lam * (1.0 - lam), dim=-1)
    prior_prec = 1.0 / (beta_prior * beta_prior)
    M = sig[..., None] * gram + torch.diag_embed(sig * soft_var + prior_prec)
    rhs = sig * lam_y + mu_prior * prior_prec
    chol, _ = torch.linalg.cholesky_ex(M)  # no host sync on the info flag
    eye = torch.eye(N, dtype=lam.dtype, device=lam.device)
    # diag(M^-1) = column sums of (L^-1)^2: one triangular solve
    Linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    mean = _mv(Linv.mT, _mv(Linv, rhs))
    return mean, torch.sum(Linv * Linv, dim=-2)


def update_noise(y, mu, beta, lam, shape_prior, rate_prior, k_true=None):
    """Gamma noise posterior (shape, rate). ``k_true``: the real trial
    count (a number or an [E] tensor) when the arrays carry inert padded
    columns; the shape term counts trials."""
    K = y.shape[-1] if k_true is None else k_true
    pred = _vm(mu, lam)
    row_lam = torch.sum(lam, dim=-1)
    row_lam2 = torch.sum(lam * lam, dim=-1)
    rate = rate_prior + 0.5 * (
        torch.sum(torch.square(y - pred), dim=-1)
        - torch.sum(mu * mu * row_lam2, dim=-1)
        + torch.sum((mu * mu + beta * beta) * row_lam, dim=-1))
    # one shape per experiment, like rate
    return torch.as_tensor(shape_prior + 0.5 * K).expand(rate.shape), rate


def powercurve_logit_means(generator, phi, phi_cov, num_mc_samples, analytic):
    """E[phi] under the zero-truncated power-curve posterior, per neuron
    (the covariance diagonal is the sampling scale, as in the
    reference). Monte Carlo from ``generator``, or exact with
    ``analytic=True``. Returns (m0 [N], m1 [N])."""
    scale = torch.diagonal(phi_cov, dim1=-2, dim2=-1)  # [N, 2]
    if analytic:
        m = truncated_normal_mean(phi, scale)
        return m[:, 0], m[:, 1]
    samps = sample_truncated_normal(generator, phi.T, scale.T, num_mc_samples)
    m = torch.mean(samps, dim=0)  # [2, N]
    return m[0], m[1]


def power_counts_of(stim, powers, dtype):
    """[..., N, P] trials per neuron per power."""
    return torch.stack([torch.sum(stim == powers[p], dim=-1)
                        for p in range(powers.shape[0])], dim=-1).to(dtype)


def sweep_spikes(y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers, order,
                 msrmp_eff, minimum_spike_count, gate_active, block_size=1):
    """Plain coordinate-ascent sweep over all N spike-posterior rows in
    the row order ``order``, with the signature of the JAX package's
    ``sweep_spikes``. block_size=1 is the reference's update order, the
    plain row sweep (``sweep_spikes_row_torch``). ``block_size`` > 1
    updates that many consecutive entries of ``order`` per step from
    the shared block-start residual (Jacobi within a block,
    Gauss-Seidel across); the blocked kernel's ``border`` is the case
    where each block is 8 consecutive rows."""
    counts = power_counts_of(stim, powers, lam.dtype)
    if block_size == 1:
        return sweep_spikes_row_torch(y, stim, mu, beta, lam, sig, m0, m1,
                                      lam_mask, powers, counts, order,
                                      msrmp_eff, minimum_spike_count,
                                      gate_active)
    N = lam.shape[0]
    nb = -(-N // block_size)
    fill = torch.full((nb * block_size - N,), N, dtype=torch.long,
                      device=lam.device)
    blocks = torch.cat([order.to(torch.long), fill]).reshape(nb, block_size)
    return _sweep_row_blocks(
        y[None], stim[None], mu[None], beta[None], lam[None], sig, m0[None],
        m1[None], lam_mask[None], powers, counts[None], blocks[None],
        msrmp_eff, minimum_spike_count, gate_active)[0]


def update_spontaneous(y, mu, lam, z, it, penalty, lam_mask, scale_factor,
                       tol, orthogonality, max_iters):
    """Soft-threshold estimate of per-trial spontaneous activity.

    The reference seeds its loop counter with the CAVI iteration index
    ``it`` and its error with ``sum(y)``, so iteration ``it`` runs at
    most ``max_iters - it`` shrink steps (none from ``it >= max_iters``,
    and ``z`` then stays as it was). Those trips run here as a fixed
    masked loop: a step that the reference's ``err > tol`` test would
    not take leaves the state unchanged, without a host read.
    """
    resid = y - _vm(mu, lam)
    explained = torch.any(lam >= orthogonality, dim=-2)
    denom = torch.sum(y * y, dim=-1) + 1e-5
    err = torch.sum(y, dim=-1)
    pen = torch.full(err.shape, float(penalty), dtype=y.dtype,
                     device=y.device)
    for _ in range(max(0, int(max_iters) - int(it))):
        live = err > tol
        z_new = torch.where(resid < pen[..., None], 0.0,
                            resid - pen[..., None])
        z_new = torch.clamp(z_new, min=0.0)
        z_new = torch.where(explained, 0.0, z_new) * lam_mask
        err_new = torch.sum(torch.square(resid - z_new), dim=-1) / denom
        z = torch.where(live[..., None], z_new, z)
        err = torch.where(live, err_new, err)
        pen = torch.where(live, pen * scale_factor, pen)
    return z


# ---------------------------------------------------------------------------
# The fit loop
# ---------------------------------------------------------------------------


def _each_stream(generators, fn, stacked):
    """``fn(generator, b)`` for each experiment's random stream, stacked
    on a leading axis when ``stacked`` (a stack of experiments, of any
    count); a single fit's one stream is not stacked."""
    if not stacked:
        return fn(generators[0], None)
    return torch.stack([fn(g, b) for b, g in enumerate(generators)])


_SWEEPS = {  # (strictly sequential, experiment axis) -> sweep wrapper
    (True, False): sweep_spikes_row, (True, True): sweep_spikes_row_batched,
    (False, False): sweep_spikes_blocked,
    (False, True): sweep_spikes_blocked_batched,
}


def _run_caviar(y, stim, lam0, lam_mask, powers, power_counts, hyper,
                generators, *, iters, num_mc_samples, minimum_spike_count,
                delay_spont_est, msrmp, scale_factor, penalty,
                max_backtrack_iters, tol, spont_orthogonality, analytic_mc,
                save_histories, sweep_block_size, update_order, k_true=None,
                track_elbo=False, elbo_tol=None, init_state=None,
                start_iter=0, spont_seed_cap=None):
    """The fit loop over one experiment (y [K], stim [N, K], one
    generator) or E of them (y [E, K], stim [E, N, K], E generators,
    the batched sweep kernels). ``k_true``: None, the real trial count
    (a number) of one experiment, or the real trial counts [E] of a
    stack, when the arrays carry inert padded columns (zero traces, stim
    and mask); the places that count trials use it.

    Warm starts (the resumable and streaming fits): ``init_state`` (a
    :class:`CaviarState`) replaces the priors and ``lam0`` as the
    starting point; the iterations are numbered from ``start_iter``,
    which sets the gate's delay (``it > delay_spont_est``) and the
    spontaneous update's trips; ``spont_seed_cap`` caps the index that
    seeds those trips (``min(it, cap)``). Segments run with the same
    generators one after another give the one-shot fit.

    ``track_elbo`` (one experiment): the bound after each iteration
    (``diagnostics.elbo_device``), returned third as ``(elbos [iters],
    stop_at)``, else None. With ``elbo_tol``, ``stop_at`` is the first
    iteration after ``start_iter`` whose bound moved by less than
    ``elbo_tol`` relative to the one before (one host read an
    iteration): the state freezes there, and the remaining history and
    bound slots repeat the frozen values. It is ``start_iter + iters``
    when that never happens.

    Returns (final :class:`CaviarState`, the per-iteration (mu, beta,
    lam, shape, rate, phi, phi_cov, z) when ``save_histories``, the
    bound or None)."""
    mu_prior, beta_prior, shape_prior, rate_prior, phi_prior, phi_cov_prior = hyper
    N, K = stim.shape[-2:]
    lead = y.shape[:-1]  # () for one experiment, (E,) for a stack
    dev = y.device
    B = sweep_block_size
    sweep = _SWEEPS[B == 1, bool(lead)]
    if B != 1:
        sweep = functools.partial(sweep, block_size=B)
    n_slots = N if B == 1 else -(-N // B)  # rows, or blocks incl. padding
    k_count = K if k_true is None else k_true
    if init_state is None:
        init_state = CaviarState(
            mu_prior, beta_prior, lam0, shape_prior, rate_prior,
            phi_prior.expand(*lead, N, 2),
            phi_cov_prior.expand(*lead, N, 2, 2),
            torch.zeros(*lead, K, dtype=y.dtype, device=dev),
            torch.zeros(lead, dtype=y.dtype, device=dev))
    mu, beta, lam, shape, rate, phi, phi_cov, z, spont_rate = init_state
    end = start_iter + iters
    snaps, elbos, stop_at = [], [], end
    for it in range(start_iter, end):
        mu, beta = update_weights(y, lam, shape, rate, mu_prior, beta_prior)
        if update_order == "identity":
            order = torch.arange(n_slots, device=dev).expand(*lead, n_slots)
        else:
            order = _each_stream(generators, lambda g, b: torch.randperm(
                n_slots, generator=g, device=dev), bool(lead))
        m0, m1 = _each_stream(generators, lambda g, b: torch.stack(
            powercurve_logit_means(
                g, phi if b is None else phi[b],
                phi_cov if b is None else phi_cov[b], num_mc_samples,
                analytic_mc)), bool(lead)).unbind(-2)
        sig = shape / rate
        gate_active = float(it > delay_spont_est)
        lam = sweep(y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
                    power_counts, order, msrmp + spont_rate,
                    minimum_spike_count, gate_active)
        shape, rate = update_noise(y, mu, beta, lam, shape_prior, rate_prior,
                                   k_true)
        phi, phi_cov = laplace_phi_update(lam, stim, phi_prior, phi_cov_prior,
                                          powers=powers, total_trials=k_count,
                                          counts=power_counts)
        spont_it = it if spont_seed_cap is None else min(it, spont_seed_cap)
        z = update_spontaneous(y, mu, lam, z, spont_it, penalty, lam_mask,
                               scale_factor, tol, spont_orthogonality,
                               max_backtrack_iters)
        spont_rate = torch.sum((z != 0.0).to(y.dtype), dim=-1) / k_count
        if save_histories:
            snaps.append((mu, beta, lam, shape, rate, phi, phi_cov, z))
        if track_elbo:
            elbos.append(elbo_device(y, stim, dict(
                mu=mu, beta=beta, lam=lam, shape=shape, rate=rate, phi=phi,
                z=z), hyper, k_count))
            if elbo_tol is not None and it > start_iter:
                prev = elbos[-2]
                rel = torch.abs(elbos[-1] - prev) / torch.clamp(
                    torch.abs(prev), min=1e-12)
                if bool(rel < elbo_tol):
                    stop_at = it
                    break
    if stop_at < end:  # the frozen iterations repeat the state
        frozen = end - 1 - stop_at
        snaps += snaps[-1:] * frozen
        elbos += elbos[-1:] * frozen
    elbo_out = ((torch.stack(elbos).cpu().numpy(), stop_at) if track_elbo
                else None)
    final = CaviarState(mu, beta, lam, shape, rate, phi, phi_cov, z,
                        spont_rate)
    return final, snaps, elbo_out


# ---------------------------------------------------------------------------
# Post-fit false-negative reconnection scan
# ---------------------------------------------------------------------------


def _reconnect_scan_device(stim, lam, mu, beta, z, powers, msrmp,
                           minimum_spike_count):
    """Greedy reconnection of cells inferred disconnected whose stim
    trials coincide with spontaneous events (reference
    ``reconnect_spont_cells``): while more than ``minimum_spike_count``
    events remain, the candidate (mu == 0) with the most events among
    those whose isotonic event rate at max power clears ``msrmp`` and
    whose event count clears the minimum is reconnected — mu the mean
    of its events, beta their standard error (NaN for one event), its
    lam set to 1 there — and absorbs them. Ties go to the lowest index.
    Runs on the tensors' device; one host read per reconnection.
    Returns (mu, beta, lam, z, n_reconnected).
    """
    dtype = lam.dtype
    P = powers.shape[0]
    mu, beta, lam, z = mu.clone(), beta.clone(), lam.clone(), z.clone()

    def hits_of(vec):  # [K] membership -> [N, P] event counts
        with highest_matmul():
            return torch.stack([(stim == powers[p]).to(dtype) @ vec
                                for p in range(P)], dim=1)

    counts = power_counts_of(stim, powers, dtype)
    z_nz = (z != 0.0).to(dtype)
    candidate = mu == 0.0
    hits = hits_of(z_nz)
    n_rec = 0
    while True:
        rates = torch.where(counts > 0, hits / torch.clamp(counts, min=1.0),
                            0.0)
        iso = isotonic_fit_at_max_batched(rates)
        n_events = torch.sum(hits, dim=1)
        ok = candidate & (iso >= msrmp) & (n_events >= minimum_spike_count)
        n = torch.argmax(torch.where(ok, n_events, -1.0))
        go, more = torch.stack([ok.any(),
                                torch.sum(z_nz) > minimum_spike_count]).tolist()
        if not (go and more):
            break
        locs = ((stim[n] != 0.0) & (z_nz > 0)).to(dtype)
        c = torch.sum(locs)
        c_safe = torch.clamp(c, min=1.0)
        mean = torch.sum(z * locs) / c_safe
        var = torch.sum(torch.square(z - mean) * locs) / torch.clamp(c - 1.0,
                                                                     min=1.0)
        mu[n] = mean
        beta[n] = torch.where(c > 1.0, torch.sqrt(var / c_safe),
                              torch.full_like(c, float("nan")))
        lam[n] = torch.where(locs > 0, 1.0, lam[n])
        z = torch.where(locs > 0, 0.0, z)
        z_nz = z_nz * (1.0 - locs)
        candidate[n] = False
        hits = hits - hits_of(locs)
        n_rec += 1
    return mu, beta, lam, z, n_rec


def reconnect_from_spontaneous(y, stim, lam, mu, beta, z, msrmp=0.3,
                               minimum_spike_count=3, powers=None,
                               power_counts=None, verbose=False):
    """The reconnection scan with the signature of the JAX package's
    ``reconnect_from_spontaneous``: :func:`_reconnect_scan_device` on
    lam's device (the CPU for a numpy lam). ``powers`` defaults to the
    nonzero levels of ``stim``; ``y`` and ``power_counts`` are accepted
    for the signature (the scan counts trials from ``stim``). Results
    come back as lam came: tensors, or numpy arrays. Returns (mu, beta,
    lam, z, reconnected).
    """
    del y, power_counts
    as_numpy = not isinstance(lam, torch.Tensor)
    lam = torch.as_tensor(np.asarray(lam)) if as_numpy else lam
    stim, mu, beta, z = (_as(a, lam.dtype, lam.device)
                         for a in (stim, mu, beta, z))
    if powers is None:
        powers = torch.unique(stim)[1:]
    else:
        powers = torch.sort(_as(powers, lam.dtype, lam.device)).values
    mu, beta, lam, z, n_rec = _reconnect_scan_device(
        stim, lam, mu, beta, z, powers, float(msrmp),
        float(minimum_spike_count))
    if verbose:
        print(f"Reconnected {n_rec} neurons previously attributed to "
              "spontaneous activity.")
    out = (mu, beta, lam, z)
    if as_numpy:
        out = tuple(a.cpu().numpy() for a in out)
    return (*out, n_rec > 0)


def _reconnect_and_refit(stim, lam, mu, beta, z, powers, phi, phi_cov,
                         phi_prior, phi_cov_prior, msrmp,
                         minimum_spike_count, total_trials=None):
    """Reconnection scan, then the power-curve refit if lam changed.
    ``total_trials``: the real trial count when the arrays carry inert
    padded columns (the streaming fit's capacity buffers); the scan is
    padding-proof, the refit's unstimulated bucket counts trials."""
    mu, beta, lam, z, n_rec = _reconnect_scan_device(
        stim, lam, mu, beta, z, powers, msrmp, minimum_spike_count)
    if n_rec:
        phi, phi_cov = laplace_phi_update(lam, stim, phi_prior, phi_cov_prior,
                                          powers=powers,
                                          total_trials=total_trials)
    return mu, beta, lam, z, phi, phi_cov, n_rec


# ---------------------------------------------------------------------------
# Public entry point
# ---------------------------------------------------------------------------


def _validate_update_order(update_order):
    if update_order not in ("random", "identity"):
        raise ValueError(
            f"update_order must be 'random' or 'identity', got "
            f"{update_order!r}")
    return update_order


def _resolve_sweep(sweep_impl, sweep_block_size, device, k=None):
    """The sweep's block size on ``device`` (only its type is read) for
    ``k`` trials, which no longer matters: the cluster kernel takes any
    K at any block size.

    'auto' is 8 on CUDA (the cluster kernel at 8 rows a step) and 1 on
    the CPU (the reference's strictly sequential schedule). A pinned size
    is honoured verbatim on every device (on CUDA, 1 is the strictly
    sequential schedule, and a block above 32 rows runs as sub-steps of
    one warp's rows against the block's residual).
    """
    if sweep_impl not in SWEEP_IMPLS:
        raise ValueError(
            f"sweep_impl must be one of {SWEEP_IMPLS}, got {sweep_impl!r} "
            "(the JAX package's 'xla' and 'pallas*' implementations do "
            "not exist in the port; both values dispatch by device)")
    on_cuda = device.type == "cuda"
    if sweep_block_size == "auto":
        return CUDA_BLOCK_SIZE if on_cuda else 1
    block = int(sweep_block_size)
    if block < 1:
        raise ValueError(f"sweep_block_size must be >= 1, got {block}")
    return block


def seeded_generator(seed, device):
    """The fit's random stream: a ``torch.Generator`` on ``device``."""
    generator = torch.Generator(device=device)
    generator.manual_seed(int(seed))
    return generator


def _as(a, dtype, device):
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(a, dtype=np.float64),
                           device=device).to(dtype)


def caviar(
    y_psc, stim, mu_prior, beta_prior, shape_prior, rate_prior, phi_prior,
    phi_cov_prior, iters=50, num_mc_samples=100, seed=0, y_xcorr_thresh=1e-2,
    minimum_spike_count=3, delay_spont_est=1, msrmp=0.3, scale_factor=0.75,
    penalty=5e0, save_histories=False, max_backtrack_iters=20, tol=0.05,
    spont_orthogonality=0.1, fn_scan=True, dtype=torch.float32,
    analytic_mc=False, sweep_block_size="auto", sweep_impl="auto",
    laplace_impl="auto", powers=None, update_order="random",
    track_elbo=False, elbo_tol=None, trace_wire=None, verbose=True,
    device=None,
):
    """Fit CAVIaR; the signature of ``circuitmap_tpu.solvers.caviar``
    plus ``device`` (None means CUDA; the package's device rule).

    Returns ``(mu, beta, lam, shape, rate, phi, phi_cov, z,
    receptive_fields, *eight history arrays)``: tensors on the fit's
    device, receptive_fields None, histories numpy arrays (shape and
    rate widened to [iters, K], the reference's layout) or None unless
    ``save_histories``.

    ``sweep_impl``/``laplace_impl`` take "auto" or "cuda" (both dispatch
    by device: the kernels on CUDA, in float32 or float64 as the fit's
    dtype, the plain versions on the CPU).

    ``sweep_block_size="auto"`` is 8 on CUDA at any K and 1 on the CPU;
    a pinned size is honoured on every device (``_resolve_sweep``), as
    is any number of power levels.

    ``track_elbo=True`` appends an 18th element ``(elbos [iters],
    converged_at)``: the evidence lower bound after each iteration
    (``diagnostics.elbo_device``). With ``elbo_tol`` the updates stop
    once the bound's relative change drops below it (``converged_at``
    is that iteration, else ``iters``); the remaining history and bound
    slots hold the frozen state, as the JAX package's frozen scan steps
    do. Each iteration then reads one flag on the host.
    """
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    block_size = _resolve_sweep(sweep_impl, sweep_block_size, dev,
                                k=np.shape(stim)[-1])
    resolve_laplace_impl(laplace_impl)
    update_order = _validate_update_order(str(update_order))
    if verbose:
        print("Running CAVIaR (PyTorch).")

    warn_single_chip_envelope(*np.shape(stim), what="caviar()", dtype=dtype,
                              device=dev)
    # the stim stage is two spans: the host sparsify, then (once the
    # observations' mask is known) the upload, the init, the priors and
    # the power counts
    with span("cm.fit.stim"):
        stim_np, plan = stim_upload_plan(stim, powers)
    with span("cm.fit.traces"):
        y_psc = prepare_traces(y_psc, dtype, dev, trace_wire=trace_wire)
        y, active = prepare_observations(y_psc, y_xcorr_thresh)
    with span("cm.fit.stim"):
        stim_t, lam_mask, lam0, _, _, powers_dev_np, pc_np = (
            prepare_stim_and_init(stim_np, active, dtype, dev, plan))
        warn_data_thin_design(pc_np, stim_t.shape[1], what="caviar()")
        powers_t = _as(powers_dev_np, dtype, dev)
        hyper = tuple(_as(a, dtype, dev) for a in (
            mu_prior, beta_prior, shape_prior, rate_prior, phi_prior,
            phi_cov_prior))
        power_counts = power_counts_of(stim_t, powers_t, dtype)
    with span("cm.fit.loop"):
        final, snaps, elbo_out = _run_caviar(
            y, stim_t, lam0, lam_mask, powers_t, power_counts, hyper,
            [seeded_generator(seed, dev)],
            iters=int(iters), num_mc_samples=int(num_mc_samples),
            minimum_spike_count=int(minimum_spike_count),
            delay_spont_est=int(delay_spont_est), msrmp=float(msrmp),
            scale_factor=float(scale_factor), penalty=float(penalty),
            max_backtrack_iters=int(max_backtrack_iters), tol=float(tol),
            spont_orthogonality=float(spont_orthogonality),
            analytic_mc=bool(analytic_mc),
            save_histories=bool(save_histories),
            sweep_block_size=block_size, update_order=update_order,
            track_elbo=bool(track_elbo),
            elbo_tol=None if elbo_tol is None else float(elbo_tol))
    mu, beta, lam, shape, rate, phi, phi_cov, z, _ = final

    if fn_scan:
        with span("cm.fit.scan"):
            mu, beta, lam, z, phi, phi_cov, n_rec = _reconnect_and_refit(
                stim_t, lam, mu, beta, z, powers_t, phi, phi_cov, hyper[4],
                hyper[5], float(msrmp), float(minimum_spike_count))
        if verbose:
            print(f"Reconnected {n_rec} neurons previously attributed to "
                  "spontaneous activity.")

    if save_histories:
        hist_arrs = [torch.stack([s[i] for s in snaps]).cpu().numpy()
                     for i in range(8)]
        k_hist = hist_arrs[7].shape[1]
        for i in (3, 4):  # scalar posteriors, stored broadcast to [iters, K]
            hist_arrs[i] = np.repeat(hist_arrs[i][:, None], k_hist, axis=1)
    else:
        hist_arrs = [None] * 8
    out = (mu, beta, lam, shape, rate, phi, phi_cov, z, None, *hist_arrs)
    if track_elbo:
        out = out + (elbo_out,)
    return out
