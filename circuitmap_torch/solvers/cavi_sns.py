"""CAVI-SnS: spike-and-slab variational inference (port of
``circuitmap_tpu/solvers/cavi_sns.py``).

The baseline solver beside CAVIaR: an explicit per-neuron connection
probability ``alpha``, no isotonic gate and no spontaneous-activity
model. Each iteration runs three sequential coordinate sweeps (mu,
alpha, lam), each with a running residual ``r = (mu * alpha) @ lam``,
then the gamma noise update and the Laplace refit of the power curves.

The lam sweep is the CAVIaR row sweep (``ops/sweep_row_cuda.py``: the
cluster kernel at one row a step on CUDA, its plain version on the CPU)
with the weights ``mu * alpha``, the slab scale ``beta_eff`` below, a
gate threshold of -1 (the isotonic fit of non-negative rates never
falls below it, so only the spike-count gate acts) and the gate on. The
mu and alpha sweeps are plain PyTorch on the fit's device, one row
after another: the row order is read to the host once a sweep and each
row is a few small launches, with no host read.

``_run_sns_many`` runs the loop over a stack of independent experiments
(``sns_many``'s batched mode, solvers/batched.py): the lam sweep is one
launch of the batched row kernel, the refit one batched Laplace launch,
and the mu and alpha sweeps visit position i of every experiment's
order at once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import resolve_device, torch_dtype
from ..ops.charge import integrated_charge
from ..ops.sweep_row_cuda import sweep_spikes_row
from ._common import (prepare_stim, prepare_traces, stim_upload_plan,
                      warn_data_thin_design_dense)
from ._laplace import laplace_phi_update, resolve_laplace_impl
from ..ops.sweep_row_cuda import sweep_spikes_row_batched
from .caviar import (_as, _each_expt, _each_stream, _mv,
                     _validate_update_order, _vm, power_counts_of,
                     powercurve_logit_means, seeded_generator)

EPS = 1e-10


class SnsState(NamedTuple):
    mu: torch.Tensor
    beta: torch.Tensor
    alpha: torch.Tensor
    lam: torch.Tensor
    shape: torch.Tensor
    rate: torch.Tensor
    phi: torch.Tensor
    phi_cov: torch.Tensor


def update_slab_scale(alpha, lam, shape, rate, beta_prior):
    """Closed-form beta update."""
    return 1.0 / torch.sqrt(alpha * torch.sum((shape / rate) * lam, dim=1)
                            + 1.0 / (beta_prior * beta_prior))


def _host_order(order):
    return [int(n) for n in order.tolist()]


# The mu and alpha sweeps visit one row at a time. Every per-row scalar
# that does not depend on the residual is computed for all rows before
# the loop (a row's own mu and alpha are read before the row updates
# them), so each row costs six to eight small launches; the sums are
# the reference's, grouped so that fused multiply-adds can take them.


def sweep_means(y, mu, beta, alpha, lam, sig, mu_prior, beta_prior, order):
    """Sequential mu coordinate sweep with a running residual."""
    w = mu * alpha
    r = _vm(w, lam)
    beta2 = beta * beta
    # new mu[n] = beta^2 (alpha ylam + prior - alpha sig lam[n].r_excl)
    base = beta2 * (alpha * _mv(lam, sig * y) + mu_prior / (beta_prior
                                                            * beta_prior))
    slope = beta2 * (alpha * sig)
    mu = mu.clone()
    for n in _host_order(order):
        lam_n = lam[n]
        r_excl = torch.addcmul(r, w[n], lam_n, value=-1.0)
        new = torch.addcmul(base[n], slope[n], torch.dot(lam_n, r_excl),
                            value=-1.0)
        r = torch.addcmul(r_excl, new * alpha[n], lam_n)
        mu[n] = new
    return mu


def sweep_connection_probs(y, mu, beta, alpha, lam, sig, alpha_prior, order):
    """Sequential alpha coordinate sweep with a running residual."""
    w = mu * alpha
    r = _vm(w, lam)
    prior_logit = torch.log((alpha_prior + EPS) / (1.0 - alpha_prior + EPS))
    # quad[n] = -2 mu ydot + (mu^2 + beta^2) lam_sum + 2 mu lam[n].r_excl
    base = (-2.0 * mu * _mv(lam, y)
            + (mu * mu + beta * beta) * torch.sum(lam, dim=1))
    two_mu = 2.0 * mu
    half_sig = 0.5 * sig
    alpha = alpha.clone()
    for n in _host_order(order):
        lam_n = lam[n]
        r_excl = torch.addcmul(r, w[n], lam_n, value=-1.0)
        quad = torch.addcmul(base[n], two_mu[n], torch.dot(lam_n, r_excl))
        new = torch.sigmoid(torch.addcmul(prior_logit[n], half_sig, quad,
                                          value=-1.0))
        r = torch.addcmul(r_excl, mu[n] * new, lam_n)
        alpha[n] = new
    return alpha


def _sweep_means_many(y, mu, beta, alpha, lam, sig, mu_prior, beta_prior,
                      orders):
    """:func:`sweep_means` over a stack ([E, ...] arrays, ``sig`` [E] or
    shared, ``orders`` [E, N]): step i updates row ``orders[e, i]`` of
    every experiment e, from its own residual. Products and dots are
    taken experiment by experiment (the single sweep's own), the rest
    over the stack at once."""
    E, N = mu.shape
    ex = torch.arange(E, device=mu.device)
    sig = torch.as_tensor(sig).expand(E)[:, None]
    w = mu * alpha
    r = _each_expt(_vm, w, lam)
    beta2 = beta * beta
    base = beta2 * (alpha * _each_expt(_mv, lam, sig * y)
                    + mu_prior / (beta_prior * beta_prior))
    slope = beta2 * (alpha * sig)
    mu = mu.clone()
    for i in range(N):
        n = orders[:, i]
        lam_n = lam[ex, n]
        r_excl = torch.addcmul(r, w[ex, n][:, None], lam_n, value=-1.0)
        new = torch.addcmul(base[ex, n], slope[ex, n],
                            _each_expt(torch.dot, lam_n, r_excl), value=-1.0)
        r = torch.addcmul(r_excl, (new * alpha[ex, n])[:, None], lam_n)
        mu[ex, n] = new
    return mu


def _sweep_connection_probs_many(y, mu, beta, alpha, lam, sig, alpha_prior,
                                 orders):
    """:func:`sweep_connection_probs` over a stack, as
    :func:`_sweep_means_many`."""
    E, N = mu.shape
    ex = torch.arange(E, device=mu.device)
    w = mu * alpha
    r = _each_expt(_vm, w, lam)
    prior_logit = torch.log((alpha_prior + EPS) / (1.0 - alpha_prior + EPS))
    base = (-2.0 * mu * _each_expt(_mv, lam, y)
            + (mu * mu + beta * beta)
            * _each_expt(lambda a: torch.sum(a, dim=1), lam))
    two_mu = 2.0 * mu
    half_sig = 0.5 * torch.as_tensor(sig).expand(E)
    alpha = alpha.clone()
    for i in range(N):
        n = orders[:, i]
        lam_n = lam[ex, n]
        r_excl = torch.addcmul(r, w[ex, n][:, None], lam_n, value=-1.0)
        quad = torch.addcmul(base[ex, n], two_mu[ex, n],
                             _each_expt(torch.dot, lam_n, r_excl))
        new = torch.sigmoid(torch.addcmul(prior_logit[n], half_sig, quad,
                                          value=-1.0))
        r = torch.addcmul(r_excl, (mu[ex, n] * new)[:, None], lam_n)
        alpha[ex, n] = new
    return alpha


def sweep_spikes_sns(y, stim, mu, beta, alpha, lam, sig, m0, m1, lam_mask,
                     order, minimum_spike_count, powers=None,
                     power_counts=None):
    """Sequential lam sweep: rows whose total posterior mass falls below
    ``minimum_spike_count`` are zeroed (no isotonic gate in this solver).

    Runs the CAVIaR row sweep (the kernel on CUDA) with the weights
    ``mu * alpha`` and the slab scale ``beta_eff = sqrt(alpha * (mu^2 *
    (1 - alpha) + beta^2))``, for which ``w^2 + beta_eff^2`` is the SnS
    quadratic term ``(mu^2 + beta^2) * alpha``, and the gate threshold
    -1. ``powers`` and ``power_counts`` (the stim's levels and the
    trials per neuron per level, loop-invariant in a fit) default to
    those of ``stim``.
    """
    if powers is None:
        powers = torch.unique(stim)[1:]
    if power_counts is None:
        power_counts = power_counts_of(stim, powers, lam.dtype)
    w, beta_eff = row_sweep_weights(mu, beta, alpha)
    return sweep_spikes_row(y, stim, w, beta_eff, lam, sig, m0, m1, lam_mask,
                            powers, power_counts, order, -1.0,
                            minimum_spike_count, 1.0)


def row_sweep_weights(mu, beta, alpha):
    """The CAVIaR row sweep's weights and slab scales for the SnS lam
    sweep: ``(mu * alpha, sqrt(alpha * (mu^2 * (1 - alpha) + beta^2)))``,
    the scale in the form that does not cancel as alpha -> 1."""
    return mu * alpha, torch.sqrt(alpha * (mu * mu * (1.0 - alpha)
                                           + beta * beta))


def update_noise_sns(y, mu, beta, alpha, lam, shape_prior, rate_prior):
    """Gamma noise posterior with slab-weighted moments."""
    K = y.shape[0]
    w = mu * alpha
    pred = _vm(w, lam)
    row_lam = torch.sum(lam, dim=1)
    row_lam2 = torch.sum(lam * lam, dim=1)
    rate = rate_prior + 0.5 * (
        torch.sum(torch.square(y - pred))
        - torch.sum(w * w * row_lam2)
        + torch.sum((mu * mu + beta * beta) * alpha * row_lam))
    return shape_prior + 0.5 * K, rate


def _iteration(state, data, hyper, orders, generators, *, num_mc_samples,
               minimum_spike_count, analytic_mc):
    """One CAVI-SnS iteration over one experiment or a stack (a leading
    axis on y). ``orders``: the row orders of the mu, alpha and lam
    sweeps ([N] or [E, N]); ``generators``: the Monte Carlo streams of
    the power-curve means, one per experiment (unused with
    ``analytic_mc``)."""
    y, stim, lam_mask, powers, power_counts = data
    (mu_prior, beta_prior, alpha_prior, shape_prior, rate_prior,
     phi_prior, phi_cov_prior) = hyper
    many = y.dim() > 1
    sig0 = state.shape / state.rate
    if many:  # each experiment's slab scale as its single fit takes it
        E = y.shape[0]
        beta = _each_expt(
            lambda a, lm, sh, rt: update_slab_scale(a, lm, sh, rt,
                                                    beta_prior),
            state.alpha, state.lam, state.shape.expand(E),
            state.rate.expand(E))
    else:
        beta = update_slab_scale(state.alpha, state.lam, state.shape,
                                 state.rate, beta_prior)
    mu = (_sweep_means_many if many else sweep_means)(
        y, state.mu, beta, state.alpha, state.lam, sig0, mu_prior,
        beta_prior, orders[0])
    alpha = (_sweep_connection_probs_many if many else
             sweep_connection_probs)(y, mu, beta, state.alpha, state.lam,
                                     sig0, alpha_prior, orders[1])
    m0, m1 = _each_stream(generators, lambda g, b: torch.stack(
        powercurve_logit_means(
            g, state.phi if b is None else state.phi[b],
            state.phi_cov if b is None else state.phi_cov[b],
            num_mc_samples, analytic_mc)), many).unbind(-2)
    if many:
        w, beta_eff = row_sweep_weights(mu, beta, alpha)
        lam = sweep_spikes_row_batched(
            y, stim, w, beta_eff, state.lam, sig0, m0, m1, lam_mask, powers,
            power_counts, orders[2], -1.0, minimum_spike_count, 1.0)
    else:
        lam = sweep_spikes_sns(y, stim, mu, beta, alpha, state.lam, sig0, m0,
                               m1, lam_mask, orders[2], minimum_spike_count,
                               powers, power_counts)
    if many:
        shape, rate = _each_expt(
            lambda *a: update_noise_sns(*a, shape_prior, rate_prior),
            y, mu, beta, alpha, lam)
    else:
        shape, rate = update_noise_sns(y, mu, beta, alpha, lam, shape_prior,
                                       rate_prior)
    phi, phi_cov = laplace_phi_update(lam, stim, phi_prior, phi_cov_prior,
                                      powers=powers, counts=power_counts)
    return SnsState(mu, beta, alpha, lam, shape, rate, phi, phi_cov)


def _run_sns(y, stim, lam0, lam_mask, powers, hyper, generators, *, iters,
             num_mc_samples, minimum_spike_count, analytic_mc, save_histories,
             update_order="random"):
    """The fit loop over one experiment (y [K], one generator) or a stack
    (y [E, K], stim [E, N, K], E generators); draws each iteration's
    three row orders (then the Monte Carlo samples) from each
    experiment's generator. Returns (final state, the per-iteration
    states when ``save_histories``)."""
    (mu_prior, beta_prior, alpha_prior, shape_prior, rate_prior,
     phi_prior, phi_cov_prior) = hyper
    N = stim.shape[-2]
    lead = y.shape[:-1]
    data = (y, stim, lam_mask, powers, power_counts_of(stim, powers, y.dtype))
    state = SnsState(mu_prior.expand(*lead, N), beta_prior.expand(*lead, N),
                     alpha_prior.expand(*lead, N), lam0, shape_prior,
                     rate_prior, phi_prior.expand(*lead, N, 2),
                     phi_cov_prior.expand(*lead, N, 2, 2))

    def draw():
        if update_order == "identity":
            return torch.arange(N, device=y.device).expand(*lead, N)
        return _each_stream(generators, lambda g, b: torch.randperm(
            N, generator=g, device=y.device), bool(lead))

    snaps = []
    for _ in range(iters):
        orders = (draw(), draw(), draw())
        state = _iteration(state, data, hyper, orders, generators,
                           num_mc_samples=num_mc_samples,
                           minimum_spike_count=minimum_spike_count,
                           analytic_mc=analytic_mc)
        if save_histories:
            snaps.append(state)
    return state, snaps


def cavi_sns(
    y_psc, stim, mu_prior, beta_prior, alpha_prior, shape_prior, rate_prior,
    phi_prior, phi_cov_prior, iters=50, num_mc_samples=100, seed=1,
    y_xcorr_thresh=1e-2, minimum_spike_count=3, save_histories=True,
    dtype=torch.float32, analytic_mc=False, laplace_impl="auto",
    trace_wire=None, update_order="random", verbose=True, device=None,
):
    """Fit CAVI-SnS; the signature of ``circuitmap_tpu.solvers.cavi_sns``
    plus ``device`` (None means CUDA; the package's device rule).

    Returns ``(mu, beta, alpha, lam, shape, rate, phi, phi_cov, *eight
    history arrays)``: tensors on the fit's device, histories numpy
    arrays (shape and rate widened to [iters, K]) or None unless
    ``save_histories``. The reference disables the activity mask for
    this solver: every trial takes part (``y_xcorr_thresh`` is accepted
    for the signature). CUDA fits are float32; a float64 fit runs on the
    CPU.
    """
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    if dev.type == "cuda" and dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA kernels of this version take float32 only; a "
            f"{dtype} fit runs with device='cpu'")
    resolve_laplace_impl(laplace_impl)
    update_order = _validate_update_order(str(update_order))
    if verbose:
        print("Running CAVI-SnS (PyTorch).")

    stim_np, plan = stim_upload_plan(stim, None)
    y_psc = prepare_traces(y_psc, dtype, dev, trace_wire=trace_wire)
    stim_t, _, _, powers_dev_np = prepare_stim(stim_np, dtype, dev,
                                               plan=plan)
    warn_data_thin_design_dense(stim_np, what="cavi_sns()")
    y = integrated_charge(y_psc)
    lam_mask = torch.ones(stim_t.shape[1], dtype=dtype, device=dev)
    lam0 = (stim_t > 0).to(dtype) * 0.95
    hyper = tuple(_as(a, dtype, dev) for a in (
        mu_prior, beta_prior, alpha_prior, shape_prior, rate_prior,
        phi_prior, phi_cov_prior))
    final, snaps = _run_sns(
        y, stim_t, lam0, lam_mask, _as(powers_dev_np, dtype, dev), hyper,
        [seeded_generator(seed, dev)], iters=int(iters),
        num_mc_samples=int(num_mc_samples),
        minimum_spike_count=int(minimum_spike_count),
        analytic_mc=bool(analytic_mc), save_histories=bool(save_histories),
        update_order=update_order)

    if save_histories:
        hist_arrs = [torch.stack([s[i] for s in snaps]).cpu().numpy()
                     for i in range(8)]
        k_hist = hist_arrs[3].shape[-1]
        for i in (4, 5):  # scalar posteriors, stored broadcast to [iters, K]
            hist_arrs[i] = np.repeat(hist_arrs[i][:, None], k_hist, axis=1)
    else:
        hist_arrs = [None] * 8
    return (*final, *hist_arrs)
