"""Convergence diagnostics: the evidence lower bound of CAVIaR fits
(port of ``circuitmap_tpu/solvers/diagnostics.py``).

The variational lower bound of the spike-and-slab charge model under
the CAVIaR posterior family:

  y_k = sum_n w_n s_nk + z_k + eps_k,   eps ~ N(0, 1/tau)
  q(w_n) = N(mu_n, var_n),  q(s_nk) = Bern(lam_nk),  q(tau) = Gamma(a, b)

ELBO = E_q[log p(y | w, s, tau)] - KL(q(w) || p(w)) - KL(q(tau) || p(tau))
       + E_q[log p(s | phi)] + H[q(s)]

The spike prior uses the posterior-mean power curves (a plug-in
approximation; the phi KL term is omitted). ``elbo_device`` is the
in-fit form (``caviar(track_elbo=True)``), ``elbo_components`` and
``elbo_trajectory`` the post-fit ones.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .._device import highest_matmul


def _gauss_kl(mu_q, var_q, mu_p, var_p):
    return 0.5 * (torch.log(var_p / var_q)
                  + (var_q + (mu_q - mu_p) ** 2) / var_p - 1.0)


def _gamma_kl(a_q, b_q, a_p, b_p):
    return ((a_q - a_p) * torch.special.digamma(a_q) - torch.lgamma(a_q)
            + torch.lgamma(a_p) + a_p * (torch.log(b_q) - torch.log(b_p))
            + a_q * (b_p - b_q) / b_q)


def _bound(y, stim, mu, var, lam, a, b, phi, z, mu_prior, beta_prior,
           shape_prior, rate_prior, k_true):
    """The bound's terms as 0-d tensors: (elbo, expected log-likelihood,
    weight KL, noise KL, spike prior, spike entropy). ``var`` holds the
    weight posterior variances."""
    e_tau = a / b
    e_log_tau = torch.special.digamma(a) - torch.log(b)
    with highest_matmul():
        resid = y - z - mu @ lam
    # row-weighted reductions: one pass over [N, K] (caviar.update_noise)
    row_lam = torch.sum(lam, dim=1)
    row_lam2 = torch.sum(lam * lam, dim=1)
    e_sq = (torch.sum(resid * resid) - torch.sum(mu * mu * row_lam2)
            + torch.sum((mu * mu + var) * row_lam))
    e_loglik = (0.5 * k_true * (e_log_tau - math.log(2 * math.pi))
                - 0.5 * e_tau * e_sq)
    kl_w = torch.sum(_gauss_kl(mu, var, mu_prior, torch.square(beta_prior)))
    kl_tau = _gamma_kl(a, b, shape_prior, rate_prior)
    drive = phi[:, 0:1] * stim - phi[:, 1:2]
    targeted = stim > 0
    logp = lam * F.logsigmoid(drive) + (1.0 - lam) * F.logsigmoid(-drive)
    e_log_prior_s = torch.sum(torch.where(targeted, logp, 0.0))
    lam_c = torch.clamp(lam, 1e-7, 1.0 - 1e-7)
    entropy_s = -torch.sum(torch.where(
        targeted, lam_c * torch.log(lam_c) + (1 - lam_c) * torch.log(1 - lam_c),
        0.0))
    elbo = e_loglik - kl_w - kl_tau + e_log_prior_s + entropy_s
    return elbo, e_loglik, kl_w, kl_tau, e_log_prior_s, entropy_s


def _tensor(a, like=None):
    """A tensor from a tensor or a host value, on ``like``'s device and
    in its dtype when given (else in the value's own float width)."""
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    if like is not None:
        return t.to(device=like.device, dtype=like.dtype)
    return t if t.is_floating_point() else t.double()


def elbo_components(y, stim, state, priors, z=None):
    """ELBO terms of a (possibly intermediate) CAVIaR state.

    y: [K] integrated charges; stim: [N, K]; ``state``/``priors`` are
    dicts with mu/beta/lam/shape/rate/phi (beta entries are variances,
    the caviar state contract), as tensors or host arrays; the bound is
    computed on lam's device in its dtype. Returns a dict of floats incl.
    'elbo'.
    """
    lam = _tensor(state["lam"])
    mu = _tensor(state["mu"], lam)
    var = torch.clamp(_tensor(state["beta"], lam), min=1e-12)
    a, b = _tensor(state["shape"], lam), _tensor(state["rate"], lam)
    phi = _tensor(state["phi"], lam)
    y, stim = _tensor(y, lam), _tensor(stim, lam)
    if z is None:
        z = state.get("z")
    z = torch.zeros_like(y) if z is None else _tensor(z, lam)
    terms = _bound(y, stim, mu, var, lam, a, b, phi, z,
                   *(_tensor(priors[k], lam)
                     for k in ("mu", "beta", "shape", "rate")), y.shape[0])
    names = ("elbo", "expected_loglik", "kl_weights", "kl_noise",
             "spike_prior", "spike_entropy")
    return {name: float(t) for name, t in zip(names, terms)}


def elbo_device(y, stim, state, hyper, k_true):
    """In-fit ELBO as a 0-d tensor (no host read): the bound of
    ``elbo_components`` on the live fit state (a mapping with mu, beta
    (the weight posterior VARIANCE), lam, shape, rate, phi and z) with
    the solver's hyper tuple; ``k_true`` is the trial count."""
    mu_prior, beta_prior, shape_prior, rate_prior = hyper[:4]
    return _bound(y, stim, state["mu"], torch.clamp(state["beta"], min=1e-12),
                  state["lam"], state["shape"], state["rate"], state["phi"],
                  state["z"], mu_prior, beta_prior, shape_prior, rate_prior,
                  k_true)[0]


def elbo_trajectory(y, stim, history, priors):
    """ELBO per iteration from a ``save_histories=True`` fit."""
    iters = history["mu"].shape[0]
    out = []
    for it in range(iters):
        state = {k: history[k][it] for k in
                 ("mu", "beta", "lam", "shape", "rate", "phi")}
        # shape/rate histories follow the reference's [iters, K] broadcast
        # layout; the bound wants scalars
        for k in ("shape", "rate"):
            if np.ndim(state[k]) > 0:
                state[k] = np.asarray(state[k]).ravel()[0]
        state["z"] = (history["z"][it] if history.get("z") is not None
                      else np.zeros(np.asarray(y).shape[0]))
        out.append(elbo_components(y, stim, state, priors))
    return out
