"""Experimental solvers: MBCS with automatic relevance determination
(port of ``circuitmap_tpu/solvers/experimental.py``).

  * ARD relevance precisions per neuron, alpha_n = 1 / E[w_n^2], the
    sparsity mechanism;
  * a Gaussian weight posterior with the relevance-weighted prior (the
    Cholesky form of ``caviar.update_weights``);
  * sigmoid spike updates in a sequential row sweep with a running
    residual: the CAVIaR row sweep (``ops/sweep_row_cuda.py``, the
    cluster kernel at one row a step on CUDA) on ``y - z`` with the
    power-curve means (0, -spike_prior_logit), the noise precision
    ``1/sigma2`` and the gate off;
  * a soft-threshold outlier vector z.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import highest_matmul, resolve_device, torch_dtype
from ..ops.charge import integrated_charge
from ..ops.sweep_row_cuda import sweep_spikes_row
from .caviar import _mv, _vm, seeded_generator


class ArdState(NamedTuple):
    mu: torch.Tensor
    beta: torch.Tensor        # posterior sd per weight
    relevance: torch.Tensor   # ARD precision per neuron
    lam: torch.Tensor
    sigma2: torch.Tensor      # scalar noise variance
    z: torch.Tensor


def sweep_spikes_ard(y, stim, mu, beta, lam, sigma2, lam_mask, powers,
                     power_counts, order, spike_prior_logit):
    """The ARD spike sweep, ``lam[n] = mask * (stim[n] > 0) *
    sigmoid(spike_prior_logit - 0.5 * quad[n] / sigma2)`` row after row
    with a running residual: the CAVIaR row sweep with the power-curve
    means (0, -spike_prior_logit) and the gate off (so no power level is
    read; ``powers`` and ``power_counts`` only satisfy the kernel's
    1..8 levels). ``y`` is the charge less the outliers."""
    zeros = torch.zeros_like(mu)
    return sweep_spikes_row(y, stim, mu, beta, lam, 1.0 / sigma2, zeros,
                            zeros - spike_prior_logit, lam_mask, powers,
                            power_counts, order, 0.0, 0.0, 0.0)


def _iteration(state, data, static, order):
    """One MBCS-ARD iteration; ``order``: the spike sweep's row order."""
    y, stim, lam_mask, powers, power_counts = data
    N = stim.shape[0]
    lam = state.lam

    # weight posterior under the ARD prior: blocked Gaussian update
    with highest_matmul():
        gram = lam @ lam.mT
    soft_var = torch.sum(lam * (1.0 - lam), dim=-1)
    prec = (gram + torch.diag(soft_var)) / state.sigma2 + torch.diag(
        state.relevance)
    chol, _ = torch.linalg.cholesky_ex(prec)  # no host sync on the flag
    Linv = torch.linalg.solve_triangular(
        chol, torch.eye(N, dtype=y.dtype, device=y.device), upper=False)
    mu = _mv(Linv.mT, _mv(Linv, _mv(lam, y - state.z))) / state.sigma2
    beta = torch.sqrt(torch.sum(Linv * Linv, dim=0))

    relevance = torch.clamp(1.0 / (mu * mu + beta * beta + 1e-8),
                            max=static["relevance_cap"])

    lam = sweep_spikes_ard(y - state.z, stim, mu, beta, lam, state.sigma2,
                           lam_mask, powers, power_counts, order,
                           static["spike_prior_logit"])

    # spike-weighted noise variance (moment form)
    pred = _vm(mu, lam)
    resid = y - pred - state.z
    ew2 = torch.sum((mu * mu + beta * beta)[:, None] * lam * (1.0 - lam),
                    dim=0)
    sigma2 = (torch.sum(resid * resid) + torch.sum(ew2)) / y.shape[0] + 1e-8

    # outliers: soft threshold of the residual
    z = torch.clamp(y - pred - static["outlier_penalty"], min=0.0)
    z = torch.where(torch.any(lam >= 0.5, dim=0), 0.0, z) * lam_mask
    return ArdState(mu, beta, relevance, lam, sigma2, z)


def _ard_inputs(y_psc, stim, init_spike_prior, dtype, device):
    """(data, initial state) of a fit: the charges and stim (both through
    float32, as the JAX package takes them), an all-ones trial mask, the
    spike init and the one power level the sweep is given (with the gate
    off it reads none: the largest, with its trial counts)."""
    if isinstance(y_psc, torch.Tensor):
        traces = y_psc.to(device=device, dtype=torch.float32).to(dtype)
    else:
        traces = torch.as_tensor(np.asarray(y_psc, dtype=np.float32),
                                 device=device).to(dtype)
    stim_t = torch.as_tensor(np.asarray(stim, dtype=np.float32),
                             device=device).to(dtype)
    y = integrated_charge(traces)
    N, K = stim_t.shape
    lam_mask = torch.ones(K, dtype=dtype, device=device)
    lam0 = (stim_t > 0).to(dtype) * float(init_spike_prior)
    powers = torch.amax(stim_t).reshape(1)
    counts = torch.sum(stim_t == powers, dim=1, keepdim=True).to(dtype)
    init = ArdState(
        mu=torch.zeros(N, dtype=dtype, device=device),
        beta=torch.ones(N, dtype=dtype, device=device),
        relevance=torch.ones(N, dtype=dtype, device=device), lam=lam0,
        sigma2=torch.ones((), dtype=dtype, device=device),
        z=torch.zeros(K, dtype=dtype, device=device))
    return (y, stim_t, lam_mask, powers, counts), init


def mbcs_ard(y_psc, stim, iters=30, seed=0, relevance_cap=1e4,
             outlier_penalty=10.0, init_spike_prior=0.75,
             dtype=torch.float32, verbose=True, device=None):
    """Fit the ARD variant; the signature of
    ``circuitmap_tpu.solvers.experimental.mbcs_ard`` plus ``device``
    (None means CUDA; the package's device rule). Returns (mu, beta,
    relevance, lam, sigma2, z) as tensors on the fit's device.

    Neurons whose relevance saturates at ``relevance_cap`` are pruned
    (mu forced to ~0 by the prior). Row orders come from a
    ``torch.Generator`` seeded with ``seed``.
    """
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    if verbose:
        print("Running MBCS-ARD (experimental, PyTorch).")
    data, state = _ard_inputs(y_psc, stim, init_spike_prior, dtype, dev)
    static = dict(relevance_cap=float(relevance_cap),
                  outlier_penalty=float(outlier_penalty),
                  spike_prior_logit=float(np.log(
                      init_spike_prior / (1 - init_spike_prior))))
    generator = seeded_generator(seed, dev)
    N = data[1].shape[0]
    for _ in range(int(iters)):
        order = torch.randperm(N, generator=generator, device=dev)
        state = _iteration(state, data, static, order)
    return tuple(state)
