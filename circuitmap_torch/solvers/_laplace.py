"""Laplace approximation of the sigmoid power-curve posteriors (phi).

Port of ``circuitmap_tpu/solvers/_laplace.py``. The power-curve
log-likelihood depends on a trial only through its power bucket, so the
refit needs per-neuron bucket statistics S (summed spike posteriors)
and C (trial counts) [N, P+1] — one pass over [N, K] per level — and
then a Newton recursion on [P+1]-sized vectors, which is the CUDA
kernel (ops/laplace_cuda.py) on the GPU and its plain version on the
CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.laplace_cuda import laplace_from_stats

LAPLACE_IMPLS = ("auto", "cuda")


def resolve_laplace_impl(laplace_impl):
    """Validate ``laplace_impl``. Both values dispatch by device (the
    kernel on CUDA, the plain version on the CPU); the JAX package's
    names ("xla", "pallas", "pallas_interpret") have no meaning here."""
    if laplace_impl not in LAPLACE_IMPLS:
        raise ValueError(
            f"laplace_impl must be one of {LAPLACE_IMPLS}, got "
            f"{laplace_impl!r}")
    return laplace_impl


def powercurve_stats(lam, stim, powers, total_trials=None, counts=None):
    """Per-neuron bucket statistics over power levels.

    lam, stim: [..., N, K] (a leading axis holds experiments); powers:
    [P] nonzero levels. Returns (S [..., N, P+1], C [..., N, P+1],
    levels [P+1]) with bucket 0 = unstimulated trials. ``counts``:
    precomputed [..., N, P] trials per neuron per nonzero power
    (loop-invariant in a fit); bucket 0 is then ``total -
    sum(counts)`` with ``total = total_trials`` or K. ``total_trials``
    without ``counts``: bucket 0 is still derived that way (the real
    trial count when the arrays carry inert padded columns). It is a
    number, or one count per experiment ([...] tensor). A stack's
    sums are taken experiment by experiment, as its single fits take
    them.
    """
    if lam.dim() > 2:  # each experiment's sums as its single fit takes them
        E = lam.shape[0]
        per = [powercurve_stats(
            lam[b], stim[b], powers,
            total_trials[b] if isinstance(total_trials, torch.Tensor)
            and total_trials.dim() else total_trials,
            None if counts is None else counts[b]) for b in range(E)]
        return (torch.stack([x[0] for x in per]),
                torch.stack([x[1] for x in per]), per[0][2])
    levels = torch.cat([torch.zeros(1, dtype=powers.dtype,
                                    device=powers.device), powers])
    zero = torch.zeros((), dtype=lam.dtype, device=lam.device)
    S = torch.stack([torch.sum(torch.where(stim == levels[p], lam, zero), -1)
                     for p in range(levels.shape[0])], dim=-1)
    if isinstance(total_trials, torch.Tensor):
        total_trials = total_trials.to(lam.dtype)[..., None]
    if counts is not None:
        total = lam.shape[-1] if total_trials is None else total_trials
        counts = counts.to(lam.dtype)
        bucket0 = total - torch.sum(counts, dim=-1)
        return S, torch.cat([bucket0[..., None], counts], dim=-1), levels
    C = torch.stack([torch.sum((stim == levels[p]).to(lam.dtype), -1)
                     for p in range(levels.shape[0])], dim=-1)
    if total_trials is not None:
        C[..., 0] = total_trials - torch.sum(C[..., 1:], dim=-1)
    return S, C, levels


def laplace_phi_update(lam, stim, phi_prior, phi_cov_prior, powers=None,
                       total_trials=None, counts=None):
    """Refit all power-curve posteriors. lam, stim: [..., N, K]; the
    priors [N, 2] and [N, 2, 2] are shared by a leading experiment axis.
    Returns (phi [..., N, 2], phi_cov [..., N, 2, 2]). ``powers``
    defaults to the nonzero levels of stim (a host read)."""
    if powers is None:
        powers = torch.as_tensor(np.unique(stim.cpu().numpy())[1:],
                                 dtype=lam.dtype, device=lam.device)
    S, C, levels = powercurve_stats(lam, stim, powers, total_trials, counts)
    lead = S.shape[:-1]
    return laplace_from_stats(S, C, levels, phi_prior.expand(*lead, 2),
                              phi_cov_prior.expand(*lead, 2, 2))
