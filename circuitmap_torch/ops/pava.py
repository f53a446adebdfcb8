"""Isotonic regression (port of ops/pava.py).

``isotonic_regression`` is the full pool-adjacent-violators regressor
with the exponential decay ``gamma`` of the reference; the MBCS
receptive fields run it over the power axis of every neuron at once
(``isotonic_regression_batched``: a loop over the T positions,
vectorised over the rows).

The CAVIaR gate needs only the last fitted value of a gamma=1 isotonic
regression through the per-power spike rates. By the minimax
characterisation that value is the maximum over suffixes of the suffix
mean: one reversed cumulative sum (``isotonic_fit_at_max``).
"""

from __future__ import annotations

import math

import torch


def _merge_pools(y, gamma):
    """Pool-adjacent-violators over each row of y [R, T]: pools are kept
    left-packed in [R, T] buffers (decay-weighted value sum, weight,
    length). Each pushed position may merge with every pool before it,
    so push t runs t masked merge steps; a row whose top pool no longer
    violates is left as it is."""
    R, T = y.shape
    lg = math.log(gamma)
    rows = torch.arange(R, device=y.device)
    val = torch.zeros_like(y)
    wgt = torch.zeros_like(y)
    length = torch.zeros((R, T), dtype=torch.long, device=y.device)
    val[:, 0], wgt[:, 0], length[:, 0] = y[:, 0], 1.0, 1
    top = torch.zeros(R, dtype=torch.long, device=y.device)
    for t in range(1, T):
        top = top + 1
        val[rows, top], wgt[rows, top], length[rows, top] = y[:, t], 1.0, 1
        for _ in range(t):
            prev = (top - 1).clamp(min=0)
            prev_end = (val[rows, prev] / wgt[rows, prev]
                        * torch.exp(lg * length[rows, prev].to(y.dtype)))
            viol = (top > 0) & (prev_end > val[rows, top] / wgt[rows, top])
            decay = torch.exp(lg * length[rows, prev].to(y.dtype))
            merged_val = val[rows, prev] + val[rows, top] * decay
            merged_wgt = wgt[rows, prev] + wgt[rows, top] * decay * decay
            merged_len = length[rows, prev] + length[rows, top]
            val[rows, prev] = torch.where(viol, merged_val, val[rows, prev])
            wgt[rows, prev] = torch.where(viol, merged_wgt, wgt[rows, prev])
            length[rows, prev] = torch.where(viol, merged_len,
                                             length[rows, prev])
            val[rows, top] = torch.where(viol, 0.0, val[rows, top])
            wgt[rows, top] = torch.where(viol, 0.0, wgt[rows, top])
            length[rows, top] = torch.where(viol, 0, length[rows, top])
            top = torch.where(viol, prev, top)
    return val, wgt, length


def isotonic_regression_batched(y, gamma=1.0):
    """Non-decreasing (gamma=1) isotonic regression of each row of y
    [R, T]; within a pool the fitted values decay as
    ``gamma**(t - pool_start)`` (the reference's ``_isotonic_regression``)."""
    T = y.shape[-1]
    val, wgt, length = _merge_pools(y, float(gamma))
    lg = math.log(float(gamma))
    starts = torch.cumsum(length, dim=-1) - length        # [R, pools]
    t_idx = torch.arange(T, device=y.device)
    member = ((t_idx >= starts[..., None])
              & (t_idx < (starts + length)[..., None]))  # [R, pools, T]
    level = val / torch.where(wgt > 0, wgt, torch.ones_like(wgt))
    offset = (t_idx - starts[..., None]).to(y.dtype)
    fitted = level[..., None] * torch.exp(lg * offset)
    return torch.sum(torch.where(member, fitted, 0.0), dim=-2)


def isotonic_regression(y, gamma=1.0):
    """y: [T] -> [T] (see :func:`isotonic_regression_batched`)."""
    return isotonic_regression_batched(y[None], gamma)[0]


def isotonic_fit_at_max_batched(y):
    """y: [..., P] -> [...]: ``max_i mean(y[..., i:])``."""
    rev_csum = torch.cumsum(torch.flip(y, dims=(-1,)), dim=-1)
    counts = torch.arange(1, y.shape[-1] + 1, dtype=y.dtype, device=y.device)
    return torch.max(rev_csum / counts, dim=-1).values


def isotonic_fit_at_max(y):
    """y: [P] -> scalar tensor."""
    return isotonic_fit_at_max_batched(y)
