"""Batched PSC-template fitting: extract kernel parameters from data
(port of ``circuitmap_tpu/demix/template_fit.py``).

A sum of bi-exponential PSC templates (rise time, decay, onset,
amplitude) is fitted to every trace at once: one Adam optimisation,
batched over the traces on the device, with autograd for the per-trace
gradients (the traces' losses are independent, so the gradient of
their sum is each trace's own) and positivity by softplus
reparameterisation. A helper converts the fitted population into the
tau ranges ``generate_psc_dataset`` consumes, which calibrates the
demixer's training-data simulator to a preparation.

The template loss is multi-modal on superposed traces, so the fit runs
``restarts`` independent inits (a uniform onset grid, onsets seeded at
each trace's peaks, then re-jittered grids) and keeps the best restart
per trace by final loss.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device

# Adam's constants, as the JAX package writes them
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def sum_of_psc_templates(timepoints, tau_r, tau_diff, amp, onset):
    """Sum of bi-exponential PSC kernels: parameters [..., n_kernels],
    timepoints [T]; returns [..., T]."""
    dt = timepoints - onset[..., None]
    dtc = torch.clamp(dt, min=0.0)  # exp(+large) before the onset -> inf
    tau_d = tau_r + tau_diff
    ke = (torch.exp(-dtc / tau_d[..., None])
          - torch.exp(-dtc / tau_r[..., None])) * (dt > 0)
    return torch.sum(amp[..., None] * ke, dim=-2)


def _unpack(raw):
    """Softplus-positive parameters from unconstrained variables
    [..., 4]."""
    tau_r = F.softplus(raw[..., 0]) + 0.05
    tau_diff = F.softplus(raw[..., 1]) + 0.05
    amp = F.softplus(raw[..., 2])
    onset = raw[..., 3]
    return tau_r, tau_diff, amp, onset


def _loss(raw, traces, timepoints):
    """Per-trace template MSE [K] of raw [K, n_kernels, 4]."""
    model = sum_of_psc_templates(timepoints, *_unpack(raw))
    return torch.mean(torch.square(model - traces), dim=-1)


def _fit_batch(traces, timepoints, init_raw, steps, lr):
    """Adam on the per-trace template MSE, ``steps`` steps over all
    traces at once. Returns (raw [K, n, 4], final loss [K])."""
    raw = init_raw.clone().requires_grad_(True)
    m = torch.zeros_like(init_raw)
    v = torch.zeros_like(init_raw)
    for t in range(1, steps + 1):
        g, = torch.autograd.grad(torch.sum(_loss(raw, traces, timepoints)),
                                 raw)
        with torch.no_grad():
            m = ADAM_B1 * m + (1.0 - ADAM_B1) * g
            v = ADAM_B2 * v + (1.0 - ADAM_B2) * g * g
            mhat = m / (1.0 - ADAM_B1 ** t)
            vhat = v / (1.0 - ADAM_B2 ** t)
            raw -= lr * mhat / (torch.sqrt(vhat) + ADAM_EPS)
    with torch.no_grad():
        return raw.detach(), _loss(raw, traces, timepoints)


def _grid_init(K, n_kernels, timepoints_np, rng, jitter):
    """Uniform onset grid with gaussian jitter."""
    onsets0 = np.linspace(timepoints_np[0], timepoints_np[-1], n_kernels)
    raw0 = np.zeros((K, n_kernels, 4), dtype=np.float32)
    raw0[:, :, 0] = np.log(np.expm1(0.2))           # softplus^-1(0.2) ms rise
    raw0[:, :, 1] = np.log(np.expm1(0.3))           # 0.3 ms tau_diff
    raw0[:, :, 2] = np.log(np.expm1(0.5))           # 0.5 amplitude
    raw0[:, :, 3] = onsets0[None, :] + jitter * rng.standard_normal(
        (K, n_kernels))
    return raw0


def _peak_init(traces_np, timepoints_np, n_kernels, rng):
    """Per-trace onsets seeded at the trace's own peaks.

    Greedy non-max suppression picks the ``n_kernels`` largest samples
    at least ``T // (2 n_kernels)`` frames apart; amplitudes start at
    the trace value there. A bi-exponential with the default init taus
    peaks ~0.4 ms after onset, so onsets back off by that much.
    """
    K, T = traces_np.shape
    min_sep = max(1, T // (2 * n_kernels))
    dt_ms = float(timepoints_np[-1] - timepoints_np[0]) / max(T - 1, 1)
    raw0 = _grid_init(K, n_kernels, timepoints_np, rng, jitter=0.1)
    for k in range(K):
        order = np.argsort(traces_np[k])[::-1]
        picked = []
        for idx in order:
            if len(picked) == n_kernels:
                break
            if all(abs(int(idx) - j) >= min_sep for j in picked):
                picked.append(int(idx))
        if not picked:
            continue
        picked = np.sort(np.asarray(picked))
        n_got = picked.shape[0]
        raw0[k, :n_got, 3] = timepoints_np[picked] - 0.4
        amp = np.clip(traces_np[k, picked], 0.05, 50.0)
        raw0[k, :n_got, 2] = np.log(np.expm1(amp))
        # leftovers (trace flatter than n_kernels peaks) keep grid init,
        # but with near-zero amplitude so they don't fight the peaks
        raw0[k, n_got:, 2] = np.log(np.expm1(0.05))
        # avoid several kernels stacking on one peak: tiny onset jitter
        raw0[k, :n_got, 3] += 0.25 * dt_ms * rng.standard_normal(n_got)
    return raw0


def _combine_restarts(raw, final_loss, raw_r, loss_r):
    """Per-trace best-of selection. A NaN incumbent loses to any later
    restart, so a diverged first restart cannot reject every converged
    one after it."""
    better = (loss_r < final_loss) | torch.isnan(final_loss)
    raw = torch.where(better[:, None, None], raw_r, raw)
    return raw, torch.where(better, loss_r, final_loss)


def fit_psc_templates(traces, timepoints=None, n_kernels=10, steps=800,
                      lr=0.05, seed=0, restarts=3, device=None):
    """Fit a sum of ``n_kernels`` PSC templates to each trace.

    traces: [K, T] (numpy, or a tensor); timepoints defaults to
    ``linspace(-5, 40, T)`` ms. Runs ``restarts`` independent
    optimisations of ``steps`` Adam steps in float32 on ``device`` (None
    means CUDA): grid-onset init, per-trace peak-seeded init, then
    re-jittered grids, drawn on the host from
    ``np.random.default_rng(seed)``; keeps the best restart per trace by
    final MSE. Returns a dict of numpy arrays: per-trace parameters
    [K, n_kernels] (tau_r / tau_diff / amp / onset, ms), the
    reconstruction [K, T] and the per-trace fit R².
    """
    dev = resolve_device(device)
    if isinstance(traces, torch.Tensor):
        traces = traces.detach().cpu().numpy()
    traces_np = np.asarray(traces, dtype=np.float32)
    K, T = traces_np.shape
    if timepoints is None:
        timepoints = np.linspace(-5.0, 40.0, T)
    timepoints_np = np.asarray(timepoints, dtype=np.float32)
    traces_t = torch.from_numpy(traces_np).to(dev)
    timepoints_t = torch.from_numpy(timepoints_np).to(dev)

    rng = np.random.default_rng(seed)
    raw = final_loss = None
    for r in range(max(int(restarts), 1)):
        if r == 1:
            raw0 = _peak_init(traces_np, timepoints_np, n_kernels, rng)
        else:
            raw0 = _grid_init(K, n_kernels, timepoints_np, rng,
                              jitter=0.1 if r == 0 else 1.0 + r)
        raw_r, loss_r = _fit_batch(traces_t, timepoints_t,
                                   torch.from_numpy(raw0).to(dev),
                                   int(steps), float(lr))
        if raw is None:
            raw, final_loss = raw_r, loss_r
        else:
            raw, final_loss = _combine_restarts(raw, final_loss, raw_r,
                                                loss_r)

    params = _unpack(raw)
    recon_np = sum_of_psc_templates(timepoints_t, *params).cpu().numpy()
    ss_tot = np.sum(
        (traces_np - traces_np.mean(axis=1, keepdims=True)) ** 2, axis=1
    )
    ss_res = np.sum((traces_np - recon_np) ** 2, axis=1)
    r2 = 1.0 - ss_res / np.maximum(ss_tot, 1e-12)
    tau_r, tau_diff, amp, onset = (p.cpu().numpy() for p in params)
    return {
        "tau_r": tau_r,
        "tau_diff": tau_diff,
        "amp": amp,
        "onset": onset,
        "reconstruction": recon_np,
        "r2": r2,
    }


def suggest_datagen_ranges(fit, amp_threshold=0.1, srate=20000.0,
                           lo_pct=10, hi_pct=90):
    """Convert fitted template parameters (ms) into the frame-unit tau
    ranges ``generate_psc_dataset`` / ``NeuralDemixer.
    generate_training_data`` consume."""
    keep = fit["amp"] > amp_threshold
    ms_to_frames = srate / 1000.0
    tau_r = fit["tau_r"][keep] * ms_to_frames
    tau_diff = fit["tau_diff"][keep] * ms_to_frames
    return {
        "tau_r_lower": float(np.percentile(tau_r, lo_pct)),
        "tau_r_upper": float(np.percentile(tau_r, hi_pct)),
        "tau_diff_lower": float(np.percentile(tau_diff, lo_pct)),
        "tau_diff_upper": float(np.percentile(tau_diff, hi_pct)),
    }
