"""Strictly sequential CAVIaR spike sweep (block 1): the CUDA kernel's
wrappers and their plain PyTorch versions.

Port of ``circuitmap_tpu/ops/sweep_pallas.py``'s row kernels, which share
one per-row algebra (``_sweep_body``): ``sweep_spikes_pallas_dma`` and
``sweep_spikes_pallas`` (one experiment; the same function, pipelined two
ways on the TPU) and ``sweep_spikes_pallas_batched`` (E independent
experiments, one residual each). One coordinate-ascent sweep visits the
N spike-posterior rows one at a time in ``order``; each row reads the
residual ``r = mu @ lam`` left by the rows before it, computes ``est``,
the per-power spike rates, the isotonic fit at max power (suffix-mean
maximum) and the connection gate, writes the gated row and updates
``r = r_excl + new_mu * new_lam``. This is the reference's own update
order.

One kernel serves all three, the cluster sweep of the blocked sweep
(``csrc/sweep_cluster.cuh``) at one row a step: the single wrapper
launches it with one experiment, the batched wrapper with E (one
cluster each). It takes any K.

Dispatch: a CPU tensor takes the plain version; a CUDA float32 or
float64 tensor launches the kernel in that type; any other raises.
"""

from __future__ import annotations

import torch

from ._counts import count_launch, reset_launches
from .sweep_cuda import _expt_axis, _sweep_row_blocks, launch_cluster_sweep


def sweep_spikes_row_batched_torch(y, stim, mu, beta, lam, sig, m0, m1,
                                   lam_mask, powers, power_counts, order,
                                   msrmp_eff, minimum_spike_count,
                                   gate_active):
    """Plain PyTorch version of the batched row sweep (any device, any
    float dtype). Same arguments as :func:`sweep_spikes_row_batched`."""
    blocks = order.to(device=lam.device, dtype=torch.long)[..., None]
    return _sweep_row_blocks(y, stim, mu, beta, lam, sig, m0, m1, lam_mask,
                             powers, power_counts.to(lam.dtype), blocks,
                             msrmp_eff, minimum_spike_count, gate_active)


def sweep_spikes_row_torch(y, stim, mu, beta, lam, sig, m0, m1, lam_mask,
                           powers, power_counts, order, msrmp_eff,
                           minimum_spike_count, gate_active):
    """Plain PyTorch version of the row sweep (any device, any float
    dtype). Same arguments as :func:`sweep_spikes_row`."""
    return sweep_spikes_row_batched_torch(
        *_expt_axis(y, stim, mu, beta, lam), sig,
        *_expt_axis(m0, m1, lam_mask), powers,
        *_expt_axis(power_counts, order), msrmp_eff, minimum_spike_count,
        gate_active)[0]


def sweep_spikes_row(y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
                     power_counts, order, msrmp_eff, minimum_spike_count,
                     gate_active):
    """One strictly sequential sweep; returns the new lam [N, K].

    y, lam_mask: [K]; stim, lam: [N, K]; mu, beta, m0, m1: [N];
    powers: [P]; power_counts: [N, P] trials per neuron per power;
    order: [N] row order (a permutation); sig, msrmp_eff,
    minimum_spike_count, gate_active: scalars (tensors or numbers).
    The signature of ``sweep_spikes_pallas_dma`` and
    ``sweep_spikes_pallas``.
    """
    if lam.device.type == "cpu":
        return sweep_spikes_row_torch(
            y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
            power_counts, order, msrmp_eff, minimum_spike_count, gate_active)
    if lam.device.type != "cuda":
        raise ValueError(f"no row-sweep kernel for device {lam.device}")
    out = _launch(*_expt_axis(y, stim, mu, beta, lam), sig,
                  *_expt_axis(m0, m1, lam_mask), powers,
                  *_expt_axis(power_counts, order), msrmp_eff,
                  minimum_spike_count, gate_active, sweep_spikes_row)
    count_launch(sweep_spikes_row, out.dtype)
    return out[0]


reset_launches(sweep_spikes_row)


def sweep_spikes_row_batched(y, stim, mu, beta, lam, sig, m0, m1, lam_mask,
                             powers, power_counts, order, msrmp_eff,
                             minimum_spike_count, gate_active):
    """E independent strictly sequential sweeps in one launch; returns
    the new lam [E, N, K].

    y, lam_mask: [E, K]; stim, lam: [E, N, K]; mu, beta, m0, m1:
    [E, N]; powers: [P], shared; power_counts: [E, N, P]; order: [E, N];
    sig, msrmp_eff: [E] (or scalars); minimum_spike_count, gate_active:
    scalars or [E]. The signature of ``sweep_spikes_pallas_batched``.
    """
    if lam.device.type == "cpu":
        return sweep_spikes_row_batched_torch(
            y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
            power_counts, order, msrmp_eff, minimum_spike_count, gate_active)
    if lam.device.type != "cuda":
        raise ValueError(f"no row-sweep kernel for device {lam.device}")
    out = _launch(y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
                  power_counts, order, msrmp_eff, minimum_spike_count,
                  gate_active, sweep_spikes_row_batched)
    count_launch(sweep_spikes_row_batched, out.dtype)
    return out


reset_launches(sweep_spikes_row_batched)


def _launch(y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
            power_counts, order, msrmp_eff, minimum_spike_count, gate_active,
            counter):
    return launch_cluster_sweep(
        1, y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
        power_counts, order, msrmp_eff, minimum_spike_count, gate_active,
        counter)
