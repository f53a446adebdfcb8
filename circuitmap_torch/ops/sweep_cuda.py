"""Blocked CAVIaR spike sweep: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``circuitmap_tpu/ops/sweep_pallas.py::
sweep_spikes_pallas_dma_blocked``. One coordinate-ascent sweep over the
N spike-posterior rows in blocks of ``block_size`` consecutive rows (8
by default, any of 1..32), visited in the order ``border`` (a
permutation of the ceil(N/block_size) block indices, including a partial
last block): Jacobi within a block (every row of a block reads the
residual ``r = mu @ lam`` as it stood at the block's start),
Gauss-Seidel across blocks. Per row: ``est``, the per-power spike rates,
the isotonic fit at max power (suffix-mean maximum), the connection gate
and the gated new row.

``sweep_spikes_blocked_batched`` runs E independent experiments in one
launch (``sweep_spikes_pallas_dma_blocked_batched``, the batched fits'
form). ``_sweep_row_blocks`` is the plain per-row algebra that every
plain sweep of the port runs, blocked or strictly sequential.

Dispatch: a CPU tensor takes the plain version; a CUDA float32 tensor
launches ``csrc/sweep_cluster.cuh`` (1..32 rows a step, 1..16 power
levels); anything else raises. The same kernel runs the strictly
sequential sweep (1 row a step, ``ops/sweep_row_cuda.py``).
:func:`cluster_plan` lays out its launch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .._device import highest_matmul
from .pava import isotonic_fit_at_max_batched

BLOCK = 8                 # rows a step by default
MAX_BLOCK = 32            # rows a step at most (one warp's lanes)
MAX_POWERS = 16           # power levels the kernel is built for
CLUSTER_THREADS = 512     # threads per CTA (csrc/sweep_cluster.cuh THREADS)
CLUSTER_SIZES = (16, 8)   # CTAs per experiment: 16 where the card admits it
SMEM_PER_CTA = 232448     # dynamic shared memory one CTA may take on sm_90
RING_MAX = 4              # steps of rows prefetched at most


def _per_expt(v, E, dtype, device):
    """An [E] tensor on ``device`` from a number, a 0-d tensor or an [E]
    tensor. A number is filled in place (no host-to-device copy, which
    would wait on the stream)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=dtype).reshape(-1).expand(E)
    return torch.full((E,), float(v), dtype=dtype, device=device)


def _residual(mu, lam):
    """r = mu @ lam per experiment: [E, N], [E, N, K] -> [E, K], one
    full-float32 matrix-vector product each (the single fit's own)."""
    with highest_matmul():
        return torch.stack([m @ lm for m, lm in zip(mu, lam)])


def _sweep_row_blocks(y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
                      power_counts, blocks, msrmp_eff, minimum_spike_count,
                      gate_active):
    """The plain sweep of E independent experiments, the one copy of the
    per-row algebra every plain sweep runs.

    y, lam_mask: [E, K]; stim, lam: [E, N, K]; mu, beta, m0, m1: [E, N];
    power_counts: [E, N, P]; blocks: [E, NB, B] row indices, one block
    per step (index N marks an inert padding lane, a zero row); sig,
    msrmp_eff, minimum_spike_count, gate_active: numbers, 0-d or [E]
    tensors. Returns the new lam [E, N, K].
    """
    E, N, K = lam.shape
    dt, dev = lam.dtype, lam.device
    sig, msrmp_eff, min_count, gate_active = (
        _per_expt(v, E, dt, dev)[:, None]
        for v in (sig, msrmp_eff, minimum_spike_count, gate_active))
    pad = lambda a: torch.cat([a, torch.zeros_like(a[:, :1])], 1)  # noqa: E731
    stim_p, lam_p, counts_p = pad(stim), pad(lam), pad(power_counts)
    mu_p, beta_p, m0_p, m1_p = pad(mu), pad(beta), pad(m0), pad(m1)
    r = _residual(mu, lam)
    ex = torch.arange(E, device=dev)[:, None]
    for t in range(blocks.shape[1]):
        idx = blocks[:, t]                                    # [E, B]
        stim_b, lam_b = stim_p[ex, idx], lam_p[ex, idx]       # [E, B, K]
        mu_b, beta_b = mu_p[ex, idx], beta_p[ex, idx]         # [E, B]
        r_excl = r[:, None, :] - mu_b[..., None] * lam_b
        quad = sig[..., None] * (-2.0 * y[:, None, :] * mu_b[..., None]
                                 + 2.0 * mu_b[..., None] * r_excl
                                 + (mu_b * mu_b + beta_b * beta_b)[..., None])
        est = lam_mask[:, None, :] * (stim_b > 0) * torch.sigmoid(
            m0_p[ex, idx][..., None] * stim_b - m1_p[ex, idx][..., None]
            - 0.5 * quad)
        sums = torch.sum(torch.where(
            stim_b[..., None, :] == powers[:, None], est[..., None, :], 0.0),
            dim=-1)                                           # [E, B, P]
        c = counts_p[ex, idx]
        rates = sums / (c + 1e-4 * (c == 0.0))
        ok = (isotonic_fit_at_max_batched(rates) >= msrmp_eff) & (
            torch.sum(est, dim=-1) >= min_count)
        gate = torch.where(gate_active > 0, ok.to(dt), torch.ones_like(mu_b))
        new_lam = est * gate[..., None]
        new_mu = mu_b * gate
        lam_p[ex, idx] = new_lam
        if idx.shape[1] == 1:  # strictly sequential: the reference's algebra
            r = r_excl[:, 0] + new_mu * new_lam[:, 0]
        else:
            r = r + torch.sum(new_mu[..., None] * new_lam
                              - mu_b[..., None] * lam_b, dim=1)
    return lam_p[:, :N]


def _expt_axis(*arrays):
    """Each array with a leading experiment axis of 1."""
    return [a[None] for a in arrays]


def _border_blocks(border, N, block_size):
    """Block order [..., NB] -> [..., NB, B] row indices (N for rows
    past the end)."""
    rows = (border.to(torch.long)[..., None] * block_size
            + torch.arange(block_size, device=border.device))
    return torch.where(rows < N, rows, torch.full_like(rows, N))


def sweep_spikes_blocked_batched_torch(y, stim, mu, beta, lam, sig, m0, m1,
                                       lam_mask, powers, power_counts, border,
                                       msrmp_eff, minimum_spike_count,
                                       gate_active, block_size=BLOCK):
    """Plain PyTorch version of the batched blocked sweep (any device,
    any float dtype). Same arguments as
    :func:`sweep_spikes_blocked_batched`."""
    blocks = _border_blocks(border.to(lam.device), lam.shape[1], block_size)
    return _sweep_row_blocks(y, stim, mu, beta, lam, sig, m0, m1, lam_mask,
                             powers, power_counts.to(lam.dtype), blocks,
                             msrmp_eff, minimum_spike_count, gate_active)


def sweep_spikes_blocked_torch(y, stim, mu, beta, lam, sig, m0, m1, lam_mask,
                               powers, power_counts, border, msrmp_eff,
                               minimum_spike_count, gate_active,
                               block_size=BLOCK):
    """Plain PyTorch version of the blocked sweep (any device, any float
    dtype). Same arguments as :func:`sweep_spikes_blocked`."""
    return sweep_spikes_blocked_batched_torch(
        *_expt_axis(y, stim, mu, beta, lam), sig,
        *_expt_axis(m0, m1, lam_mask), powers,
        *_expt_axis(power_counts, border), msrmp_eff, minimum_spike_count,
        gate_active, block_size)[0]


def sweep_spikes_blocked(y, stim, mu, beta, lam, sig, m0, m1, lam_mask,
                         powers, power_counts, border, msrmp_eff,
                         minimum_spike_count, gate_active, block_size=BLOCK):
    """One blocked sweep; returns the new lam [N, K].

    y, lam_mask: [K]; stim, lam: [N, K]; mu, beta, m0, m1: [N];
    powers: [P]; power_counts: [N, P] trials per neuron per power;
    border: [ceil(N/block_size)] block order; sig, msrmp_eff,
    minimum_spike_count, gate_active: scalars (tensors or numbers).
    The signature of ``sweep_spikes_pallas_dma_blocked``.
    """
    if lam.device.type == "cpu":
        return sweep_spikes_blocked_torch(
            y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
            power_counts, border, msrmp_eff, minimum_spike_count,
            gate_active, block_size)
    if lam.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {lam.device}")
    out = _launch(*_expt_axis(y, stim, mu, beta, lam), sig,
                  *_expt_axis(m0, m1, lam_mask), powers,
                  *_expt_axis(power_counts, border), msrmp_eff,
                  minimum_spike_count, gate_active, block_size)
    sweep_spikes_blocked.launches += 1
    return out[0]


sweep_spikes_blocked.launches = 0


def sweep_spikes_blocked_batched(y, stim, mu, beta, lam, sig, m0, m1,
                                 lam_mask, powers, power_counts, border,
                                 msrmp_eff, minimum_spike_count, gate_active,
                                 block_size=BLOCK):
    """E independent blocked sweeps in one launch (one cluster per
    experiment); returns the new lam [E, N, K].

    y, lam_mask: [E, K]; stim, lam: [E, N, K]; mu, beta, m0, m1:
    [E, N]; powers: [P], shared; power_counts: [E, N, P]; border:
    [E, ceil(N/block_size)]; sig, msrmp_eff: [E] (or scalars);
    minimum_spike_count, gate_active: scalars or [E]. The signature of
    ``sweep_spikes_pallas_dma_blocked_batched``.
    """
    if lam.device.type == "cpu":
        return sweep_spikes_blocked_batched_torch(
            y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
            power_counts, border, msrmp_eff, minimum_spike_count,
            gate_active, block_size)
    if lam.device.type != "cuda":
        raise ValueError(f"no sweep kernel for device {lam.device}")
    out = _launch(y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
                  power_counts, border, msrmp_eff, minimum_spike_count,
                  gate_active, block_size)
    sweep_spikes_blocked_batched.launches += 1
    return out


sweep_spikes_blocked_batched.launches = 0


def _kernel_args(y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
                power_counts, msrmp_eff, minimum_spike_count, gate_active,
                what):
    """The float32 operands both sweep kernels take, checked: (the ten
    arrays y, lam_mask, stim, lam, mu, beta, m0, m1, power_counts, powers
    as contiguous float32 on lam's device, scalars [E, 4] = (sig,
    msrmp_eff, min_count, gate_active), r = mu @ lam [E, K])."""
    if lam.dtype != torch.float32:
        raise TypeError(
            f"the CUDA {what} kernel takes float32 only, got {lam.dtype}; "
            "a float64 fit runs on the CPU in this version")
    E = lam.shape[0]
    P = powers.shape[0]
    if not 1 <= P <= MAX_POWERS:
        raise ValueError(
            f"the CUDA {what} kernel takes 1..{MAX_POWERS} power levels, "
            f"got {P}")
    dev = lam.device

    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=dev).contiguous()

    scalars = torch.stack([_per_expt(v, E, torch.float32, dev) for v in
                           (sig, msrmp_eff, minimum_spike_count, gate_active)],
                          dim=1).contiguous()
    arrays = [f32(a) for a in (y, lam_mask, stim, lam, mu, beta, m0, m1,
                               power_counts, powers)]
    return arrays, scalars, _residual(arrays[4], arrays[3])


class ClusterPlan(NamedTuple):
    """How one cluster sweep launches: ``cluster`` CTAs per experiment
    (one cluster per experiment), each owning ``cols`` columns (a
    multiple of 4, the last CTA's slice cut at K); ``on_chip``: r, y,
    mask and the step's est rows live in shared memory (else in device
    memory); ``depth`` steps of stim and lam rows prefetched into a
    shared-memory ring; ``smem_bytes`` of dynamic shared memory per
    CTA."""
    cluster: int
    cols: int
    on_chip: bool
    depth: int
    smem_bytes: int


def cluster_plan(E, K, rows, P=MAX_POWERS, cluster=CLUSTER_SIZES[0]):
    """The launch of ``E`` sweeps over ``K`` trials at ``rows`` rows a
    step (1..32) and ``P`` power levels (one cluster per experiment, so
    the layout is the same for every E), as ``csrc/sweep_cluster.cuh``
    lays out its shared memory (in floats, each part a multiple of 4):
    the exchanged partials [2, cluster, rows*(P+1)], the CTA's reduction
    [warps, rows*(P+1)], the gates (32), the row parameters
    [2, rows, 4+P], the step's first row (4) and the exchange's two
    mbarriers (4); then, on chip, r, y and mask [cols] and est
    [rows, cols]; then the ring, ``depth`` slots of [rows, 2, cols]."""
    if not 1 <= rows <= MAX_BLOCK or cluster not in CLUSTER_SIZES:
        raise ValueError(f"no cluster sweep at rows={rows}, "
                         f"cluster={cluster}")
    cols = 4 * -(-K // (4 * cluster))
    ns = rows * (P + 1)
    fixed = (2 * cluster * ns + CLUSTER_THREADS // 32 * ns + MAX_BLOCK
             + 4 * -(-2 * rows * (4 + P) // 4) + 8)
    resident = (3 + rows) * cols
    slot = 2 * rows * cols
    limit = SMEM_PER_CTA // 4
    on_chip = fixed + resident <= limit
    base = fixed + (resident if on_chip else 0)
    depth = min(RING_MAX, (limit - base) // slot)
    return ClusterPlan(cluster, cols, on_chip, depth,
                       4 * (base + depth * slot))


@functools.lru_cache(maxsize=None)
def _cluster_admitted(rows, P, cluster, on_chip, smem_bytes):
    """Whether the card can hold one such cluster at a time."""
    from . import _build

    n = _build.library().cm_sweep_cluster_active(rows, P, cluster,
                                                 int(on_chip), smem_bytes)
    if n < 0:
        _build.check(_build.library(), -n, "sweep cluster occupancy query")
    return n > 0


def launch_plan(E, K, rows, P):
    """The plan a launch takes: 16 CTAs per experiment where the card
    admits such a cluster, else 8 (the portable size)."""
    for cluster in CLUSTER_SIZES:
        plan = cluster_plan(E, K, rows, P, cluster)
        if _cluster_admitted(rows, P, cluster, plan.on_chip,
                             plan.smem_bytes):
            return plan
    raise RuntimeError(f"the card admits no sweep cluster of "
                       f"{CLUSTER_SIZES} CTAs at K={K}, rows={rows}")


def launch_cluster_sweep(rows, y, stim, mu, beta, lam, sig, m0, m1,
                         lam_mask, powers, power_counts, steps, msrmp_eff,
                         minimum_spike_count, gate_active):
    """One launch of the cluster sweep over E experiments ([E, ...]
    arrays) at ``rows`` rows a step (1..32); ``steps``: [E,
    ceil(N/rows)] block indices, or [E, N] rows at one row a step.
    Returns the new lam [E, N, K]."""
    from . import _build

    what = "sweep" if rows > 1 else "row-sweep"
    arrays, scalars, r = _kernel_args(
        y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers, power_counts,
        msrmp_eff, minimum_spike_count, gate_active, what)
    E, N, K = lam.shape
    nsteps = -(-N // rows)
    if steps.shape != (E, nsteps):
        raise ValueError(
            f"{'border' if rows > 1 else 'order'} must hold {nsteps} "
            f"{'block' if rows > 1 else 'row'} indices per "
            f"experiment, got {tuple(steps.shape)}")
    dev = lam.device
    P = powers.shape[0]
    plan = launch_plan(E, K, rows, P)
    steps32 = steps.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(arrays[3])
    lib = _build.library()
    # r holds mu @ lam and is the kernel's scratch residual off chip
    err = lib.cm_sweep_cluster_f32(
        *(a.data_ptr() for a in arrays), steps32.data_ptr(),
        scalars.data_ptr(), r.data_ptr(), out.data_ptr(), E, N, K, P,
        nsteps, rows, plan.cluster, plan.cols, int(plan.on_chip),
        plan.depth, plan.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "sweep_cluster")
    return out


def _launch(y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
            power_counts, border, msrmp_eff, minimum_spike_count,
            gate_active, block_size):
    if not 1 <= block_size <= MAX_BLOCK:
        raise ValueError(
            f"the CUDA sweep kernel takes block_size 1..{MAX_BLOCK}, got "
            f"{block_size}")
    return launch_cluster_sweep(
        block_size, y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
        power_counts, border, msrmp_eff, minimum_spike_count, gate_active)
