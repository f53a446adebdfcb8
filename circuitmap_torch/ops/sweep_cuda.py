"""Blocked CAVIaR spike sweep: the CUDA kernel's wrapper and its plain
PyTorch version.

Port of ``circuitmap_tpu/ops/sweep_pallas.py::
sweep_spikes_pallas_dma_blocked``. One coordinate-ascent sweep over the
N spike-posterior rows in blocks of ``block_size`` consecutive rows (8
by default, any size), visited in the order ``border`` (a
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

Dispatch: a CPU tensor takes the plain version; a CUDA float32 or
float64 tensor launches ``csrc/sweep_cluster.cuh`` in that type; any
other raises. The kernel takes any block size (a block above 32 rows
runs as sub-steps of at most one warp's rows against the block's
residual) and any number of power levels (in float32 1..16 fixed at
compile time, more at run time with the sums in global scratch; in
float64 always at run time). The same kernel runs the strictly
sequential sweep (1 row a step, ``ops/sweep_row_cuda.py``).
:func:`cluster_plan` lays out its launch. Each wrapper counts its
launches in ``launches`` and, of those, the float64 ones in
``launches_f64``, and each launch's layout and step count, a
:class:`SweepLaunch`, in ``plans`` (``ops/_counts.py``).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from .._device import highest_matmul
from ._counts import count_launch, count_plan, reset_launches
from .pava import isotonic_fit_at_max_batched

BLOCK = 8                 # rows a step by default
MAX_BLOCK = 32            # rows a (sub-)step at most (one warp's lanes)
MAX_POWERS = 16           # power levels fixed at compile time; more at run time
DYN_ROWS, DYN_LEVELS = 4, 8  # above MAX_POWERS: rows x levels a thread sums
CLUSTER_THREADS = 512     # threads per CTA (csrc/sweep_cluster.cuh THREADS)
CLUSTER_SIZES = (16, 8)   # CTAs per experiment: 16 where the card admits it
SMEM_PER_CTA = 232448     # dynamic shared memory one CTA may take on sm_90
RING_MAX = 4              # steps of rows prefetched at most
KERNEL_DTYPES = (torch.float32, torch.float64)


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
                  minimum_spike_count, gate_active, block_size,
                  sweep_spikes_blocked)
    count_launch(sweep_spikes_blocked, out.dtype)
    return out[0]


reset_launches(sweep_spikes_blocked)


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
                  gate_active, block_size, sweep_spikes_blocked_batched)
    count_launch(sweep_spikes_blocked_batched, out.dtype)
    return out


reset_launches(sweep_spikes_blocked_batched)


def _kernel_args(y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
                power_counts, msrmp_eff, minimum_spike_count, gate_active,
                what):
    """The operands both sweep kernels take, checked, in lam's dtype
    (float32 or float64): (the ten arrays y, lam_mask, stim, lam, mu,
    beta, m0, m1, power_counts, powers as contiguous tensors on lam's
    device, scalars [E, 4] = (sig, msrmp_eff, min_count, gate_active),
    r = mu @ lam [E, K])."""
    dt = lam.dtype
    if dt not in KERNEL_DTYPES:
        raise TypeError(f"the CUDA {what} kernel takes float32 or float64, "
                        f"got {dt}")
    E = lam.shape[0]
    if powers.shape[0] < 1:
        raise ValueError(f"the CUDA {what} kernel needs a power level")
    dev = lam.device

    def cast(a):
        return torch.as_tensor(a, dtype=dt, device=dev).contiguous()

    scalars = torch.stack([_per_expt(v, E, dt, dev) for v in
                           (sig, msrmp_eff, minimum_spike_count, gate_active)],
                          dim=1).contiguous()
    arrays = [cast(a) for a in (y, lam_mask, stim, lam, mu, beta, m0, m1,
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


class SweepLaunch(NamedTuple):
    """What a wrapper's ``plans`` counts of one cluster-sweep launch: its
    :class:`ClusterPlan`'s ``cluster``, ``cols``, ``on_chip`` and ring
    ``depth``, and ``nsteps``, the dependent block steps it chains (one
    a row at one row a step)."""
    cluster: int
    cols: int
    on_chip: bool
    depth: int
    nsteps: int


def dynamic_levels(P, item=4):
    """Whether the kernel takes its level count at run time: above
    MAX_POWERS levels, and always in float64 (``item`` 8 bytes)."""
    return P > MAX_POWERS or item == 8


def cluster_plan(E, K, rows, P=MAX_POWERS, cluster=CLUSTER_SIZES[0],
                 item=4):
    """The launch of ``E`` sweeps over ``K`` trials at ``rows`` rows a
    (sub-)step (1..32) and ``P`` power levels (one cluster per
    experiment, so the layout is the same for every E), in elements of
    ``item`` bytes (4, float32; 8, float64: half the columns fit on
    chip), as ``csrc/sweep_cluster.cuh`` lays out its shared memory (in
    elements, each part a multiple of 4): at a compile-time level count
    (up to 16 levels, float32) the exchanged partials
    [2, cluster, rows*(P+1)] and the CTA's reduction [warps,
    rows*(P+1)], at a runtime count (:func:`dynamic_levels`) the
    reduction of one pass [warps, DYN_ROWS*DYN_LEVELS] alone (the
    partials go to global scratch); the gates (32), the row parameters
    [2, rows, 4+P] (4 at a runtime count: the counts stay in device
    memory), the step's first rows and row
    counts (4) and the exchange's two mbarriers (4); then, on chip, r, y
    and mask [cols] and est [rows, cols]; then the ring, ``depth`` slots
    of [rows, 2, cols]."""
    if not 1 <= rows <= MAX_BLOCK or cluster not in CLUSTER_SIZES:
        raise ValueError(f"no cluster sweep at rows={rows}, "
                         f"cluster={cluster}")
    if item not in (4, 8):
        raise ValueError(f"no cluster sweep for {item}-byte elements")
    cols = 4 * -(-K // (4 * cluster))
    warps = CLUSTER_THREADS // 32
    if dynamic_levels(P, item):
        fixed = warps * DYN_ROWS * DYN_LEVELS + 4 * -(-2 * rows * 4 // 4)
    else:
        ns = rows * (P + 1)
        fixed = 2 * cluster * ns + warps * ns + 4 * -(-2 * rows * (4 + P) // 4)
    fixed += MAX_BLOCK + 8
    resident = (3 + rows) * cols
    slot = 2 * rows * cols
    limit = SMEM_PER_CTA // item
    on_chip = fixed + resident <= limit
    base = fixed + (resident if on_chip else 0)
    depth = min(RING_MAX, (limit - base) // slot)
    return ClusterPlan(cluster, cols, on_chip, depth,
                       item * (base + depth * slot))


@functools.lru_cache(maxsize=None)
def _cluster_admitted(rows, P, cluster, on_chip, smem_bytes, item=4):
    """Whether the card can hold one such cluster at a time."""
    from . import _build

    lib = _build.library()
    query = (lib.cm_sweep_cluster_active_f64 if item == 8
             else lib.cm_sweep_cluster_active)
    n = query(rows, P, cluster, int(on_chip), smem_bytes)
    if n < 0:
        _build.check(lib, -n, "sweep cluster occupancy query")
    return n > 0


def launch_plan(E, K, rows, P, item=4):
    """The plan a launch takes: 16 CTAs per experiment where the card
    admits such a cluster, else 8 (the portable size)."""
    for cluster in CLUSTER_SIZES:
        plan = cluster_plan(E, K, rows, P, cluster, item)
        if _cluster_admitted(rows, P, cluster, plan.on_chip,
                             plan.smem_bytes, item):
            return plan
    raise RuntimeError(f"the card admits no sweep cluster of "
                       f"{CLUSTER_SIZES} CTAs at K={K}, rows={rows}")


def sub_steps(block):
    """A block of ``block`` rows as (sub-steps, rows a sub-step): one
    step up to MAX_BLOCK rows, else the fewest sub-steps of at most
    MAX_BLOCK rows, of even size but the last."""
    subs = -(-block // MAX_BLOCK)
    return subs, -(-block // subs)


def launch_cluster_sweep(rows, y, stim, mu, beta, lam, sig, m0, m1,
                         lam_mask, powers, power_counts, steps, msrmp_eff,
                         minimum_spike_count, gate_active, counter):
    """One launch of the cluster sweep over E experiments ([E, ...]
    arrays) at ``rows`` rows a block (any size; above MAX_BLOCK a block
    runs as :func:`sub_steps` against the residual of its start);
    ``steps``: [E, ceil(N/rows)] block indices, or [E, N] rows at one
    row a step. The launch's :class:`SweepLaunch` is counted in the
    ``plans`` of ``counter``, the wrapper that launches it. Returns the
    new lam [E, N, K]."""
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
    dev, dt = lam.device, arrays[3].dtype
    item = dt.itemsize
    P = powers.shape[0]
    subs, sub_rows = sub_steps(rows)
    plan = launch_plan(E, K, sub_rows, P, item)
    steps32 = steps.to(device=dev, dtype=torch.int32).contiguous()
    out = torch.empty_like(arrays[3])
    # a long block's update of r, and the exchange at a runtime level count
    dacc = torch.zeros((E, K), dtype=dt, device=dev) if subs > 1 else None
    xg = torch.empty(E * 3 * plan.cluster * sub_rows * (P + 1), dtype=dt,
                     device=dev) if dynamic_levels(P, item) else None
    lib = _build.library()
    entry = lib.cm_sweep_cluster_f64 if item == 8 else lib.cm_sweep_cluster_f32
    # r holds mu @ lam and is the kernel's scratch residual off chip
    err = entry(
        *(a.data_ptr() for a in arrays), steps32.data_ptr(),
        scalars.data_ptr(), r.data_ptr(), out.data_ptr(),
        None if dacc is None else dacc.data_ptr(),
        None if xg is None else xg.data_ptr(), E, N, K, P, nsteps,
        sub_rows, rows, subs, plan.cluster, plan.cols, int(plan.on_chip),
        plan.depth, plan.smem_bytes,
        torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, err, "sweep_cluster")
    count_plan(counter, SweepLaunch(plan.cluster, plan.cols, plan.on_chip,
                                    plan.depth, nsteps))
    return out


def _launch(y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
            power_counts, border, msrmp_eff, minimum_spike_count,
            gate_active, block_size, counter):
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    return launch_cluster_sweep(
        block_size, y, stim, mu, beta, lam, sig, m0, m1, lam_mask, powers,
        power_counts, border, msrmp_eff, minimum_spike_count, gate_active,
        counter)
