"""Trial-sharded fits (port of ``circuitmap_tpu/parallel/sharded.py``).

Every CAVI update reduces over trials, so K shards over the mesh
(``mesh.py``) and each reduction becomes a ``psum``:

  * blocked weight update: the [N, N] Gram ``lam @ lam.T``, the [N]
    soft variances and the [N] data projections psum once an iteration
    (one [N, N+2] tensor); the N x N Cholesky solve is replicated,
  * the spike sweep: each block of B rows is local elementwise work on
    the shard's trials plus ONE [B, P+1] psum of the gate statistics
    (B = 1: one [P+1] psum a row, the reference's sequential schedule),
  * noise and spontaneous updates: scalar psums,
  * the power-curve refit: one [N, P+1] psum of the bucket sums S; the
    Laplace recursion (the B2 kernel on CUDA, ``ops/laplace_cuda.py``)
    runs once per distinct device on the psum'd statistics, and its
    result is shared by the shards on that device.

The shards run in lockstep: each update is the JAX body's algebra on a
shard's [.., K/D] slice, with each psum where the JAX body has it.
Neuron-axis state (mu, beta, phi, phi_cov) is replicated; ``lam`` and
``z`` never leave their shard until the fit returns. The sweep is plain
PyTorch, as the JAX body is XLA: the cluster kernel cannot take it,
because its gate needs the global sums in the middle of the sweep.

K is padded to a multiple of the shard count; padded trials carry
``valid = 0`` and ``lam_mask = 0`` and are excluded from every
reduction and from the trial count. The outputs are trimmed of them.

An iteration's randomness (the row order and the Monte Carlo power-curve
means) is drawn once from the fit's ``torch.Generator`` on the mesh's
first device and copied to every device; every process of a
multi-process mesh seeds the same generator, so all shards share one
order.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .._device import highest_matmul, torch_dtype
from ..ops.charge import integrated_charge, prepare_observations
from ..ops.laplace_cuda import laplace_from_stats
from ..ops.pava import isotonic_fit_at_max_batched, isotonic_regression_batched
from ..solvers._common import (_powers_dev, _stim_on_device, _upload_plan,
                               prepare_traces, warn_data_thin_design_dense)
from ..solvers._laplace import resolve_laplace_impl
from ..solvers.caviar import (CaviarState, _as, _mv, _reconnect_and_refit,
                              _resolve_sweep, _validate_update_order, _vm,
                              powercurve_logit_means, seeded_generator)
from ..solvers.diagnostics import _gamma_kl, _gauss_kl
from .mesh import TrialMesh


# ---------------------------------------------------------------------------
# Shard preparation
# ---------------------------------------------------------------------------


class ShardData(NamedTuple):
    """A fit's inputs over the mesh: per-shard lists (``y``, ``stim``
    [N, Ks] with ``stim_p`` its view of [N+1, Ks] whose last row is
    zero, ``lam_mask``, ``valid``) and replicated lists (``powers`` [P],
    ``levels`` [P+1] with 0 first, ``counts`` [N, P] trials per neuron
    per power, ``C`` [N, P+1] the refit's bucket trial counts).
    ``k_global``: the real trial count of the whole mesh."""
    y: list
    stim: list
    stim_p: list
    lam_mask: list
    valid: list
    powers: list
    levels: list
    counts: list
    C: list
    k_global: float


def _fit_dtype(mesh, dtype):
    """The fit's torch dtype. On a mesh with a CUDA shard it must be one
    the Laplace kernel takes (float32 or float64); the sharded sweep is
    plain PyTorch and runs at the fit's dtype."""
    dtype = torch_dtype(dtype)
    if (any(d.type == "cuda" for d in mesh.devices)
            and dtype not in (torch.float32, torch.float64)):
        raise TypeError(f"a sharded fit on CUDA shards runs in float32 or "
                        f"float64, got {dtype}")
    return dtype


def _require_local(mesh, what):
    if not isinstance(mesh, TrialMesh):
        raise TypeError(f"{what}: mesh must be a TrialMesh "
                        "(circuitmap_torch.parallel.trial_mesh), got "
                        f"{type(mesh).__name__}")
    if mesh.group is not None:
        raise ValueError(
            f"{what} takes the whole trial set in one process; a mesh "
            "over a process group runs the *_distributed entry points, "
            "where each process feeds its own trials")


def _pad_cols(a, width, fill=0):
    """[.., K] -> [.., width] with ``fill`` in the new columns."""
    pad = width - a.shape[-1]
    if not pad:
        return a
    if isinstance(a, torch.Tensor):
        return torch.cat([a, a.new_full((*a.shape[:-1], pad), fill)], -1)
    return np.concatenate(
        [a, np.full((*a.shape[:-1], pad), fill, a.dtype)], axis=-1)


def _stim_shard(stim_np, plan, lo, hi, dtype, device):
    """Columns lo..hi of the stim (zero past its last column), rebuilt
    on ``device`` from the plan's compressed upload of those columns."""
    _, levels_np, kind, payload = plan
    N, K = stim_np.shape

    def cols(a, fill):
        return _pad_cols(a[:, lo:min(hi, K)], hi - lo, fill)

    if kind == "dense":
        return _stim_on_device(cols(stim_np, 0), levels_np, kind, None,
                               dtype, device)
    if kind == "bucket":
        return _stim_on_device(None, levels_np, kind, cols(payload, 0),
                               dtype, device)
    targets, tbucket, _ = payload
    shape = np.broadcast_to(np.zeros((), bool), (N, hi - lo))
    return _stim_on_device(shape, levels_np, kind,
                           (cols(targets, -1), cols(tbucket, 0), None),
                           dtype, device)


def power_counts_host(stim_np, powers_dev_np, plan=None):
    """[N, P] trials per neuron per power of a host stim, compared in
    float32 as the device stim holds its levels (one [N, K] pass per
    level); the sparse upload's free counts when the plan has them."""
    if plan is not None and plan[2] == "sparse":
        return np.asarray(plan[3][2], np.float64)
    s32 = np.asarray(stim_np).astype(np.float32, copy=False)
    return np.stack([(s32 == np.float32(p)).sum(axis=1)
                     for p in powers_dev_np], axis=1).astype(np.float64)


def shard_inputs(mesh, y, lam_mask, stim_np, plan, width, counts_np,
                 k_global, powers_dev_np, dtype):
    """The :class:`ShardData` of this process's trials: ``y`` and
    ``lam_mask`` [K_loc] tensors, ``stim_np`` the host [N, K_loc] stim
    with its upload ``plan``, padded to ``width`` trials (a multiple of
    the local shard count) and split over the shards; ``counts_np`` the
    whole mesh's [N, P] power counts and ``k_global`` its trial
    count."""
    k_loc = y.shape[-1]
    n = stim_np.shape[0]
    valid = torch.zeros(width, dtype=dtype, device=y.device)
    valid[:k_loc] = 1.0
    ks = width // mesh.n_local
    stim = [_stim_shard(stim_np, plan, s * ks, (s + 1) * ks, dtype, d)
            for s, d in enumerate(mesh.devices)]
    stim_p = [torch.cat([st, st.new_zeros((1, ks))]) for st in stim]
    stim = [sp[:n] for sp in stim_p]
    counts = _as(counts_np, dtype, mesh.devices[0])
    C = torch.cat([(k_global - torch.sum(counts, 1))[:, None], counts], 1)
    powers = _as(powers_dev_np, dtype, mesh.devices[0])
    levels = torch.cat([powers.new_zeros(1), powers])
    return ShardData(
        mesh.split(_pad_cols(y.to(dtype), width)), stim, stim_p,
        mesh.split(_pad_cols(lam_mask.to(dtype), width) * valid),
        mesh.split(valid), mesh.replicate(powers), mesh.replicate(levels),
        mesh.replicate(counts), mesh.replicate(C), float(k_global))


def observations(y_psc, mesh, dtype, y_xcorr_thresh, trace_wire, mask):
    """A [K, T] trace block's charges and lam mask on the mesh's first
    device. ``mask``: "activity" (CAVIaR's trial activity mask), "none"
    (CAVI-SnS: every trial) or an explicit [K] host mask (MBCS)."""
    dev0 = mesh.devices[0]
    traces = prepare_traces(y_psc, dtype, dev0, trace_wire=trace_wire)
    if isinstance(mask, str) and mask == "activity":
        y, active = prepare_observations(traces, y_xcorr_thresh)
        return y, active.to(dtype)
    y = integrated_charge(traces)
    if isinstance(mask, str):
        return y, torch.ones(y.shape[0], dtype=dtype, device=dev0)
    return y, _as(mask, dtype, dev0)


def _prep(y_psc, stim, mesh, dtype, y_xcorr_thresh, powers=None,
          trace_wire=None, mask="activity", what="caviar_sharded()"):
    """The single-process preamble: the observations (``observations``)
    and the stim's compressed upload, K padded to a multiple of the
    shard count. Returns (ShardData, K)."""
    stim_np = (stim.detach().cpu().numpy() if isinstance(stim, torch.Tensor)
               else np.asarray(stim))
    plan = _upload_plan(stim_np, powers)
    y, lam_mask = observations(y_psc, mesh, dtype, y_xcorr_thresh,
                               trace_wire, mask)
    K = y.shape[0]
    if stim_np.shape[1] != K:
        raise ValueError(f"{what}: traces carry {K} trials but stim "
                         f"{stim_np.shape[1]}")
    powers_dev_np = _powers_dev(*plan[:3])
    warn_data_thin_design_dense(stim_np, k_true=K, what=what)
    data = shard_inputs(mesh, y, lam_mask, stim_np, plan,
                        K + (-K) % mesh.size,
                        power_counts_host(stim_np, powers_dev_np, plan), K,
                        powers_dev_np, dtype)
    return data, K


def _hyper(mesh, dtype, *priors):
    dev0 = mesh.devices[0]
    return tuple(mesh.replicate(_as(p, dtype, dev0)) for p in priors)


def _lam0(mesh, data, value):
    """The initial spike posteriors: ``value`` on targeted trials of the
    lam mask."""
    return mesh.map(lambda st, m: (st > 0).to(st.dtype) * value * m,
                    data.stim, data.lam_mask)


# ---------------------------------------------------------------------------
# Sharded CAVIaR updates
# ---------------------------------------------------------------------------


def _solve_weights(red, shape, rate, mu_prior, beta_prior):
    """The replicated half of the weight update: Cholesky of the N x N
    system from the psum'd [N, N+2] statistics (Gram, soft variances,
    data projections)."""
    N = red.shape[0]
    gram, soft_var, lam_y = red[:, :N], red[:, N], red[:, N + 1]
    sig = shape / rate
    prior_prec = 1.0 / (beta_prior * beta_prior)
    M = sig * gram + torch.diag(sig * soft_var + prior_prec)
    rhs = sig * lam_y + mu_prior * prior_prec
    chol, _ = torch.linalg.cholesky_ex(M)
    eye = torch.eye(N, dtype=red.dtype, device=red.device)
    Linv = torch.linalg.solve_triangular(chol, eye, upper=False)
    return _mv(Linv.mT, _mv(Linv, rhs)), torch.sum(Linv * Linv, dim=-2)


def _weight_stats(lam, y):
    with highest_matmul():
        gram = lam @ lam.mT
    return torch.cat([gram, torch.sum(lam * (1.0 - lam), -1)[:, None],
                      _mv(lam, y)[:, None]], 1)


def _gram_and_projection(a, y):
    with highest_matmul():
        return torch.cat([a @ a.mT, _mv(a, y)[:, None]], 1)


def update_weights(mesh, y, lam, shape, rate, mu_prior, beta_prior):
    """Blocked Gaussian weight update; one [N, N+2] psum."""
    red = mesh.psum(mesh.map(_weight_stats, lam, y))
    return mesh.rep(_solve_weights, red, shape, rate, mu_prior, beta_prior)


def _noise_parts(y, lam, mu, beta):
    pred = _vm(mu, lam)
    row_lam = torch.sum(lam, dim=1)
    row_lam2 = torch.sum(lam * lam, dim=1)
    return torch.stack([torch.sum(torch.square(y - pred)),
                        torch.sum(mu * mu * row_lam2),
                        torch.sum((mu * mu + beta * beta) * row_lam)])


def update_noise(mesh, y, mu, beta, lam, shape_prior, rate_prior, k_global):
    """Gamma noise posterior; one [3] psum."""
    red = mesh.psum(mesh.map(_noise_parts, y, lam, mu, beta))
    return mesh.rep(lambda r, sp, rp: (sp + 0.5 * k_global,
                                       rp + 0.5 * (r[0] - r[1] + r[2])),
                    red, shape_prior, rate_prior)


def _block_tables(order, mu, beta, m0, m1, counts, sig, N, B):
    """The sweep's blocks [NB, B] in visiting order (block ``b`` holds
    rows bB..bB+B-1; N marks a padding lane past the last row) and each
    block's per-row mu, ``m1 + sig (mu^2 + beta^2) / 2``, ``sig mu``, m0
    and count guard. Every row is visited once, so these are the values
    at the sweep's start."""
    rows = (order.to(torch.long)[:, None] * B
            + torch.arange(B, device=order.device))
    blocks = torch.where(rows < N, rows, torch.full_like(rows, N))

    def pad(v):
        return torch.cat([v, v.new_zeros((1,) + tuple(v.shape[1:]))])[blocks]

    c = pad(counts)
    return (blocks, pad(mu), pad(m1 + 0.5 * sig * (mu * mu + beta * beta)),
            pad(sig * mu), pad(m0), c + 1e-4 * (c == 0.0))


def sweep_spikes(mesh, y, stim_p, mu, beta, lam, sig, m0, m1, lam_mask,
                 powers, counts, order, msrmp_eff, minimum_spike_count,
                 gate_active, block_size=1):
    """Coordinate sweep with psum-reduced gate statistics: blocks of
    ``block_size`` consecutive rows in the block order ``order`` (a
    permutation of the ceil(N/B) blocks: the single-device schedule of
    ``solvers.caviar``), each block's rows updated from the block-start
    residual (Jacobi within a block, Gauss-Seidel across) with ONE
    [B, P+1] psum of their gate statistics; at block size 1 the
    reference's sequential sweep, one [P+1] psum a row.

    Replicated: mu, beta, m0, m1, sig, powers, counts, order,
    msrmp_eff; per shard: y, stim_p ([N+1, Ks], zero last row), lam,
    lam_mask. ``gate_active`` is a host bool (off: no psum). Returns the
    new lam."""
    N = lam[0].shape[0]
    B = int(block_size)
    shards = range(mesh.n_local)
    blocks, mu_b, a1_b, smu_b, m0_b, guard = mesh.rep(
        lambda *a: _block_tables(*a, N, B), order, mu, beta, m0, m1, counts,
        sig)
    nb = blocks[0].shape[0]
    flat = [b.reshape(-1) for b in blocks]
    # each block's rows gathered once: rows are visited once a sweep
    stim_perm = [stim_p[s][flat[s]] for s in shards]
    lam_perm = [torch.cat([lam[s], lam[s].new_zeros((1, lam[s].shape[1]))])
                [flat[s]] for s in shards]
    live = [(stim_perm[s] > 0) * lam_mask[s] for s in shards]
    out_perm = [torch.empty_like(lp) for lp in lam_perm]
    r = mesh.map(_vm, mu, lam)
    P = powers[0].shape[0]

    def gate_of(t, red, g, mb, msr):
        ok = (isotonic_fit_at_max_batched(red[:, :P] / g[t]) >= msr) & (
            red[:, P] >= minimum_spike_count)
        gate = ok.to(red.dtype)
        return gate, mb[t] * gate

    with highest_matmul():
        for t in range(nb):
            rows = slice(t * B, (t + 1) * B)
            est, r_excl, parts = [], [], []
            for s in shards:
                st_b = stim_perm[s][rows]
                rx = torch.addcmul(r[s], mu_b[s][t][:, None],
                                   lam_perm[s][rows], value=-1.0)
                arg = torch.addcmul(
                    m0_b[s][t][:, None] * st_b - a1_b[s][t][:, None],
                    smu_b[s][t][:, None], rx - y[s], value=-1.0)
                e = live[s][rows] * torch.sigmoid(arg)
                est.append(e)
                r_excl.append(rx)
                if gate_active:
                    sums = torch.sum(torch.where(
                        st_b[:, None, :] == powers[s][:, None],
                        e[:, None, :], 0.0), -1)
                    parts.append(torch.cat([sums, torch.sum(e, -1)[:, None]],
                                           1))
            if gate_active:
                gate, new_mu = mesh.rep(lambda *a: gate_of(t, *a),
                                        mesh.psum(parts), guard, mu_b,
                                        msrmp_eff)
            else:  # the gate is 1: no statistics are needed
                gate, new_mu = None, [mb[t] for mb in mu_b]
            for s in shards:
                new = out_perm[s][rows]
                if gate is None:
                    new.copy_(est[s])
                else:
                    torch.mul(est[s], gate[s][:, None], out=new)
                if B == 1:  # strictly sequential: the reference's algebra
                    r[s] = torch.addcmul(r_excl[s][0], new_mu[s], new[0])
                else:  # gates are 0 or 1: new_mu @ new == new_mu @ est
                    r[s] = torch.addmv(torch.addmv(r[s], est[s].T, new_mu[s]),
                                       lam_perm[s][rows].T, mu_b[s][t],
                                       alpha=-1.0)
    out = [lm.new_zeros((N + 1, lm.shape[1])) for lm in lam]
    for s in shards:
        out[s].index_copy_(0, flat[s], out_perm[s])
    return [o[:N] for o in out]


def update_spontaneous(mesh, y, mu, lam, z, it, penalty, lam_mask,
                       scale_factor, tol, orthogonality, max_iters):
    """Soft-threshold spontaneous activity, seeded as the reference
    (counter ``it``, error ``sum(y)``), as a fixed masked loop of
    ``max_iters - it`` trips with one scalar psum a trip."""
    resid = mesh.map(lambda yy, mu_, lm: yy - _vm(mu_, lm), y, mu, lam)
    explained = mesh.map(lambda lm: torch.any(lm >= orthogonality, dim=0),
                         lam)
    y_stats = mesh.psum(mesh.map(
        lambda yy: torch.stack([torch.sum(yy * yy), torch.sum(yy)]), y))
    denom = mesh.rep(lambda s: s[0] + 1e-5, y_stats)
    err = mesh.rep(lambda s: s[1], y_stats)
    pen = mesh.rep(lambda s: torch.full((), float(penalty), dtype=s.dtype,
                                        device=s.device), y_stats)
    for _ in range(max(0, int(max_iters) - int(it))):
        live = mesh.rep(lambda e: e > tol, err)
        z_new = mesh.map(
            lambda rs, p, ex, m: torch.where(
                ex, 0.0, torch.clamp(torch.where(rs < p, 0.0, rs - p),
                                     min=0.0)) * m,
            resid, pen, explained, lam_mask)
        red = mesh.psum(mesh.map(
            lambda rs, zn: torch.sum(torch.square(rs - zn)), resid, z_new))
        z = mesh.map(lambda lv, zn, zo: torch.where(lv, zn, zo), live, z_new,
                     z)
        err = mesh.rep(lambda lv, r_, d, e: torch.where(lv, r_ / d, e), live,
                       red, denom, err)
        pen = mesh.rep(lambda lv, p: torch.where(lv, p * scale_factor, p),
                       live, pen)
    return z


def bucket_sums(mesh, lam, stim, levels, valid):
    """[N, P+1] psum'd spike-posterior sums per power bucket (0 first)."""
    def part(lm, st, lv, v):
        lam_v = lm * v[None, :]
        return torch.stack([torch.sum(torch.where(st == lv[p], lam_v, 0.0),
                                      -1)
                            for p in range(lv.shape[0])], dim=1)
    return mesh.psum(mesh.map(part, lam, stim, levels, valid))


def refit_phi(mesh, S, C, levels, phi_prior, phi_cov_prior):
    """The Laplace refit once per distinct device (the B2 kernel on
    CUDA) on the psum'd statistics."""
    N = phi_prior[0].shape[0]
    return mesh.rep(lambda s, c, lv, pp, pc: laplace_from_stats(
        s, c, lv, pp.expand(N, 2), pc.expand(N, 2, 2)),
        S, C, levels, phi_prior, phi_cov_prior)


def _elbo_parts(y, stim, mu, var, lam, phi, z):
    resid = y - z - _vm(mu, lam)
    row_lam = torch.sum(lam, dim=1)
    row_lam2 = torch.sum(lam * lam, dim=1)
    drive = phi[:, 0:1] * stim - phi[:, 1:2]
    targeted = stim > 0
    logp = lam * torch.nn.functional.logsigmoid(drive) + (1.0 - lam) * \
        torch.nn.functional.logsigmoid(-drive)
    lam_c = torch.clamp(lam, 1e-7, 1.0 - 1e-7)
    ent = torch.where(targeted, lam_c * torch.log(lam_c)
                      + (1 - lam_c) * torch.log(1 - lam_c), 0.0)
    return torch.stack([
        torch.sum(resid * resid), torch.sum(mu * mu * row_lam2),
        torch.sum((mu * mu + var) * row_lam),
        torch.sum(torch.where(targeted, logp, 0.0)), -torch.sum(ent)])


def elbo_sharded(mesh, d, st, hyper):
    """The evidence lower bound with every trial reduction psum'd (one
    [5] psum); a replicated 0-d tensor. Padded trials are inert; only
    the trial-count factor uses ``k_global``."""
    mu_prior, beta_prior, shape_prior, rate_prior = hyper[:4]
    var = mesh.rep(lambda b: torch.clamp(b, min=1e-12), st.beta)
    red = mesh.psum(mesh.map(_elbo_parts, d.y, d.stim, st.mu, var, st.lam,
                             st.phi, st.z))

    def bound(r, mu, v, a, b, mp, bp, sp, rp):
        e_tau = a / b
        e_log_tau = torch.special.digamma(a) - torch.log(b)
        e_sq = r[0] - r[1] + r[2]
        e_loglik = (0.5 * d.k_global * (e_log_tau - np.log(2 * np.pi))
                    - 0.5 * e_tau * e_sq)
        kl_w = torch.sum(_gauss_kl(mu, v, mp, torch.square(bp)))
        kl_tau = _gamma_kl(a, b, sp, rp)
        return e_loglik - kl_w - kl_tau + r[3] + r[4]

    return mesh.rep(bound, red, st.mu, var, st.shape, st.rate, mu_prior,
                    beta_prior, shape_prior, rate_prior)


# ---------------------------------------------------------------------------
# The sharded CAVIaR loop
# ---------------------------------------------------------------------------


def draw(mesh, generator, N, update_order, phi, phi_cov, num_mc_samples,
         analytic_mc, orders=1):
    """An iteration's randomness, drawn once on the first device and
    copied to every device: ``orders`` orders of N slots (rows, or the
    blocks of a blocked sweep; random permutations or the identity),
    then the power-curve means (m0, m1), in ``solvers.caviar``'s
    sequence. Returns replicated lists."""
    dev0 = mesh.devices[0]
    out = []
    for _ in range(orders):
        if update_order == "identity":
            o = torch.arange(N, device=dev0)
        else:
            o = torch.randperm(N, generator=generator, device=dev0)
        out.append(mesh.replicate(o))
    m = torch.stack(powercurve_logit_means(generator, phi[0], phi_cov[0],
                                           num_mc_samples, analytic_mc))
    m = mesh.replicate(m)
    return out, [x[0] for x in m], [x[1] for x in m]


def _iteration(mesh, st, it, d, hyper, generator, static):
    mu_prior, beta_prior, shape_prior, rate_prior, phi_prior, phi_cov_prior = \
        hyper
    N, B = st.lam[0].shape[0], static["sweep_block_size"]
    mu, beta = update_weights(mesh, d.y, st.lam, st.shape, st.rate, mu_prior,
                              beta_prior)
    (order,), m0, m1 = draw(mesh, generator, -(-N // B),
                            static["update_order"],
                            st.phi, st.phi_cov, static["num_mc_samples"],
                            static["analytic_mc"])
    sig = mesh.rep(lambda a, b: a / b, st.shape, st.rate)
    msrmp_eff = mesh.rep(lambda sr: static["msrmp"] + sr, st.spont_rate)
    lam = sweep_spikes(mesh, d.y, d.stim_p, mu, beta, st.lam, sig, m0, m1,
                       d.lam_mask, d.powers, d.counts, order, msrmp_eff,
                       static["minimum_spike_count"],
                       it > static["delay_spont_est"],
                       static["sweep_block_size"])
    shape, rate = update_noise(mesh, d.y, mu, beta, lam, shape_prior,
                               rate_prior, d.k_global)
    S = bucket_sums(mesh, lam, d.stim, d.levels, d.valid)
    phi, phi_cov = refit_phi(mesh, S, d.C, d.levels, phi_prior,
                             phi_cov_prior)
    cap = static["spont_seed_cap"]
    z = update_spontaneous(mesh, d.y, mu, lam, st.z,
                           it if cap is None else min(it, cap),
                           static["penalty"], d.lam_mask,
                           static["scale_factor"], static["tol"],
                           static["spont_orthogonality"],
                           static["max_backtrack_iters"])
    spont_rate = mesh.rep(lambda c: c / d.k_global, mesh.psum(mesh.map(
        lambda zz: torch.sum((zz != 0.0).to(zz.dtype)), z)))
    return CaviarState(mu, beta, lam, shape, rate, phi, phi_cov, z,
                       spont_rate)


def initial_state(mesh, d, hyper, lam0):
    """The sharded CaviarState at the priors."""
    mu_prior, beta_prior, shape_prior, rate_prior, phi_prior, phi_cov_prior = \
        hyper
    N = lam0[0].shape[0]
    zeros = mesh.map(lambda yy: torch.zeros_like(yy), d.y)
    return CaviarState(
        mu_prior, beta_prior, lam0, shape_prior, rate_prior,
        mesh.rep(lambda p: p.expand(N, 2), phi_prior),
        mesh.rep(lambda p: p.expand(N, 2, 2), phi_cov_prior), zeros,
        mesh.rep(lambda yy: yy.new_zeros(()), d.y))


def run_sharded(mesh, d, hyper, generator, lam0=None, *, iters,
                num_mc_samples, minimum_spike_count, delay_spont_est, msrmp,
                scale_factor, penalty, max_backtrack_iters, tol,
                spont_orthogonality, analytic_mc, save_histories=False,
                sweep_block_size=1, update_order="random", track_elbo=False,
                elbo_tol=None, init_state=None, start_iter=0,
                spont_seed_cap=None):
    """The fit loop over the mesh. ``init_state`` (a CaviarState of
    per-shard lists) replaces the priors and ``lam0``; iterations are
    numbered from ``start_iter`` and ``spont_seed_cap`` caps the
    spontaneous update's seed, as in ``solvers.caviar._run_caviar``.

    Returns (final state, the per-iteration states when
    ``save_histories``, ``(elbos, stop_at)`` when ``track_elbo``).
    With ``elbo_tol`` the state freezes at the first iteration after
    ``start_iter`` whose replicated bound moved by less than it relative
    to the one before (one host read an iteration); the remaining
    history and bound slots repeat the frozen values."""
    static = dict(
        num_mc_samples=int(num_mc_samples),
        minimum_spike_count=int(minimum_spike_count),
        delay_spont_est=int(delay_spont_est), msrmp=float(msrmp),
        scale_factor=float(scale_factor), penalty=float(penalty),
        max_backtrack_iters=int(max_backtrack_iters), tol=float(tol),
        spont_orthogonality=float(spont_orthogonality),
        analytic_mc=bool(analytic_mc), sweep_block_size=int(sweep_block_size),
        update_order=update_order, spont_seed_cap=spont_seed_cap)
    st = initial_state(mesh, d, hyper, lam0) if init_state is None \
        else init_state
    end = start_iter + iters
    snaps, elbos, stop_at = [], [], end
    for it in range(start_iter, end):
        st = _iteration(mesh, st, it, d, hyper, generator, static)
        if save_histories:
            snaps.append(st)
        if track_elbo:
            elbos.append(elbo_sharded(mesh, d, st, hyper)[0])
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
    return st, snaps, elbo_out


def _trim(mesh, shards, K):
    """Per-shard [.., Ks] tensors as one [.., K] tensor on the first
    device, padding dropped."""
    return mesh.gather(shards)[..., :K]


def _histories(mesh, snaps, K, sharded_fields, n_fields):
    """numpy [iters, ...] histories of per-iteration states: replicated
    fields from the first shard, trial-sharded ones gathered and trimmed
    to K."""
    out = []
    for i in range(n_fields):
        rows = [(_trim(mesh, s[i], K) if i in sharded_fields else s[i][0])
                for s in snaps]
        out.append(torch.stack(rows).cpu().numpy())
    return out


def _widen(hist, idx, K):
    """Scalar posteriors stored broadcast to [iters, K] (the reference's
    history layout)."""
    for i in idx:
        hist[i] = np.repeat(hist[i][:, None], K, axis=1)
    return hist


def caviar_sharded(
    y_psc, stim, mu_prior, beta_prior, shape_prior, rate_prior, phi_prior,
    phi_cov_prior, mesh, iters=50, num_mc_samples=100, seed=0,
    y_xcorr_thresh=1e-2, minimum_spike_count=3, delay_spont_est=1,
    msrmp=0.3, scale_factor=0.75, penalty=5e0, max_backtrack_iters=20,
    tol=0.05, spont_orthogonality=0.1, fn_scan=True, save_histories=False,
    dtype=torch.float32, analytic_mc=False, powers=None, sweep_impl="auto",
    sweep_block_size=1, laplace_impl="auto", track_elbo=False, elbo_tol=None,
    update_order="random", trace_wire=None, verbose=True,
):
    """Fit CAVIaR with the trial axis sharded over ``mesh`` (a
    :class:`TrialMesh` of this process); the signature of
    ``circuitmap_tpu.parallel.caviar_sharded``.

    Returns ``caviar()``'s tuple ``(mu, beta, lam, shape, rate, phi,
    phi_cov, z, None, *eight histories)``: tensors on the mesh's first
    device, lam and z gathered and trimmed of the padding; histories
    numpy (shape/rate widened to [iters, K]) or None. ``track_elbo``
    appends ``(elbos, converged_at)``. ``sweep_block_size`` > 1 shares
    one [B, P+1] psum among a block of B rows ("auto": 8 when the mesh's
    first device is CUDA, else 1). ``sweep_impl`` is accepted so that a
    single-device fit config can add ``mesh``; the sharded sweep is its
    own psum formulation. ``laplace_impl`` dispatches by device as in
    ``caviar()``. The results match the single-device fit up to the
    reassociation of the reductions.
    """
    _require_local(mesh, "caviar_sharded()")
    dtype = _fit_dtype(mesh, dtype)
    block = _resolve_sweep(sweep_impl, sweep_block_size, mesh.devices[0])
    resolve_laplace_impl(laplace_impl)
    update_order = _validate_update_order(str(update_order))
    d, K = _prep(y_psc, stim, mesh, dtype, y_xcorr_thresh, powers=powers,
                 trace_wire=trace_wire)
    if verbose:
        print(f"Running CAVIaR sharded over {mesh.size} shards (K={K}, "
              f"pad={d.valid[0].shape[0] * mesh.size - K}).")
    hyper = _hyper(mesh, dtype, mu_prior, beta_prior, shape_prior,
                   rate_prior, phi_prior, phi_cov_prior)
    final, snaps, elbo_out = run_sharded(
        mesh, d, hyper, seeded_generator(seed, mesh.devices[0]),
        _lam0(mesh, d, 0.95), iters=int(iters),
        num_mc_samples=num_mc_samples,
        minimum_spike_count=minimum_spike_count,
        delay_spont_est=delay_spont_est, msrmp=msrmp,
        scale_factor=scale_factor, penalty=penalty,
        max_backtrack_iters=max_backtrack_iters, tol=tol,
        spont_orthogonality=spont_orthogonality, analytic_mc=analytic_mc,
        save_histories=bool(save_histories), sweep_block_size=block,
        update_order=update_order, track_elbo=bool(track_elbo),
        elbo_tol=None if elbo_tol is None else float(elbo_tol))
    mu, beta, lam, z, phi, phi_cov = finish(
        mesh, final, d, K, hyper, fn_scan, msrmp, minimum_spike_count,
        verbose)
    if save_histories:
        hist = _widen(_histories(mesh, snaps, K, (2, 7), 8), (3, 4), K)
    else:
        hist = [None] * 8
    out = (mu, beta, lam, final.shape[0], final.rate[0], phi, phi_cov, z,
           None, *hist)
    return out + (elbo_out,) if track_elbo else out


def finish(mesh, final, d, K, hyper, fn_scan, msrmp, minimum_spike_count,
           verbose=False):
    """The fit's outputs on the first device, lam and z gathered and
    trimmed to K, after the reconnection scan (and its refit) with
    ``fn_scan``."""
    mu, beta, phi, phi_cov = (final.mu[0], final.beta[0], final.phi[0],
                              final.phi_cov[0])
    lam, z = _trim(mesh, final.lam, K), _trim(mesh, final.z, K)
    if fn_scan:
        mu, beta, lam, z, phi, phi_cov, n_rec = _reconnect_and_refit(
            _trim(mesh, d.stim, K), lam, mu, beta, z, d.powers[0], phi,
            phi_cov, hyper[4][0], hyper[5][0], float(msrmp),
            float(minimum_spike_count))
        if verbose:
            print(f"Reconnected {n_rec} neurons previously attributed to "
                  "spontaneous activity.")
    return mu, beta, lam, z, phi, phi_cov


# ---------------------------------------------------------------------------
# Sharded CAVI-SnS
# ---------------------------------------------------------------------------


class _SnsState(NamedTuple):
    mu: list
    beta: list
    alpha: list
    lam: list
    shape: list
    rate: list
    phi: list
    phi_cov: list


def _host_order(order):
    return [int(n) for n in order[0].tolist()]


def _sns_sweep_means(mesh, y, mu, beta, alpha, lam, sig, mu_prior,
                     beta_prior, order):
    """Sequential mu sweep; one scalar psum a row."""
    r = mesh.map(lambda m, a, lm: _vm(m * a, lm), mu, alpha, lam)
    ylam = mesh.psum(mesh.map(lambda lm, yy, s: _mv(lm, s * yy), lam, y, sig))
    mu = mesh.rep(torch.clone, mu)
    for n in _host_order(order):
        r_excl = mesh.map(lambda r_, m, a, lm: r_ - m[n] * a[n] * lm[n], r,
                          mu, alpha, lam)
        dot = mesh.psum(mesh.map(lambda lm, rx: torch.dot(lm[n], rx), lam,
                                 r_excl))

        def put(m, b, a, yl, s, dt, mp, bp):
            m[n] = (b[n] * b[n]) * (a[n] * yl[n] - a[n] * s * dt
                                    + mp[n] / (bp[n] * bp[n]))
            return m
        mu = mesh.rep(put, mu, beta, alpha, ylam, sig, dot, mu_prior,
                      beta_prior)
        r = mesh.map(lambda rx, m, a, lm: rx + m[n] * a[n] * lm[n], r_excl,
                     mu, alpha, lam)
    return mu


def _sns_sweep_connection_probs(mesh, y, mu, beta, alpha, lam, sig,
                                alpha_prior, order):
    """Sequential alpha sweep; one scalar psum a row."""
    eps = 1e-10
    r = mesh.map(lambda m, a, lm: _vm(m * a, lm), mu, alpha, lam)
    ydot = mesh.psum(mesh.map(_mv, lam, y))
    lam_sum = mesh.psum(mesh.map(lambda lm: torch.sum(lm, dim=1), lam))
    prior_logit = mesh.rep(
        lambda ap: torch.log((ap + eps) / (1.0 - ap + eps)), alpha_prior)
    alpha = mesh.rep(torch.clone, alpha)
    for n in _host_order(order):
        r_excl = mesh.map(lambda r_, m, a, lm: r_ - m[n] * a[n] * lm[n], r,
                          mu, alpha, lam)
        dot = mesh.psum(mesh.map(lambda lm, rx: torch.dot(lm[n], rx), lam,
                                 r_excl))

        def put(a, m, b, yd, ls, s, dt, pl):
            quad = (-2.0 * m[n] * yd[n] + 2.0 * m[n] * dt
                    + (m[n] * m[n] + b[n] * b[n]) * ls[n])
            a[n] = torch.sigmoid(pl[n] - 0.5 * s * quad)
            return a
        alpha = mesh.rep(put, alpha, mu, beta, ydot, lam_sum, sig, dot,
                         prior_logit)
        r = mesh.map(lambda rx, m, a, lm: rx + m[n] * a[n] * lm[n], r_excl,
                     mu, alpha, lam)
    return alpha


def _sns_sweep_spikes(mesh, y, stim, mu, beta, alpha, lam, sig, m0, m1,
                      lam_mask, order, minimum_spike_count):
    """Sequential lam sweep; the spike-count gate psums a row."""
    r = mesh.map(lambda m, a, lm: _vm(m * a, lm), mu, alpha, lam)
    lam = mesh.map(torch.clone, lam)
    w = mesh.rep(lambda m, a: m * a, mu, alpha)
    q = mesh.rep(lambda m, b, a: (m * m + b * b) * a, mu, beta, alpha)
    for n in _host_order(order):
        def est_of(yy, st, r_, lm, w_, q_, s, a0, a1, mask):
            r_excl = r_ - w_[n] * lm[n]
            quad = -2.0 * yy * w_[n] + 2.0 * w_[n] * r_excl + q_[n]
            return r_excl, mask * (st[n] > 0) * torch.sigmoid(
                a0[n] * st[n] - a1[n] - 0.5 * s * quad)
        r_excl, est = mesh.map(est_of, y, stim, r, lam, w, q, sig, m0, m1,
                               lam_mask)
        total = mesh.psum(mesh.map(torch.sum, est))

        def put(lm, e, tot, rx, w_):
            new = e * (tot >= minimum_spike_count)
            lm[n] = new
            return rx + w_[n] * new
        r = mesh.map(put, lam, est, total, r_excl, w)
    return lam


def _sns_iteration(mesh, st, d, hyper, generator, static):
    (mu_prior, beta_prior, alpha_prior, shape_prior, rate_prior, phi_prior,
     phi_cov_prior) = hyper
    N = st.lam[0].shape[0]
    sig = mesh.rep(lambda a, b: a / b, st.shape, st.rate)
    orders, m0, m1 = draw(mesh, generator, N, static["update_order"],
                          st.phi, st.phi_cov, static["num_mc_samples"],
                          static["analytic_mc"], orders=3)
    lam_sum = mesh.psum(mesh.map(lambda lm: torch.sum(lm, dim=1), st.lam))
    beta = mesh.rep(lambda a, s, ls, bp: 1.0 / torch.sqrt(
        a * s * ls + 1.0 / (bp * bp)), st.alpha, sig, lam_sum, beta_prior)
    mu = _sns_sweep_means(mesh, d.y, st.mu, beta, st.alpha, st.lam, sig,
                          mu_prior, beta_prior, orders[0])
    alpha = _sns_sweep_connection_probs(mesh, d.y, mu, beta, st.alpha,
                                        st.lam, sig, alpha_prior, orders[1])
    lam = _sns_sweep_spikes(mesh, d.y, d.stim, mu, beta, alpha, st.lam, sig,
                            m0, m1, d.lam_mask, orders[2],
                            static["minimum_spike_count"])

    def parts(yy, lm, m, b, a):
        w = m * a
        row_lam = torch.sum(lm, dim=1)
        return torch.stack([
            torch.sum(torch.square(yy - _vm(w, lm))),
            torch.sum(w * w * torch.sum(lm * lm, dim=1)),
            torch.sum((m * m + b * b) * a * row_lam)])
    red = mesh.psum(mesh.map(parts, d.y, lam, mu, beta, alpha))
    shape, rate = mesh.rep(lambda r, sp, rp: (sp + 0.5 * d.k_global,
                                              rp + 0.5 * (r[0] - r[1] + r[2])),
                           red, shape_prior, rate_prior)
    S = bucket_sums(mesh, lam, d.stim, d.levels, d.valid)
    phi, phi_cov = refit_phi(mesh, S, d.C, d.levels, phi_prior,
                             phi_cov_prior)
    return _SnsState(mu, beta, alpha, lam, shape, rate, phi, phi_cov)


def run_sns_sharded(mesh, d, hyper, generator, lam0, *, iters,
                    num_mc_samples, minimum_spike_count, analytic_mc,
                    save_histories, update_order="random"):
    """The CAVI-SnS loop over the mesh; returns (final state, the
    per-iteration states when ``save_histories``)."""
    (mu_prior, beta_prior, alpha_prior, shape_prior, rate_prior, phi_prior,
     phi_cov_prior) = hyper
    N = lam0[0].shape[0]
    st = _SnsState(mu_prior, beta_prior, alpha_prior, lam0, shape_prior,
                   rate_prior, mesh.rep(lambda p: p.expand(N, 2), phi_prior),
                   mesh.rep(lambda p: p.expand(N, 2, 2), phi_cov_prior))
    static = dict(num_mc_samples=int(num_mc_samples),
                  minimum_spike_count=int(minimum_spike_count),
                  analytic_mc=bool(analytic_mc), update_order=update_order)
    snaps = []
    for _ in range(int(iters)):
        st = _sns_iteration(mesh, st, d, hyper, generator, static)
        if save_histories:
            snaps.append(st)
    return st, snaps


def cavi_sns_sharded(
    y_psc, stim, mu_prior, beta_prior, alpha_prior, shape_prior, rate_prior,
    phi_prior, phi_cov_prior, mesh, iters=50, num_mc_samples=100, seed=1,
    minimum_spike_count=3, save_histories=True, dtype=torch.float32,
    analytic_mc=False, y_xcorr_thresh=1e-2, laplace_impl="auto",
    update_order="random", trace_wire=None, verbose=True,
):
    """Fit CAVI-SnS with the trial axis sharded over ``mesh``; the
    signature of ``circuitmap_tpu.parallel.cavi_sns_sharded`` plus
    ``trace_wire`` (as ``cavi_sns``). Returns ``cavi_sns()``'s tuple
    ``(mu, beta, alpha, lam, shape, rate, phi, phi_cov, *eight
    histories)``. As in the single-device solver no trial activity mask
    applies (``y_xcorr_thresh`` is accepted for the signature); the
    mask only excludes the padding. The mu, alpha and lam sweeps psum
    one scalar a row."""
    _require_local(mesh, "cavi_sns_sharded()")
    dtype = _fit_dtype(mesh, dtype)
    resolve_laplace_impl(laplace_impl)
    update_order = _validate_update_order(str(update_order))
    d, K = _prep(y_psc, stim, mesh, dtype, y_xcorr_thresh,
                 trace_wire=trace_wire, mask="none",
                       what="cavi_sns_sharded()")
    if verbose:
        print(f"Running CAVI-SnS sharded over {mesh.size} shards (K={K}).")
    hyper = _hyper(mesh, dtype, mu_prior, beta_prior, alpha_prior,
                   shape_prior, rate_prior, phi_prior, phi_cov_prior)
    final, snaps = run_sns_sharded(
        mesh, d, hyper, seeded_generator(seed, mesh.devices[0]),
        _lam0(mesh, d, 0.95), iters=int(iters),
        num_mc_samples=num_mc_samples,
        minimum_spike_count=minimum_spike_count, analytic_mc=analytic_mc,
        save_histories=bool(save_histories), update_order=update_order)
    if save_histories:
        hist = _widen(_histories(mesh, snaps, K, (3,), 8), (4, 5), K)
    else:
        hist = [None] * 8
    return (final.mu[0], final.beta[0], final.alpha[0],
            _trim(mesh, final.lam, K), final.shape[0], final.rate[0],
            final.phi[0], final.phi_cov[0], *hist)


# ---------------------------------------------------------------------------
# Sharded MBCS
# ---------------------------------------------------------------------------


def _mbcs_weights(mesh, y, mu, lam, shape, rate, valid, k_global, p):
    """Penalty-shrinking FISTA lasso: the normal-equation statistics
    psum once (A is fixed across the penalty loop), the recursion runs
    replicated; the residual norm is a psum'd scalar a penalty step."""
    from ..solvers.mbcs import _fista

    flip = p["constrain_weights"] == "negative"
    positive = p["constrain_weights"] in ("positive", "negative")
    A = mesh.map(lambda lm: -lm if flip else lm, lam)       # rows of A^T
    stats = mesh.psum(mesh.map(_gram_and_projection, A, y))
    constr = mesh.rep(torch.sqrt, mesh.psum(mesh.map(
        lambda v, r, s: torch.sum(v * r / s), valid, rate, shape)))

    def setup(st):
        N = st.shape[0]
        AtA, Aty = st[:, :N] / k_global, st[:, N] / k_global
        v = torch.ones(N, dtype=st.dtype, device=st.device) / np.sqrt(N)
        for _ in range(30):
            w = _mv(AtA, v)
            v = w / (torch.linalg.norm(w) + 1e-12)
        return AtA, Aty, 1.0 / torch.clamp(torch.dot(v, _mv(AtA, v)),
                                           min=1e-8)
    setups = mesh.rep(lambda st: (setup(st),), stats)[0]
    coef = mesh.rep(lambda m: -m if flip else m, mu)
    pen = mesh.rep(lambda c: torch.full((), p["penalty"], dtype=c.dtype,
                                        device=c.device), constr)
    for i in range(p["max_penalty_iters"]):
        new = mesh.rep(lambda su, c, pn: _fista(
            su, c, pn, p["max_lasso_iters"], positive), setups, coef, pen)
        err = mesh.rep(torch.sqrt, mesh.psum(mesh.map(
            lambda yy, a, x: torch.sum(torch.square(yy - _vm(x, a))), y, A,
            new)))
        done = mesh.rep(lambda e, c: e <= c, err, constr)
        if i > 0:
            done = mesh.rep(
                lambda dn, x, c: dn | (torch.all(torch.abs(x - c) < 1e-5)
                                       & ~torch.all(x == 0)), done, new, coef)
        coef, pen = new, mesh.rep(lambda pn: pn * p["scale_factor"], pen)
        if bool(done[0]):
            break
    return mesh.rep(lambda c: -c if flip else c, coef)


def _mbcs_receptive_fields(mesh, lam, stim, pw, valid):
    S = bucket_sums(mesh, lam, stim, pw, valid)
    C = mesh.psum(mesh.map(lambda st, lv, v: torch.stack(
        [torch.sum((st == lv[q]).to(v.dtype) * v[None, :], -1)
         for q in range(lv.shape[0])], dim=1), stim, pw, valid))

    def fit(s, c):
        rates = s / torch.clamp(c, min=1.0)
        rates[:, 0] = 0.0
        return torch.clamp(isotonic_regression_batched(rates, 1.0), 0.0, 1.0)
    rf = mesh.rep(fit, S, C)

    def prior(st, lv, f):
        out = torch.zeros_like(st)
        for q in range(lv.shape[0]):
            out = out + torch.where(st == lv[q], f[:, q:q + 1], 0.0)
        return out
    return rf, mesh.map(prior, stim, pw, rf)


def _mbcs_noise_mc(mesh, generator, shard_generators, y, mu, beta, lam,
                   noise_scale, num_mc_samples, eps=1e-4):
    """MC noise model: the weight draws from the fit's generator,
    replicated; each shard's spike uniforms from its own generator, so
    results are statistically (not bit for bit) the single-device
    model's."""
    S = int(num_mc_samples)
    m0 = mu[0]
    w = m0[None, :] + (beta[0] * (m0 != 0))[None, :] * torch.randn(
        (S,) + tuple(m0.shape), generator=generator, dtype=m0.dtype,
        device=m0.device)
    w = mesh.replicate(w)

    def one(g, yy, m, lm, ws_):
        s = (torch.rand((S,) + tuple(lm.shape), generator=g,
                        device=g.device, dtype=lm.dtype).to(lm.device)
             <= lm[None]).to(lm.dtype)
        with highest_matmul():
            ws = torch.bmm(ws_[:, None, :], s)[:, 0, :]
        mc_sq = torch.mean(ws * ws, dim=0)
        mc_err = torch.mean(torch.square(yy[None] - ws), dim=0)
        return (noise_scale * noise_scale * mc_sq + 0.5,
                noise_scale * _vm(m, lm) + 0.5 * mc_err + eps)
    return mesh.map(one, shard_generators, y, mu, lam, w)


def _mbcs_outliers(mesh, y, mu, lam, lam_mask, p):
    resid = mesh.map(lambda yy, m, lm: yy - _vm(m, lm), y, mu, lam)
    explained = mesh.map(lambda lm: torch.any(lm >= 0.5, dim=0), lam)
    denom = mesh.psum(mesh.map(lambda yy: torch.sum(yy * yy), y))
    err = mesh.rep(lambda d_: torch.full_like(d_, float("inf")), denom)
    pen = mesh.rep(lambda d_: torch.full_like(d_, p["outlier_penalty"]),
                   denom)
    z = mesh.map(torch.zeros_like, resid)
    for _ in range(p["max_penalty_iters"]):
        live = mesh.rep(lambda e: e > p["outlier_tol"], err)

        def new_z(rs, pn, ex, m):
            zn = torch.clamp(torch.where(rs < pn, 0.0, rs - pn), min=0.0)
            if p["orthogonal_outliers"]:
                zn = torch.where(ex, 0.0, zn)
            return zn * m
        z_new = mesh.map(new_z, resid, pen, explained, lam_mask)
        red = mesh.psum(mesh.map(lambda rs, zn: torch.sum(
            torch.square(rs - zn)), resid, z_new))
        z = mesh.map(lambda lv, zn, zo: torch.where(lv, zn, zo), live, z_new,
                     z)
        err = mesh.rep(lambda lv, r_, d_, e: torch.where(lv, r_ / d_, e),
                       live, red, denom, err)
        pen = mesh.rep(lambda lv, pn: torch.where(
            lv, pn * p["scale_factor"], pn), live, pen)
    return z


def run_mbcs_sharded(mesh, d, lam0, mu0, beta_prior, shape0, rate0,
                     spont_rate0, generator, shard_generators, p, *, iters,
                     save_histories):
    """The MBCS loop over the mesh; returns (final (mu, beta, lam,
    shape, rate, z, spont_rate), receptive fields, per-iteration (mu,
    beta, lam, shape, rate, z) when ``save_histories``)."""
    from ..solvers.mbcs import sweep_spikes_mbcs, update_noise_analytic

    N = lam0[0].shape[0]
    mu, beta, lam, shape, rate = mu0, beta_prior, lam0, shape0, rate0
    z = mesh.map(torch.zeros_like, d.y)
    spont, prior = spont_rate0, lam0
    rf = mesh.rep(lambda m: m.new_zeros((N, d.levels[0].shape[0])), mu0)
    snaps = []
    for it in range(int(iters)):
        sums = mesh.psum(mesh.map(
            lambda lm, sh, rt: torch.sum((sh / rt)[None, :] * lm, dim=1),
            lam, shape, rate))
        beta = mesh.rep(lambda s, bp: 1.0 / torch.sqrt(s + 1.0 / (bp * bp)),
                        sums, beta_prior)
        mu = _mbcs_weights(mesh, d.y, mu, lam, shape, rate, d.valid,
                           d.k_global, p)
        order = mesh.replicate(torch.randperm(N, generator=generator,
                                              device=mesh.devices[0]))
        if p["learn_lam"]:  # each row's update is local to the shard
            lam = mesh.map(sweep_spikes_mbcs, d.y, d.stim, mu, beta, lam,
                           shape, rate, d.lam_mask, prior, order)
        rf, prior = _mbcs_receptive_fields(mesh, lam, d.stim, d.levels,
                                           d.valid)
        n_spk = mesh.psum(mesh.map(
            lambda lm: torch.sum((lm >= 0.5).to(lm.dtype), dim=1), lam))
        keep = mesh.rep(lambda f, c, sr: ((f[:, -1] >= p[
            "minimum_maximal_spike_prob"] + sr) & (c >= p[
                "minimum_spike_count"])).to(f.dtype), rf, n_spk, spont)
        mu = mesh.rep(lambda m, k: m * k, mu, keep)
        lam = mesh.map(lambda lm, k: lm * k[:, None], lam, keep)
        if p["analytic_noise"]:  # per trial: local, bit-exact
            shape, rate = mesh.map(lambda yy, m, b, lm: update_noise_analytic(
                yy, m, b, lm, noise_scale=p["noise_scale"]), d.y, mu, beta,
                lam)
        else:
            shape, rate = _mbcs_noise_mc(
                mesh, generator, shard_generators, d.y, mu, beta, lam,
                p["noise_scale"], p["num_mc_samples_noise_model"])
        if it > p["delay_spont_estimation"]:
            z = _mbcs_outliers(mesh, d.y, mu, lam, d.lam_mask, p)
            spont = mesh.rep(lambda c: c / d.k_global, mesh.psum(mesh.map(
                lambda zz: torch.sum((zz != 0.0).to(zz.dtype)), z)))
        if save_histories:
            snaps.append((mu, beta, lam, shape, rate, z))
    return (mu, beta, lam, shape, rate, z, spont), rf, snaps


def mbcs_sharded(
    y_psc, stim, mu_prior, beta_prior, shape_prior, rate_prior, mesh,
    iters=50, seed=0, y_xcorr_thresh=0.05, penalty=5e0, scale_factor=0.5,
    max_penalty_iters=10, max_lasso_iters=100, constrain_weights="positive",
    learn_lam=True, delay_spont_estimation=1, minimum_spike_count=1,
    noise_scale=0.5, num_mc_samples_noise_model=10,
    minimum_maximal_spike_prob=0.2, orthogonal_outliers=True,
    outlier_penalty=5e1, init_spike_prior=0.75, outlier_tol=0.05,
    spont_rate=0, lam_mask_fraction=0.05, dtype=torch.float32,
    save_histories=True, init_lam=None, verbose=False, analytic_noise=False,
    **_compat,
):
    """Fit MBCS with the trial axis sharded over ``mesh``; the signature
    of ``circuitmap_tpu.parallel.mbcs_sharded``. Returns ``mbcs()``'s
    tuple ``(mu, beta, lam, shape, rate, z, receptive_fields, *six
    histories)``. The MC noise model's spike draws are shard-local
    (statistically, not bit for bit, the single-device model's);
    ``analytic_noise=True`` is exact. ``_compat`` takes the single
    fit's keywords that have no sharded meaning (``num_mc_samples``,
    ``warm_start_lasso``, ``learn_noise``)."""
    from ..solvers.mbcs import _activity_mask, fit_params

    _require_local(mesh, "mbcs_sharded()")
    dtype = _fit_dtype(mesh, dtype)
    dev0 = mesh.devices[0]
    N = np.asarray(mu_prior).shape[0]
    mask = _activity_mask(
        y_psc.to(dev0) if isinstance(y_psc, torch.Tensor) else y_psc,
        y_xcorr_thresh, lam_mask_fraction)
    d, K = _prep(y_psc, stim, mesh, dtype, y_xcorr_thresh, mask=mask,
                 what="mbcs_sharded()")
    if verbose:
        print(f"Running MBCS sharded over {mesh.size} shards (K={K}).")
    params = fit_params(
        penalty=penalty, scale_factor=scale_factor,
        max_penalty_iters=max_penalty_iters, max_lasso_iters=max_lasso_iters,
        constrain_weights=constrain_weights, learn_lam=learn_lam,
        delay_spont_estimation=delay_spont_estimation,
        minimum_spike_count=minimum_spike_count,
        num_mc_samples_noise_model=num_mc_samples_noise_model,
        orthogonal_outliers=orthogonal_outliers,
        analytic_noise=analytic_noise, outlier_penalty=outlier_penalty,
        minimum_maximal_spike_prob=minimum_maximal_spike_prob,
        outlier_tol=outlier_tol, noise_scale=noise_scale)
    if init_lam is None:
        lam0 = _lam0(mesh, d, float(init_spike_prior))
    else:
        lam0 = mesh.split(_pad_cols(_as(init_lam, dtype, dev0),
                                    d.valid[0].shape[0] * mesh.n_local))
    final, rf, snaps = run_mbcs_sharded(
        mesh, d, lam0,
        mesh.replicate(_as(np.random.default_rng(seed).lognormal(
            1.0, 1.0, N), dtype, dev0)),
        _hyper(mesh, dtype, beta_prior)[0],
        mesh.map(lambda yy: torch.full_like(yy, float(shape_prior)), d.y),
        mesh.map(lambda yy: torch.full_like(yy, float(rate_prior)), d.y),
        mesh.replicate(torch.tensor(float(spont_rate), dtype=dtype,
                                    device=dev0)),
        seeded_generator(seed, dev0), shard_generators(mesh, seed), params,
        iters=iters, save_histories=bool(save_histories))
    mu, beta, lam, shape, rate, z, _ = final
    if save_histories:
        hist = _histories(mesh, snaps, K, (2, 3, 4, 5), 6)
    else:
        hist = [None] * 6
    return (mu[0], beta[0], _trim(mesh, lam, K), _trim(mesh, shape, K),
            _trim(mesh, rate, K), _trim(mesh, z, K), rf[0], *hist)


def shard_generators(mesh, seed):
    """One generator per local shard for shard-local draws, seeded from
    ``seed`` and the shard's global index."""
    return [seeded_generator(int(seed) * 1_000_003 + mesh.rank * mesh.n_local
                             + s + 1, d)
            for s, d in enumerate(mesh.devices)]


def shard_tensors(mesh, y, stim, lam_mask, k_true, powers):
    """The :class:`ShardData` of device-resident capacity buffers (the
    streaming fit's): ``y``, ``lam_mask`` [C] and ``stim`` [N, C] whose
    columns from ``k_true`` on are inert, C a multiple of the shard
    count, split over the shards."""
    from ..solvers.caviar import power_counts_of

    cap, n = y.shape[-1], stim.shape[0]
    valid = (torch.arange(cap, device=y.device) < k_true).to(y.dtype)
    stim_p = mesh.split(torch.cat([stim, stim.new_zeros((1, cap))]))
    counts = power_counts_of(stim, powers, y.dtype)
    C = torch.cat([(k_true - torch.sum(counts, 1))[:, None], counts], 1)
    levels = torch.cat([powers.new_zeros(1), powers])
    return ShardData(mesh.split(y), [sp[:n] for sp in stim_p], stim_p,
                     mesh.split(lam_mask * valid), mesh.split(valid),
                     mesh.replicate(powers), mesh.replicate(levels),
                     mesh.replicate(counts), mesh.replicate(C), float(k_true))
