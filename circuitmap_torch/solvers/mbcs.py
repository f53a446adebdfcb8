"""MBCS: model-based compressed sensing with isotonic regularisation
(port of ``circuitmap_tpu/solvers/mbcs.py``).

Lasso-constrained weight updates (FISTA with a shrinking penalty),
isotonic receptive fields as spike priors, a Monte-Carlo spike-dependent
noise model (or its exact moments) and a soft-threshold outlier
estimate. Everything runs in plain PyTorch on the fit's device: the
MBCS sweep takes a per-trial noise vector, a per-trial spike prior and
skips disconnected rows, so it does not map onto the CAVIaR sweep
kernel (and is no Pallas kernel in the JAX package either).

The updates take one experiment or a stack of independent experiments
with a leading axis (``mbcs_many``'s batched mode, solvers/batched.py):
FISTA over [E, N, N] with a stopping flag per experiment, and a spike
sweep over the union of the experiments' connected rows.

Host reads: the penalty loop of the weight update reads its stopping
flags once a penalty step, and the spike sweep reads the row order and
the connected rows once a sweep; nothing is read per row.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import highest_matmul, resolve_device, torch_dtype
from ..ops.charge import integrated_charge
from ..ops.pava import isotonic_regression_batched
from ._common import prepare_stim, prepare_traces, warn_data_thin_design_dense
from .caviar import _as, _each_expt, _each_stream, _mv, _vm, seeded_generator


# ---------------------------------------------------------------------------
# FISTA lasso (the reference's sklearn Lasso)
# ---------------------------------------------------------------------------


def _lasso_setup(A, y):
    """(AtA, Aty, step) of the lasso on A [K, N]: the Gram matrix and
    correlations over K, and the step 1/L with L the largest eigenvalue
    of AtA (30 power iterations)."""
    K, N = A.shape
    with highest_matmul():
        AtA = (A.T @ A) / K
    Aty = _mv(A.T, y) / K
    v = torch.ones(N, dtype=A.dtype, device=A.device) / np.sqrt(N)
    for _ in range(30):
        w = _mv(AtA, v)
        v = w / (torch.linalg.norm(w) + 1e-12)
    L = torch.clamp(torch.dot(v, _mv(AtA, v)), min=1e-8)
    return AtA, Aty, 1.0 / L


def _each(many, fn, *arrays):
    """``fn`` on the arrays, or with ``many`` on each experiment's slices
    of them, stacked (``caviar._each_expt``): a stack's products and
    reductions are its single fits' own, so the batched loop rounds as
    the sequential one does, and MBCS's thresholds (the lasso's zeros,
    the isotonic filter) decide alike."""
    return _each_expt(fn, *arrays) if many else fn(*arrays)


def _momentum_coefs(max_iters, dtype):
    """FISTA's momentum factors (t - 1) / t_new, computed in the fit's
    float width as the device recursion would."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    t, one, coefs = np_dtype(1.0), np_dtype(1.0), []
    for _ in range(max_iters):
        t_new = np_dtype(0.5) * (one + np.sqrt(one + np_dtype(4.0) * t * t))
        coefs.append(float((t - one) / t_new))
        t = t_new
    return coefs


def _fista(setup, x0, penalty, max_iters, positive):
    AtA, Aty, step = setup
    thresh = (step * penalty)[..., None]
    step = step[..., None]

    def prox(u):
        if positive:  # sign(u) * max(|u| - thresh, 0), clipped at 0
            return torch.clamp(u - thresh, min=0.0)
        return torch.sign(u) * torch.clamp(torch.abs(u) - thresh, min=0.0)

    def grad_of(a, b, v):  # AtA x - Aty
        return torch.addmv(b, a, v, beta=-1.0)

    x, x_last = x0, x0
    with highest_matmul():
        for coef in _momentum_coefs(max_iters, x0.dtype):
            grad = _each(x.dim() > 1, grad_of, AtA, Aty, x)
            x_new = prox(torch.addcmul(x, step, grad, value=-1.0))
            x = torch.add(x_new, x_new - x_last, alpha=coef)
            x_last = x_new
    return x_last


def _fista_lasso(A, y, x0, penalty, max_iters=200, positive=True):
    """min_x 0.5/K * ||y - A x||^2 + penalty * ||x||_1 (sklearn's
    objective) by accelerated proximal gradient with the fixed step 1/L.
    A: [K, N]."""
    return _fista(_lasso_setup(A, y), x0, penalty, int(max_iters), positive)


def update_weights_constrained_l1(
    y, mu, lam, shape, rate, penalty=1.0, scale_factor=0.5,
    max_penalty_iters=10, max_lasso_iters=100, constrain_weights="positive",
    verbose=False, tol=1e-5,
):
    """Penalty-shrinking constrained Lasso weight update: shrinks the L1
    penalty geometrically until the residual meets the noise-scale
    constraint ``sqrt(sum(rate/shape))``, or until shrinking no longer
    changes the solution. A stack of experiments ([E, ...] arrays) runs
    FISTA over [E, N, N] Gram matrices, and each experiment stops on its
    own: a stopped experiment keeps its weights and penalty while the
    others go on. Reads the stopping flags on the host once a penalty
    step; the lasso's Gram matrix and step are computed once."""
    del verbose
    many = lam.dim() > 2
    constr = _each(many, lambda r, s: torch.sqrt(torch.sum(r / s)), rate,
                   shape)
    flip = constrain_weights == "negative"
    A = (-lam if flip else lam).mT  # [..., K, N]
    coef = -mu if flip else mu
    positive = constrain_weights in ("positive", "negative")
    pen = torch.full(constr.shape, float(penalty), dtype=lam.dtype,
                     device=lam.device)
    live = torch.ones(constr.shape, dtype=torch.bool, device=lam.device)
    setup = _each(many, _lasso_setup, A, y)
    for i in range(int(max_penalty_iters)):
        new = _fista(setup, coef, pen, int(max_lasso_iters), positive)
        err = _each(many, lambda yy, a, x: torch.linalg.norm(yy - _mv(a, x)),
                    y, A, new)
        done = err <= constr
        if i > 0:
            plateau = (torch.all(torch.abs(new - coef) < tol, dim=-1)
                       & ~torch.all(new == 0, dim=-1))
            done = done | plateau
        coef = torch.where(live[..., None], new, coef)
        pen = torch.where(live, pen * scale_factor, pen)
        live = live & ~done
        if not bool(live.any()):
            break
    return -coef if flip else coef


# ---------------------------------------------------------------------------
# Isotonic receptive fields (the reference's sklearn IsotonicRegression)
# ---------------------------------------------------------------------------


def update_receptive_fields(lam, stim, powers_with_zero):
    """Isotonic fit of per-power spike rates, incl. the zero-power knot.

    Returns (receptive_field [N, P+1], spike_prior [N, K]): the prior at
    each trial is the fitted value at that trial's power.
    """
    pw = torch.as_tensor(powers_with_zero, dtype=lam.dtype, device=lam.device)
    P1 = pw.shape[0]
    S = torch.stack([torch.sum(torch.where(stim == pw[p], lam, 0.0), dim=-1)
                     for p in range(P1)], dim=1)
    counts = torch.stack([torch.sum((stim == pw[p]).to(lam.dtype), dim=-1)
                          for p in range(P1)], dim=1)
    rates = S / torch.clamp(counts, min=1.0)
    rates[:, 0] = 0.0  # zero power: zero rate, as the reference
    rf = torch.clamp(isotonic_regression_batched(rates, 1.0), 0.0, 1.0)
    spike_prior = torch.zeros_like(lam)
    for p in range(P1):
        spike_prior = spike_prior + torch.where(stim == pw[p], rf[:, p:p + 1],
                                                0.0)
    return rf, spike_prior


def isotonic_filtering(mu, lam, receptive_field, minimum_spike_count=1,
                       minimum_maximal_spike_prob=0.2):
    """Disconnect cells failing the max-power rate or spike-count floor.
    ``minimum_maximal_spike_prob``: a number, or one per experiment."""
    floor = torch.as_tensor(minimum_maximal_spike_prob)
    if floor.dim():
        floor = floor[..., None]
    keep = ((receptive_field[..., -1] >= floor)
            & (torch.sum(lam >= 0.5, dim=-1) >= minimum_spike_count))
    keep = keep.to(mu.dtype)
    return mu * keep, lam * keep[..., None]


# ---------------------------------------------------------------------------
# Remaining updates
# ---------------------------------------------------------------------------


def update_slab_scale_mbcs(lam, shape, rate, beta_prior):
    """beta update with the per-trial noise vector."""
    return 1.0 / torch.sqrt(torch.sum((shape / rate)[None, :] * lam, dim=1)
                            + 1.0 / (beta_prior * beta_prior))


def update_noise_mc(generator, y, mu, beta, lam, noise_scale=0.5,
                    num_mc_samples=10, eps=1e-4):
    """Monte-Carlo spike-dependent noise model: per-trial gamma
    parameters from ``num_mc_samples`` sampled weights and spikes (the
    normals, then the uniforms, from ``generator``)."""
    S = int(num_mc_samples)
    std = beta * (mu != 0)
    w = mu[None, :] + std[None, :] * torch.randn(
        (S,) + tuple(mu.shape), generator=generator, dtype=mu.dtype,
        device=mu.device)
    s = (torch.rand((S,) + tuple(lam.shape), generator=generator,
                    dtype=lam.dtype, device=lam.device) <= lam[None]
         ).to(lam.dtype)
    with highest_matmul():
        ws = torch.bmm(w[:, None, :], s)[:, 0, :]  # [S, K]
    mc_sq = torch.mean(ws * ws, dim=0)
    mc_err = torch.mean(torch.square(y[None] - ws), dim=0)
    shape = noise_scale * noise_scale * mc_sq + 0.5
    rate = noise_scale * _vm(mu, lam) + 0.5 * mc_err + eps
    return shape, rate


def update_noise_analytic(y, mu, beta, lam, noise_scale=0.5, eps=1e-4):
    """Exact moments of the spike-dependent noise model: the limit of
    ``update_noise_mc`` at infinitely many samples, with

        E[ws]       = sum_n mu_n lam_nk
        Var[ws]     = sum_n [(mu_n^2 + std_n^2) lam_nk - mu_n^2 lam_nk^2]
        E[(y-ws)^2] = y^2 - 2 y E[ws] + E[ws]^2 + Var[ws]
    """
    std2 = beta * beta * (mu != 0)
    pred = _vm(mu, lam)
    second = _vm(mu * mu + std2, lam)
    sq_correction = _vm(mu * mu, lam * lam)
    var = second - sq_correction
    e_sq = pred * pred + var
    e_err = y * y - 2.0 * y * pred + e_sq
    shape = noise_scale * noise_scale * e_sq + 0.5
    rate = noise_scale * pred + 0.5 * e_err + eps
    return shape, rate


def sweep_spikes_mbcs(y, stim, mu, beta, lam, shape, rate, lam_mask,
                      spike_prior, order):
    """Sequential lam sweep with the isotonic receptive-field prior;
    shape and rate are per-trial vectors. A row whose weight is 0 keeps
    its lam and leaves the residual as it was, so only the connected
    rows are visited (read to the host with the order, once a sweep)."""
    sig = shape / (2.0 * rate)  # [K]
    r = _vm(mu, lam)
    m2y = -2.0 * y
    lam = lam.clone()
    live = set(torch.nonzero(mu != 0).flatten().tolist())
    for n in (int(n) for n in order.tolist()):
        if n not in live:
            continue
        lam_n = lam[n]
        r_excl = r - mu[n] * lam_n
        quad = (m2y * mu[n] + 2.0 * mu[n] * r_excl
                + (mu[n] * mu[n] + beta[n] * beta[n]))
        new = (lam_mask * (stim[n] > 0)) * torch.sigmoid(spike_prior[n]
                                                          - sig * quad)
        r = r_excl + mu[n] * new
        lam[n] = new
    return lam


def _sweep_spikes_mbcs_many(y, stim, mu, beta, lam, shape, rate, lam_mask,
                            spike_prior, orders):
    """:func:`sweep_spikes_mbcs` over a stack of experiments ([E, ...]
    arrays, ``orders`` [E, N]): at each position of the orders it visits
    the rows of every experiment at once, but only the positions where
    some experiment's row is connected (read to the host with the
    orders, once a sweep), and each row's new lam is taken only where
    its experiment's weight is nonzero. A zero weight leaves the
    residual exactly as it was, so each experiment's result is its own
    sweep's."""
    E = lam.shape[0]
    sig = shape / (2.0 * rate)  # [E, K]
    r = _each_expt(_vm, mu, lam)
    m2y = -2.0 * y
    lam = lam.clone()
    live = mu != 0
    ex = torch.arange(E, device=lam.device)
    orders_h, live_h = orders.cpu().numpy(), live.cpu().numpy()
    visit = live_h[np.arange(E)[:, None], orders_h].any(axis=0)
    for i in np.flatnonzero(visit):
        n = orders[:, i]
        lam_n = lam[ex, n]                       # [E, K]
        mu_n, beta_n = mu[ex, n][:, None], beta[ex, n][:, None]
        r_excl = r - mu_n * lam_n
        quad = (m2y * mu_n + 2.0 * mu_n * r_excl
                + (mu_n * mu_n + beta_n * beta_n))
        new = (lam_mask * (stim[ex, n] > 0)) * torch.sigmoid(
            spike_prior[ex, n] - sig * quad)
        r = r_excl + mu_n * new
        lam[ex, n] = torch.where(live[ex, n][:, None], new, lam_n)
    return lam


def update_outliers(y, mu, lam, lam_mask, penalty=1.0, scale_factor=0.5,
                    max_penalty_iters=10, orthogonal=True, tol=0.05):
    """Soft-threshold outlier (spontaneous) estimate over a shrinking
    penalty schedule, while the relative residual exceeds ``tol``: a
    fixed masked loop of ``max_penalty_iters`` trips, a trip the
    reference would not take leaving the state as it is."""
    resid = y - _vm(mu, lam)
    explained = torch.any(lam >= 0.5, dim=0)
    denom = torch.sum(y * y)
    err = torch.full((), float("inf"), dtype=y.dtype, device=y.device)
    z = torch.zeros_like(resid)
    pen = torch.as_tensor(penalty, dtype=y.dtype, device=y.device)
    for _ in range(int(max_penalty_iters)):
        live = err > tol
        z_new = torch.clamp(torch.where(resid < pen, 0.0, resid - pen),
                            min=0.0)
        if orthogonal:
            z_new = torch.where(explained, 0.0, z_new)
        z_new = z_new * lam_mask
        err_new = torch.sum(torch.square(resid - z_new)) / denom
        z = torch.where(live, z_new, z)
        err = torch.where(live, err_new, err)
        pen = torch.where(live, pen * scale_factor, pen)
    return z


# ---------------------------------------------------------------------------
# The fit
# ---------------------------------------------------------------------------


def _iteration(carry, it, data, params, order, generators):
    """One MBCS iteration over one experiment or a stack. ``order``:
    the spike sweep's row order ([N], or [E, N]); ``generators``: the
    Monte Carlo noise model's streams, one per experiment (unused with
    ``analytic_noise``)."""
    mu, beta, lam, shape, rate, z, spont_rate, spike_prior = carry
    y, stim, lam_mask, powers_with_zero, beta_prior = data
    p = params
    many = mu.dim() > 1
    beta = _each(many, lambda lm, sh, rt: update_slab_scale_mbcs(
        lm, sh, rt, beta_prior), lam, shape, rate)
    mu = update_weights_constrained_l1(
        y, mu, lam, shape, rate, penalty=p["penalty"],
        scale_factor=p["scale_factor"],
        max_penalty_iters=p["max_penalty_iters"],
        max_lasso_iters=p["max_lasso_iters"],
        constrain_weights=p["constrain_weights"])
    if p["learn_lam"]:
        sweep = _sweep_spikes_mbcs_many if many else sweep_spikes_mbcs
        lam = sweep(y, stim, mu, beta, lam, shape, rate, lam_mask,
                    spike_prior, order)
    rf, spike_prior = _each(many, lambda lm, st: update_receptive_fields(
        lm, st, powers_with_zero), lam, stim)
    mu, lam = isotonic_filtering(
        mu, lam, rf, minimum_spike_count=p["minimum_spike_count"],
        minimum_maximal_spike_prob=p["minimum_maximal_spike_prob"]
        + spont_rate)
    if p["analytic_noise"]:
        shape, rate = _each(many, lambda *a: update_noise_analytic(
            *a, noise_scale=p["noise_scale"]), y, mu, beta, lam)
    else:  # each experiment's samples from its own stream
        streams = iter(generators)
        shape, rate = _each(many, lambda *a: update_noise_mc(
            next(streams), *a, noise_scale=p["noise_scale"],
            num_mc_samples=p["num_mc_samples_noise_model"]), y, mu, beta,
            lam)
    if it > p["delay_spont_estimation"]:
        z = _each(many, lambda *a: update_outliers(
            *a, penalty=p["outlier_penalty"], scale_factor=p["scale_factor"],
            max_penalty_iters=p["max_penalty_iters"],
            orthogonal=p["orthogonal_outliers"], tol=p["outlier_tol"]),
            y, mu, lam, lam_mask)
        spont_rate = torch.mean((z != 0.0).to(y.dtype), dim=-1)
    return (mu, beta, lam, shape, rate, z, spont_rate, spike_prior), rf


def _run_mbcs(y, stim, lam0, lam_mask, powers_with_zero, mu0, beta_prior,
              shape0, rate0, spont_rate0, generators, params, *, iters,
              save_histories):
    """The fit loop over one experiment (one generator) or a stack with
    a leading axis (one generator each); draws each iteration's row
    order (then the noise model's samples) from each experiment's
    generator. Returns (final carry, receptive fields, the
    per-iteration (mu, beta, lam, shape, rate, z))."""
    N, P1 = stim.shape[-2], powers_with_zero.shape[0]
    carry = (mu0, beta_prior, lam0, shape0, rate0, torch.zeros_like(y),
             spont_rate0, lam0)
    rf = torch.zeros((*y.shape[:-1], N, P1), dtype=y.dtype, device=y.device)
    data = (y, stim, lam_mask, powers_with_zero, beta_prior)
    snaps = []
    for it in range(iters):
        order = _each_stream(generators, lambda g, b: torch.randperm(
            N, generator=g, device=y.device), y.dim() > 1)
        carry, rf = _iteration(carry, it, data, params, order, generators)
        if save_histories:
            snaps.append(carry[:6])
    return carry, rf, snaps


def fit_params(*, penalty, scale_factor, max_penalty_iters, max_lasso_iters,
               constrain_weights, learn_lam, delay_spont_estimation,
               minimum_spike_count, num_mc_samples_noise_model,
               orthogonal_outliers, analytic_noise, outlier_penalty,
               minimum_maximal_spike_prob, outlier_tol, noise_scale):
    """The fit loop's options (``_run_mbcs``'s ``params``), typed."""
    return dict(
        penalty=float(penalty), scale_factor=float(scale_factor),
        max_penalty_iters=int(max_penalty_iters),
        max_lasso_iters=int(max_lasso_iters),
        constrain_weights=str(constrain_weights), learn_lam=bool(learn_lam),
        delay_spont_estimation=int(delay_spont_estimation),
        minimum_spike_count=int(minimum_spike_count),
        num_mc_samples_noise_model=int(num_mc_samples_noise_model),
        orthogonal_outliers=bool(orthogonal_outliers),
        analytic_noise=bool(analytic_noise),
        outlier_penalty=float(outlier_penalty),
        minimum_maximal_spike_prob=float(minimum_maximal_spike_prob),
        outlier_tol=float(outlier_tol), noise_scale=float(noise_scale))


def _activity_mask(y_psc, y_xcorr_thresh, lam_mask_fraction):
    """Energy threshold plus small-event suppression: host numpy for a
    host array (the JAX package's own arithmetic), the tensor's device
    for a tensor."""
    if isinstance(y_psc, torch.Tensor):
        energy = torch.sum(y_psc * y_psc, dim=-1)
        mask = (energy > y_xcorr_thresh).to(y_psc.dtype)
        small = (torch.amax(y_psc, dim=1)
                 < lam_mask_fraction * torch.amax(y_psc))
        return torch.where(small, 0.0, mask)
    y_np = np.asarray(y_psc)
    mask = (np.sum(y_np * y_np, axis=-1) > y_xcorr_thresh).astype(float)
    mask[np.max(y_np, axis=1) < lam_mask_fraction * np.max(y_np)] = 0.0
    return mask


def mbcs(
    y_psc, stim, mu_prior, beta_prior, shape_prior, rate_prior, iters=50,
    num_mc_samples=100, seed=0, y_xcorr_thresh=0.05, penalty=5e0,
    scale_factor=0.5, max_penalty_iters=10, max_lasso_iters=100,
    warm_start_lasso=True, constrain_weights="positive", verbose=False,
    learn_noise=False, init_lam=None, learn_lam=True,
    delay_spont_estimation=1, minimum_spike_count=1, noise_scale=0.5,
    num_mc_samples_noise_model=10, minimum_maximal_spike_prob=0.2,
    orthogonal_outliers=True, outlier_penalty=5e1, init_spike_prior=0.75,
    outlier_tol=0.05, spont_rate=0, lam_mask_fraction=0.05,
    dtype=torch.float32, save_histories=True, analytic_noise=False,
    device=None,
):
    """Fit MBCS; the signature of ``circuitmap_tpu.solvers.mbcs`` plus
    ``device`` (None means CUDA; the package's device rule). Returns
    ``(mu, beta, lam, shape, rate, z, receptive_fields, *six history
    arrays)``: tensors on the fit's device, histories numpy arrays or
    None unless ``save_histories``.

    ``analytic_noise=True`` takes the exact moments of the Monte Carlo
    noise model (``update_noise_analytic``), deterministic. The initial
    weights come from ``np.random.default_rng(seed)`` as in the JAX
    package; the row orders and noise samples from a ``torch.Generator``
    seeded with ``seed``. Feed demixed traces at scale: MBCS has no
    power-curve gate or reconnection scan and collapses on raw
    contaminated traces. ``num_mc_samples``, ``warm_start_lasso`` and
    ``learn_noise`` are accepted for the signature.
    """
    del num_mc_samples, warm_start_lasso, learn_noise
    dev = resolve_device(device)
    dtype = torch_dtype(dtype)
    if dev.type == "cuda" and dtype != torch.float32:
        raise NotImplementedError(
            f"the CUDA fits of this version run in float32 only; a "
            f"{dtype} fit runs with device='cpu'")
    if verbose:
        print("Running MBCS (PyTorch).")

    traces = prepare_traces(y_psc, dtype, dev)
    y = integrated_charge(traces)
    K = y.shape[0]
    N = np.asarray(mu_prior).shape[0]
    lam_mask = _as(_activity_mask(
        traces if isinstance(y_psc, torch.Tensor) else y_psc,
        y_xcorr_thresh, lam_mask_fraction), dtype, dev)
    stim_t, stim_np, _, powers_dev_np = prepare_stim(stim, dtype, dev)
    warn_data_thin_design_dense(stim_np, what="mbcs()")
    powers_with_zero = _as(np.concatenate([[0.0], powers_dev_np]), dtype, dev)
    mu0 = _as(np.random.default_rng(seed).lognormal(1.0, 1.0, N), dtype, dev)
    if init_lam is None:
        lam0 = (stim_t > 0).to(dtype) * float(init_spike_prior) * lam_mask
    else:
        lam0 = _as(init_lam, dtype, dev)
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
    carry, receptive_fields, snaps = _run_mbcs(
        y, stim_t, lam0, lam_mask, powers_with_zero, mu0,
        _as(beta_prior, dtype, dev),
        torch.full((K,), float(shape_prior), dtype=dtype, device=dev),
        torch.full((K,), float(rate_prior), dtype=dtype, device=dev),
        torch.as_tensor(float(spont_rate), dtype=dtype, device=dev),
        [seeded_generator(seed, dev)], params, iters=int(iters),
        save_histories=bool(save_histories))
    mu, beta, lam, shape, rate, z = carry[:6]
    if save_histories:
        hist_arrs = [torch.stack([s[i] for s in snaps]).cpu().numpy()
                     for i in range(6)]
    else:
        hist_arrs = [None] * 6
    return (mu, beta, lam, shape, rate, z, receptive_fields, *hist_arrs)
