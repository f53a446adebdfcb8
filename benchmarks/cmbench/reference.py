"""The plain reference: what the timed path should produce, worked out
again from the benchmark's own inputs in plain PyTorch.

It imports nothing of the program and takes nothing that the program
made: it reads the demixer's weights from the checkpoint file, encodes
the raw traces on the int4d2 wire itself, runs the U-Net layer by layer,
takes the charges, and runs CAVIaR (the blocked sweep in a fixed row
order, the exact power-curve means, the Laplace refit, the noise and
spontaneous updates and the reconnection scan after the loop) as the
upstream method defines it. Every step runs in ``dtype``: float64 for
the reference, float32 with TF32 on for the control (``precision``).

The fit follows the configuration's options: ``update_order="identity"``
and ``analytic_mc=True``, which make CAVIaR a deterministic function of
its inputs, and ``sweep_block_size`` rows a step.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def precision(tf32):
    """float32 products in TF32 (``tf32=True``, the control) or in full
    float32; the previous settings come back on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = bool(tf32)
    torch.backends.cudnn.allow_tf32 = bool(tf32)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


# ---------------------------------------------------------------------------
# The int4d2 trace wire (the format: float32 mean-pool by 2, per-trace
# peak/7 step, round half to even, clip to +-7; linear upsample back)
# ---------------------------------------------------------------------------


def int4d2_codes(raw):
    """(codes int8 [K, ceil(T/2)], step float32 [K]) of float32 [K, T]
    host traces, in float32 arithmetic as the wire defines it."""
    x = np.asarray(raw, dtype=np.float32)
    T = x.shape[1]
    p = np.float32(0.5) * (x[:, 0:T - 1:2] + x[:, 1:T:2])
    if T % 2:
        p = np.concatenate([p, x[:, -1:]], axis=1)
    step = (np.abs(p).max(axis=1) / np.float32(7.0)).astype(np.float32)
    step = np.where(step > 0, step, np.float32(1.0))
    codes = np.clip(np.rint(p / step[:, None]), -7, 7).astype(np.int8)
    return codes, step


def int4d2_decode(codes, step, T, dtype, device):
    """Traces [K, T] in ``dtype`` on ``device`` from the wire's codes."""
    p = (torch.as_tensor(codes, device=device).to(dtype)
         * torch.as_tensor(step, device=device).to(dtype)[:, None])
    prev = torch.cat([p[:, :1], p[:, :-1]], 1)
    nxt = torch.cat([p[:, 1:], p[:, -1:]], 1)
    up = torch.stack([0.75 * p + 0.25 * prev, 0.75 * p + 0.25 * nxt], -1)
    return up.reshape(p.shape[0], -1)[:, :T]


# ---------------------------------------------------------------------------
# The demixer: the NWD U-Net in eval mode, from the checkpoint's arrays
# ---------------------------------------------------------------------------

DOWN = [("dblock1", 2), ("dblock2", 1), ("dblock3", 1), ("dblock4", 1)]
UP = [("ublock1", 1), ("ublock2", 1), ("ublock3", 1), ("ublock4", 2)]
BN_EPS = 1e-5


def load_unet(path, dtype, device):
    """The checkpoint's ``block/group/leaf`` arrays as tensors."""
    with np.load(path) as z:
        return {k: torch.as_tensor(z[k], device=device).to(dtype)
                for k in z.files}


def _bn_relu(w, block, h):
    scale = w[f"{block}/bn/scale"] / torch.sqrt(
        w[f"{block}/bn/running_var"] + BN_EPS)
    shift = w[f"{block}/bn/bias"] - w[f"{block}/bn/running_mean"] * scale
    return torch.relu(h * scale[:, None] + shift[:, None])


def unet(w, x):
    """x [B, L] peak-normalised traces -> [B, L]."""
    h = x[:, None, :]
    skips = []
    for block, dil in DOWN:
        h = F.conv1d(F.avg_pool1d(h, 3, stride=2), w[f"{block}/conv/w"],
                     w[f"{block}/conv/b"], dilation=dil)
        h = _bn_relu(w, block, h)
        skips.append(h)
    sizes = [skips[2].shape[-1], skips[1].shape[-1], skips[0].shape[-1],
             x.shape[-1]]
    cats = [skips[2], skips[1], skips[0], None]
    h = skips[3]
    for (block, stride), size, skip in zip(UP, sizes, cats):
        h = F.conv_transpose1d(h, w[f"{block}/deconv/w"],
                               w[f"{block}/deconv/b"], stride=stride)
        h = F.interpolate(_bn_relu(w, block, h), size=size, mode="linear",
                          align_corners=False)
        if skip is not None:
            h = torch.cat([h, skip], 1)
    h = F.conv1d(h, w["conv/conv/w"], w["conv/conv/b"], padding=255,
                 dilation=2)
    return _bn_relu(w, "conv", h)[:, 0, :]


def demix(w, traces, filter_start=500, rows=4096):
    """Peak-normalise each trace, run the U-Net, scale back, then the
    running minimum from ``filter_start`` on (seeded one sample early)."""
    out = []
    for k0 in range(0, traces.shape[0], rows):
        x = traces[k0:k0 + rows]
        peak = x.max(dim=1, keepdim=True).values
        peak = torch.where(peak != 0, peak, torch.ones_like(peak))
        d = unet(w, x / peak) * peak
        tail = torch.cummin(d[:, filter_start - 1:], dim=1).values
        out.append(torch.cat([d[:, :filter_start], tail[:, 1:]], 1))
    return torch.cat(out)


def charges(dem, xcorr_thresh):
    """(trapezoidal charge [K], active-trial mask [K]) of demixed traces."""
    y = torch.trapezoid(dem, dim=1)
    return y, (torch.sum(dem * dem, dim=1) > xcorr_thresh).to(dem.dtype)


# ---------------------------------------------------------------------------
# CAVIaR
# ---------------------------------------------------------------------------


def priors(N, dtype, device):
    """The upstream default priors."""
    kw = dict(dtype=dtype, device=device)
    return dict(mu=torch.zeros(N, **kw), beta=torch.full((N,), 10.0, **kw),
                shape=torch.tensor(1.0, **kw), rate=torch.tensor(0.1, **kw),
                phi=torch.tensor([0.1, 5.0], **kw).expand(N, 2),
                phi_cov=torch.tensor([[0.1, 0.0], [0.0, 1.0]],
                                     **kw).expand(N, 2, 2))


def _ndtr(x):
    return 0.5 * torch.special.erfc(-x / math.sqrt(2.0))


def truncnorm_mean(mean, sd):
    """Mean of N(mean, sd) truncated to (0, inf)."""
    a = -mean / sd
    pdf = torch.exp(-0.5 * a * a) / math.sqrt(2.0 * math.pi)
    tail = _ndtr(-a)
    ratio = pdf / torch.clamp(tail, min=torch.finfo(mean.dtype).tiny)
    return mean + sd * torch.where(tail > 0, ratio, a + 1.0 / a)


def update_weights(y, lam, sig, p):
    """Gaussian posterior of the weights: (mean [N], covariance diagonal
    [N]) of M = sig lam lam^T + diag(sig sum(lam (1 - lam)) + 1/beta0^2)."""
    prior_prec = 1.0 / (p["beta"] * p["beta"])
    M = sig * (lam @ lam.T) + torch.diag(
        sig * torch.sum(lam * (1.0 - lam), 1) + prior_prec)
    rhs = sig * (lam @ y) + p["mu"] * prior_prec
    L = torch.linalg.cholesky(M)
    Linv = torch.linalg.solve_triangular(
        L, torch.eye(M.shape[0], dtype=M.dtype, device=M.device), upper=False)
    return Linv.T @ (Linv @ rhs), torch.sum(Linv * Linv, 0)


def isotonic_at_max(rates):
    """[..., P] -> the isotonic (non-decreasing) fit's value at the top
    level: max over i of mean(rates[..., i:])."""
    tail = torch.cumsum(torch.flip(rates, (-1,)), -1)
    n = torch.arange(1, rates.shape[-1] + 1, dtype=rates.dtype,
                     device=rates.device)
    return torch.max(tail / n, -1).values


def sweep(y, stim, mu, beta, lam, sig, m0, m1, live, onehot, counts,
          msrmp_eff, min_count, gate_on, rows):
    """One coordinate-ascent sweep over the spike posteriors, ``rows``
    consecutive rows a step from the prediction ``mu @ lam`` at the
    step's start. ``live``: [N, K] 1 on a neuron's stimulated active
    trials; ``onehot``: [N, K, P] 1 where a trial's power is level p."""
    N = lam.shape[0]
    lam = lam.clone()
    r = mu @ lam
    for a in range(0, N, rows):
        b = min(N, a + rows)
        s_b, l_b = stim[a:b], lam[a:b].clone()
        mu_b, be_b = mu[a:b], beta[a:b]
        r_ex = r[None] - mu_b[:, None] * l_b
        quad = sig * (-2.0 * y[None] * mu_b[:, None]
                      + 2.0 * mu_b[:, None] * r_ex
                      + (mu_b * mu_b + be_b * be_b)[:, None])
        est = live[a:b] * torch.sigmoid(
            m0[a:b, None] * s_b - m1[a:b, None] - 0.5 * quad)
        sums = torch.einsum("bk,bkp->bp", est, onehot[a:b])
        c = counts[a:b]
        rates = sums / (c + 1e-4 * (c == 0.0))
        ok = (isotonic_at_max(rates) >= msrmp_eff) & (
            torch.sum(est, 1) >= min_count)
        gate = ok.to(lam.dtype) if gate_on else torch.ones_like(mu_b)
        new = est * gate[:, None]
        lam[a:b] = new
        r = r + torch.sum((mu_b * gate)[:, None] * new - mu_b[:, None] * l_b,
                          0)
    return lam


def update_noise(y, mu, beta, lam, p, k):
    rate = p["rate"] + 0.5 * (
        torch.sum((y - mu @ lam) ** 2)
        - torch.sum(mu * mu * torch.sum(lam * lam, 1))
        + torch.sum((mu * mu + beta * beta) * torch.sum(lam, 1)))
    return p["shape"] + 0.5 * k, rate


def bucket_stats(lam, stim, powers, counts, k):
    """(S, C) [N, P+1]: summed spike posteriors and trial counts per
    power bucket, bucket 0 the unstimulated trials."""
    S = torch.stack([torch.sum(torch.where(stim == lv, lam, 0.0), 1)
                     for lv in [0.0, *powers]], 1)
    C = torch.cat([(k - counts.sum(1))[:, None], counts], 1)
    return S, C


NEWTON_STEPS, BARRIER_T, ARMIJO, BACKTRACK, MAX_HALVINGS = 10, 10.0, 0.25, \
    0.5, 40


def _inv2(M):
    a, b, c, d = M[..., 0, 0], M[..., 0, 1], M[..., 1, 0], M[..., 1, 1]
    adj = torch.stack([torch.stack([d, -b], -1), torch.stack([-c, a], -1)],
                      -2)
    return adj / (a * d - b * c)[..., None, None]


def laplace(S, C, levels, phi0, cov0):
    """Laplace approximation of each neuron's sigmoid power curve: damped
    Newton steps from the prior on the barrier-regularised objective,
    the first of the step sizes BACKTRACK^j that passes Armijo's test
    (the smallest where none does). Returns (phi [N, 2], the inverse
    Hessian at the last step's start [N, 2, 2])."""
    prec = _inv2(cov0)
    steps = BACKTRACK ** torch.arange(MAX_HALVINGS + 1, dtype=S.dtype,
                                      device=S.device)

    def objective(phi):  # [N, J, 2] -> [N, J]
        x = phi[..., 0:1] * levels - phi[..., 1:2]
        ll = S[:, None] * F.logsigmoid(x) + (C - S)[:, None] * F.logsigmoid(-x)
        d = phi - phi0[:, None]
        quad = torch.sum(d * torch.sum(prec[:, None] * d[..., None, :], -1),
                         -1)
        return (-torch.sum(torch.nan_to_num(ll), -1)
                - torch.sum(torch.log(phi), -1) / BARRIER_T + 0.5 * quad)

    phi = phi0
    for _ in range(NEWTON_STEPS):
        f = torch.sigmoid(phi[:, 0:1] * levels - phi[:, 1:2])
        res = S - C * f
        g = torch.stack([-torch.sum(levels * res, -1), torch.sum(res, -1)], -1)
        g = g + torch.sum(prec * (phi - phi0)[:, None, :], -1) \
            - 1.0 / (BARRIER_T * phi)
        w = C * f * (1.0 - f)
        h00 = torch.sum(levels * levels * w, -1)
        h01 = -torch.sum(levels * w, -1)
        Hm = torch.stack([torch.stack([h00, h01], -1),
                          torch.stack([h01, torch.sum(w, -1)], -1)], -2)
        barrier = torch.diag_embed(1.0 / (BARRIER_T * phi * phi))
        cov = _inv2(Hm + prec + barrier)
        v = -torch.sum(cov * g[:, None, :], -1)
        lhs = objective(phi[:, None] + steps[:, None] * v[:, None])
        rhs = objective(phi[:, None])[:, :1] + ARMIJO * steps * torch.sum(
            g * v, -1)[:, None]
        ok = ~torch.isnan(lhs) & (lhs <= rhs)
        j = torch.where(ok.any(-1), torch.argmax(ok.to(torch.int8), -1),
                        MAX_HALVINGS)
        phi = phi + steps[j][:, None] * v
    return phi, cov


def update_spont(y, mu, lam, z, it, mask, o):
    """Soft-threshold estimate of per-trial spontaneous activity: at most
    ``max_backtrack_iters - it`` shrink steps, each taken while the
    explained error stays above ``tol``."""
    resid = y - mu @ lam
    explained = torch.any(lam >= o["spont_orthogonality"], 0)
    denom = torch.sum(y * y) + 1e-5
    err = torch.sum(y)
    pen = o["penalty"]
    for _ in range(max(0, o["max_backtrack_iters"] - it)):
        if not bool(err > o["tol"]):
            break
        z = torch.clamp(torch.where(resid < pen, 0.0, resid - pen), min=0.0)
        z = torch.where(explained, 0.0, z) * mask
        err = torch.sum((resid - z) ** 2) / denom
        pen = pen * o["scale_factor"]
    return z


def reconnect(stim, lam, mu, beta, z, powers, counts, msrmp, min_count):
    """Greedy reconnection of cells inferred disconnected whose stimulated
    trials coincide with spontaneous events. Returns (mu, beta, lam, z,
    number reconnected)."""
    mu, beta, lam, z = mu.clone(), beta.clone(), lam.clone(), z.clone()
    dt = lam.dtype
    z_nz = (z != 0).to(dt)

    def hits_of(v):
        return torch.stack([(stim == pw).to(dt) @ v for pw in powers], 1)

    candidate = mu == 0
    hits = hits_of(z_nz)
    n_rec = 0
    while True:
        rates = torch.where(counts > 0, hits / torch.clamp(counts, min=1.0),
                            0.0)
        n_events = hits.sum(1)
        ok = candidate & (isotonic_at_max(rates) >= msrmp) & (
            n_events >= min_count)
        if not (bool(ok.any()) and bool(z_nz.sum() > min_count)):
            return mu, beta, lam, z, n_rec
        n = int(torch.argmax(torch.where(ok, n_events, -1.0)))
        locs = ((stim[n] != 0) & (z_nz > 0)).to(dt)
        c = locs.sum()
        mean = torch.sum(z * locs) / torch.clamp(c, min=1.0)
        var = torch.sum((z - mean) ** 2 * locs) / torch.clamp(c - 1.0, min=1.0)
        mu[n] = mean
        beta[n] = (torch.sqrt(var / torch.clamp(c, min=1.0)) if c > 1
                   else float("nan"))
        lam[n] = torch.where(locs > 0, 1.0, lam[n])
        z = torch.where(locs > 0, 0.0, z)
        z_nz = z_nz * (1.0 - locs)
        candidate[n] = False
        hits = hits - hits_of(locs)
        n_rec += 1


def caviar(y, stim, mask, powers, fit, dtype, device):
    """A batch CAVIaR fit of charges ``y`` [K] on ``stim`` [N, K] with the
    active-trial ``mask`` [K]: ``fit["iters"]`` iterations from the
    priors (the spike posteriors start at 0.95 on each neuron's
    stimulated active trials), then the reconnection scan, and the
    refit of the power curves where it reconnected. Returns the
    posterior's fields."""
    o = fit
    powers = [float(p) for p in sorted(powers)]
    stim = stim.to(dtype)
    N, k = stim.shape[0], y.shape[0]
    p = priors(N, dtype, device)
    onehot = torch.stack([stim == pw for pw in powers], -1).to(dtype)
    counts = onehot.sum(1)
    live = (stim > 0).to(dtype) * mask
    levels = torch.tensor([0.0, *powers], dtype=dtype, device=device)
    lam, z = 0.95 * live, torch.zeros_like(y)
    shape, rate, phi, phi_cov = p["shape"], p["rate"], p["phi"], p["phi_cov"]
    spont_rate = torch.zeros((), dtype=dtype, device=device)
    for it in range(int(o["iters"])):
        sig = shape / rate
        mu, beta = update_weights(y, lam, sig, p)
        m = truncnorm_mean(phi, torch.diagonal(phi_cov, dim1=-2, dim2=-1))
        lam = sweep(y, stim, mu, beta, lam, sig, m[:, 0], m[:, 1], live,
                    onehot, counts, o["msrmp"] + spont_rate,
                    o["minimum_spike_count"], it > o["delay_spont_est"],
                    int(o["sweep_block_size"]))
        shape, rate = update_noise(y, mu, beta, lam, p, k)
        phi, phi_cov = laplace(*bucket_stats(lam, stim, powers, counts, k),
                               levels, p["phi"], p["phi_cov"])
        z = update_spont(y, mu, lam, z, it, mask, o)
        spont_rate = torch.sum((z != 0).to(dtype)) / k
    mu, beta, lam, z, n = reconnect(stim, lam, mu, beta, z, powers, counts,
                                    o["msrmp"], o["minimum_spike_count"])
    if n:
        phi, phi_cov = laplace(*bucket_stats(lam, stim, powers, counts, k),
                               levels, p["phi"], p["phi_cov"])
    return dict(mu=mu, beta=beta, lam=lam, shape=shape, rate=rate, phi=phi,
                phi_cov=phi_cov, z=z)
