"""The plain reference's CAVIaR (``reference.caviar``) on F folds of one
experiment at once, at one row a sweep step.

At one row a step the reference's sweep is N dependent steps of a few
dozen small operations an iteration: fit one fold after another, four
folds of N=1000 spend ~150 s of host time launching them (PERF.md §2).
Here the sweep takes the folds as a leading axis, one step a row for
all of them; every other update is ``reference.py``'s own, called fold
by fold. Each fold's fit is ``reference.caviar``'s on that fold (the
same operations, summed in other shapes), and like it this file imports
nothing of the program.
"""

from __future__ import annotations

import torch

from . import reference as R


def sweep_rows(y, stim, mu, beta, lam, sig, m0, m1, live, onehot, counts,
               msrmp_eff, min_count, gate_on):
    """``reference.sweep`` at ``rows=1`` on F folds: y [F, K]; stim, lam,
    live [F, N, K]; onehot [F, N, K, P]; mu, beta, m0, m1 [F, N];
    counts [F, N, P]; sig, msrmp_eff [F]."""
    lam = lam.clone()
    r = torch.einsum("fn,fnk->fk", mu, lam)
    sig = sig[:, None]
    for n in range(lam.shape[1]):
        l_n, mu_n, be_n = lam[:, n].clone(), mu[:, n, None], beta[:, n, None]
        r_ex = r - mu_n * l_n
        quad = sig * (-2.0 * y * mu_n + 2.0 * mu_n * r_ex
                      + (mu_n * mu_n + be_n * be_n))
        est = live[:, n] * torch.sigmoid(
            m0[:, n, None] * stim[:, n] - m1[:, n, None] - 0.5 * quad)
        sums = torch.einsum("fk,fkp->fp", est, onehot[:, n])
        c = counts[:, n]
        rates = sums / (c + 1e-4 * (c == 0.0))
        ok = (R.isotonic_at_max(rates) >= msrmp_eff) & (
            torch.sum(est, 1) >= min_count)
        gate = (ok.to(lam.dtype) if gate_on
                else torch.ones_like(ok, dtype=lam.dtype))
        new = est * gate[:, None]
        lam[:, n] = new
        r = r + (mu_n * gate[:, None]) * new - mu_n * l_n
    return lam


def caviar_folds(ys, stims, masks, powers, fit, dtype, device):
    """``reference.caviar`` of each fold f of charges ``ys[f]`` [K] on
    ``stims[f]`` [N, K] with the active-trial mask ``masks[f]`` [K], at
    one row a sweep step. Returns the F posteriors."""
    o = fit
    if int(o["sweep_block_size"]) != 1:
        raise ValueError("caviar_folds sweeps one row a step")
    powers = [float(p) for p in sorted(powers)]
    stims = stims.to(dtype)
    F, N, k = stims.shape
    p = R.priors(N, dtype, device)
    onehot = torch.stack([stims == pw for pw in powers], -1).to(dtype)
    counts = onehot.sum(2)
    live = (stims > 0).to(dtype) * masks[:, None]
    levels = torch.tensor([0.0, *powers], dtype=dtype, device=device)
    lam, z = 0.95 * live, torch.zeros_like(ys)
    shape, rate = [p["shape"]] * F, [p["rate"]] * F
    phi, phi_cov = [p["phi"]] * F, [p["phi_cov"]] * F
    spont_rate = torch.zeros(F, dtype=dtype, device=device)
    for it in range(int(o["iters"])):
        sig = torch.stack([a / b for a, b in zip(shape, rate)])
        mu, beta = (torch.stack(v) for v in zip(*[
            R.update_weights(ys[f], lam[f], sig[f], p) for f in range(F)]))
        m = torch.stack([R.truncnorm_mean(phi[f], torch.diagonal(
            phi_cov[f], dim1=-2, dim2=-1)) for f in range(F)])
        lam = sweep_rows(ys, stims, mu, beta, lam, sig, m[..., 0], m[..., 1],
                         live, onehot, counts, o["msrmp"] + spont_rate,
                         o["minimum_spike_count"], it > o["delay_spont_est"])
        for f in range(F):
            shape[f], rate[f] = R.update_noise(ys[f], mu[f], beta[f], lam[f],
                                               p, k)
            phi[f], phi_cov[f] = R.laplace(
                *R.bucket_stats(lam[f], stims[f], powers, counts[f], k),
                levels, p["phi"], p["phi_cov"])
            z[f] = R.update_spont(ys[f], mu[f], lam[f], z[f], it, masks[f], o)
        spont_rate = torch.sum((z != 0).to(dtype), 1) / k
    posts = []
    for f in range(F):
        mu_f, beta_f, lam_f, z_f, n = R.reconnect(
            stims[f], lam[f], mu[f], beta[f], z[f], powers, counts[f],
            o["msrmp"], o["minimum_spike_count"])
        phi_f, cov_f = phi[f], phi_cov[f]
        if n:
            phi_f, cov_f = R.laplace(
                *R.bucket_stats(lam_f, stims[f], powers, counts[f], k),
                levels, p["phi"], p["phi_cov"])
        posts.append(dict(mu=mu_f, beta=beta_f, lam=lam_f, shape=shape[f],
                          rate=rate[f], phi=phi_f, phi_cov=cov_f, z=z_f))
    return posts
