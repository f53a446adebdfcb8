"""The benchmark's data: a trial-based holographic mapping experiment.

A frozen copy of the data model of ``circuitmap_torch.simulation.simulate``
(the ensemble path: blockwise design, sigmoid power curves, gamma spike
latencies, bi-exponential PSC kernels, spontaneous events, GP and white
noise), as of commit 2a4eea50fb68982d273bbeba2057be11d71ede01, rewritten
in plain PyTorch so that every array is drawn on the device from one
``torch.Generator`` seeded by the run's ``--seed``. It imports nothing of
the program: the yardstick must not move with the program.

Where ``simulate`` loops on the host, this file computes the same
quantities in a few large device calls:

* the PSCs are summed over the (trial, neuron) pairs that spiked in a
  connected neuron (the others add exactly zero in ``simulate`` too);
* the padding of each neuron's spike rate at the top power to the floor
  flips a random choice of its silent top-power trials, chosen by ranking
  random keys within the neuron;
* gamma latencies come from Marsaglia and Tsang's method (every shape is
  above 1 at the mapping powers) in a fixed number of vectorised rounds.

The streams differ from numpy's, so one seed gives another experiment
than ``np.random.seed`` does in ``simulate``, of the same distribution.
"""

from __future__ import annotations

import math

import torch

GAMMA_ROUNDS = 12  # Marsaglia-Tsang rounds; a round accepts > 95%


def _uniform(g, shape, lo, hi, device):
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device,
                                       dtype=torch.float64)


def _gamma(g, shape_param, device):
    """Gamma(shape_param, 1) draws for shape_param >= 1 (float64 [n])."""
    n = shape_param.numel()
    d = shape_param - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    x = torch.randn((GAMMA_ROUNDS, n), generator=g, device=device,
                    dtype=torch.float64)
    u = torch.rand((GAMMA_ROUNDS, n), generator=g, device=device,
                   dtype=torch.float64)
    v = (1.0 + c * x) ** 3
    ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                    + d * torch.log(torch.clamp(v, min=1e-300)))
    first = torch.argmax(ok.to(torch.int8), dim=0)
    draw = (d * v)[first, torch.arange(n, device=device)]
    return torch.where(ok.any(0), draw, d)  # never reached in practice


def blockwise_targets(g, N, H, K, powers, device):
    """The blockwise design: passes over a random partition of the N
    neurons into H-spot holograms, each pass swept over the powers from
    the highest down, cut at K trials and shuffled. Returns (targets
    [K, H] int64, power [K] float64)."""
    if N % H:
        raise ValueError(f"N={N} must be a multiple of H={H}")
    n_holo = N // H
    P = len(powers)
    passes = -(-K // (P * n_holo))
    order = torch.argsort(torch.rand((passes, N), generator=g,
                                     device=device), dim=1)
    holos = order.reshape(passes, 1, n_holo, H).expand(passes, P, n_holo, H)
    levels = torch.tensor(sorted(powers, reverse=True), dtype=torch.float64,
                          device=device)
    power = levels.reshape(1, P, 1).expand(passes, P, n_holo)
    targets = holos.reshape(-1, H)[:K]
    power = power.reshape(-1)[:K]
    shuffle = torch.randperm(K, generator=g, device=device)
    return targets[shuffle], power[shuffle]


def _pad_to_min_rate(g, spk, tgt, pw, N, max_power, min_rate):
    """Raise each neuron's spike rate over its top-power trials to
    ``min_rate`` by flipping a random choice of its silent ones."""
    dev = spk.device
    top = (pw == max_power)[:, None].expand_as(tgt)
    neuron = tgt[top]
    s = spk[top]
    locs = torch.zeros(N, dtype=torch.float64, device=dev).index_add_(
        0, neuron, torch.ones_like(s))
    fired = torch.zeros(N, dtype=torch.float64, device=dev).index_add_(
        0, neuron, s)
    rate = fired / torch.clamp(locs, min=1.0)
    deficit = torch.clamp(min_rate - rate, min=0.0)
    need = torch.minimum(torch.ceil(deficit * locs), locs - fired)
    # silent entries ranked by a random key within their neuron
    key = torch.rand(neuron.shape, generator=g, device=dev,
                     dtype=torch.float64)
    key = torch.where(s > 0, 2.0, key) + 3.0 * neuron.to(torch.float64)
    order = torch.argsort(key)
    first = torch.cumsum(locs, 0) - locs
    rank = torch.empty_like(order)
    rank[order] = torch.arange(order.numel(), device=dev)
    rank = rank.to(torch.float64) - first[neuron]
    flip = (s == 0) & (rank < need[neuron])
    s = torch.where(flip, 1.0, s)
    out = spk.clone()
    out[top] = s
    return out


def _kernels(tau_r, tau_d, start, T, inclusive):
    """[n, T] bi-exponential kernels starting at ``start`` (float64), from
    the start sample on (``inclusive``) or after it."""
    t = torch.arange(T, dtype=torch.float64, device=start.device)
    dt = t - start[:, None]
    dtc = torch.clamp(dt, min=0.0)
    ke = (torch.exp(-dtc / tau_d[:, None]) - torch.exp(-dtc / tau_r[:, None]))
    return ke * (dt >= 0) if inclusive else ke * (dt > 0)


def make_experiment(cfg, seed, device):
    """One experiment of the configuration ``cfg`` from ``seed``.

    Returns a dict of device tensors: ``psc`` [K, T] float32 raw traces,
    ``stim`` [N, K] float32 powers, ``weights`` [N] float64 (the truth).
    """
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    dev = torch.device(device)
    N, K, T, H = cfg["N"], cfg["trials"], cfg["T"], cfg["H"]
    powers = [float(p) for p in cfg["powers"]]
    s = cfg["simulate"]

    tgt, pw = blockwise_targets(g, N, H, K, powers, dev)           # [K, H]
    tau_r = _uniform(g, N, s["tau_r_min"], s["tau_r_max"], dev)
    tau_d = tau_r + _uniform(g, N, s["tau_delta_min"], s["tau_delta_max"],
                             dev)
    phi_0 = _uniform(g, N, s["phi_0_lower"], s["phi_0_upper"], dev)
    phi_1 = _uniform(g, N, s["phi_1_lower"], s["phi_1_upper"], dev)
    drive = phi_0[tgt] * pw[:, None] - phi_1[tgt]
    p_fire = 1.0 / (1.0 + torch.exp(-drive))
    spk = (torch.rand(tgt.shape, generator=g, device=dev,
                      dtype=torch.float64) <= p_fire).to(torch.float64)
    spk = _pad_to_min_rate(g, spk, tgt, pw, N, max(powers),
                           s["max_power_min_spike_rate"])

    # sparse weights: a strong uniform tier and a weak shifted-exponential
    n_conn = int(cfg["connection_prob"] * N)
    connected = torch.randperm(N, generator=g, device=dev)[:n_conn]
    n_strong = int(math.ceil(s["frac_strongly_connected"] * n_conn))
    weights = torch.zeros(N, dtype=torch.float64, device=dev)
    weights[connected[:n_strong]] = _uniform(
        g, n_strong, s["strong_weight_lower"], s["strong_weight_upper"], dev)
    n_weak = n_conn - n_strong
    expo = -torch.log1p(-torch.rand(n_weak, generator=g, device=dev,
                                    dtype=torch.float64))
    weights[connected[n_strong:]] = s["weak_exp_mean"] * expo + s["min_weight"]

    # evoked PSCs of the (trial, target) pairs that spiked in a connected
    # neuron: gamma latency, log-normal amplitude noise, unit-area kernel
    hit = (spk > 0) & (weights[tgt] != 0)
    k_idx = torch.arange(K, device=dev)[:, None].expand_as(tgt)[hit]
    n_idx = tgt[hit]
    p_hit = pw[:, None].expand_as(tgt)[hit]
    lat = s["min_latency"] + s["gamma_beta"] * _gamma(g, 1e4 / p_hit ** 2,
                                                      dev)
    mult = torch.exp(s["mult_noise_log_var"] * torch.randn(
        n_idx.shape, generator=g, device=dev, dtype=torch.float64))
    ke = _kernels(tau_r[n_idx], tau_d[n_idx], torch.floor(lat), T, True)
    ke = ke / (ke.sum(1, keepdim=True) + 1e-5)
    amp = (weights[n_idx] * mult)[:, None]
    psc = torch.zeros((K, T), dtype=torch.float64, device=dev)
    psc.index_add_(0, k_idx, ke * amp)

    # spontaneous events: one random-kernel PSC on a random subset of trials
    spont = torch.rand(K, generator=g, device=dev,
                       dtype=torch.float64) <= s["spont_prob"]
    k_sp = torch.nonzero(spont)[:, 0]
    n_sp = k_sp.numel()
    tr = _uniform(g, n_sp, s["tau_r_min"], s["tau_r_max"], dev)
    td = tr + _uniform(g, n_sp, s["tau_delta_min"], s["tau_delta_max"], dev)
    delta = torch.randint(1, T, (n_sp,), generator=g, device=dev).double()
    w_conn = weights[connected]
    w = _uniform(g, n_sp, 0.0, 1.0, dev) * (w_conn.max() - w_conn.min()) \
        + w_conn.min()
    ke = _kernels(tr, td, delta, T, False)
    area = torch.trapezoid(ke, dim=1)
    psc.index_add_(0, k_sp, w[:, None] * ke / (area[:, None] + 1e-5))

    # squared-exponential GP noise by spectral factorisation, white noise
    t = torch.arange(T, dtype=torch.float64, device=dev)
    cov = torch.exp(-(t[:, None] - t[None, :]) ** 2
                    / (2.0 * s["gp_lengthscale"] ** 2))
    evals, Q = torch.linalg.eigh(cov)
    half = Q * torch.sqrt(torch.clamp(evals, min=0.0))[None, :]
    eps = torch.randn((K, T), generator=g, device=dev, dtype=torch.float64)
    psc += s["gp_scale"] * (eps @ half.T)
    psc += s["sigma"] * torch.randn((K, T), generator=g, device=dev,
                                    dtype=torch.float64)

    stim = torch.zeros((N, K), dtype=torch.float32, device=dev)
    stim[tgt, torch.arange(K, device=dev)[:, None].expand_as(tgt)] = \
        pw[:, None].expand_as(tgt).to(torch.float32)
    return {"psc": psc.to(torch.float32), "stim": stim, "weights": weights}
