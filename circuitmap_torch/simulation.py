"""Synthetic holographic-mapping experiments.

Port of ``circuitmap_tpu/simulation.py``: ``simulate`` (trial-based: K
independent PSC traces) and ``simulate_continuous_experiment`` (a full
20 kHz timeline, sliced into stim-aligned response windows), with the
earlier single-target variant
``simulate_continuous_experiment_without_spike_failures``. The
experiment design (holograms, spikes, latencies, weights, noise) is host
numpy and makes exactly the same sequence of ``np.random`` calls as the
JAX simulator, so one ``np.random.seed`` gives the same experiment in
both packages. The trial PSCs, the continuous experiment's ground-truth
windows and the single-target variant's evoked responses are computed
in torch on ``device``; the continuous timeline's FFT convolution and
its AR(1) noise stay host numpy and scipy, as in the JAX package.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ._device import resolve_device


def _resolve_kernel_taus(kernel, N, tau_r_min, tau_r_max,
                         tau_delta_min, tau_delta_max):
    """Per-neuron bi-exponential time constants: supplied or sampled.
    ``kernel`` is a ``(tau_r, tau_d)`` pair or ``{"tau_r", "tau_d"}``,
    each scalar or [N]."""
    if kernel is None:
        tau_r = np.random.uniform(tau_r_min, tau_r_max, N)
        tau_d = tau_r + np.random.uniform(tau_delta_min, tau_delta_max, N)
        return tau_r, tau_d
    if isinstance(kernel, dict):
        tau_r, tau_d = kernel["tau_r"], kernel["tau_d"]
    else:
        tau_r, tau_d = kernel
    tau_r = np.broadcast_to(np.asarray(tau_r, dtype=float), (N,)).copy()
    tau_d = np.broadcast_to(np.asarray(tau_d, dtype=float), (N,)).copy()
    if np.any(tau_d <= tau_r):
        raise ValueError("kernel requires tau_d > tau_r elementwise")
    return tau_r, tau_d


def _shifted_psc_batch(tau_r, tau_d, spk_times, amps, T):
    """Sum over neurons of amplitude-scaled, spike-time-shifted kernels.

    tau_r, tau_d: [n]; spk_times: [n, k]; amps: [n, k] (weight *
    mult_noise * spike), float32 tensors on one device. Returns [k, T].
    Each shifted kernel is renormalised by its sum over the visible
    window, so late spikes keep unit area.
    """
    tgrid = torch.arange(T, dtype=amps.dtype, device=amps.device)
    dt = tgrid - spk_times[:, :, None]                       # [n, k, T]
    dtc = torch.clamp(dt, min=0.0)  # exp(+large) before the spike -> inf
    ke = (torch.exp(-dtc / tau_d[:, None, None])
          - torch.exp(-dtc / tau_r[:, None, None])) * (dt >= 0)
    ke = ke / (torch.sum(ke, dim=2, keepdim=True) + 1e-5)
    return torch.sum(ke * amps[:, :, None], dim=0)


def sample_spike_time(power, gamma_beta=1.5e1, min_latency=160):
    """Gamma-distributed spike latency after stimulus onset."""
    return min_latency + np.random.gamma(alpha(power), gamma_beta)


def alpha(power, scale=1e4):
    """The latency gamma's shape at ``power``, scale / power^2 (the
    reference's name, simulation.py:197-198)."""
    return scale / (power ** 2)


def get_kernel(tau_r, tau_d):
    """Bi-exponential PSC kernel closure f(t, delta), host numpy (the
    reference's simulation.py:200-203)."""
    def func(t, delta):
        t = np.asarray(t, dtype=float)
        return (np.exp(-(t - delta) / tau_d)
                - np.exp(-(t - delta) / tau_r)) * (t > delta)
    return func


def get_kernels(tau_r, tau_d):
    """One kernel closure per (tau_r, tau_d) pair."""
    return [get_kernel(tr, td) for tr, td in zip(tau_r, tau_d)]


def eval_kernel(trange, tau_r, tau_d, delta, eps=1e-8):
    """Peak-normalised delayed bi-exponential kernels, one row per
    neuron: trange [T]; tau_r, tau_d, delta [n]. Returns [n, T] on the
    inputs' device (tensors), or on the CPU (arrays), in float32 unless
    a tensor input is float64 (the reference's simulation.py:217-220,
    the JAX package's jitted vmap)."""
    ins = (trange, tau_r, tau_d, delta)
    tensors = [a for a in ins if isinstance(a, torch.Tensor)]
    dev = tensors[0].device if tensors else torch.device("cpu")
    dt = (torch.float64 if any(a.dtype == torch.float64 for a in tensors)
          else torch.float32)
    t, tr, td, d = (torch.as_tensor(a, dtype=dt, device=dev) for a in ins)
    t = t[None, :]
    tr, td, d = tr[:, None], td[:, None], d[:, None]
    ke = (torch.exp(-(t - d) / td) - torch.exp(-(t - d) / tr)) * (t > d)
    return ke / (ke.max(dim=-1, keepdim=True).values + eps)


def sample_gp(trial_dur=900, gp_lengthscale=25, gp_scale=0.01, n_samples=1):
    """Squared-exponential GP noise by spectral factorisation."""
    t = np.arange(trial_dur)
    cov = np.exp(-((t[:, None] - t[None, :]) ** 2) / (2.0 * gp_lengthscale**2))
    w, Q = np.linalg.eigh(cov)
    half = Q * np.sqrt(np.clip(w, 0.0, None))[None, :]
    eps = np.random.randn(n_samples, trial_dur)
    return gp_scale * (eps @ half.T)


def blockwise_design(N, H, trials, powers, nreps=1, shuffle=True):
    """Random neuron partitions into H-spot holograms, swept over powers."""
    powers = np.sort(np.asarray(powers))[::-1]
    rows = []
    while len(rows) < trials:
        order = np.random.choice(N, N, replace=False)
        holos = [order[i * H:(i + 1) * H] for i in range(int(np.ceil(N / H)))]
        for power, holo, _ in itertools.product(powers, holos, range(nreps)):
            if len(rows) >= trials:
                break
            row = np.zeros(N)
            row[holo] = power
            rows.append(row)
    stim = np.stack(rows, axis=1)
    if shuffle:
        stim = stim[:, np.random.choice(trials, trials, replace=False)]
    return stim


def random_design(N, H, trials, powers):
    """Random holograms with balanced power representation."""
    powers = np.asarray(powers, dtype=float)
    per = int(np.ceil(trials / len(powers)))
    pool = np.repeat(powers, per)[:trials]
    power_order = np.random.permutation(pool)
    stim = np.zeros((N, trials))
    for k in range(trials):
        stim[np.random.choice(N, H), k] = power_order[k]
    return stim


def _pad_spikes_to_min_rate(spks, stim, max_power, min_rate):
    """Raise each neuron's spike rate at max power to ``min_rate`` by
    flipping zero trials (no-op when the design never stimulates)."""
    if max_power <= 0:
        return spks
    for n in range(spks.shape[0]):
        locs = np.flatnonzero(stim[n] == max_power)
        if locs.size == 0:
            continue
        deficit = min_rate - spks[n, locs].mean()
        if deficit > 0:
            zeros = np.flatnonzero(spks[n, locs] == 0)
            need = min(int(np.ceil(deficit * locs.size)), zeros.size)
            if need:
                spks[n, locs[np.random.choice(zeros, need, replace=False)]] = 1.0
    return spks


def _sample_weights(N, connection_prob, frac_strong, strong_lower,
                    strong_upper, weak_mean, min_weight):
    """Sparse weights: a strong uniform tier and a weak shifted-exponential
    tier."""
    n_conn = int(connection_prob * N)
    connected = np.random.choice(N, n_conn, replace=False)
    n_strong = int(np.ceil(frac_strong * n_conn))
    strong = np.random.choice(connected, n_strong, replace=False)
    weak = np.setdiff1d(connected, strong)
    weights = np.zeros(N)
    weights[strong] = np.random.uniform(strong_lower, strong_upper, n_strong)
    weights[weak] = np.random.exponential(weak_mean, weak.size) + min_weight
    return weights


def simulate(
    N=300, T=900, H=10, trials=1000, nreps=1, connection_prob=0.05,
    powers=[45, 55, 65], min_latency=160, gamma_beta=1.5e1, sigma=6e-4,
    frac_strongly_connected=0.2, strong_weight_lower=20,
    strong_weight_upper=40, weak_exp_mean=4, min_weight=9,
    phi_0_lower=0.2, phi_0_upper=0.25, phi_1_lower=10, phi_1_upper=15,
    mult_noise_log_var=0.01, tau_r_min=25, tau_r_max=60, tau_delta_min=75,
    tau_delta_max=250, weights=None, kernel=None, phi_0=None, phi_1=None,
    stim_matrix=None, gp_scale=4e-3, gp_lengthscale=50, spont_prob=0.05,
    design="blockwise", max_power_min_spike_rate=0.4, batch_size=500,
    neuron_batch_size=500, verbose=True, device=None,
):
    """Simulate a trial-based ensemble-stimulation experiment.

    Same signature and returned dict (numpy arrays) as
    ``circuitmap_tpu.simulation.simulate``, plus ``device`` for the
    trace synthesis (None means CUDA; the package's device rule).
    """
    dev = resolve_device(device)
    if design not in ("random", "blockwise"):
        raise ValueError(f"design must be 'random' or 'blockwise', got {design!r}")
    if verbose:
        print(f"Simulating N={N} T={T} H={H} trials={trials} "
              f"density={connection_prob} powers={powers} design={design}")

    if stim_matrix is not None:
        stim_matrix = np.asarray(stim_matrix, dtype=float)
        if stim_matrix.ndim != 2 or stim_matrix.shape[0] != N:
            raise ValueError(
                f"stim_matrix must be [N={N}, K], got {stim_matrix.shape}")
    elif design == "blockwise":
        stim_matrix = blockwise_design(N, H, trials, powers, nreps)
    else:
        stim_matrix = random_design(N, H, trials, powers)
    K = stim_matrix.shape[1]
    I = stim_matrix.max(axis=0)

    tau_r, tau_d = _resolve_kernel_taus(
        kernel, N, tau_r_min, tau_r_max, tau_delta_min, tau_delta_max)
    if phi_0 is None and phi_1 is None:
        phi_0 = np.random.uniform(phi_0_lower, phi_0_upper, N)
        phi_1 = np.random.uniform(phi_1_lower, phi_1_upper, N)
    elif phi_0 is None:
        phi_0 = np.random.uniform(phi_0_lower, phi_0_upper, N)
    elif phi_1 is None:
        phi_1 = np.random.uniform(phi_1_lower, phi_1_upper, N)

    drive = phi_0[:, None] * stim_matrix - phi_1[:, None]
    frates = 1.0 / (1.0 + np.exp(-drive)) * (stim_matrix > 0)
    spks = (np.random.rand(N, K) <= frates).astype(float)
    spks = _pad_spikes_to_min_rate(spks, stim_matrix,
                                   np.max(stim_matrix) if K else 0.0,
                                   max_power_min_spike_rate)

    spk_times = np.zeros((N, K))
    spiking = stim_matrix * spks
    nz = spiking > 0
    spk_times[nz] = sample_spike_time(spiking[nz], gamma_beta=gamma_beta,
                                      min_latency=min_latency)

    if weights is None:
        weights = _sample_weights(
            N, connection_prob, frac_strongly_connected, strong_weight_lower,
            strong_weight_upper, weak_exp_mean, min_weight)
    connected = np.flatnonzero(weights != 0)

    mult_noise = np.random.lognormal(0, mult_noise_log_var, [N, K])

    # trace synthesis on the device, connected neurons only (the others
    # multiply to exactly zero), in trial batches
    amps = (weights[:, None] * mult_noise * spks)[connected]
    st_c = spk_times[connected].astype(np.int32)
    f32 = dict(dtype=torch.float32, device=dev)
    tr_c = torch.as_tensor(tau_r[connected], **f32)
    td_c = torch.as_tensor(tau_d[connected], **f32)
    chunks = []
    for k0 in range(0, K, batch_size):
        k1 = min(k0 + batch_size, K)
        chunks.append(_shifted_psc_batch(
            tr_c, td_c, torch.as_tensor(st_c[:, k0:k1], **f32),
            torch.as_tensor(amps[:, k0:k1], **f32), T).cpu().numpy())
    psc = np.concatenate(chunks, axis=0)

    # spontaneous events: one random-kernel PSC on a random subset of trials
    spont_pscs = np.zeros((K, T))
    spont_trials = np.flatnonzero(np.random.rand(K) <= spont_prob)
    tgrid = np.arange(T)
    for k in spont_trials:
        tr = np.random.uniform(tau_r_min, tau_r_max)
        td = tr + np.random.uniform(tau_delta_min, tau_delta_max)
        delta = np.random.randint(1, T)
        dtc = np.maximum(tgrid - delta, 0.0)
        ke = (np.exp(-dtc / td) - np.exp(-dtc / tr)) * (tgrid > delta)
        if connected.size:
            w = np.random.uniform(weights[connected].min(),
                                  weights[connected].max())
        else:
            w = np.random.uniform(0.5, 1.5)
        spont_pscs[k] = w * ke / (np.trapezoid(ke) + 1e-5)

    gp_noise = sample_gp(trial_dur=T, n_samples=K, gp_scale=gp_scale,
                         gp_lengthscale=gp_lengthscale)
    noise = np.random.normal(0, sigma, [K, T])
    psc = psc + spont_pscs + gp_noise + noise

    return {
        "weights": weights, "phi_0": phi_0, "phi_1": phi_1,
        "mult_noise": mult_noise, "sigma": sigma,
        "stim_matrix": stim_matrix, "psc": psc, "gp_noise": gp_noise,
        "kernel": kernel, "spks": spks, "spk_times": spk_times,
        "spont_pscs": spont_pscs, "I": I, "tau_r": tau_r, "tau_d": tau_d,
    }


# ---------------------------------------------------------------------------
# Continuous-experiment simulator
# ---------------------------------------------------------------------------


def psc_kernel_bank(tau_r, tau_d, window):
    """Bi-exponential PSC kernels evaluated on [0, window). [N, window].

    Unnormalised: exp(-t/tau_d) - exp(-t/tau_r). Normalisation happens
    at the use sites, which differ (sum vs trapz of a truncation).
    """
    t = np.arange(window)[None, :]
    tau_r = np.asarray(tau_r)[:, None]
    tau_d = np.asarray(tau_d)[:, None]
    return np.exp(-t / tau_d) - np.exp(-t / tau_r)


def _windowed_slices(pscs, stim_times, window):
    """[K, W] stim-aligned windows of the timeline, zero-filled where a
    window falls off the recording edges (a raw fancy index would wrap a
    negative offset to the end of the timeline)."""
    idx = stim_times[:, None] + window[None, :]
    valid = (idx >= 0) & (idx < pscs.shape[0])
    return np.where(valid, pscs[np.clip(idx, 0, pscs.shape[0] - 1)], 0.0)


def _ar1_noise(eps, coef):
    """x[t] = coef * x[t-1] + eps[t]: an IIR filter, one C pass of
    scipy's lfilter over the timeline (host, as the FFT convolution)."""
    from scipy.signal import lfilter

    return lfilter([1.0], [1.0, -float(coef)], np.asarray(eps))


def _timeline_fft_conv(impulses, kernels, expt_len):
    """Sum over neurons of (impulse train * kernel) via batched rFFT.

    impulses: [n, expt_len]; kernels: [n, W]. Linear convolution by
    zero-padding to expt_len + W, truncated to expt_len. Host numpy, as
    in the JAX package: data generation over tens of millions of
    samples.
    """
    W = kernels.shape[1]
    L = expt_len + W
    F = np.fft.rfft(impulses, n=L) * np.fft.rfft(kernels, n=L)
    out = np.fft.irfft(np.sum(F, axis=0), n=L)
    return out[:expt_len]


def _evoked_window_batch(tau_r, tau_d, divisors, spk_times, amps,
                         response_length):
    """Ground-truth evoked responses for a batch of stims.

    tau_r/tau_d/divisors: [n] kernel parameters and trapz normalisers;
    spk_times/amps: [n, k]; tensors on one device. Returns [k,
    response_length]: each neuron's kernel placed at its (context-offset)
    spike time, evaluated by broadcasting.
    """
    tgrid = torch.arange(response_length, dtype=amps.dtype,
                         device=amps.device)
    dt = tgrid - spk_times[:, :, None].to(amps.dtype)        # [n, k, T]
    dtc = torch.clamp(dt, min=0.0)  # exp(+large) before the spike -> inf
    ke = (torch.exp(-dtc / tau_d[:, None, None])
          - torch.exp(-dtc / tau_r[:, None, None])) * (dt >= 0) \
        / divisors[:, None, None]
    return torch.sum(ke * amps[:, :, None], dim=0)


def simulate_continuous_experiment_without_spike_failures(
    N=100,
    connected_frac=0.2,
    exp_len=int(2e4),
    gamma_beta=1.5e1,
    min_latency=60,
    spont_rate=0.0005,
    mult_noise_log_var=0.01,
    response_length=900,
    noise_std=1e-2,
    tau_r_min=10,
    tau_r_max=40,
    tau_delta_min=250,
    tau_delta_max=300,
    power=50,
    sampling_freq=20000,
    stim_freq=10,
    weight_lower=2,
    weight_upper=10,
    seed=0,
    ar_coef=0.95,
    ar_std=1e-1,
    device=None,
):
    """Single-target continuous experiment where every stim evokes a spike.

    One random target per stim at a single power, deterministic spiking,
    peak-normalised kernels. The evoked and spontaneous kernels are
    evaluated over the timeline in float64 on ``device`` (None means
    CUDA). Returns pscs / obs_responses / true_responses / tars /
    stim_times / weights (numpy), as the JAX package does.
    """
    dev = resolve_device(device)
    tau_r = np.random.uniform(tau_r_min, tau_r_max, N)
    tau_d = tau_r + np.random.uniform(tau_delta_min, tau_delta_max, N)

    isi = int(sampling_freq / stim_freq)
    stim_times = np.arange(isi, exp_len - response_length, isi, dtype=int)
    nstim = len(stim_times)
    spike_lat = sample_spike_time(power * np.ones(nstim),
                                  gamma_beta=gamma_beta,
                                  min_latency=min_latency)
    tars = np.random.choice(N, nstim)

    n_conn = int(connected_frac * N)
    connected = np.random.choice(N, n_conn, replace=False)
    weights = np.zeros(N)
    weights[connected] = np.random.uniform(weight_lower, weight_upper, n_conn)

    mult_noise = np.random.lognormal(0, mult_noise_log_var, nstim)

    f64 = dict(dtype=torch.float64, device=dev)
    trange = torch.arange(exp_len, **f64)

    def peak_kernel(t0, tr, td):
        # the kernel at frame t0 over the timeline, peak-normalised
        dt = trange - float(t0)
        dtc = torch.clamp(dt, min=0.0)
        ke = (torch.exp(-dtc / td) - torch.exp(-dtc / tr)) * (dt > 0)
        peak = ke.max()
        return torch.where(peak > 0, ke / peak, ke)

    # per-stim responses: the targeted neuron's kernel at its (stim +
    # latency) frame; the response window clipped at the recording edges
    frames = (stim_times + spike_lat).astype(int)
    pscs_evoked = torch.zeros(exp_len, **f64)
    true_resps = np.zeros((nstim, response_length))
    win = np.arange(-100, response_length - 100)
    for s_ in range(nstim):
        n = tars[s_]
        contrib = peak_kernel(frames[s_], tau_r[n], tau_d[n]) * (
            weights[n] * mult_noise[s_])
        pscs_evoked += contrib
        idx = stim_times[s_] + win
        valid = (idx >= 0) & (idx < exp_len)
        true_resps[s_, valid] = contrib[torch.from_numpy(idx[valid]).to(
            dev)].cpu().numpy()

    # spontaneous events
    nspont = int(spont_rate * exp_len)
    sponts = torch.zeros(exp_len, **f64)
    if nspont:
        sp_t = np.random.choice(exp_len, nspont, replace=False)
        sp_tr = np.random.uniform(tau_r_min, tau_r_max, nspont)
        sp_td = sp_tr + np.random.uniform(tau_delta_min, tau_delta_max,
                                          nspont)
        sp_w = np.random.uniform(weight_lower, weight_upper, nspont)
        for s_ in range(nspont):
            sponts += sp_w[s_] * peak_kernel(sp_t[s_], sp_tr[s_], sp_td[s_])

    eps = np.random.normal(0, ar_std, exp_len)
    ar1 = _ar1_noise(eps, ar_coef)
    pscs = (pscs_evoked + sponts).cpu().numpy() + ar1

    obs_resps = _windowed_slices(pscs, stim_times, win)
    return {
        "pscs": pscs,
        "obs_responses": obs_resps,
        "true_responses": true_resps,
        "tars": tars,
        "stim_times": stim_times,
        "weights": weights,
    }


def simulate_continuous_experiment(
    N=100,
    expt_len=int(2e4),
    gamma_beta=1.5e1,
    min_latency=60,
    powers=[45, 55, 65],
    mult_noise_log_var=0.05,
    response_length=900,
    noise_std=1e-2,
    tau_r_min=10,
    tau_r_max=40,
    tau_delta_min=250,
    tau_delta_max=300,
    sampling_freq=20000,
    stim_freq=10,
    weight_lower=2,
    weight_upper=10,
    seed=0,
    ar_coef=0.95,
    ar_std=3e-4,
    weights=None,
    frac_strongly_connected=0.2,
    strong_weight_lower=20,
    strong_weight_upper=40,
    weak_exp_mean=4,
    min_weight=7,
    phi_0_lower=0.2,
    phi_0_upper=0.25,
    phi_1_lower=10,
    phi_1_upper=15,
    kernel=None,
    phi_0=None,
    phi_1=None,
    H=10,
    nreps=1,
    connection_prob=0.1,
    spont_rate=3,
    kernel_window=3000,
    prior_context=100,
    ground_truth_eval_batch_size=1000,
    max_power_min_spike_rate=0.3,
    verbose=True,
    device=None,
):
    """Simulate a continuous 20 kHz mapping experiment.

    Same signature and returned dict (numpy arrays: pscs, obs_responses,
    true_responses, stim_matrix, weights, spike_matrix, stim_times) as
    ``circuitmap_tpu.simulation.simulate_continuous_experiment``, plus
    ``device`` for the ground-truth response windows (float32, batches of
    ``ground_truth_eval_batch_size`` stims; None means CUDA).
    """
    dev = resolve_device(device)
    if verbose:
        print(
            f"Simulating continuous experiment: N={N} H={H} "
            f"duration={expt_len / sampling_freq:.1f}s "
            f"stim_freq={stim_freq}Hz spont_rate={spont_rate}Hz "
            f"powers={powers}"
        )

    tau_r, tau_d = _resolve_kernel_taus(
        kernel, N, tau_r_min, tau_r_max, tau_delta_min, tau_delta_max
    )

    if weights is None:
        weights = _sample_weights(
            N, connection_prob, frac_strongly_connected, strong_weight_lower,
            strong_weight_upper, weak_exp_mean, min_weight,
        )
    connected = np.flatnonzero(weights != 0)

    # stim timing + blockwise design
    isi = int(sampling_freq / stim_freq)
    stim_times = np.arange(isi, expt_len - response_length - isi, isi,
                           dtype=int)
    nstim = len(stim_times)
    stim_matrix = blockwise_design(N, H, nstim, powers, nreps, shuffle=False)

    # sample only the missing opsin parameter (a supplied value is never
    # re-drawn)
    if phi_0 is None and phi_1 is None:
        phi_0 = np.random.uniform(phi_0_lower, phi_0_upper, N)
        phi_1 = np.random.uniform(phi_1_lower, phi_1_upper, N)
    elif phi_0 is None:
        phi_0 = np.random.uniform(phi_0_lower, phi_0_upper, N)
    elif phi_1 is None:
        phi_1 = np.random.uniform(phi_1_lower, phi_1_upper, N)

    drive = phi_0[:, None] * stim_matrix - phi_1[:, None]
    frates = 1.0 / (1.0 + np.exp(-drive)) * (stim_matrix > 0)
    spks = (np.random.rand(N, nstim) <= frates).astype(float)
    spks = _pad_spikes_to_min_rate(spks, stim_matrix, np.max(powers),
                                   max_power_min_spike_rate)

    spike_times = np.zeros((N, nstim))
    targeted = stim_matrix > 0
    spike_times[targeted] = sample_spike_time(
        stim_matrix[targeted], gamma_beta=gamma_beta, min_latency=min_latency
    )

    # shuffle the trial order
    reorder = np.random.choice(nstim, nstim, replace=False)
    stim_matrix = stim_matrix[:, reorder]
    spike_times = spike_times[:, reorder]
    spks = spks[:, reorder]

    mult_noise = np.random.lognormal(0, mult_noise_log_var, [N, nstim])

    # --- evoked timeline: impulse trains conv kernels (connected only) ---
    if verbose:
        print("Synthesising evoked timeline (FFT conv)...")
    kernels_c = psc_kernel_bank(tau_r[connected], tau_d[connected],
                                kernel_window)
    # normalised by trapz over the response window
    divisors = np.trapezoid(kernels_c[:, :response_length], axis=1) + 1e-5
    kernels_c = kernels_c / divisors[:, None]

    impulses = np.zeros((len(connected), expt_len))
    frames = (spike_times + stim_times[None, :]).astype(int)
    for i, c in enumerate(connected):
        hit = spks[c] > 0
        np.add.at(
            impulses[i], frames[c, hit], weights[c] * mult_noise[c, hit]
        )
    impulses[:, 0] = 0.0  # the first bin is guarded, as in the reference

    pscs = np.zeros(expt_len)
    nb = 8
    for i0 in range(0, len(connected), nb):
        pscs += _timeline_fft_conv(
            impulses[i0:i0 + nb], kernels_c[i0:i0 + nb], expt_len
        )

    # --- ground-truth per-stim responses, on the device ---
    if verbose:
        print("Extracting ground-truth evoked responses...")
    f32 = dict(dtype=torch.float32, device=dev)
    tr_c = torch.as_tensor(tau_r[connected], **f32)
    td_c = torch.as_tensor(tau_d[connected], **f32)
    div_c = torch.as_tensor(divisors, **f32)
    amps_c = (weights[:, None] * mult_noise * spks)[connected]
    st_c = (prior_context + spike_times[connected]).astype(np.int32)
    true_resps = []
    for k0 in range(0, nstim, ground_truth_eval_batch_size):
        k1 = min(k0 + ground_truth_eval_batch_size, nstim)
        true_resps.append(_evoked_window_batch(
            tr_c, td_c, div_c,
            torch.from_numpy(np.ascontiguousarray(st_c[:, k0:k1])).to(dev),
            torch.as_tensor(amps_c[:, k0:k1], **f32),
            response_length).cpu().numpy())
    true_resps = np.concatenate(true_resps, axis=0)

    # --- spontaneous events: windowed scatter-add ---
    nspont = int(spont_rate / sampling_freq * expt_len)
    if nspont:
        spont_times = np.random.choice(expt_len, nspont, replace=False)
        sp_tr = np.random.uniform(tau_r_min, tau_r_max, nspont)
        sp_td = sp_tr + np.random.uniform(tau_delta_min, tau_delta_max,
                                          nspont)
        sp_kerns = psc_kernel_bank(sp_tr, sp_td, kernel_window)
        sp_div = np.trapezoid(sp_kerns[:, :response_length], axis=1) + 1e-8
        sp_w = np.random.uniform(0.0, np.max(weights), nspont)
        sponts = np.zeros(expt_len + kernel_window)
        for s_ in range(nspont):
            # kernel offset o lands at frame delta + o, offset 0
            # suppressed (the kernel is 0 there anyway)
            seg = sp_kerns[s_][1: expt_len + kernel_window - spont_times[s_]]
            sponts[spont_times[s_] + 1: spont_times[s_] + 1 + seg.size] += (
                sp_w[s_] * seg / sp_div[s_]
            )
        sponts = sponts[:expt_len]
    else:
        sponts = np.zeros(expt_len)

    # --- AR(1) noise ---
    eps = np.random.normal(0, ar_std, expt_len)
    ar1 = _ar1_noise(eps, ar_coef)

    pscs = pscs + sponts + ar1

    # --- slice into K x response_length windows ---
    window = np.arange(-prior_context, response_length - prior_context)
    obs_resps = _windowed_slices(pscs, stim_times, window)

    return {
        "pscs": pscs,
        "obs_responses": obs_resps,
        "true_responses": true_resps,
        "stim_matrix": stim_matrix,
        "weights": weights,
        "spike_matrix": spks,
        "stim_times": stim_times,
    }
