"""Synthetic PSC training data for the demixer (port of
``circuitmap_tpu/demix/datagen.py``, host numpy, the same code).

Each training pair is a noisy superposition of 0-3 "target" PSCs
(onsets inside the stimulus window) with "previous"/"next" trial
contaminants (onsets outside it); the target trace is the clean
supervision signal. GP + iid noise is added after peak-normalisation.
Every kernel is evaluated as one broadcast [chunk, modes, T] array and
the GP is sampled through a precomputed spectral factor
(``simulation.sample_gp``, which draws from the global ``np.random``
stream as the JAX package's does), so one ``default_rng(seed)`` and one
``np.random.seed`` give the same dataset in both packages.
"""

from __future__ import annotations

import numpy as np

from ..simulation import sample_gp


def _psc_mixtures(
    rng,
    size,
    n_modes,
    trial_dur,
    tau_r_range,
    tau_diff_range,
    delta_range,
    amplitude_range=(0.1, 1.5),
    max_modes=4,
):
    """Sum of up to ``max_modes`` peak-normalised PSC kernels per trace.

    n_modes: [size] counts; kernels with index >= count are masked out.
    Matches reference _sample_psc_kernel (neural_waveform_demixing.py:317-335):
    onset gating is (t >= delta), each kernel normalised to unit peak and
    scaled by a uniform amplitude.
    """
    tau_r = rng.uniform(*tau_r_range, (size, max_modes, 1))
    tau_d = tau_r + rng.uniform(*tau_diff_range, (size, max_modes, 1))
    delta = rng.uniform(*delta_range, (size, max_modes, 1))
    amp = rng.uniform(*amplitude_range, (size, max_modes, 1))
    active = (np.arange(max_modes)[None, :, None] < n_modes[:, None, None])

    t = np.arange(trial_dur)[None, None, :]
    out = np.zeros((size, trial_dur))
    chunk = 2048
    for i0 in range(0, size, chunk):
        i1 = min(i0 + chunk, size)
        dt = t - delta[i0:i1]
        dtc = np.maximum(dt, 0.0)  # clamp before exp: inf * 0-mask is nan
        ke = (np.exp(-dtc / tau_d[i0:i1]) - np.exp(-dtc / tau_r[i0:i1])) * (dt >= 0)
        peak = np.max(ke, axis=2, keepdims=True)
        ke = np.where(peak > 0, ke / np.maximum(peak, 1e-30), 0.0)
        out[i0:i1] = np.sum(ke * amp[i0:i1] * active[i0:i1], axis=1)
    return out


def generate_psc_dataset(
    trial_dur=900,
    size=1000,
    training_fraction=0.9,
    tau_r_lower=10,
    tau_r_upper=80,
    tau_diff_lower=2,
    tau_diff_upper=150,
    delta_lower=160,
    delta_upper=400,
    next_delta_lower=400,
    next_delta_upper=899,
    prev_delta_lower=-400,
    prev_delta_upper=-100,
    mode_probs=(0.4, 0.4, 0.1, 0.1),
    prev_mode_probs=(0.5, 0.4, 0.05, 0.05),
    next_mode_probs=(0.5, 0.4, 0.05, 0.05),
    noise_std_lower=0.01,
    noise_std_upper=0.1,
    gp_lengthscale=25,
    gp_scale=0.01,
    max_modes=4,
    templates=None,
    template_prob=0.075,
    seed=None,
    lp_cutoff=500,
    srate=20000,
    observed_amplitude_lower=0.75,
    observed_amplitude_upper=1.25,
    prob_zero_event=0.001,
):
    """Returns ((train_in, train_tgt), (test_in, test_tgt)).

    Mirrors reference generate_training_data kwargs
    (neural_waveform_demixing.py:96-104). ``templates`` mixes in real
    negative examples (e.g. direct photocurrents) with zero targets.

    ``lp_cutoff``/``srate``/``observed_amplitude_*``/``prob_zero_event``
    are accepted for call compatibility but have no effect — the
    reference accepts them too and never uses them (its low-pass
    filtfilt is commented out, neural_waveform_demixing.py:142-144, and
    the amplitude/zero-event knobs appear only in its signature).
    """
    del lp_cutoff, srate, observed_amplitude_lower
    del observed_amplitude_upper, prob_zero_event
    rng = np.random.default_rng(seed)

    counts = rng.choice(max_modes, size, p=np.asarray(mode_probs))
    counts_prev = rng.choice(max_modes, size, p=np.asarray(prev_mode_probs))
    counts_next = rng.choice(max_modes, size, p=np.asarray(next_mode_probs))

    kw = dict(
        trial_dur=trial_dur,
        tau_r_range=(tau_r_lower, tau_r_upper),
        tau_diff_range=(tau_diff_lower, tau_diff_upper),
        max_modes=max_modes,
    )
    targets = _psc_mixtures(rng, size, counts,
                            delta_range=(delta_lower, delta_upper), **kw)
    prevs = _psc_mixtures(rng, size, counts_prev,
                          delta_range=(prev_delta_lower, prev_delta_upper), **kw)
    nexts = _psc_mixtures(rng, size, counts_next,
                          delta_range=(next_delta_lower, next_delta_upper), **kw)
    inputs = targets + prevs + nexts

    if templates is not None:
        templates = np.asarray(templates)
        use = rng.random(size) <= template_prob
        idx = rng.integers(0, templates.shape[0], size)
        inputs[use] = templates[idx[use]]
        targets[use] = 0.0

    # normalise by raw-input peak, then add noise (reference order,
    # neural_waveform_demixing.py:147-152)
    peak = np.max(inputs, axis=1, keepdims=True) + 1e-5
    gp = sample_gp(trial_dur=trial_dur, gp_lengthscale=gp_lengthscale,
                   gp_scale=gp_scale, n_samples=size)
    gp = gp * rng.uniform(0, 1, size)[:, None]
    iid = rng.normal(0, rng.uniform(noise_std_lower, noise_std_upper, size)[:, None],
                     (size, trial_dur))
    inputs = inputs / peak + gp + iid
    targets = targets / peak

    n_train = int(training_fraction * size)
    return (
        (inputs[:n_train], targets[:n_train]),
        (inputs[n_train:], targets[n_train:]),
    )
