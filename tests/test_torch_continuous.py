"""The continuous 20 kHz simulation in the port against the JAX
package's.

Both simulators make the same ``np.random`` calls, so one
``np.random.seed`` gives the same experiment. The host parts (design,
FFT timeline, AR(1) noise, spontaneous events, windows) are the same
numpy code and are held exactly; the continuous experiment's
ground-truth windows are float32 on the device in both, held at 1e-5 of
their peak; the single-target variant's evoked and spontaneous kernels
are float64 on the device in the port (host numpy in the JAX package),
held at 1e-9 of the peak.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from circuitmap_tpu import simulation as jsim
from circuitmap_torch import simulation as tsim


def _same(got, want, tol=0.0):
    assert got.keys() == want.keys()
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.shape == w.shape, k
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * max(np.abs(w).max(), 1e-30)
                                   if w.size else 0, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(N=40, H=5, expt_len=60000, stim_freq=30),
    # every neuron connected at fixed weights, a given kernel and
    # phi_0, no spontaneous events, a fast stim rate
    dict(N=12, H=3, expt_len=40000, stim_freq=100, spont_rate=0,
         weights=np.linspace(5, 30, 12), kernel=(20.0, 300.0),
         phi_0=np.full(12, 0.22), ground_truth_eval_batch_size=64),
])
def test_continuous_experiment_matches_jax(kw):
    np.random.seed(3)
    want = jsim.simulate_continuous_experiment(verbose=False, **kw)
    np.random.seed(3)
    got = tsim.simulate_continuous_experiment(verbose=False, device="cpu",
                                              **kw)
    exact = {k: v for k, v in want.items() if k != "true_responses"}
    _same({k: got[k] for k in exact}, exact)
    assert got["true_responses"].dtype == np.float32
    _same({"t": got["true_responses"]}, {"t": want["true_responses"]},
          1e-5)
    assert np.abs(got["true_responses"]).max() > 0


def test_without_spike_failures_matches_jax():
    kw = dict(N=20, exp_len=60000, stim_freq=30)
    np.random.seed(5)
    want = jsim.simulate_continuous_experiment_without_spike_failures(**kw)
    np.random.seed(5)
    got = tsim.simulate_continuous_experiment_without_spike_failures(
        device="cpu", **kw)
    _same(got, want, 1e-9)


def test_psc_kernel_bank_and_windowed_slices_match_jax():
    rng = np.random.default_rng(0)
    tau_r = rng.uniform(10, 40, 6)
    tau_d = tau_r + rng.uniform(250, 300, 6)
    np.testing.assert_array_equal(tsim.psc_kernel_bank(tau_r, tau_d, 500),
                                  jsim.psc_kernel_bank(tau_r, tau_d, 500))
    pscs = rng.normal(size=3000)
    stim_times = np.array([50, 700, 2950])
    window = np.arange(-100, 800)
    got = tsim._windowed_slices(pscs, stim_times, window)
    np.testing.assert_array_equal(
        got, jsim._windowed_slices(pscs, stim_times, window))
    # off the recording edges the windows are zero, not wrapped
    assert np.all(got[0, :50] == 0) and np.all(got[2, 150:] == 0)


def test_ar1_noise_and_fft_conv_match_jax():
    rng = np.random.default_rng(1)
    eps = rng.normal(0, 0.1, 5000)
    np.testing.assert_array_equal(tsim._ar1_noise(eps, 0.95),
                                  jsim._ar1_noise(eps, 0.95))
    impulses = np.zeros((3, 4000))
    impulses[rng.integers(0, 3, 40), rng.integers(1, 4000, 40)] = 1.0
    kernels = rng.random((3, 300))
    got = tsim._timeline_fft_conv(impulses, kernels, 4000)
    np.testing.assert_array_equal(
        got, jsim._timeline_fft_conv(impulses, kernels, 4000))
    direct = sum(np.convolve(impulses[i], kernels[i])[:4000]
                 for i in range(3))
    np.testing.assert_allclose(got, direct, atol=1e-10)


def test_evoked_window_batch_matches_jax():
    rng = np.random.default_rng(2)
    n, k = 5, 7
    tr = rng.uniform(10, 40, n).astype(np.float32)
    td = (tr + rng.uniform(250, 300, n)).astype(np.float32)
    div = rng.uniform(100, 200, n).astype(np.float32)
    st = rng.integers(100, 800, (n, k)).astype(np.int32)
    amps = rng.uniform(0, 10, (n, k)).astype(np.float32)
    got = tsim._evoked_window_batch(
        *(torch.from_numpy(a) for a in (tr, td, div, st, amps)), 900)
    want = jsim._evoked_window_batch(
        *(jnp.asarray(a) for a in (tr, td, div, st, amps)), 900)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))


def test_demix_fidelity_at_30hz_matches_jax():
    """ROADMAP C3, settled: on one timeline (N=50, 30 s at 20 kHz,
    30 Hz, phase 24's connection probability and spontaneous rate, one
    seed) demixed on the int4d2 wire by the shipped QAT checkpoint, the
    port's mean per-trial fidelity R2 is the JAX package's (the
    timelines are equal; the demixes agree to ~4e-7 of their peak). A
    30 Hz fidelity below the prediction is the simulation's and the
    demixer's, not the port's."""
    from circuitmap_tpu.demix import NeuralDemixer as JaxDemixer
    from circuitmap_torch.demix import NeuralDemixer
    from circuitmap_torch.utils.metrics import r2_score

    def fidelity(true, demixed):
        return float(np.mean([r2_score(t, d) for t, d in zip(true, demixed)
                              if t.std() > 0]))

    kw = dict(N=50, H=10, expt_len=30 * 20000, stim_freq=30,
              connection_prob=0.1, spont_rate=3, verbose=False)
    np.random.seed(0)
    want = jsim.simulate_continuous_experiment(**kw)
    np.random.seed(0)
    got = tsim.simulate_continuous_experiment(device="cpu", **kw)
    np.testing.assert_array_equal(got["obs_responses"], want["obs_responses"])
    ck = "demixers/nwd_ie_ChroME2f_int4d2qat.npz"
    dem_jax = np.asarray(JaxDemixer(path=ck)(
        want["obs_responses"], transfer_dtype="int4d2", verbose=False))
    dem = NeuralDemixer(ck, device="cpu")(
        got["obs_responses"], transfer_dtype="int4d2", verbose=False)
    np.testing.assert_allclose(dem, dem_jax, rtol=0,
                               atol=1e-5 * np.abs(dem_jax).max())
    f_jax = fidelity(want["true_responses"], dem_jax)
    f_port = fidelity(got["true_responses"], dem)
    assert f_port >= f_jax - 0.01
    assert abs(f_port - f_jax) < 1e-4, (f_port, f_jax)
