"""PSC-template fitting in the port against the JAX package's.

Both run float32 Adam from the same numpy inits (``default_rng(seed)``
draws the same grid and peak inits in both) on the same traces. The
gradients come from autograd against JAX's ``grad`` and the sums run in
another order, so after 200 steps the parameters are held at 1e-3
relative to each array's largest entry and the reconstructions at 1e-4
of the traces' peak (measured: ~5e-6 and ~3e-6); the template sum
itself at float32 rounding.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from circuitmap_tpu.demix import template_fit as jtf
from circuitmap_tpu.demix.datagen import generate_psc_dataset
from circuitmap_torch.demix import template_fit as ttf


@pytest.fixture(autouse=True, scope="module")
def _one_host_thread():
    """One torch and one BLAS thread while this file runs (the suite's
    parallel workers would oversubscribe the cores)."""
    from threadpoolctl import threadpool_limits

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def traces():
    np.random.seed(0)
    (_, y), _ = generate_psc_dataset(size=40, seed=1)
    # eight traces that carry at least one PSC
    return y[np.flatnonzero(y.max(axis=1) > 0.1)[:8]].astype(np.float32)


def test_sum_of_psc_templates_matches_jax():
    rng = np.random.default_rng(0)
    t = np.linspace(-5.0, 40.0, 900).astype(np.float32)
    p = [rng.uniform(lo, hi, (3, 5)).astype(np.float32)
         for lo, hi in ((0.5, 2), (3, 15), (0.1, 2), (-2, 30))]
    got = ttf.sum_of_psc_templates(torch.from_numpy(t),
                                   *(torch.from_numpy(a) for a in p))
    for i in range(3):
        want = jtf.sum_of_psc_templates(jnp.asarray(t),
                                        *(jnp.asarray(a[i]) for a in p))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-6)


def test_fit_matches_jax(traces):
    kw = dict(n_kernels=4, steps=200, restarts=3, seed=2)
    want = jtf.fit_psc_templates(traces, **kw)
    got = ttf.fit_psc_templates(traces, device="cpu", **kw)
    for key in ("tau_r", "tau_diff", "amp", "onset"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=1e-3 * np.abs(want[key]).max())
    np.testing.assert_allclose(got["reconstruction"], want["reconstruction"],
                               rtol=0, atol=1e-4 * np.abs(traces).max())
    np.testing.assert_allclose(got["r2"], want["r2"], rtol=0, atol=1e-4)
    assert np.median(got["r2"]) > 0.9
    # a device tensor is taken as input too
    again = ttf.fit_psc_templates(torch.from_numpy(traces), device="cpu",
                                  **kw)
    np.testing.assert_array_equal(again["amp"], got["amp"])


def test_suggest_datagen_ranges_matches_jax(traces):
    fit = ttf.fit_psc_templates(traces, n_kernels=4, steps=100, restarts=1,
                                device="cpu")
    assert ttf.suggest_datagen_ranges(fit) == jtf.suggest_datagen_ranges(fit)
    got = ttf.suggest_datagen_ranges(fit, amp_threshold=0.3, lo_pct=20,
                                     hi_pct=80, srate=10000.0)
    assert got == jtf.suggest_datagen_ranges(fit, amp_threshold=0.3,
                                             lo_pct=20, hi_pct=80,
                                             srate=10000.0)
    assert got["tau_r_lower"] <= got["tau_r_upper"]


def test_inits_equal_jax(traces):
    t = np.linspace(-5.0, 40.0, traces.shape[1]).astype(np.float32)
    for fn_t, fn_j, args in (
            (ttf._grid_init, jtf._grid_init, (8, 5, t)),
            (ttf._peak_init, jtf._peak_init, (traces, t, 5))):
        a = fn_t(*args, np.random.default_rng(4), *(
            (0.5,) if fn_t is ttf._grid_init else ()))
        b = fn_j(*args, np.random.default_rng(4), *(
            (0.5,) if fn_j is jtf._grid_init else ()))
        np.testing.assert_array_equal(a, b)


def test_nan_restart_cannot_poison_selection():
    """A diverged (NaN-loss) restart loses to any later finite restart
    (the JAX package's regression case)."""
    raw_a = torch.full((2, 3, 4), float("nan"))
    loss_a = torch.tensor([float("nan"), 1.0])
    raw_b = torch.ones((2, 3, 4))
    loss_b = torch.tensor([0.5, 2.0])
    raw, loss = ttf._combine_restarts(raw_a, loss_a, raw_b, loss_b)
    np.testing.assert_array_equal(loss.numpy(), [0.5, 1.0])
    assert torch.all(raw[0] == 1.0)        # NaN incumbent replaced
    assert torch.isnan(raw[1]).all()       # finite incumbent kept
    jraw, jloss = jtf._combine_restarts(
        jnp.asarray(raw_a.numpy()), jnp.asarray(loss_a.numpy()),
        jnp.asarray(raw_b.numpy()), jnp.asarray(loss_b.numpy()))
    np.testing.assert_array_equal(np.asarray(jloss), loss.numpy())
    np.testing.assert_array_equal(np.asarray(jraw), raw.numpy())
