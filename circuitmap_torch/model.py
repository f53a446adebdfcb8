"""Model facade: priors, solver dispatch, posterior state (port of
``circuitmap_tpu/model.py``).

Construct with a neuron count and optional prior overrides, call
``fit(obs, stimuli, method, fit_options, device=None)``, read the
posteriors from ``model.state`` (numpy arrays), the per-iteration
snapshots from ``model.history`` and the wall-clock from ``model.time``.
"""

from __future__ import annotations

import time
from copy import deepcopy

import numpy as np
import torch

from ._device import resolve_device


def default_priors(N):
    """The reference's default prior set (model.py:24-31)."""
    return {
        "alpha": 0.25 * np.ones(N),
        "phi": np.column_stack([1e-1 * np.ones(N), 5e0 * np.ones(N)]),
        "phi_cov": np.tile(np.array([[1e-1, 0.0], [0.0, 1e0]]), (N, 1, 1)),
        "mu": np.zeros(N),
        "beta": 1e1 * np.ones(N),
        "shape": 1.0,
        "rate": 1e-1,
    }


def _host(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return v


class Model:
    """Connectivity-mapping model: priors in, posterior ``state`` out."""

    def __init__(self, N, priors=None):
        self.N = N
        self.priors = dict(priors) if priors is not None else {}
        for key, val in default_priors(N).items():
            self.priors.setdefault(key, val)
        self.state = deepcopy(self.priors)
        self.history = {}
        self.time = None
        self.trial_count = None

    def fit(self, obs, stimuli, method="caviar", fit_options=None,
            device=None):
        """Run a fit on ``device`` (None means CUDA; ``fit_options`` may
        carry ``device`` too). ``fit_options`` takes every keyword of the
        method's solver (``caviar``, ``cavi_sns``, ``mbcs``; ``k``, ``tol``
        and ``maxiter`` for ``cosamp``); ``mesh`` (multi-GPU fits) is not
        ported yet. CoSaMP is a host numpy baseline by design: it runs on
        the CPU whatever the device."""
        fit_options = dict(fit_options or {})
        runner = {
            "caviar": self._fit_caviar,
            "cavi_sns": self._fit_cavi_sns,
            "mbcs": self._fit_mbcs,
            "cosamp": self._fit_cosamp,
        }.get(method)
        if runner is None:
            raise ValueError(
                f"unknown method {method!r}; expected "
                "caviar | cavi_sns | mbcs | cosamp")
        if fit_options.pop("mesh", None) is not None:
            raise NotImplementedError(
                "mesh= (trial-sharded multi-GPU fits) is ROADMAP item A9 "
                "and not ported yet")
        device = resolve_device(fit_options.pop("device", device))
        self.fit_method = method
        t0 = time.time()
        runner(obs, stimuli, fit_options, device)
        self.time = time.time() - t0
        return self

    def summary(self, stim=None, verbose=True):
        """Per-neuron posterior summary (``circuitmap_torch.summarize``);
        prints the table unless ``verbose=False``. Returns the dict."""
        from .summary import format_summary, summarize

        out = summarize(self, stim=stim)
        if verbose:
            print(format_summary(out), end="")
        return out

    def _set_history(self, names, hists):
        self.history = {n: _host(h) for n, h in zip(names, hists)}

    def _fit_caviar(self, obs, stimuli, fit_options, device):
        from .solvers.caviar import caviar

        s = self.state
        track_elbo = bool(fit_options.get("track_elbo"))
        result = caviar(obs, stimuli, s["mu"], s["beta"], s["shape"],
                        s["rate"], s["phi"], s["phi_cov"], device=device,
                        **fit_options)
        if track_elbo:
            *result, (elbos, converged_at) = result
            self.elbo = np.asarray(elbos)
            self.elbo_converged_at = converged_at
        (mu, beta, lam, shape, rate, phi, phi_cov, z, receptive_fields,
         *hists) = result
        self.state.update(
            mu=_host(mu), beta=_host(beta), lam=_host(lam),
            shape=_host(shape), rate=_host(rate), phi=_host(phi),
            phi_cov=_host(phi_cov), z=_host(z),
            receptive_fields=receptive_fields)
        self.trial_count = self.state["lam"].shape[1]
        self._set_history(["mu", "beta", "lam", "shape", "rate", "phi",
                           "phi_cov", "z"], hists)
        if track_elbo:
            self.history["elbo"] = self.elbo

    def _fit_cavi_sns(self, obs, stimuli, fit_options, device):
        from .solvers.cavi_sns import cavi_sns

        s = self.state
        mu, beta, alpha, lam, shape, rate, phi, phi_cov, *hists = cavi_sns(
            obs, stimuli, s["mu"], s["beta"], s["alpha"], s["shape"],
            s["rate"], s["phi"], s["phi_cov"], device=device, **fit_options)
        self.state.update(
            mu=_host(mu), beta=_host(beta), alpha=_host(alpha),
            lam=_host(lam), shape=_host(shape), rate=_host(rate),
            phi=_host(phi), phi_cov=_host(phi_cov))
        self.trial_count = self.state["lam"].shape[1]
        self._set_history(["mu", "beta", "alpha", "lam", "shape", "rate",
                           "phi", "phi_cov"], hists)

    def _fit_mbcs(self, obs, stimuli, fit_options, device):
        from .solvers.mbcs import mbcs

        s = self.state
        mu, beta, lam, shape, rate, z, receptive_fields, *hists = mbcs(
            obs, stimuli, s["mu"], s["beta"], s["shape"], s["rate"],
            device=device, **fit_options)
        self.state.update(
            mu=_host(mu), beta=_host(beta), lam=_host(lam),
            shape=_host(shape), rate=_host(rate), z=_host(z),
            receptive_fields=_host(receptive_fields))
        self.trial_count = self.state["lam"].shape[1]
        self._set_history(["mu", "beta", "lam", "shape", "rate", "z"], hists)

    def _fit_cosamp(self, obs, stimuli, fit_options, device):
        """Greedy CoSaMP baseline on the integrated charge, in host numpy
        (``device`` is not used): sensing matrix = the binary targeting
        design, measurements = trapezoidal charges. Records the point
        weights and the solver's own elapsed time; lam and the rest of
        the state stay at the priors."""
        from .solvers.cosamp import cosamp

        del device
        stim = np.asarray(_host(stimuli), dtype=float)
        y = np.trapezoid(np.asarray(_host(obs), dtype=float), axis=-1)
        A = (stim > 0).T.astype(float)
        k = int(fit_options.pop("k", max(int(0.1 * self.N), 1)))
        weights, elapsed = cosamp(A, y, k, **fit_options)
        self.state.update(mu=weights, cosamp_time=float(elapsed))
        self.trial_count = stim.shape[1]
        self.history = {}
