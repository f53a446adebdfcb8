"""Model facade: priors, solver dispatch, posterior state (port of
``circuitmap_tpu/model.py``).

Construct with a neuron count and optional prior overrides, call
``fit(obs, stimuli, method, fit_options, device=None)``, read the
posteriors from ``model.state`` (numpy arrays), the per-iteration
snapshots from ``model.history`` and the wall-clock from ``model.time``.
The fit server's ``return_fields`` narrows which fields are pulled to
the host (``fit(_materialize=)``).
"""

from __future__ import annotations

import time
from copy import deepcopy

import numpy as np
import torch

from ._device import resolve_device
from .utils.profiling import span
from .utils.pull import to_host


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
    return to_host({"v": v})["v"]


class DeviceField(torch.Tensor):
    """A posterior field left on the fit's device by
    ``Model.fit(_materialize=)``: a tensor whose ``np.asarray`` pulls it
    to the host on access (``utils/pull.py::to_host``)."""

    def __array__(self, dtype=None, copy=None):
        out = _host(self)
        return out if dtype is None else out.astype(dtype, copy=False)


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
        self._materialize = None  # see fit(_materialize=)

    def fit(self, obs, stimuli, method="caviar", fit_options=None,
            device=None, _materialize=None):
        """Run a fit on ``device`` (None means CUDA; ``fit_options`` may
        carry ``device`` too). ``fit_options`` takes every keyword of the
        method's solver (``caviar``, ``cavi_sns``, ``mbcs``; ``k``, ``tol``
        and ``maxiter`` for ``cosamp``). ``mesh`` (a
        ``parallel.TrialMesh``) runs the trial-sharded solver of the
        method over the mesh's devices instead (``parallel.sharded``;
        ``device`` is then not used); CoSaMP has no mesh path and raises.
        CoSaMP is a host numpy baseline by design: it runs on the CPU
        whatever the device.

        ``_materialize`` is the fit server's ``return_fields``: ``None``
        pulls every state and history field to a host numpy array; a
        collection of names pulls only those and leaves the rest on the
        device as ``DeviceField`` tensors (``np.asarray`` still pulls
        one). History fields are named ``history_<field>``, as in the
        server's response."""
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
        device = fit_options.pop("device", device)
        if fit_options.get("mesh") is None:
            fit_options.pop("mesh", None)
            device = resolve_device(device)
        self.fit_method = method
        self._materialize = (None if _materialize is None
                             else {str(f) for f in _materialize})
        t0 = time.time()
        try:
            with span("cm.fit"):
                runner(obs, stimuli, fit_options, device)
        finally:
            self._materialize = None
        self.time = time.time() - t0
        return self

    def _pull(self, fields):
        """Result fields ({name: value}) under the ``_materialize``
        policy (see fit): the named ones to the host in one
        ``to_host`` call, the others left on the device."""
        keep = self._materialize
        out = to_host({k: v for k, v in fields.items()
                       if keep is None or k in keep
                       or not isinstance(v, torch.Tensor)})
        return {k: out[k] if k in out
                else v.detach().as_subclass(DeviceField)
                for k, v in fields.items()}

    def _update_state(self, **fields):
        with span("cm.fit.pull"):
            self.state.update(self._pull(fields))

    def summary(self, stim=None, verbose=True):
        """Per-neuron posterior summary (``circuitmap_torch.summarize``);
        prints the table unless ``verbose=False``. Returns the dict."""
        from .summary import format_summary, summarize

        out = summarize(self, stim=stim)
        if verbose:
            print(format_summary(out), end="")
        return out

    def _set_history(self, names, hists):
        pulled = self._pull({f"history_{n}": h
                             for n, h in zip(names, hists)})
        self.history = {n: pulled[f"history_{n}"] for n in names}

    def _fit_caviar(self, obs, stimuli, fit_options, device):
        from .solvers.caviar import caviar

        s = self.state
        track_elbo = bool(fit_options.get("track_elbo"))
        priors = (s["mu"], s["beta"], s["shape"], s["rate"], s["phi"],
                  s["phi_cov"])
        if "mesh" in fit_options:
            from .parallel import caviar_sharded

            result = caviar_sharded(obs, stimuli, *priors, **fit_options)
        else:
            result = caviar(obs, stimuli, *priors, device=device,
                            **fit_options)
        if track_elbo:
            *result, (elbos, converged_at) = result
            self.elbo = np.asarray(elbos)
            self.elbo_converged_at = converged_at
        (mu, beta, lam, shape, rate, phi, phi_cov, z, receptive_fields,
         *hists) = result
        self._update_state(
            mu=mu, beta=beta, lam=lam, shape=shape, rate=rate, phi=phi,
            phi_cov=phi_cov, z=z)
        self.state["receptive_fields"] = receptive_fields
        self.trial_count = self.state["lam"].shape[1]
        self._set_history(["mu", "beta", "lam", "shape", "rate", "phi",
                           "phi_cov", "z"], hists)
        if track_elbo:
            self.history["elbo"] = self.elbo

    def _fit_cavi_sns(self, obs, stimuli, fit_options, device):
        from .solvers.cavi_sns import cavi_sns

        s = self.state
        priors = (s["mu"], s["beta"], s["alpha"], s["shape"], s["rate"],
                  s["phi"], s["phi_cov"])
        if "mesh" in fit_options:
            from .parallel import cavi_sns_sharded

            result = cavi_sns_sharded(obs, stimuli, *priors, **fit_options)
        else:
            result = cavi_sns(obs, stimuli, *priors, device=device,
                              **fit_options)
        mu, beta, alpha, lam, shape, rate, phi, phi_cov, *hists = result
        self._update_state(
            mu=mu, beta=beta, alpha=alpha, lam=lam, shape=shape, rate=rate,
            phi=phi, phi_cov=phi_cov)
        self.trial_count = self.state["lam"].shape[1]
        self._set_history(["mu", "beta", "alpha", "lam", "shape", "rate",
                           "phi", "phi_cov"], hists)

    def _fit_mbcs(self, obs, stimuli, fit_options, device):
        from .solvers.mbcs import mbcs

        s = self.state
        priors = (s["mu"], s["beta"], s["shape"], s["rate"])
        if "mesh" in fit_options:
            from .parallel import mbcs_sharded

            result = mbcs_sharded(obs, stimuli, *priors, **fit_options)
        else:
            result = mbcs(obs, stimuli, *priors, device=device,
                          **fit_options)
        mu, beta, lam, shape, rate, z, receptive_fields, *hists = result
        self._update_state(
            mu=mu, beta=beta, lam=lam, shape=shape, rate=rate, z=z,
            receptive_fields=receptive_fields)
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
        if fit_options.pop("mesh", None) is not None:
            raise ValueError(
                "cosamp has no mesh path (it is a host-side greedy "
                "baseline) — drop mesh= or use method='caviar'/"
                "'cavi_sns'/'mbcs'")
        stim = np.asarray(_host(stimuli), dtype=float)
        y = np.trapezoid(np.asarray(_host(obs), dtype=float), axis=-1)
        A = (stim > 0).T.astype(float)
        k = int(fit_options.pop("k", max(int(0.1 * self.N), 1)))
        weights, elapsed = cosamp(A, y, k, **fit_options)
        self.state.update(mu=weights, cosamp_time=float(elapsed))
        self.trial_count = stim.shape[1]
        self.history = {}
