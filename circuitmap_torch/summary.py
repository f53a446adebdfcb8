"""Posterior summaries: the fitted state, answered as a scientist asks
(port of ``circuitmap_tpu/summary.py``, host numpy, the same code).

``summarize`` turns a fitted state into the quantities a mapping
experiment reports: which neurons are connected, their synaptic
weights with uncertainty, evoked spike counts per stimulation power,
the spontaneous-activity load and the noise level. It works on a
fitted :class:`~circuitmap_torch.model.Model` or a raw state dict of
numpy arrays; nothing runs on a device.
"""

from __future__ import annotations

import io

import numpy as np

__all__ = ["summarize", "format_summary"]


def _state_of(model_or_state):
    state = getattr(model_or_state, "state", model_or_state)
    try:
        mu = np.asarray(state["mu"])
    except (TypeError, KeyError, IndexError):
        raise TypeError(
            "summarize() wants a fitted Model or a model.state dict "
            "(mapping with 'mu'/'lam'/...)")
    if mu.ndim != 1:
        raise ValueError(
            f"state['mu'] has shape {mu.shape}; summarize() handles one "
            "fit — index a batched (*_many) result first")
    return state


def summarize(model_or_state, stim=None, weight_sd_threshold=0.0,
              method=None):
    """Per-neuron summary of a fitted connectivity posterior.

    Parameters
    ----------
    model_or_state : a fitted ``Model`` or ``model.state``.
    stim : optional [N, K] design matrix; adds per-power stimulation
        counts and evoked spike rates.
    weight_sd_threshold : report a neuron as connected only when
        ``|mean| > threshold * sd`` in addition to the solver's own
        call (default 0: the solver decides).
    method : which solver produced the state; taken from a fitted
        ``Model`` automatically, pass it for raw dicts when it was not
        ``'caviar'``. The connected call is solver-specific: CAVIaR /
        MBCS / CoSaMP hard-prune, so ``mu != 0`` IS their detection
        decision (the same call ``design.AdaptiveDesigner.observe``
        uses); CAVI-SnS is spike-and-slab — its ``mu`` is nonzero
        almost everywhere and inclusion lives in the posterior slab
        probability ``alpha`` (> 0.5).

    Returns a dict of numpy arrays / scalars:

    - ``connected`` — indices the fit calls connected
    - ``weight_mean`` [N], ``weight_sd`` [N] (sqrt of the posterior
      variance diagonal ``beta`` — reference caviar.py state contract)
    - ``connection_prob`` [N] — CAVI-SnS only (the ``alpha`` slab)
    - ``expected_spikes`` [N] — summed posterior spike probabilities
    - ``noise_std`` — sqrt(rate/shape), the gamma noise posterior's
      point estimate of the observation noise scale
    - ``spont_trials`` — trials carrying nonzero spontaneous charge
    - with ``stim``: ``powers`` [P], ``stim_trials`` [N, P] and
      ``spike_rate`` [N, P] (evoked spike probability per power —
      the empirical power curve the ``phi`` sigmoid models)

    Point-estimate fits (CoSaMP) computed no posterior beyond the
    weights — the model leaves the rest of the state at the priors
    (model.py _fit_cosamp), so uncertainty/noise/spont fields are
    omitted rather than reporting priors as posteriors.
    """
    state = _state_of(model_or_state)
    if method is None:
        method = getattr(model_or_state, "fit_method", None)
    mu = np.asarray(state["mu"], dtype=np.float64)
    beta = np.asarray(state["beta"], dtype=np.float64)
    lam = state.get("lam")
    lam = None if (lam is None or np.ndim(lam) != 2) else np.asarray(
        lam, dtype=np.float64)
    # no spike posterior == a point-estimate fit: everything but mu is
    # still the prior, so don't present it as inference
    point_estimate = lam is None
    n = mu.shape[0]
    sd = np.sqrt(np.maximum(beta, 0.0))
    if method == "cavi_sns":
        alpha = np.asarray(state["alpha"], dtype=np.float64)
        connected = alpha > 0.5
    else:
        alpha = None
        connected = mu != 0
    if weight_sd_threshold > 0 and not point_estimate:
        connected &= np.abs(mu) > weight_sd_threshold * sd
    out = {
        "n_neurons": n,
        "n_trials": None if lam is None else int(lam.shape[1]),
        "connected": np.flatnonzero(connected),
        "weight_mean": mu,
    }
    if alpha is not None:
        out["connection_prob"] = alpha
    if not point_estimate:
        out["weight_sd"] = sd
        out["expected_spikes"] = lam.sum(axis=1)
        shape, rate = state.get("shape"), state.get("rate")
        if shape is not None and rate is not None and float(shape) > 0:
            out["noise_std"] = float(np.sqrt(float(rate) / float(shape)))
        z = state.get("z")
        if z is not None:
            out["spont_trials"] = int(np.count_nonzero(np.asarray(z)))
    if stim is not None:
        stim = np.asarray(stim)
        if stim.ndim != 2 or stim.shape[0] != n or (
                lam is not None and stim.shape != lam.shape):
            raise ValueError(
                f"stim has shape {stim.shape} but the fit covers "
                f"{(n, out['n_trials'])} (neurons x trials)")
        powers = np.unique(stim[stim != 0]).astype(np.float64)
        trials = np.zeros((n, powers.size))
        rates = np.zeros((n, powers.size))
        for j, p in enumerate(powers):
            # tolerant match: designs round-trip through narrower
            # dtypes between design and fit (design.py observe note)
            mask = np.isclose(stim, p, rtol=1e-5, atol=0.0)
            cnt = mask.sum(axis=1)
            trials[:, j] = cnt
            if lam is not None:
                rates[:, j] = (lam * mask).sum(axis=1) / np.maximum(
                    cnt, 1)
        out["powers"] = powers
        out["stim_trials"] = trials
        if lam is not None:
            out["spike_rate"] = rates
    return out


def format_summary(summary, max_rows=30):
    """Render a ``summarize`` dict as a fixed-width table (connected
    neurons first, strongest weights on top)."""
    buf = io.StringIO()
    n = summary["n_neurons"]
    conn = summary["connected"]
    trials = summary.get("n_trials")
    trials_txt = "" if trials is None else f", {trials} trials"
    print(f"{n} neurons{trials_txt} — {conn.size} connected", file=buf)
    if "noise_std" in summary:
        print(f"observation noise std ≈ {summary['noise_std']:.4g}",
              file=buf)
    if "spont_trials" in summary:
        print(f"spontaneous activity on {summary['spont_trials']} "
              "trials", file=buf)
    have_sd = "weight_sd" in summary
    have_prob = "connection_prob" in summary
    have_spikes = "expected_spikes" in summary
    have_powers = "spike_rate" in summary
    head = "neuron   weight" + (" ± sd      " if have_sd else "   ")
    if have_prob:
        head += "   P(conn)"
    if have_spikes:
        head += "  E[spikes]"
    if have_powers:
        head += "   spike rate @ " + "/".join(
            f"{p:g}" for p in summary["powers"])
    print(head, file=buf)
    order = conn[np.argsort(-np.abs(summary["weight_mean"][conn]))]
    for i in order[:max_rows]:
        row = f"{i:>6}   {summary['weight_mean'][i]:+8.3f}"
        if have_sd:
            row += f" ± {summary['weight_sd'][i]:<7.3f}"
        if have_prob:
            row += f"   {summary['connection_prob'][i]:>7.2f}"
        if have_spikes:
            row += f" {summary['expected_spikes'][i]:>9.1f}"
        if have_powers:
            row += "   " + "/".join(
                f"{r:.2f}" for r in summary["spike_rate"][i])
        print(row, file=buf)
    if conn.size > max_rows:
        print(f"... ({conn.size - max_rows} more connected)", file=buf)
    return buf.getvalue()
