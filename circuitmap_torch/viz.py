"""Visualisation: checkerboard trace plots and cross-model comparisons
(port of ``circuitmap_tpu/viz.py``, host numpy and matplotlib, the same
code).

The checkerboard lays out, per neuron row, its stimulated trials grouped
by power, shading each trial by the inferred spike probability and
marking trials attributed to spontaneous activity; the comparison grid
renders several fitted models side by side on a shared cell ordering.
Inputs are host arrays (a fitted ``Model``'s state is numpy).

matplotlib is imported lazily so the core library stays import-light.
"""

from __future__ import annotations

import numpy as np


def _require_mpl():
    import matplotlib.pyplot as plt

    return plt


def cell_order_from_weights(weight_sets):
    """Stable cell ordering: strongest connections of each model first,
    then everything else (reference get_cell_order, viz.py:183-191)."""
    weight_sets = [np.asarray(w) for w in weight_sets]
    N = weight_sets[0].shape[0]
    order = []
    for w in weight_sets:
        conn = np.flatnonzero(w)
        for n in conn[np.argsort(w[conn])[::-1]]:
            if n not in order:
                order.append(int(n))
    for n in range(N):
        if n not in order:
            order.append(n)
    return np.array(order, dtype=int)


def get_cell_order(weights):
    """Reference-name alias (reference viz.py:183-191) — keyword
    ``weights=`` included."""
    return cell_order_from_weights(weights)


def _trials_by_power(stim_row, powers, per_power):
    locs = []
    for p in powers:
        locs.extend(np.flatnonzero(stim_row == p)[:per_power])
    return np.asarray(locs, dtype=int)


def plot_checkerboard(
    psc,
    stim_matrix,
    model,
    true_spikes=None,
    true_weights=None,
    spike_thresh=0.01,
    save=None,
    ymax=None,
    n_plots=15,
    max_trials_to_show=30,
    col_width=7.5,
    row_height=0.6,
    order=None,
    sdevs=None,
    fig_width=None,
    overlay_spikes=False,
    annotate_spikes=False,
    labels=None,
    hspace=0.5,
    wspace=0.05,
    ylabelpad=0.05,
    facecol=None,
    edgecol=None,
    trial_len=900,
    fontsize=14,
    append_last_row=False,
    plot_sponts=True,
    spont_col="C0",
    spont_alpha=0.75,
    spike_col="lightcoral",
    trials=None,
    save_fmt="png",
    backend=None,
):
    """Checkerboard of PSC traces with spike-posterior shading.

    ``model`` is either a fitted Model (with ``.state``) or a state dict.
    Full kwarg parity with reference plot_checkerboard (viz.py:4-181):
    ``sdevs`` annotates a per-trial value under each trial,
    ``annotate_spikes`` prints true:inferred spiking-cell counts (needs
    ``true_spikes``/``true_weights``), ``labels`` overrides row labels,
    ``append_last_row`` adds the last (unconnected) neuron as a
    reference row, ``facecol``/``edgecol`` style the spike shading.
    ``spike_thresh`` is accepted for signature parity (the reference
    accepts but never reads it, viz.py:4); ``backend`` is forwarded to
    savefig when given (the reference defaults to 'pgf', which needs a
    LaTeX install — None uses matplotlib's active backend).
    """
    plt = _require_mpl()
    if facecol is not None:
        spike_col = facecol
    edge_kw = (
        {"lw": 0} if edgecol is None else {"edgecolor": edgecol, "lw": 1.25}
    )

    state = model.state if hasattr(model, "state") else model
    psc = np.asarray(psc)
    stim = np.asarray(stim_matrix)
    K_all = psc.shape[0]

    mu = np.asarray(state["mu"])
    # point-estimate fits (cosamp) carry no lam/z: default to zeros so
    # the plot renders with no spike shading rather than KeyError
    lam = np.asarray(state.get("lam", np.zeros((mu.shape[0], K_all))))
    z = np.asarray(state.get("z", np.zeros(K_all)))
    if trials is not None:
        psc = psc[trials]
        stim = stim[:, trials]
        lam = lam[:, trials]
        z = z[trials]

    if order is None:
        order = np.argsort(mu)[::-1]
    # the reference indexes order[m] for m < n_plots and crashes when
    # the circuit has fewer neurons than the default 15 rows; clamp.
    n_plots = min(n_plots, len(order))
    if ymax is None:
        ymax = np.percentile(psc / np.max(psc), 99.99)
    ymin = -0.05 * ymax
    norm = np.max(np.abs(psc))

    trial_powers = stim.max(axis=0)
    powers = np.unique(trial_powers[trial_powers > 0])
    per_power = max_trials_to_show // max(len(powers), 1)

    if fig_width is None:
        fig_width = max_trials_to_show * col_width
    nrows = n_plots + 2 if append_last_row else n_plots
    fig, axes = plt.subplots(
        nrows, 1, figsize=(fig_width, row_height * nrows * 1.5), squeeze=False
    )
    fig.subplots_adjust(hspace=hspace, wspace=wspace)

    for m in range(n_plots):
        n = order[m]
        ax = axes[m, 0]
        locs = _trials_by_power(stim[n], powers, per_power)
        if locs.size == 0:
            ax.axis("off")
            continue
        trace = psc[locs].reshape(-1) / norm
        n_shown = locs.size
        col = "k" if mu[n] != 0 else "gray"
        if m == 0:
            # reference viz.py:66-67: the top row is titled 'Power' to
            # explain the mW annotations' trial grouping
            ax.set_title("Power", fontsize=fontsize, y=1.5)

        for t in range(n_shown):
            x0 = t * trial_len
            if t > 0:
                ax.plot([x0, x0], [ymin, ymax], "--", color=col, linewidth=0.6)
            if not np.isnan(mu[n]):
                ax.axvspan(x0, x0 + trial_len, color=spike_col,
                           alpha=float(lam[n, locs[t]]), zorder=-5, **edge_kw)
            if plot_sponts and z[locs[t]] != 0:
                ax.axvspan(x0, x0 + trial_len, color=spont_col,
                           alpha=spont_alpha, zorder=-5, **edge_kw)
            if m == 0 and (t == 0 or stim[n, locs[t]] != stim[n, locs[t - 1]]):
                ax.text(x0, 1.1 * ymax, f"{stim[n, locs[t]]:.0f} mW",
                        fontsize=fontsize - 2)
            if sdevs is not None:
                ax.text(x0 + trial_len / 3, 0.65, f"{sdevs[locs[t]]:.2f}",
                        fontsize=5)
            if annotate_spikes:
                # true:inferred spiking-cell counts per trial
                # (reference viz.py:104-119)
                assert true_spikes is not None
                inferred = np.intersect1d(
                    np.flatnonzero(lam[:, locs[t]] >= 0.5),
                    np.flatnonzero(mu != 0),
                )
                tw = mu if true_weights is None else np.asarray(true_weights)
                true_c = np.intersect1d(
                    np.flatnonzero(true_spikes[:, locs[t]] > 0),
                    np.flatnonzero(tw != 0),
                )
                if inferred.size > 0:
                    ax.text(x0 + trial_len // 4, -0.3,
                            f"{true_c.size}: {inferred.size}", fontsize=7)
            if overlay_spikes and true_spikes is not None and \
                    true_spikes[n, locs[t]] > 0:
                ax.scatter(x0 + trial_len / 2, 0.75 * ymax, s=20, marker="v",
                           edgecolor="k", facecolor="none", linewidth=0.5)

        ax.plot(trace, color=col, linewidth=1.5)
        ax.set_xlim(0, trial_len * n_shown)
        ax.set_ylim(ymin, ymax)
        ax.set_xticks([])
        ax.set_yticks([])
        for side in ("top", "right", "left", "bottom"):
            ax.spines[side].set_visible(False)
        if labels is not None:
            ax.set_ylabel(labels[m] + 1, fontsize=fontsize - 1, rotation=0,
                          labelpad=15, va="center", color="k")
        elif m % 4 == 0:
            ax.set_ylabel(m + 1, fontsize=fontsize - 1, rotation=0,
                          labelpad=15, va="center", color=col)

    if append_last_row:
        # blank spacer row, then the last (weakest, typically unconnected)
        # neuron as a gray reference row (reference viz.py:147-175)
        axes[n_plots, 0].axis("off")
        ax = axes[n_plots + 1, 0]
        n = stim.shape[0] - 1
        locs = _trials_by_power(stim[n], powers, per_power)
        if locs.size:
            trace = psc[locs].reshape(-1) / norm
            for t in range(1, locs.size):
                ax.plot([t * trial_len, t * trial_len], [ymin, ymax], "--",
                        color="gray", linewidth=0.6)
            ax.plot(trace, color="gray", linewidth=1.5)
            ax.set_xlim(0, trial_len * locs.size)
        ax.set_ylim(ymin, ymax)
        ax.set_xticks([])
        ax.set_yticks([])
        for side in ("top", "right", "left", "bottom"):
            ax.spines[side].set_visible(False)
        ax.set_xlabel("Trials", fontsize=fontsize)
        ax.set_ylabel(stim.shape[0], fontsize=fontsize - 1, rotation=0,
                      labelpad=15, va="center", color="gray")

    fig.supylabel("Neuron", fontsize=fontsize, x=ylabelpad)
    if save is not None:
        kw = {} if backend is None else {"backend": backend}
        fig.savefig(save, format=save_fmt, bbox_inches="tight", dpi=300, **kw)
    return fig


def plot_spike_inference_comparison(
    den_pscs,
    stim_matrices,
    models,
    spks=None,
    titles=None,
    save=None,
    ymax=1.1,
    n_plots=15,
    max_trials_to_show=30,
    col_widths=None,
    row_height=0.6,
    order=None,
    trial_len=900,
    lp_cell=None,
    fontsize=14,
):
    """Side-by-side checkerboards for several fitted models
    (reference viz.py:193-280). ``models`` are state dicts.
    ``col_widths`` sets per-model column widths; ``lp_cell`` marks the
    loose-patched cell (its spike shading renders in C0, reference
    viz.py:238)."""
    plt = _require_mpl()

    ncols = len(models)
    if col_widths is None:
        col_widths = 7.5 * np.ones(ncols)
    col_widths = np.asarray(col_widths, dtype=float)
    states = [m.state if hasattr(m, "state") else m for m in models]
    if order is None:
        order = cell_order_from_weights([s["mu"] for s in states])
    # same small-circuit clamp as plot_checkerboard (the reference
    # crashes indexing order[m] when N < n_plots)
    n_plots = min(n_plots, len(order))
    norm = np.max(np.abs(np.vstack(den_pscs)))
    ymin = -0.05 * ymax

    fig, axes = plt.subplots(
        n_plots, ncols,
        figsize=(float(np.sum(col_widths)), row_height * n_plots * 1.5),
        squeeze=False,
        gridspec_kw={"width_ratios": col_widths / col_widths[0]},
    )
    fig.subplots_adjust(hspace=0.5, wspace=0.05)

    for col in range(ncols):
        stim = np.asarray(stim_matrices[col])
        state = states[col]
        lam = np.asarray(state["lam"])
        mu = np.asarray(state["mu"])
        z = np.asarray(state.get("z", np.zeros(lam.shape[1])))
        trial_powers = stim.max(axis=0)
        powers = np.unique(trial_powers[trial_powers > 0])
        per_power = max_trials_to_show // max(len(powers), 1)

        for m in range(n_plots):
            n = order[m]
            ax = axes[m, col]
            locs = _trials_by_power(stim[n], powers, per_power)
            if locs.size == 0:
                ax.axis("off")
                continue
            trace = np.asarray(den_pscs[col])[locs].reshape(-1) / norm
            tc = "k" if mu[n] != 0 else "gray"
            for t in range(locs.size):
                x0 = t * trial_len
                if t > 0:
                    ax.plot([x0, x0], [ymin, ymax], "--", color=tc, linewidth=0.5)
                shade = "firebrick" if n != lp_cell else "C0"
                ax.axvspan(x0, x0 + trial_len, color=shade,
                           alpha=float(lam[n, locs[t]]) * 0.5, zorder=-5, lw=0)
                if m == 0 and (t == 0 or trial_powers[locs[t]]
                               != trial_powers[locs[t - 1]]):
                    # per-power annotations at each power change on the
                    # top row (reference viz.py:258-260)
                    ax.text(x0, 1.1 * ymax,
                            f"{trial_powers[locs[t]]:.0f} mW",
                            fontsize=fontsize - 2)
                if z[locs[t]] != 0:
                    ax.plot(x0 + trial_len / 2, 0.7 * ymax, marker="*",
                            markerfacecolor="b", markeredgecolor="none",
                            markersize=6)
            ax.plot(trace, color=tc, linewidth=0.65)
            ax.set_xlim(0, trial_len * locs.size)
            ax.set_ylim(ymin, ymax)
            ax.set_xticks([])
            ax.set_yticks([])
            for side in ("top", "right", "left", "bottom"):
                ax.spines[side].set_visible(False)
            if m == 0 and titles is not None:
                ax.set_title(titles[col], fontsize=fontsize)
            if col == 0:
                ax.set_ylabel(f"{m + 1} ({n})", fontsize=fontsize - 1,
                              rotation=0, labelpad=15, va="center")

    if save is not None:
        fig.savefig(save, bbox_inches="tight", dpi=300, facecolor="white")
    return fig
