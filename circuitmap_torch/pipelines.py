"""Experimental-data analysis pipelines: shared building blocks (port
of ``circuitmap_tpu/pipelines.py``).

  * trial splitting (single-target vs ensemble),
  * per-connection PSC waveforms via positive ridge regression (on the
    device: ``connection_waveforms(device=None)`` means CUDA, as every
    entry point of the port),
  * duplicate-connection merging (same cell mapped at adjacent imaging
    planes) by waveform similarity + 3-D proximity clustering,
  * loose-patch ("LP") ground-truth spike detection and per-power
    spike-rate comparison against the model posteriors.

Everything but the ridge regression is host numpy, the JAX package's
own code.
"""

from __future__ import annotations

import numpy as np
import torch

from ._device import highest_matmul, resolve_device


# ---------------------------------------------------------------------------
# Trial splitting
# ---------------------------------------------------------------------------


def split_single_ensemble(stim_matrix):
    """Indices of single-target and multi-target trials
    (run_1v10_pipeline_reformatted.py:197-200)."""
    n_targets = np.sum(np.asarray(stim_matrix) > 0, axis=0)
    return np.flatnonzero(n_targets == 1), np.flatnonzero(n_targets > 1)


# ---------------------------------------------------------------------------
# Ridge waveforms
# ---------------------------------------------------------------------------


def _positive_ridge(X, Y, alpha, iters=300):
    """min_W ||X @ W - Y||^2 + alpha ||W||^2 s.t. W >= 0.

    X: [K, n]; Y: [K, T] tensors on one device; W: [n, T]. Projected
    gradient with a 1/L step, L the spectral norm of X'X + alpha I (the
    sklearn Ridge(positive=True) equivalent used for waveform extraction,
    run_1v10_pipeline_reformatted.py:38-43). Full float32 products (no
    TF32).
    """
    with highest_matmul():
        XtX = X.T @ X + alpha * torch.eye(X.shape[1], dtype=X.dtype,
                                          device=X.device)
        XtY = X.T @ Y
        step = 1.0 / (torch.linalg.matrix_norm(XtX, ord=2) + 1e-8)
        W = torch.zeros((X.shape[1], Y.shape[1]), dtype=X.dtype,
                        device=X.device)
        for _ in range(iters):
            W = torch.clamp_min(W - step * (XtX @ W - XtY), 0.0)
    return W


def connection_waveforms(psc, stim_matrix, state, alpha=1e-3, device=None):
    """Per-connection PSC waveform estimates.

    Regresses the demixed traces of all trials touching any inferred
    connection onto the spike posteriors of the connected cells, in
    float32 on ``device`` (None means CUDA; ``psc`` may be a tensor
    there already). Returns (connected_idx [n], waveforms [n, T]) as
    numpy arrays.
    """
    dev = resolve_device(device)
    mu = np.asarray(state["mu"])
    lam = np.asarray(state["lam"])
    stim = np.asarray(stim_matrix)
    cnx = np.flatnonzero(mu)
    if cnx.size == 0:
        return cnx, np.zeros((0, psc.shape[1]))
    locs = np.flatnonzero((stim[cnx] > 0).any(axis=0))
    X = torch.from_numpy(np.ascontiguousarray(lam[cnx][:, locs].T,
                                              np.float32)).to(dev)
    if isinstance(psc, torch.Tensor):
        Y = psc.to(device=dev, dtype=torch.float32)[
            torch.from_numpy(locs).to(dev)]
    else:
        Y = torch.from_numpy(np.asarray(psc, np.float32)[locs]).to(dev)
    W = _positive_ridge(X, Y, alpha)
    return cnx, W.cpu().numpy()


# ---------------------------------------------------------------------------
# Duplicate merging
# ---------------------------------------------------------------------------


def _pairwise_sq_dist(points):
    d = points[:, None, :] - points[None, :, :]
    return np.sum(d * d, axis=-1)


def _plane_adjacency(plane_of, planes):
    idx = np.array([np.flatnonzero(planes == p)[0] for p in plane_of])
    return (np.abs(idx[:, None] - idx[None, :]) <= 1).astype(int)


def merge_duplicate_connections(
    psc, stim_matrix, state, targets, img=None, mse_threshold=0.1,
    dist_threshold=15.0, waveform_alpha=1e-3, device=None,
):
    """Cluster inferred connections that are the same physical cell.

    Holographic target lists repeat cells across adjacent imaging
    planes; a cell mapped twice shows near-identical PSC waveforms at
    nearby (x, y) on neighbouring z-planes. Clusters such duplicates
    and picks one representative per cluster — the brightest pixel when
    an image stack is supplied, else the strongest weight (reference
    merge_duplicates, run_1v10_pipeline_reformatted.py:45-61).

    The waveforms' ridge regression runs on ``device``
    (:func:`connection_waveforms`). Returns (representatives, clusters):
    arrays of target indices.
    """
    targets = np.asarray(targets)
    planes = np.unique(targets[:, -1])
    mu = np.asarray(state["mu"])
    cnx, waveforms = connection_waveforms(psc, stim_matrix, state,
                                          alpha=waveform_alpha, device=device)
    n = cnx.size
    if n == 0:
        return np.array([], dtype=int), []

    wf_err = _pairwise_sq_dist(waveforms)
    xy_close = _pairwise_sq_dist(targets[cnx][:, :2]) < dist_threshold**2
    z_adj = _plane_adjacency(targets[cnx][:, -1], planes)
    duplicate = (wf_err < mse_threshold) & xy_close & (z_adj > 0)

    clusters = {tuple(sorted(cnx[np.flatnonzero(row)].tolist())) for row in duplicate}
    clusters = [list(c) for c in clusters]

    reps = []
    for cluster in clusters:
        if img is not None:
            brightness = []
            for c in cluster:
                tar = targets[c].astype(int)
                depth = int(np.flatnonzero(planes == targets[c][-1])[0])
                brightness.append(float(np.asarray(img)[0][depth][tar[0], tar[1]]))
            reps.append(cluster[int(np.argmax(brightness))])
        else:
            reps.append(cluster[int(np.argmax(mu[cluster]))])
    return np.asarray(reps, dtype=int), clusters


# ---------------------------------------------------------------------------
# Loose-patch ground truth (pair-patch experiments)
# ---------------------------------------------------------------------------


def detect_lp_spikes(psp, spike_threshold=0.1, window=(100, 240)):
    """Threshold detection of presynaptic spikes from loose-patch traces.

    psp: [K, T] presynaptic patch recording. Returns boolean [K]
    (reference run_pair_patch_pipeline.py:213-220).
    """
    psp = np.asarray(psp)
    seg = np.abs(psp[:, window[0]:window[1]])
    return seg.max(axis=1) > spike_threshold


def find_patched_cell(stim_matrix, psp, spike_threshold=0.1, window=(100, 240)):
    """Which mapped cell is the patched one: the cell whose stim trials
    coincide with the most LP-detected spikes."""
    stim = np.asarray(stim_matrix)
    spikes = detect_lp_spikes(psp, spike_threshold, window)
    # cast before the matmul: numpy bool @ bool is a LOGICAL dot whose
    # result caps at 1, which silently turns "most coincident spikes"
    # into "first cell with ANY coincident spike"
    counts = (stim > 0).astype(float) @ spikes.astype(float)
    return int(np.argmax(counts))


def power_curve_comparison(stim_matrix, lam, lp_spikes, cell, trial_subset=None):
    """Per-power (LP spike rate, posterior spike rate) for one cell.

    ``stim_matrix`` / ``lp_spikes`` live in the full experiment's trial
    space; ``lam`` is the posterior of a model fitted on
    ``trial_subset`` (its columns are subset-local). Returns dict of
    arrays keyed power / lp_rate / lp_std / model_rate / model_std
    (reference run_pair_patch_pipeline.py:229-246).
    """
    stim = np.asarray(stim_matrix)
    lam = np.asarray(lam)
    lp = np.asarray(lp_spikes, dtype=float)
    if trial_subset is None:
        trial_subset = np.arange(stim.shape[1])
    trial_subset = np.asarray(trial_subset)
    stim_cell_local = stim[cell, trial_subset]
    powers = np.unique(stim)[1:]
    out = {k: np.zeros(len(powers)) for k in
           ("power", "lp_rate", "lp_std", "model_rate", "model_std")}
    for i, p in enumerate(powers):
        local = np.flatnonzero(stim_cell_local == p)
        out["power"][i] = p
        if local.size:
            glob = trial_subset[local]
            out["lp_rate"][i] = lp[glob].mean()
            out["lp_std"][i] = lp[glob].std()
            out["model_rate"][i] = lam[cell, local].mean()
            out["model_std"][i] = lam[cell, local].std()
    return out
