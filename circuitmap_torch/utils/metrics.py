"""Evaluation metrics (the port's copy of ``circuitmap_tpu/utils/metrics.py``)."""

from __future__ import annotations

import numpy as np


def r2_score(y_true, y_pred):
    """Coefficient of determination with sklearn's semantics: 1-D
    inputs give ``1 - SSres/SStot``; 2-D inputs the uniform average of
    the per-output scores."""
    y_true = np.asarray(y_true, dtype=float)
    y_pred = np.asarray(y_pred, dtype=float)
    ss_res = np.sum((y_true - y_pred) ** 2, axis=0)
    ss_tot = np.sum((y_true - y_true.mean(axis=0)) ** 2, axis=0)
    scores = np.where(
        ss_tot > 0,
        1.0 - ss_res / np.where(ss_tot > 0, ss_tot, 1.0),
        np.where(ss_res == 0, 1.0, 0.0),
    )
    return float(np.mean(scores))


def correlation(a, b):
    """Pearson correlation between flattened arrays (0 when either is
    constant)."""
    a = np.asarray(a, dtype=float).ravel()
    b = np.asarray(b, dtype=float).ravel()
    if a.std() == 0 or b.std() == 0:
        return 0.0
    return float(np.corrcoef(a, b)[0, 1])


def precision_recall_connections(w_true, w_est):
    """Connection-detection (precision, recall) of the nonzero entries of
    ``w_est`` against those of ``w_true``."""
    t = np.asarray(w_true) != 0
    e = np.asarray(w_est) != 0
    tp = np.sum(t & e)
    precision = tp / max(np.sum(e), 1)
    recall = tp / max(np.sum(t), 1)
    return float(precision), float(recall)
