"""CoSaMP: compressive-sampling matching pursuit baseline (port of
``circuitmap_tpu/solvers/cosamp.py``, kept as its own copy).

Greedy sparse recovery of weights from integrated charges, ``y ≈ A x``
with A the stimulus design: support expansion by the 2k largest
correlations, restricted least squares, pruning to k, residual update
and a relative-residual stopping rule. Returns ``(x_hat,
elapsed_seconds)`` like the reference.

Host numpy by design, as in the JAX package: each iteration picks a
data-dependent support and solves a tiny least-squares problem, so it
never touches the GPU. It exists for comparison harnesses, not the hot
path.
"""

from __future__ import annotations

import time

import numpy as np


def cosamp(A, y, k, tol=1e-8, maxiter=500, x=None):
    """Estimate a k-sparse x from measurements y = A x.

    A: [M, N] sensing matrix; y: [M]; k: expected sparsity.
    """
    t0 = time.time()
    A = np.asarray(A)
    y = np.asarray(y)
    _, N = A.shape

    x_hat = np.zeros(N, dtype=y.dtype)
    residual = y.copy()
    y_norm = np.linalg.norm(y)
    if y_norm == 0:
        return x_hat, time.time() - t0

    for _ in range(maxiter):
        corr = A.conj().T @ residual
        # union of the current support with the 2k strongest correlations
        support = np.union1d(
            np.flatnonzero(x_hat), np.argsort(np.abs(corr))[-2 * k:])

        trial = np.zeros(N, dtype=y.dtype)
        trial[support] = np.linalg.lstsq(A[:, support], y, rcond=None)[0]

        # prune to the k largest entries
        trial[np.argsort(np.abs(trial))[:-k]] = 0
        x_hat = trial

        residual = y - A @ x_hat
        if np.linalg.norm(residual) / y_norm < tol:
            break

    return x_hat, time.time() - t0
