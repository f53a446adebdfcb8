"""The folds of a cross-validated map (the one rule that cuts them), and
the bytes that the batched row sweep (B5, ``csrc/sweep_cluster.cuh`` at
one row a step with one cluster per experiment, launched by
``sweep_row_cuda.sweep_spikes_row_batched``) needs, counted from the
shapes of a stack of folds.

B5 does for each of E experiments what B1 does for one, so its least
traffic is E times B1's (``counts.sweep_bytes``: each input read once,
each output written once); the kernel table in PERF.md gives 0.2149 ms
at E=4, N=1000, K=15,000, the three [E, N, K] arrays alone.
"""

from __future__ import annotations

import numpy as np

from .counts import PEAK_BYTES_PER_S, sweep_bytes


def fold_keeps(cfg):
    """Each fold's kept trial indices: fold f holds out the f-th of
    ``folds`` contiguous equal parts of the ``trials`` and keeps the
    others, in order (this repo's README recipe)."""
    K, n = cfg["trials"], cfg["folds"]
    if K % n:
        raise ValueError(f"{K} trials do not split into {n} equal folds")
    h = K // n
    return [np.r_[0:f * h, (f + 1) * h:K] for f in range(n)]


def fold_trials(cfg):
    """The trials each fold keeps: all but one of ``folds`` equal parts."""
    return fold_keeps(cfg)[0].size


def batched_sweep_bytes(E, N, K, P, item=4):
    """B5's least traffic for one sweep of E [N, K] problems."""
    return E * sweep_bytes(N, K, P, item)


def batched_sweep_bound_s(E, N, K, P, item=4):
    """The least time of one B5 launch: its bytes at the HBM peak."""
    return batched_sweep_bytes(E, N, K, P, item) / PEAK_BYTES_PER_S
