"""Shape-faithful synthetic experiments and CLI shape parsing (the
port's copy of ``circuitmap_tpu/utils/synthetic.py``).

The fit server's ``/warm`` runs its pipeline on data of the right shape
so that the kernel build, the cuBLAS and cuSOLVER handles and the
allocator's pools are paid before the first real request; the values
need only be tame (an all-zero stim would leave no power levels).
"""

from __future__ import annotations

import numpy as np


def parse_shape(text):
    """'NxK' -> (N, K); raises argparse.ArgumentTypeError otherwise."""
    import argparse

    try:
        n, k = text.lower().split("x")
        return int(n), int(k)
    except ValueError:
        raise argparse.ArgumentTypeError(
            "shape must look like NxK, e.g. 1000x20000") from None


def synthetic_experiment(N, K, T=900, H=10, powers=(45.0, 55.0, 65.0),
                         seed=0):
    """Random data at the reference's array contracts: [K, T] float32
    traces, [N, K] float64 stim with H targets per trial, one power level
    per trial (every trial stimulates at least one target)."""
    rng = np.random.default_rng(seed)
    stim = np.zeros((N, K), dtype=np.float64)
    tgt = rng.integers(0, N, size=(max(int(H), 1), K))
    pw = rng.choice(np.asarray(powers, dtype=np.float64), size=K)
    for h in range(tgt.shape[0]):
        stim[tgt[h], np.arange(K)] = pw
    psc = 0.01 * rng.standard_normal((K, T)).astype(np.float32)
    return psc, stim
