"""Device ops: plain PyTorch primitives and the CUDA kernel wrappers.

The primitives are exported here under the JAX package's names
(``circuitmap_tpu.ops``); the kernel wrappers live in ``sweep_cuda``,
``sweep_row_cuda``, ``laplace_cuda``, ``resize_cuda`` and ``gram_cuda``.
"""

from .charge import integrated_charge, prepare_observations, trial_activity_mask
from .masks import get_mask
from .monotone import monotone_decay_filter
from .pava import (isotonic_fit_at_max, isotonic_fit_at_max_batched,
                   isotonic_regression, isotonic_regression_batched)
from .spike_rates import spike_rates_by_power, spike_rates_by_power_batched
from .truncnorm import sample_truncated_normal, truncated_normal_mean

__all__ = [
    "isotonic_regression", "isotonic_regression_batched",
    "isotonic_fit_at_max", "isotonic_fit_at_max_batched",
    "integrated_charge", "trial_activity_mask", "prepare_observations",
    "sample_truncated_normal", "truncated_normal_mean",
    "spike_rates_by_power", "spike_rates_by_power_batched",
    "monotone_decay_filter", "get_mask",
]
