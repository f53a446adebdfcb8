"""Launch counts of the kernel wrappers.

Each wrapper that launches a CUDA kernel carries two plain integers:
``launches`` (every launch) and ``launches_f64`` (those in float64), so
a run can show that a path went through a kernel, and in which type.
"""

from __future__ import annotations

import torch


def count_launch(wrapper, dtype):
    """One launch of ``wrapper``'s kernel in ``dtype``."""
    wrapper.launches += 1
    if dtype == torch.float64:
        wrapper.launches_f64 += 1


def reset_launches(*wrappers):
    """Both launch counts of each wrapper to 0."""
    for fn in wrappers:
        fn.launches = fn.launches_f64 = 0
