"""Launch counts of the kernel wrappers.

Each wrapper that launches a CUDA kernel carries two plain integers:
``launches`` (every launch) and ``launches_f64`` (those in float64), so
a run can show that a path went through a kernel, and in which type.
A wrapper whose kernel takes a launch plan also counts its launches by
plan in ``plans`` ({plan: launches}), so a run can show which layout
its launches took.
"""

from __future__ import annotations

import torch


def count_launch(wrapper, dtype):
    """One launch of ``wrapper``'s kernel in ``dtype``."""
    wrapper.launches += 1
    if dtype == torch.float64:
        wrapper.launches_f64 += 1


def count_plan(wrapper, plan):
    """One launch of ``wrapper``'s kernel on ``plan`` (a hashable record
    of its layout)."""
    wrapper.plans[plan] = wrapper.plans.get(plan, 0) + 1


def reset_launches(*wrappers):
    """Both launch counts of each wrapper to 0, and its plans' counts
    cleared."""
    for fn in wrappers:
        fn.launches = fn.launches_f64 = 0
        fn.plans = {}
