"""How ``correct`` is decided: the program's outputs from the window
against the plain reference (``reference.py``) at the timed sizes.

The reference runs once the window has closed, the memory peak has been
read and the program's state is freed. Each request kind
(``kinds/<kind>.py``) names the numbers it compares; each number has a
limit of its own in ``limits/<cell>.json``, and the run is correct when
every number is within its limit and every request was answered.
"""

from __future__ import annotations

import numpy as np
import torch


def gap(a, b, absolute=False):
    """The widest gap between ``a`` (the program's) and ``b`` (the
    reference's), over ``max|b|`` unless ``absolute``. A NaN where the
    other holds a number is an infinite gap."""
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a,
                   np.float64)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b,
                   np.float64)
    if a.shape != b.shape or not np.array_equal(np.isnan(a), np.isnan(b)):
        return float("inf")
    both = ~np.isnan(b)
    if not both.any():
        return 0.0
    diff = float(np.max(np.abs(a[both] - b[both])))
    if absolute:
        return diff
    return diff / max(float(np.max(np.abs(b[both]))), 1e-300)


def median(values):
    """The median of ``values`` (0 where there are none)."""
    values = np.asarray(values, np.float64)
    return float(np.median(values)) if values.size else 0.0


def judge(numbers, limits, attempted, failed):
    """(correct, lines): every number within its limit, every request
    answered, and no limit without its number."""
    lines, ok = [], attempted > 0 and failed == 0
    for name in sorted(set(numbers) | set(limits)):
        value, limit = numbers.get(name), limits.get(name)
        good = (value is not None and limit is not None
                and np.isfinite(value) and value <= limit)
        ok &= good
        lines.append(f"{name} {value!r} limit {limit!r}"
                     f"{'' if good else ' FAILED'}")
    lines.append(f"requests attempted {attempted} failed {failed}")
    return bool(ok), lines
