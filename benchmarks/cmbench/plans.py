"""The program's count of its blocked-sweep (B1) launches by launch plan
(``circuitmap_torch/ops/_counts.py``: the ``plans`` of
``sweep_cuda.sweep_spikes_blocked``, each plan's CTAs a cluster,
columns a CTA, on-chip state, ring depth and block steps), for the
per-layer readers. The count is the whole run's, set-up included. A
program without the count gives None."""

from __future__ import annotations


def main_plan():
    """The plan that most of the run's B1 launches took, or None where
    the program keeps no such count or launched no B1."""
    from circuitmap_torch.ops import sweep_cuda

    plans = getattr(sweep_cuda.sweep_spikes_blocked, "plans", None)
    if not plans:
        return None
    return max(plans.items(), key=lambda kv: kv[1])[0]
