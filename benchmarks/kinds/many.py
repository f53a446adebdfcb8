"""The ``many`` kind of request: the cross-validation folds of one map,
fit in one ``caviar_many`` call, in a closed loop of one client (the
next request goes when the last answer is on the host).

The configuration's ``folds`` cut its ``trials`` into contiguous parts:
fold f holds out the f-th and keeps the others, in order (this repo's
README recipe). Set-up makes the map's experiment from the seed, as the
``map`` kind does, demixes its traces once on the device on the
configuration's wire, and gathers each fold's kept traces into one
resident [folds, kept trials, T] float32 stack; each fold's design is a
host float64 [N, kept trials] array, stacked as a rig hands them over.
A request is one ``caviar_many`` call on the stack and the designs with
the configuration's fit options (its ``compile_mode`` among them) and
the default priors; its answer holds each field as a list over the
folds.

How ``correct`` is decided: the plain reference (``cmbench/reference.py``)
demixes the whole experiment once in float64 and fits each fold's
charges (``cmbench/reference_folds.py``: the folds' sweeps stepped
together, each fold's other updates ``reference.py``'s own). For each
fold the numbers are the ``map`` kind's (``phi_med_gap``,
``lam_med_gap``, ``mu_med_gap``: medians over the neurons the reference
connects, see ``kinds/map.py``). An answer reads each twice: the median
of its folds' values, under the name, and the largest over its folds,
as ``*_worst_fold``; with the widest gaps over every fold. The small
fields are compared on every answer of the window, the spike posteriors
on the answers sampled from the seed and the last.

Why two readings. A fold's medians over the neurons are the ``map``
kind's answer to a swap (one trial's event settled on another
co-stimulated neuron, a mode that float32 rounding picks), and in
``map1000`` a swap leaves them below the control's. Not here: the one
fold of 40 in which the program swapped on the card read medians above
the control's smallest largest-over-the-folds (PERF.md §2), so no limit
on the largest over the folds separates the program from the control.
A swap moves one fold, the control's rounding all four: the median over
the folds separates them. The largest over the folds is held to a limit
of its own, above a swapped fold and far below a fault in one fold
alone (a fold left at its priors, fit on another fold's design or
trials, or its power curves altered), so each fold is still checked.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from cmbench import check, harness
from cmbench import reference as R
from cmbench import reference_folds as RF
from cmbench.counts_many import fold_keeps

M = harness.kind({"request": "map"})

# the fields kept only for the answers sampled from the seed
BIG = ("lam", "z")


def make_data(cfg, seed, device, root):
    """The ``map`` kind's experiment, and the folds' designs as one host
    float64 [folds, N, kept trials] stack."""
    data = M.make_data(cfg, seed, device, root)
    data["stims_host"] = np.stack([data["stim_host"][:, k]
                                   for k in fold_keeps(cfg)])
    return data


class Driver:
    """Drives the program (``circuitmap_torch``) with one fold stack a
    request."""

    def __init__(self, cfg, traffic, data, device, root, setup):
        from circuitmap_torch import caviar_many, default_priors
        from circuitmap_torch.demix.demixer import NeuralDemixer

        self.caviar_many = caviar_many
        self.device = device
        self.opts = M.fit_options(cfg)
        p = default_priors(cfg["N"])
        self.priors = (p["mu"], p["beta"], p["shape"], p["rate"], p["phi"],
                       p["phi_cov"])
        self.stims = data["stims_host"]
        t0 = time.perf_counter()
        demixer = NeuralDemixer(os.path.join(root, cfg["demixer"]),
                                device=device)
        setup["demixer_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dem = demixer(data["psc_host"], keep_on_device=True,
                      transfer_dtype=cfg["trace_wire"], verbose=False)
        self.stack = torch.stack([dem[torch.as_tensor(k, device=dem.device)]
                                  for k in fold_keeps(cfg)])
        setup["demix_once_s"] = time.perf_counter() - t0

    def request(self, spans):
        """One cross-validated map: the folds' posteriors, each field a
        list over the folds of host arrays."""
        spans.mark("many")
        outs = self.caviar_many(self.stack, self.stims, *self.priors,
                                device=self.device, **self.opts)
        spans.mark("many.end")
        return {f: [o[f] for o in outs] for f in outs[0]}

    def counters(self):
        """The program's kernel-launch counters: the batched row sweep
        (B5), the Laplace refit (B2), and the weight update's Gram by
        path (the dense product, W1)."""
        from circuitmap_torch.ops.gram_cuda import costim_gram
        from circuitmap_torch.ops.laplace_cuda import laplace_from_stats
        from circuitmap_torch.ops.sweep_row_cuda import \
            sweep_spikes_row_batched

        return {"sweep_row_batched": sweep_spikes_row_batched.launches,
                "laplace": laplace_from_stats.launches,
                "gram_dense": costim_gram.plans.get("dense", 0),
                "gram_costim": costim_gram.launches}

    def request_log(self):
        return None

    def close(self):
        self.__dict__.pop("stack", None)


def end_to_end(traffic, window_s, answered, latencies):
    """Seconds per cross-validated map (all its folds) over the window."""
    return {"map_s": window_s / max(answered, 1)}


# ---------------------------------------------------------------------------
# The reference and the compared numbers
# ---------------------------------------------------------------------------


def fold_maps(cfg, data, inputs, dtype, device):
    """Each fold's posterior, fit in ``dtype`` from the whole experiment's
    reference charges and mask (``inputs``): ``reference.caviar`` of each
    fold, the folds' sweeps stepped together
    (``reference_folds.caviar_folds``)."""
    _, y, mask = inputs
    keeps = [torch.as_tensor(k, device=device) for k in fold_keeps(cfg)]
    stim = data["stim"].to(device)
    return RF.caviar_folds(
        torch.stack([y[k] for k in keeps]).to(dtype),
        torch.stack([stim[:, k] for k in keeps]),
        torch.stack([mask[k] for k in keeps]).to(dtype), cfg["powers"],
        cfg["fit"], dtype, device)


def reference(cfg, traffic, data, device):
    """The float64 reference's posteriors, one a fold."""
    with R.precision(False):
        inputs = M.reference_inputs(cfg, data, torch.float64, device)
        return fold_maps(cfg, data, inputs, torch.float64, device)


def numbers(cfg, traffic, ref, small, sampled):
    """Every number the check can read from the kept answers (see the
    module docstring): ``phi_med_gap``, ``lam_med_gap`` and
    ``mu_med_gap`` the median over an answer's folds of each fold's, the
    largest over the answers; ``*_worst_fold`` the same with the largest
    over the folds; the widest gaps over every fold."""
    if any(len(o["mu"]) != len(ref) for o in (*small, *sampled)):
        return {k + w: float("inf")
                for k in ("phi_med_gap", "lam_med_gap", "mu_med_gap")
                for w in ("", "_worst_fold")}
    nums = {}
    for out in (*small, *sampled):
        folds = {}
        for f, post in enumerate(ref):
            gaps = M.median_gaps({k: v[f] for k, v in out.items()}, post)
            for k, v in gaps.items():
                folds.setdefault(k, []).append(v)
        for k, v in folds.items():
            nums[k] = max(nums.get(k, 0.0), float(np.median(v)))
            worst = k + "_worst_fold"
            nums[worst] = max(nums.get(worst, 0.0), max(v))
    for name in M.WIDEST:
        nums[f"{name}_gap"] = max(check.gap(o[name][f], post[name])
                                  for o in small
                                  for f, post in enumerate(ref))
    nums["lam_gap"] = max(check.gap(o["lam"][f], post["lam"], absolute=True)
                          for o in sampled for f, post in enumerate(ref))
    return nums


def control(cfg, traffic, data, device):
    """The control's answers, as (every answer, the sampled answers): each
    fold fit by the reference in float32 with TF32 products in the
    program's place, on the float64 reference's charges (the program's
    traces are demixed once in set-up: only the fit is in its place)."""
    with R.precision(False):
        inputs = M.reference_inputs(cfg, data, torch.float64, device)
    with R.precision(True):
        posts = fold_maps(cfg, data, inputs, torch.float32, device)
    out = {k: [p[k] for p in posts] for k in posts[0]}
    return [out], [out]
