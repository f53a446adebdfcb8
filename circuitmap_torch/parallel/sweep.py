"""Embarrassingly-parallel sweep runner (port of
``circuitmap_tpu/parallel/sweep.py``).

Replaces the reference's SLURM job-array generator
(generate_loho_cv_slurm_scripts.py:8-124) — which writes sbatch scripts
that call worker files not present in the repo — with an in-process
runner: a list of work items is executed against a shared solver, with
results collected to JSON. Leave-one-hologram-out CV is provided as the
canonical work-item generator.
"""

from __future__ import annotations

import json
import time

import numpy as np
import torch


def loho_folds(stim_matrix):
    """Leave-one-hologram-out folds.

    Groups trials by hologram (identical stim columns) and yields
    (holo_id, train_trial_idx, test_trial_idx) per unique hologram —
    the reference's CV unit (generate_loho_cv_slurm_scripts.py:19-36).
    """
    stim = np.asarray(stim_matrix)
    _, inverse = np.unique(stim.T, axis=0, return_inverse=True)
    for holo in np.unique(inverse):
        test = np.flatnonzero(inverse == holo)
        train = np.flatnonzero(inverse != holo)
        yield int(holo), train, test


def run_sweep(items, fit_fn, save_path=None, verbose=True):
    """Run ``fit_fn(**item)`` for every item; collect results + timing.

    items: list of kwargs dicts. Returns a list of dicts with ``result`` and
    ``seconds``; optionally JSON-dumps summaries to ``save_path``.
    """
    records = []
    for i, item in enumerate(items):
        t0 = time.time()
        result = fit_fn(**item)
        dt = time.time() - t0
        if verbose:
            print(f"sweep item {i + 1}/{len(items)}: {dt:.2f}s")
        records.append({"item": i, "seconds": dt, "result": result})

    if save_path is not None:
        summary = [
            {
                "item": r["item"],
                "seconds": r["seconds"],
                "result": _jsonable(r["result"]),
            }
            for r in records
        ]
        with open(save_path, "w") as f:
            json.dump(summary, f)
    return records


_JSON_MAX_ELEMENTS = 100_000


def _jsonable(x):
    """JSON form of a sweep result, SUMMARISING large arrays.

    The saved file is a summary: full [N, K] posterior matrices or
    history stacks would serialise to hundreds of MB of JSON at
    flagship scale. Arrays above _JSON_MAX_ELEMENTS elements are
    replaced by shape/dtype plus summary statistics; the in-memory
    ``records`` returned to the caller keep everything.
    """
    if isinstance(x, dict):
        return {k: _jsonable(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_jsonable(v) for v in x]
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    if hasattr(x, "tolist"):
        arr = np.asarray(x)
        if arr.size > _JSON_MAX_ELEMENTS:
            finite = arr[np.isfinite(arr)] if arr.dtype.kind == "f" else arr
            return {
                "summarised_array": True,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "mean": float(np.mean(finite)) if finite.size else None,
                "min": float(np.min(finite)) if finite.size else None,
                "max": float(np.max(finite)) if finite.size else None,
                "nonzero": int(np.count_nonzero(arr)),
            }
        return arr.tolist()
    return x
