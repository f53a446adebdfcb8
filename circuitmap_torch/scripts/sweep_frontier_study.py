"""Sweep-parallelism / recovery frontier study on the card (port of
``scripts_tpu/sweep_frontier_study.py``) -> SWEEP_FRONTIER_H100.json.

The coordinate sweep is the one sequential part of the CAVI iteration
(N/B dependent steps). Larger Jacobi blocks B buy wall-clock but stale
more coordinates per step. The port's ``auto`` block of 8 on CUDA was
taken from the JAX study's TPU run; this study maps the frontier on the
card with the bench pipeline (int4 QAT demix + fit):

  B in {1, 8, 10, 12, 16} x >= 3 seeds x 2 shapes, plus "perm8": a
  fresh neuron relabelling per fit at B=8 (random but fixed block
  composition; the cluster kernel's blocks are row-consecutive, and the
  solver already permutes the block order every iteration). The
  relabelling is drawn from ``np.random.default_rng(1000 + seed)``, so it
  is not the JAX study's draw: the two are compared by truth-R2 within
  the seed band.

B=1 is the reference's strictly sequential schedule; every B runs the
cluster kernel (``csrc/sweep_cluster.cuh``; a runtime row count for B
other than 1 and 8). The JAX study's "xla8" arm (its XLA sweep, which
re-forms the blocks from every iteration's permuted order) has no
counterpart: the port's CUDA fits always take the kernel
(``sweep_impl`` is "auto" or "cuda"), so the record lists it as not run.

Each arm records a cold and a warm fit time (the first and second fit
of that block in the process, each timed to its host pull), the
truth-R2 and the warm fit's B1 (blocked sweep), B3 (row sweep) and B2
(Laplace) launches. ``device`` names the card and its power limit.

    python -m circuitmap_torch.scripts.sweep_frontier_study [--quick]
        [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path

import numpy as np

from . import add_device_argument

_REPO = Path(__file__).resolve().parents[2]
NOT_RUN = {"xla8": "no counterpart: the port's CUDA fits always take the "
                   "cluster kernel (sweep_impl is 'auto' or 'cuda'), "
                   "whose blocks are row-consecutive"}


def grid(quick):
    """(shapes, seeds, blocks, iters) of the study."""
    if quick:
        return [(100, 2000)], [0, 1], [1, 8, "perm8"], 20
    return ([(1000, 20000), (2000, 20000)], [0, 1, 2],
            [1, 8, 10, 12, 16, "perm8"], 50)


def _wrappers():
    from ..ops import laplace_cuda, sweep_cuda, sweep_row_cuda

    return {"B1": (sweep_cuda.sweep_spikes_blocked,
                   sweep_cuda.sweep_spikes_blocked_batched),
            "B3": (sweep_row_cuda.sweep_spikes_row,
                   sweep_row_cuda.sweep_spikes_row_batched),
            "B2": (laplace_cuda.laplace_from_stats,)}


def fit_block(dem, stim, priors, block, seed, iters, device):
    """One caviar fit at ``block`` rows a step; "perm8" relabels the
    neurons (a permutation from the seed) and undoes it on the
    outputs. Returns the weights (numpy, pulled to the host: the fit's
    time ends with the pull)."""
    from ..solvers import caviar

    stim = np.asarray(stim)
    if block == "perm8":
        perm = np.random.default_rng(1000 + seed).permutation(stim.shape[0])
        inv = np.empty_like(perm)
        inv[perm] = np.arange(perm.size)
        out = caviar(dem, stim[perm], priors["mu"][perm],
                     priors["beta"][perm], priors["shape"], priors["rate"],
                     priors["phi"][perm], priors["phi_cov"][perm],
                     iters=iters, msrmp=0.3, seed=seed,
                     powers=[45.0, 55.0, 65.0], sweep_block_size=8,
                     verbose=False, device=device)
        return out[0].cpu().numpy()[inv]
    out = caviar(dem, stim, priors["mu"], priors["beta"], priors["shape"],
                 priors["rate"], priors["phi"], priors["phi_cov"],
                 iters=iters, msrmp=0.3, seed=seed,
                 powers=[45.0, 55.0, 65.0], sweep_block_size=int(block),
                 verbose=False, device=device)
    return out[0].cpu().numpy()


def run_arm(dem, sim, priors, block, seed, iters, device):
    """Cold and warm fits of one arm: its record (without N, K)."""
    from ..utils.metrics import r2_score

    def counts():
        return {k: sum(fn.launches for fn in fns)
                for k, fns in _wrappers().items()}

    t0 = time.time()
    fit_block(dem, sim["stim_matrix"], priors, block, seed, iters, device)
    t_cold = time.time() - t0
    before = counts()
    t0 = time.time()
    mu = fit_block(dem, sim["stim_matrix"], priors, block, seed, iters,
                   device)
    t_warm = time.time() - t0
    launches = {k: v - before[k] for k, v in counts().items()}
    return dict(block=str(block), seed=seed,
                r2=round(float(r2_score(sim["weights"], mu)), 4),
                fit_warm_s=round(t_warm, 3), fit_cold_s=round(t_cold, 1),
                launches=launches)


def run_study(shapes, seeds, blocks, iters, dev, out, demixer_path=None):
    """Every arm of the grid on ``dev`` (None: the GPU), each row printed
    and the record written to ``out`` as it comes; the demix is the int4
    wire with ``demixer_path`` (the QAT checkpoint), or int8 with a fresh
    network when it is None. Returns the rows."""
    from .._device import resolve_device
    from ..demix.demixer import NeuralDemixer
    from ..model import default_priors
    from ..simulation import simulate
    from .run_scaling_study import device_label

    dev = resolve_device(dev)
    demixer = NeuralDemixer(path=demixer_path, device=dev)
    wire = "int8" if demixer_path is None else "int4"
    device = device_label(dev)
    rows = []
    for N, K in shapes:
        for sim_seed in seeds:
            np.random.seed(sim_seed)
            sim = simulate(N=N, trials=K, H=10, connection_prob=0.05,
                           verbose=False, batch_size=1000, device=dev)
            dem = demixer(sim["psc"], verbose=False, keep_on_device=True,
                          transfer_dtype=wire)
            priors = default_priors(N)
            for block in blocks:
                row = dict(N=N, K=K, **run_arm(dem, sim, priors, block,
                                                sim_seed, iters, dev))
                rows.append(row)
                print(json.dumps(row), flush=True)
                _write(out, device, iters, wire, rows)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m circuitmap_torch.scripts.sweep_frontier_study",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="tiny grid to smoke the harness (CPU ok)")
    ap.add_argument("--out", default="SWEEP_FRONTIER_H100.json")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    shapes, seeds, blocks, iters = grid(args.quick)
    qat = _REPO / "demixers" / "nwd_ie_ChroME2f_int4qat.npz"
    rows = run_study(shapes, seeds, blocks, iters, args.device, args.out,
                     str(qat) if qat.exists() and not args.quick else None)

    print("\n| N | K | B | mean R2 | min R2 | warm fit (s) |")
    print("|---|---|---|---|---|---|")
    for N, K in shapes:
        for block in blocks:
            sel = [r for r in rows
                   if (r["N"], r["K"], r["block"]) == (N, K, str(block))]
            print(f"| {N} | {K} | {block} | "
                  f"{np.mean([r['r2'] for r in sel]):.4f} | "
                  f"{min(r['r2'] for r in sel):.4f} | "
                  f"{np.median([r['fit_warm_s'] for r in sel]):.3f} |")
    return 0


def _write(path, device, iters, wire, rows):
    payload = dict(device=device, iters=iters, wire=wire, results=rows,
                   not_run=NOT_RUN)
    with open(f"{path}.tmp", "w") as fh:
        json.dump(payload, fh, indent=1)
        fh.write("\n")
    os.replace(f"{path}.tmp", path)


if __name__ == "__main__":
    raise SystemExit(main())
