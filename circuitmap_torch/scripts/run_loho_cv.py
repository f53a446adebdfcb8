"""Leave-one-hologram-out cross-validation (port of
``scripts_tpu/run_loho_cv.py``).

Two modes:
  * in-process sweep (default): every fold in one process, one fit per
    held-out hologram, held-out-trial predictions collected per fold;
  * single-fold worker (``--fold I``): fit exactly one held-out
    hologram and write ``<out>.fold_I.json`` — the job-array unit that
    ``fanout-jobs`` emits.

Usage:
  python -m circuitmap_torch loho-cv --data expt.npz \
      [--demixer demixers/nwd_ie_ChroME2f.npz] --method caviar --out cv.json
  python -m circuitmap_torch loho-cv --data expt.npz --fold 3 --out cv.json
"""

import argparse
import json

import numpy as np

from . import add_device_argument


def held_out_mse(state, psc_test, stim_test):
    """Mean squared error of the held-out trials' charges against the
    charges the training fit predicts: sum_n mu_n * p(spike | power),
    through the fitted power curve where the method has one (host
    numpy)."""
    mu = state["mu"]
    y_test = np.trapezoid(psc_test, axis=-1)
    if "phi" in state:
        phi = state["phi"]
        drive = phi[:, 0:1] * stim_test - phi[:, 1:2]
        p_spk = 1.0 / (1.0 + np.exp(-drive)) * (stim_test > 0)
        y_hat = mu @ p_spk
    else:
        y_hat = mu @ (stim_test > 0)
    return float(np.mean((y_test - y_hat) ** 2))


def fit_options(method, iters, msrmp):
    opts = {"iters": iters, "save_histories": False, "verbose": False}
    if method == "caviar":
        opts["msrmp"] = msrmp
    return opts


def main(argv=None):
    from ..demix.demixer import NeuralDemixer
    from ..model import Model
    from ..parallel.sweep import loho_folds
    from ..utils.io import load_experiment

    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch loho-cv", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data", required=True)
    parser.add_argument("--demixer", default=None)
    parser.add_argument("--method", default="caviar",
                        choices=["caviar", "cavi_sns", "mbcs"])
    parser.add_argument("--msrmp", type=float, default=0.3)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--max_folds", type=int, default=None)
    parser.add_argument("--fold", type=int, default=None,
                        help="worker mode: run ONLY this fold index and "
                             "write <out>.fold_<I>.json")
    parser.add_argument("--out", default="loho_cv.json")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    psc, stim = load_experiment(args.data)
    if args.demixer:
        psc = NeuralDemixer(path=args.demixer, device=args.device)(psc)
    N, K = stim.shape

    folds = list(loho_folds(stim))
    if args.fold is not None:
        if not 0 <= args.fold < len(folds):
            raise SystemExit(
                f"--fold {args.fold} out of range (0..{len(folds) - 1})")
        folds = [folds[args.fold]]
        args.out = f"{args.out}.fold_{args.fold}.json"
    elif args.max_folds:
        folds = folds[: args.max_folds]
    print(f"{len(folds)} holograms; {K} trials")

    records = []
    for holo, train, test in folds:
        model = Model(N)
        model.fit(psc[train], stim[:, train] * 1.0, method=args.method,
                  fit_options=fit_options(args.method, args.iters,
                                          args.msrmp),
                  device=args.device)
        err = held_out_mse(model.state, psc[test], stim[:, test])
        records.append({
            "hologram": holo, "test_trials": len(test), "seconds": model.time,
            "held_out_mse": err,
            "n_connections": int((model.state["mu"] != 0).sum()),
        })
        print(f"fold {holo}: mse={err:.4f} t={model.time:.2f}s")

    with open(args.out, "w") as f:
        json.dump(records, f)
    print("Wrote", args.out)
