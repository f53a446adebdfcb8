"""Simulation benchmark: simulate → demix → fit all solvers → save
(port of ``scripts_tpu/run_simulations.py``).

One trial-based simulation, NWD demixing, CAVIaR + CAVI-SnS + CoSaMP
fits, results (with the ground truth and each solver's wall-clock)
pickled with bz2.
"""

import argparse
import bz2
import pickle

import numpy as np

from . import add_device_argument


def main(argv=None):
    from ..demix.demixer import NeuralDemixer
    from ..model import Model
    from ..simulation import simulate
    from ..solvers import cosamp
    from ..utils.metrics import r2_score

    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch simulations", description=__doc__)
    parser.add_argument("--N", type=int, default=300)
    parser.add_argument("--trials", type=int, default=2000)
    parser.add_argument("--H", type=int, default=10)
    parser.add_argument("--connection_prob", type=float, default=0.05)
    parser.add_argument("--spont_prob", type=float, default=0.05)
    parser.add_argument("--msrmp", type=float, default=0.3)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--demixer", default=None)
    parser.add_argument("--token", default="sim")
    parser.add_argument("--out", default=".")
    parser.add_argument("--seed", type=int, default=0)
    add_device_argument(parser)
    args = parser.parse_args(argv)

    np.random.seed(args.seed)
    sim = simulate(
        N=args.N, trials=args.trials, H=args.H,
        connection_prob=args.connection_prob, spont_prob=args.spont_prob,
        device=args.device,
    )

    psc = sim["psc"]
    if args.demixer:
        psc = NeuralDemixer(path=args.demixer, device=args.device)(psc)

    results = {"sim": {k: sim[k] for k in ("weights", "stim_matrix", "spks", "I")}}

    for method in ("caviar", "cavi_sns"):
        model = Model(args.N)
        opts = {"iters": args.iters}
        if method == "caviar":
            opts["msrmp"] = args.msrmp
        model.fit(psc, sim["stim_matrix"], method=method, fit_options=opts,
                  device=args.device)
        results[method] = {
            "state": model.state,
            "time": model.time,
            "r2": r2_score(sim["weights"], model.state["mu"]),
        }
        print(f"{method}: {model.time:.2f}s  R2={results[method]['r2']:.4f}")

    # CoSaMP baseline on integrated charge
    y = np.trapezoid(psc, axis=-1)
    A = (sim["stim_matrix"] > 0).T.astype(float)
    k_sparse = max(int(0.1 * args.N), 1)
    w_cosamp, t_cosamp = cosamp(A, y, k_sparse)
    results["cosamp"] = {
        "weights": w_cosamp,
        "time": t_cosamp,
        "r2": r2_score(sim["weights"], w_cosamp),
    }
    print(f"cosamp: {t_cosamp:.2f}s  R2={results['cosamp']['r2']:.4f}")

    out = f"{args.out}/simulation_results_{args.token}_N{args.N}_K{args.trials}.pkl.bz2"
    with bz2.BZ2File(out, "wb") as f:
        pickle.dump(results, f)
    print("Wrote", out)
