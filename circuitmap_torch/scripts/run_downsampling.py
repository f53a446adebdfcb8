"""Data-efficiency curves: fit on growing trial subsets (port of
``scripts_tpu/run_downsampling.py``).

Subsample trials at increasing fractions (x repeats), fit each subset,
save the weight trajectories.
"""

import argparse

import numpy as np

from . import add_device_argument


def main(argv=None):
    from ..demix.demixer import NeuralDemixer
    from ..model import Model
    from ..utils.io import load_experiment

    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch downsampling", description=__doc__)
    parser.add_argument("--data", required=True)
    parser.add_argument("--demixer", default=None)
    parser.add_argument("--fractions", type=float, nargs="+",
                        default=[0.1, 0.25, 0.5, 0.75, 1.0])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--msrmp", type=float, default=0.3)
    parser.add_argument("--out", default="downsampling_results.npz")
    parser.add_argument("--seed", type=int, default=0)
    add_device_argument(parser)
    args = parser.parse_args(argv)

    psc, stim = load_experiment(args.data)
    if args.demixer:
        psc = NeuralDemixer(path=args.demixer, device=args.device)(psc)
    N, K = stim.shape

    rng = np.random.default_rng(args.seed)
    weights = np.zeros((len(args.fractions), args.repeats, N))
    times = np.zeros((len(args.fractions), args.repeats))

    for i, frac in enumerate(args.fractions):
        k = max(int(frac * K), 1)
        for r in range(args.repeats):
            sel = np.sort(rng.choice(K, k, replace=False))
            model = Model(N)
            model.fit(psc[sel], stim[:, sel], method="caviar",
                      fit_options={"iters": args.iters, "msrmp": args.msrmp},
                      device=args.device)
            weights[i, r] = model.state["mu"]
            times[i, r] = model.time
            print(f"frac={frac} rep={r}: K={k} t={model.time:.2f}s")

    np.savez(args.out, fractions=np.asarray(args.fractions),
             weights=weights, times=times)
    print("Wrote", args.out)
