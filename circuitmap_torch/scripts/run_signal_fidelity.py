"""Demixer signal-fidelity analysis on continuous simulations (port of
``scripts_tpu/run_signal_fidelity.py``).

Generate continuous experiments and save the true, observed and
demixed responses for R² fidelity analysis of the demixer itself.
"""

import argparse

import numpy as np

from . import add_device_argument


def main(argv=None):
    from ..demix.demixer import NeuralDemixer
    from ..simulation import simulate_continuous_experiment
    from ..utils.metrics import r2_score

    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch signal-fidelity",
        description=__doc__)
    parser.add_argument("--demixer", required=True)
    parser.add_argument("--N", type=int, default=100)
    parser.add_argument("--expt_len_s", type=float, default=60)
    parser.add_argument("--stim_freqs", type=int, nargs="+",
                        default=[10, 30, 50])
    parser.add_argument("--out", default="signal_fidelity.npz")
    parser.add_argument("--seed", type=int, default=0)
    add_device_argument(parser)
    args = parser.parse_args(argv)

    demixer = NeuralDemixer(path=args.demixer, device=args.device)
    payload = {}
    for freq in args.stim_freqs:
        np.random.seed(args.seed)
        expt = simulate_continuous_experiment(
            N=args.N, expt_len=int(args.expt_len_s * 20000), stim_freq=freq,
            device=args.device,
        )
        dem = demixer(expt["obs_responses"], verbose=False)
        r2 = np.mean([
            r2_score(t, d)
            for t, d in zip(expt["true_responses"], dem)
            if t.std() > 0
        ])
        print(f"stim_freq={freq}: mean per-trial R2(true, demixed) = {r2:.4f}")
        payload[f"true_{freq}"] = expt["true_responses"]
        payload[f"obs_{freq}"] = expt["obs_responses"]
        payload[f"demixed_{freq}"] = dem

    np.savez(args.out, **payload)
    print("Wrote", args.out)
