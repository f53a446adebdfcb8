"""Pair-patch pipeline: inferred spikes vs loose-patch ground truth
(port of ``scripts_tpu/run_pair_patch_pipeline.py``).

The 1v10 split-and-fit, plus a directly patched presynaptic cell
(``psps`` recordings) whose threshold-detected spikes validate the
inferred spike posteriors and power curves.

Usage:
  python -m circuitmap_torch pipeline-pair-patch --data expt.mat \
      --demixer demixers/nwd_ie_ChroME2f.npz --msrmp 0.4 --out out/
"""

import argparse
from pathlib import Path

import numpy as np

from . import add_device_argument


def main(argv=None):
    from scipy.io import loadmat, savemat

    from ..demix.demixer import NeuralDemixer
    from ..model import Model
    from ..pipelines import (detect_lp_spikes, find_patched_cell,
                             power_curve_comparison, split_single_ensemble)

    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch pipeline-pair-patch",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data", required=True)
    parser.add_argument("--demixer", required=True)
    parser.add_argument("--msrmp", type=float, default=0.3)
    parser.add_argument("--out", required=True)
    parser.add_argument("--spike_threshold", type=float, default=0.1)
    add_device_argument(parser)
    args = parser.parse_args(argv)

    data = loadmat(args.data)
    stim_matrix = data["stimulus_matrix"]
    psc = data["pscs"]
    psp = data["psps"]
    N, K = stim_matrix.shape

    single, ensemble = split_single_ensemble(stim_matrix)
    demix = NeuralDemixer(path=args.demixer, device=args.device)
    psc_dem = demix(psc)

    fits = {}
    for name, locs in (("single", single), ("ensemble", ensemble)):
        model = Model(N)
        model.fit(
            psc_dem[locs], stim_matrix[:, locs] * 1.0, method="caviar",
            fit_options={"msrmp": args.msrmp, "save_histories": False},
            device=args.device,
        )
        fits[name] = (model, locs)

    # ground truth from the patched cell
    lp_cell = find_patched_cell(stim_matrix, psp, args.spike_threshold)
    lp_spikes = detect_lp_spikes(psp, args.spike_threshold)
    print(f"patched cell: {lp_cell}; LP spikes detected: {int(lp_spikes.sum())}")

    curves = {}
    for name, (model, locs) in fits.items():
        curves[name] = power_curve_comparison(
            stim_matrix, model.state["lam"], lp_spikes, lp_cell,
            trial_subset=locs,
        )
        agree = np.mean(
            np.abs(curves[name]["lp_rate"] - curves[name]["model_rate"])
        )
        print(f"{name}: mean |LP rate - posterior rate| per power = {agree:.3f}")

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    stem = out / f"{Path(args.data).stem}_msrmp{args.msrmp}_pairpatch"
    savemat(
        f"{stem}.mat",
        {
            "lp_cell": lp_cell,
            "lp_spikes": lp_spikes.astype(float),
            "weights_single": fits["single"][0].state["mu"],
            "weights_ensemble": fits["ensemble"][0].state["mu"],
            "spikes_single": fits["single"][0].state["lam"],
            "spikes_ensemble": fits["ensemble"][0].state["lam"],
            **{f"curve_{n}_{k}": v for n, c in curves.items()
               for k, v in c.items()},
        },
    )
    print("Wrote", f"{stem}.mat")
