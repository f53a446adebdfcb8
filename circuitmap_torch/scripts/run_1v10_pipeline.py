"""1v10 pipeline: single-target vs ensemble consistency on real data
(port of ``scripts_tpu/run_1v10_pipeline.py``).

Split an experiment into single-target and ensemble trials, demix, fit
CAVIaR to each independently, optionally merge duplicate connections
(same cell at adjacent planes), render the checkerboard figure, export
both weight sets. Agreement between the two fits is the real-data
validation metric. The steps are ``run`` (the fits), ``figure``
(matplotlib) and ``export``.

Usage:
  python -m circuitmap_torch pipeline-1v10 --data expt.mat \
      --demixer demixers/nwd_ie_ChroME2f.npz --msrmp 0.4 --out out/
"""

import argparse
from pathlib import Path

import numpy as np

from . import add_device_argument


def load_dataset(path, reader):
    if reader == "h5py":
        import h5py

        with h5py.File(path, "r") as data:
            stim = np.array(data["stimulus_matrix"]).T
            psc = np.array(data["pscs"]).T
            targets = np.array(data["targets"]).T
        img = None
    else:
        from scipy.io import loadmat

        data = loadmat(path)
        stim = data["stimulus_matrix"]
        psc = data["pscs"]
        targets = data.get("targets")
        img = data.get("img")
    return psc, stim, targets, img


def parse_args(argv=None):
    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch pipeline-1v10", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data", required=True)
    parser.add_argument("--demixer", required=True)
    parser.add_argument("--msrmp", type=float, default=0.3)
    parser.add_argument("--out", required=True)
    parser.add_argument("--fmt", choices=["mat", "npz"], default="mat")
    parser.add_argument("--reader", choices=["scipy", "h5py"], default="scipy")
    parser.add_argument("--sign", choices=["positive", "negative"],
                        default="positive")
    parser.add_argument("--merge_duplicates", action="store_true")
    add_device_argument(parser)
    return parser.parse_args(argv)


def run(args):
    """Load, split, demix and fit. Returns (fits, psc_dem, stim_matrix):
    ``fits`` maps "single" and "ensemble" to (fitted Model, trial
    indices)."""
    from ..demix.demixer import NeuralDemixer
    from ..model import Model
    from ..pipelines import merge_duplicate_connections, split_single_ensemble
    from ..utils.metrics import r2_score

    psc, stim_matrix, targets, img = load_dataset(args.data, args.reader)
    if args.sign == "negative":
        psc = -psc
    N, K = stim_matrix.shape

    single, ensemble = split_single_ensemble(stim_matrix)
    print(f"trials: {single.size} single-target, {ensemble.size} ensemble")
    if single.size == 0 or ensemble.size == 0:
        raise SystemExit("need both single-target and ensemble trials")

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
        print(f"{name}: {model.time:.2f}s, "
              f"{int((model.state['mu'] != 0).sum())} connections")

    m_s, m_e = fits["single"][0], fits["ensemble"][0]
    print("single-vs-ensemble weight R2:",
          round(r2_score(m_s.state["mu"], m_e.state["mu"]), 4))

    if args.merge_duplicates and targets is not None:
        for name in ("single", "ensemble"):
            model, locs = fits[name]
            reps, clusters = merge_duplicate_connections(
                psc_dem[locs], stim_matrix[:, locs], model.state, targets,
                img, device=args.device)
            print(f"{name}: {len(clusters)} merged connection clusters")
    return fits, psc_dem, stim_matrix


def _stem(args):
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    return out / f"{Path(args.data).stem}_msrmp{args.msrmp}"


def figure(args, fits, psc_dem, stim_matrix):
    """The single-vs-ensemble checkerboard, ``<stem>_checkerboard.png``
    (needs matplotlib)."""
    from ..viz import plot_spike_inference_comparison

    (m_s, loc_s), (m_e, loc_e) = fits["single"], fits["ensemble"]
    plot_spike_inference_comparison(
        [psc_dem[loc_s], psc_dem[loc_e]],
        [stim_matrix[:, loc_s], stim_matrix[:, loc_e]],
        [m_s.state, m_e.state],
        titles=["Single target", "Ensemble"],
        n_plots=min(30, stim_matrix.shape[0]),
        save=f"{_stem(args)}_checkerboard.png",
    )


def export(args, fits):
    """Both fits' weights, uncertainties and spikes as
    ``<stem>_models.mat`` (or ``.npz``)."""
    m_s, m_e = fits["single"][0], fits["ensemble"][0]
    stem = _stem(args)
    payload = {
        "weights_single": m_s.state["mu"],
        "weight_uncertainty_single": m_s.state["beta"],
        "weights_ensemble": m_e.state["mu"],
        "weight_uncertainty_ensemble": m_e.state["beta"],
        "spikes_single": m_s.state["lam"],
        "spikes_ensemble": m_e.state["lam"],
    }
    if args.fmt == "npz":
        np.savez(f"{stem}_models.npz", **payload)
    else:
        from scipy.io import savemat

        savemat(f"{stem}_models.mat", payload)
    print("Wrote", f"{stem}_models.{args.fmt}")


def main(argv=None):
    args = parse_args(argv)
    fits, psc_dem, stim_matrix = run(args)
    figure(args, fits, psc_dem, stim_matrix)
    export(args, fits)
