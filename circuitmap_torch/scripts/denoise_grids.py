"""Single-spot grid mapping: per-plane fits and mean-response maps
(port of ``scripts_tpu/denoise_grids.py``).

Single-spot data stimulates one grid location per trial; per z-plane
the stim matrix is a one-hot location-by-trial matrix, fitted
independently, producing a weight map image per plane.

Input .npz/.mat keys: psc [K, T], I [K] (power per trial),
L [K, 3] (x, y, z stim location per trial).

Usage:
  python -m circuitmap_torch denoise-grids --data grid.npz \
      [--demixer demixers/nwd_ie_ChroME2f.npz] --method caviar --out out/
"""

import argparse
from pathlib import Path

import numpy as np

from . import add_device_argument


def make_plane_stim_matrices(powers_per_trial, locs):
    """Split single-spot trials by z-plane into one-hot stim matrices.

    Returns list of (z, stim [n_locs, n_trials], trial_idx, plane_locs).
    """
    locs = np.asarray(locs)
    powers_per_trial = np.asarray(powers_per_trial)
    out = []
    for z in np.unique(locs[:, -1]):
        these = np.flatnonzero(locs[:, -1] == z)
        plane_locs, loc_idx = np.unique(
            locs[these][:, :2], axis=0, return_inverse=True
        )
        stim = np.zeros((plane_locs.shape[0], these.size))
        stim[loc_idx, np.arange(these.size)] = powers_per_trial[these]
        out.append((z, stim, these, plane_locs))
    return out


def weight_map_image(plane_locs, weights):
    """Rasterise per-location weights into a 2-D map (grid-aligned)."""
    xs = np.unique(plane_locs[:, 0])
    ys = np.unique(plane_locs[:, 1])
    img = np.zeros((xs.size, ys.size))
    for (x, y), w in zip(plane_locs, weights):
        img[np.searchsorted(xs, x), np.searchsorted(ys, y)] = w
    return img


def main(argv=None):
    from ..demix.demixer import NeuralDemixer
    from ..model import Model

    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch denoise-grids", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data", required=True)
    parser.add_argument("--demixer", default=None)
    parser.add_argument("--method", default="caviar",
                        choices=["caviar", "cavi_sns", "mbcs"])
    parser.add_argument("--msrmp", type=float, default=0.2)
    parser.add_argument("--iters", type=int, default=30)
    parser.add_argument("--out", default="grids_out")
    parser.add_argument("--plot", action="store_true")
    add_device_argument(parser)
    args = parser.parse_args(argv)

    if args.data.endswith(".mat"):
        from scipy.io import loadmat

        data = loadmat(args.data)
    else:
        data = np.load(args.data, allow_pickle=True)
    psc = np.asarray(data["psc"], dtype=float)
    I = np.asarray(data["I"], dtype=float).squeeze()
    L = np.asarray(data["L"], dtype=float)

    if args.demixer:
        psc = NeuralDemixer(path=args.demixer, device=args.device)(psc)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    maps = {}
    for z, stim, trials, plane_locs in make_plane_stim_matrices(I, L):
        model = Model(stim.shape[0])
        opts = {"iters": args.iters, "save_histories": False, "verbose": False}
        if args.method == "caviar":
            opts["msrmp"] = args.msrmp
        model.fit(psc[trials], stim, method=args.method, fit_options=opts,
                  device=args.device)
        img = weight_map_image(plane_locs, model.state["mu"])
        maps[f"plane_{z:g}"] = img
        print(f"plane z={z:g}: {stim.shape[0]} locations, "
              f"{trials.size} trials, {int((model.state['mu'] != 0).sum())} "
              f"responsive, fit {model.time:.2f}s")

        if args.plot:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt

            fig, ax = plt.subplots(figsize=(5, 5))
            im = ax.imshow(img, cmap="magma")
            fig.colorbar(im)
            ax.set_title(f"z = {z:g} um")
            fig.savefig(out / f"map_z{z:g}.png", dpi=200, bbox_inches="tight")
            plt.close(fig)

    np.savez(out / "weight_maps.npz", **maps)
    print("Wrote", out / "weight_maps.npz")
