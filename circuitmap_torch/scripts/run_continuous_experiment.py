"""Continuous-experiment benchmark sweep (port of
``scripts_tpu/run_continuous_experiment.py``).

Sweep (stim_freq x H) from a YAML config, simulate a continuous
experiment per cell of the grid, then for increasing subsample lengths
fit CAVIaR / CAVI-SnS / CoSaMP with and without NWD demixing, recording
weights and per-solver wall-clock into a JSON table.

Config keys (yaml/, the reference's schema):
  N, Hs, stim_freqs, expt_len (s), subsample_every (s), connection_prob,
  spont_rate, max_power_min_spike_rate, demixer.
"""

import argparse
import itertools
import json
import time

import numpy as np

from . import add_device_argument

SAMPLING_FREQ = 20000


def fit_all(psc, stim, N, iters, msrmp, powers=None, device=None):
    """CAVIaR and CAVI-SnS through ``Model.fit`` on ``device``, and the
    CoSaMP baseline (host numpy) on the integrated charge."""
    from ..model import Model
    from ..solvers import cosamp

    out = {}
    for method in ("caviar", "cavi_sns"):
        model = Model(N)
        opts = {"iters": iters, "save_histories": False}
        if method == "caviar":
            opts["msrmp"] = msrmp
            if powers is not None:
                # the rig's stimulation levels are experiment config:
                # passing them skips the per-fit level scan
                opts["powers"] = list(powers)
        model.fit(psc, stim, method=method, fit_options=opts, device=device)
        out[method] = {"mu": model.state["mu"].tolist(), "t": model.time}
    y = np.trapezoid(psc, axis=-1)
    A = (stim > 0).T.astype(float)
    t0 = time.time()
    w, _ = cosamp(A, y, max(int(0.1 * N), 1))
    out["cosamp"] = {"mu": w.tolist(), "t": time.time() - t0}
    return out


def main(argv=None):
    import yaml

    from ..demix.demixer import NeuralDemixer
    from ..simulation import simulate_continuous_experiment
    from ..utils.metrics import r2_score

    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch continuous", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--config", required=True)
    parser.add_argument("--save_dir", default=".")
    parser.add_argument("--token", default="cont")
    parser.add_argument("--iters", type=int, default=50)
    parser.add_argument("--seed", type=int, default=1)
    add_device_argument(parser)
    args = parser.parse_args(argv)

    with open(args.config) as fh:
        cfg = yaml.safe_load(fh)
    N = cfg["N"]
    powers = cfg.get("powers", [45, 55, 65])  # simulator default levels
    expt_len = int(cfg["expt_len"] * SAMPLING_FREQ)
    sub_every = int(cfg["subsample_every"] * SAMPLING_FREQ)
    demixer = (NeuralDemixer(path=cfg["demixer"], device=args.device)
               if cfg.get("demixer") else None)

    rows = []
    for stim_freq, H in itertools.product(cfg["stim_freqs"], cfg["Hs"]):
        np.random.seed(args.seed)
        expt = simulate_continuous_experiment(
            N=N, expt_len=expt_len, stim_freq=stim_freq, H=H,
            connection_prob=cfg["connection_prob"],
            spont_rate=cfg["spont_rate"],
            max_power_min_spike_rate=cfg["max_power_min_spike_rate"],
            powers=powers, device=args.device,
        )
        obs, stim = expt["obs_responses"], expt["stim_matrix"]
        stim_times = expt["stim_times"]

        for sub_len in range(sub_every, expt_len + 1, sub_every):
            keep = np.flatnonzero(stim_times < sub_len)
            psc_sub, stim_sub = obs[keep], stim[:, keep]
            variants = {"raw": psc_sub}
            if demixer is not None:
                variants["demixed"] = demixer(psc_sub, verbose=False)
            for tag, psc_v in variants.items():
                fits = fit_all(psc_v, stim_sub, N, args.iters,
                               cfg["max_power_min_spike_rate"],
                               powers=powers, device=args.device)
                for method, res in fits.items():
                    rows.append({
                        "stim_freq": stim_freq, "H": H,
                        "subsample_s": sub_len / SAMPLING_FREQ,
                        "K": int(keep.size), "input": tag, "method": method,
                        "seconds": res["t"],
                        "r2": r2_score(expt["weights"], np.asarray(res["mu"])),
                        "mu": res["mu"],
                    })
                    print(
                        f"freq={stim_freq} H={H} sub={sub_len // SAMPLING_FREQ}s "
                        f"{tag}/{method}: {res['t']:.2f}s r2={rows[-1]['r2']:.3f}"
                    )

    out = f"{args.save_dir}/continuous_expt_{args.token}.json"
    with open(out, "w") as f:
        json.dump(rows, f)
    print("Wrote", out)
