"""Trace-wire quantisation fidelity study (port of
``scripts_tpu/wire_fidelity_study.py``).

Does a compressed trace wire preserve weight-recovery R^2? Protocol (the
JAX study's): quantise simulated N=200/K=2000 PSC blocks to each wire
format host-side (per-trace peak scale, as the demixer's transfer_dtype
path does), demix, fit CAVIaR (50 iterations, msrmp 0.3), compare
truth-R^2 across seeds, for the stock checkpoint and the QAT ones.
``quantise`` is the JAX script's, so both studies feed the networks the
same codes. The JAX study pins the CPU; this one runs on the card by
default. Writes WIRE_STUDY_H100.json (the JAX record's keys).

    python -m circuitmap_torch wire-study [--seeds 0 1 2] [--out FILE]
"""

import argparse
import json
import os

import numpy as np

from . import add_device_argument

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def quantise(psc, bits, mulaw=False):
    """Per-trace-peak linear (or mu-law) quantisation, matching the
    demixer transfer_dtype wire semantics."""
    peak = np.abs(psc).max(axis=1, keepdims=True)
    peak = np.where(peak > 0, peak, 1.0)
    x = psc / peak
    qmax = 2 ** (bits - 1) - 1
    if mulaw:
        mu = 15.0
        y = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
        q = np.rint(y * qmax) / qmax
        x = np.sign(q) * np.expm1(np.abs(q) * np.log1p(mu)) / mu
    else:
        x = np.rint(x * qmax) / qmax
    return (x * peak).astype(np.float32)


def main(argv=None):
    from .. import simulation
    from .._device import resolve_device
    from ..demix.demixer import NeuralDemixer, wire_transform
    from ..model import Model
    from ..utils.metrics import r2_score

    ap = argparse.ArgumentParser(
        prog="python -m circuitmap_torch wire-study",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="*", default=[0, 1, 2])
    ap.add_argument("--out",
                    default=os.path.join(REPO, "WIRE_STUDY_H100.json"))
    add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    ck = os.path.join(REPO, "demixers", "nwd_ie_ChroME2f.npz")
    ck_qat = os.path.join(REPO, "demixers", "nwd_ie_ChroME2f_int4qat.npz")
    ck_d2 = os.path.join(REPO, "demixers",
                         "nwd_ie_ChroME2f_int4d2qat.npz")
    rows = []
    for seed in args.seeds:
        np.random.seed(seed)
        sim = simulation.simulate(N=200, trials=2000, H=10,
                                  connection_prob=0.05, verbose=False,
                                  device=dev)
        N = sim["stim_matrix"].shape[0]
        dem = NeuralDemixer(ck, device=dev)
        dem_qat = (NeuralDemixer(ck_qat, device=dev)
                   if os.path.exists(ck_qat) else None)
        dem_d2 = (NeuralDemixer(ck_d2, device=dev)
                  if os.path.exists(ck_d2) else None)
        configs = [
            ("f32", dem, sim["psc"]),
            ("int8", dem, quantise(sim["psc"], 8)),
            ("int4", dem, quantise(sim["psc"], 4)),
            ("int4-mulaw", dem, quantise(sim["psc"], 4, mulaw=True)),
            ("int4d2", dem, wire_transform(sim["psc"], 4, decimate=2)),
        ]
        if dem_qat is not None:
            configs.append(("int4-qat", dem_qat, quantise(sim["psc"], 4)))
        if dem_d2 is not None:
            configs.append(
                ("int4d2-qat", dem_d2,
                 wire_transform(sim["psc"], 4, decimate=2)))
        for tag, net, psc_in in configs:
            d = net(psc_in, verbose=False)
            m = Model(N)
            m.fit(d, sim["stim_matrix"], method="caviar", device=dev,
                  fit_options={"iters": 50, "msrmp": 0.3, "verbose": False,
                               "powers": [45.0, 55.0, 65.0], "seed": 0})
            r2 = float(r2_score(sim["weights"], m.state["mu"]))
            rows.append({"seed": seed, "wire": tag, "truth_r2": round(r2, 4)})
            print(rows[-1], flush=True)

    summary = {}
    for tag in ("f32", "int8", "int4", "int4-mulaw", "int4-qat",
                "int4d2", "int4d2-qat"):
        vals = [r["truth_r2"] for r in rows if r["wire"] == tag]
        if vals:
            summary[tag] = {"mean_r2": round(float(np.mean(vals)), 4),
                            "min_r2": min(vals)}
    verdict = {
        "protocol": "per-trace-peak quantisation -> NWD demix -> CAVIaR "
                    "(N=200 K=2000, 50 iters, msrmp 0.3), truth-R2, "
                    f"on {dev}",
        "rows": rows,
        "summary": summary,
        "conclusion": "mean truth-R2 by wire, best first: " + ", ".join(
            f"{tag} {v['mean_r2']}" for tag, v in sorted(
                summary.items(), key=lambda kv: -kv[1]["mean_r2"])),
    }
    with open(args.out, "w") as fh:
        json.dump(verdict, fh, indent=2)
    print("wrote", args.out)
    print(json.dumps(summary, indent=2))
