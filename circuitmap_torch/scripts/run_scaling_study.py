"""Scaling study: the demix + CAVIaR pipeline across problem sizes (port
of ``scripts_tpu/run_scaling_study.py``).

Measures, on the card, the end-to-end wall time (demix on the int4 wire
with the QAT checkpoint + a 50-iteration CAVIaR fit, timed to its host
pull) and the truth-recovery R2 at a grid of (N neurons, K trials).
Every shape includes full simulation ground truth, so the R2 column is
a recovery measurement, not a smoke test. Writes SCALING_H100.json
(the JAX package's SCALING.json keys; ``device`` names the card and its
power limit) and prints a markdown table.

    python -m circuitmap_torch scaling-study [--quick] [--only N,K[,H]]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from . import add_device_argument


def device_label(dev):
    """The card's name and power limit (nvidia-smi), or the device."""
    if dev.type != "cuda":
        return str(dev)
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[dev.index or 0]


def main(argv=None):
    from .._device import resolve_device
    from ..demix.demixer import NeuralDemixer
    from ..model import default_priors
    from ..simulation import simulate
    from ..solvers import caviar
    from ..utils.metrics import r2_score

    ap = argparse.ArgumentParser(
        prog="python -m circuitmap_torch scaling-study",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="small grid for smoke-testing the harness")
    ap.add_argument("--out", default="SCALING_H100.json")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--only", action="append", default=None,
                    metavar="N,K[,H]",
                    help="run only these N,K[,H] rows (repeatable; H "
                         "defaults to 10 targets/trial); merged into "
                         "an existing --out file by (N, K, H)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    grid = (
        [(100, 5000), (300, 20000)]
        if args.quick
        else [(100, 5000), (300, 5000), (300, 20000), (1000, 20000),
              (2000, 20000), (1000, 50000), (5000, 20000),
              (1000, 100000)]
    )
    if args.only:
        grid = [tuple(int(v) for v in spec.split(",")) for spec in args.only]
    grid = [g if len(g) == 3 else (*g, 10) for g in grid]

    # the JAX study's wire: int4 + the QAT checkpoint (WIRE_STUDY)
    qat = "demixers/nwd_ie_ChroME2f_int4qat.npz"
    use_qat = os.path.exists(qat)
    demixer = NeuralDemixer(path=qat if use_qat
                            else "demixers/nwd_ie_ChroME2f.npz", device=dev)
    wire = "int4" if use_qat else "int8"
    device = device_label(dev)
    # merge by (N, K, H) into an existing file, and write after every
    # row: a crash on a late row must not discard the earlier ones
    try:
        with open(args.out) as f:
            results = json.load(f).get("results", [])
    except (OSError, ValueError):
        results = []

    def _write():
        payload = dict(device=device, iters=50, wire=wire, results=results)
        with open(args.out, "w") as f:
            json.dump(payload, f, indent=1)

    for N, K, H in grid:
        np.random.seed(0)
        t0 = time.time()
        sim = simulate(N=N, trials=K, H=H, connection_prob=0.05,
                       verbose=False, batch_size=1000, device=dev)
        t_sim = time.time() - t0
        priors = default_priors(N)

        def run():
            dem = demixer(sim["psc"], verbose=False, keep_on_device=True,
                          transfer_dtype=wire)
            return caviar(
                dem, sim["stim_matrix"], priors["mu"], priors["beta"],
                priors["shape"], priors["rate"], priors["phi"],
                priors["phi_cov"], iters=50, msrmp=0.3,
                powers=[45.0, 55.0, 65.0], verbose=False, device=dev,
            )

        t0 = time.time()
        out = run()
        out[0][:1].cpu()  # the host pull waits for the device
        t_cold = time.time() - t0

        best = np.inf
        for _ in range(args.repeats):
            t0 = time.time()
            out = run()
            out[0][:1].cpu()
            best = min(best, time.time() - t0)

        r2 = float(r2_score(sim["weights"], out[0].cpu().numpy()))
        row = dict(N=N, K=K, H=H, seconds=round(best, 4),
                   cold_seconds=round(t_cold, 2), r2=round(r2, 4),
                   sim_gen_seconds=round(t_sim, 2),
                   # per-row: --only merges can mix wire protocols
                   wire=wire)
        results = [r for r in results
                   if (r["N"], r["K"], r.get("H", 10)) != (N, K, H)] + [row]
        _write()
        print(json.dumps(row), flush=True)

    print("\n| N | K | demix+fit (s) | truth R² |")
    print("|---|---|---|---|")
    for r in results:
        print(f"| {r['N']} | {r['K']} | {r['seconds']} | {r['r2']} |")
