"""The main path of circuitmap_torch, timed: int4d2 demix + CAVIaR at
N=1000 / K=20000 on one GPU (``bench.py``'s pipeline, on the port).

``simulate(N=1000, trials=20000, H=10, connection_prob=0.05)`` at
``np.random.seed(0)``, the int4d2 trace wire with its QAT checkpoint
(``demixers/nwd_ie_ChroME2f_int4d2qat.npz``), then a 50-iteration
``caviar`` (msrmp 0.3, powers [45, 55, 65], 8 rows a sweep step). After
one warm-up, the end-to-end time is the best of 5 runs, each timed to a
host pull of the weights; the fit-only time the best of 5 fits of the
demixed traces already on the device.

Prints ONE JSON line: ``metric``, ``value`` (seconds), ``unit``, the
truth-R2 of the weights, the fit-only seconds and the card's name and
power limit (``nvidia-smi``). There is no ``vs_baseline``: bench.py
reckons that against BASELINE.json's 10 s, a target for a TPU v5e.

    python3 bench_torch.py [--small] [--device cpu]

``--small`` runs N=200 / K=2000 for a quick check; ``--device cpu`` runs
on the CPU (no kernel launches; not a measurement of the card).
"""

import argparse
import json
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CHECKPOINT = HERE / "demixers" / "nwd_ie_ChroME2f_int4d2qat.npz"
REPEATS = 5


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="N=200, K=2000 for quick local checks")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs without "
                         "a GPU)")
    args = ap.parse_args(argv)

    import torch

    from circuitmap_torch._device import resolve_device
    from circuitmap_torch.demix.demixer import NeuralDemixer
    from circuitmap_torch.model import default_priors
    from circuitmap_torch.scripts.run_scaling_study import device_label
    from circuitmap_torch.simulation import simulate
    from circuitmap_torch.solvers import caviar
    from circuitmap_torch.utils.metrics import r2_score

    dev = resolve_device(args.device)
    N, K = (200, 2000) if args.small else (1000, 20000)
    iters = 50
    np.random.seed(0)
    sim = simulate(N=N, trials=K, H=10, connection_prob=0.05, verbose=False,
                   batch_size=1000, device=dev)
    demixer = NeuralDemixer(path=str(CHECKPOINT), device=dev)
    priors = default_priors(N)

    def fit(traces):
        return caviar(traces, sim["stim_matrix"], priors["mu"],
                      priors["beta"], priors["shape"], priors["rate"],
                      priors["phi"], priors["phi_cov"], iters=iters,
                      msrmp=0.3, powers=[45.0, 55.0, 65.0],
                      sweep_block_size=8, verbose=False, device=dev)

    def pipeline():
        dem = demixer(sim["psc"], verbose=False, keep_on_device=True,
                      transfer_dtype="int4d2")
        return dem, fit(dem)

    def best_of(fn):
        best, out = float("inf"), None
        for _ in range(REPEATS):
            t0 = time.perf_counter()
            out = fn()
            np.asarray(torch.as_tensor(out[0]).cpu())  # the host pull waits
            best = min(best, time.perf_counter() - t0)
        return best, out

    dem, _ = pipeline()  # warm-up: kernel build, cuDNN plans, allocator
    elapsed, out = best_of(lambda: pipeline()[1])
    fit_only, _ = best_of(lambda: fit(dem))
    mu = np.asarray(torch.as_tensor(out[0]).cpu())
    record = {
        "metric": f"demix+caviar_fit_N{N}_K{K}_iters{iters}",
        "value": round(elapsed, 4),
        "unit": "seconds",
        "weight_recovery_r2": round(float(r2_score(sim["weights"], mu)), 4),
        "fit_only_seconds": round(fit_only, 4),
        "trace_wire": "int4d2",
        "device": device_label(dev),
    }
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
