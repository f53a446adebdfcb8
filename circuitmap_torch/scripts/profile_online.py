"""Steady-state ``OnlineCaviar.update()`` latency (port of
``scripts_tpu/profile_online.py``).

Closed-loop mapping cares about one number: how long after a block of
trials lands does the refreshed posterior come back? This measures the
full update path (host block prep + upload + insert + warm-started CAVI
iterations + the per-update reconnect scan) at steady state (fixed
capacity, kernels built), plus the ``posterior()`` readout pull, which
waits for the device.

    python -m circuitmap_torch profile-online [N] [block] [iters]
"""

import argparse
import json
import time

import numpy as np

from . import add_device_argument


def main(argv=None):
    from .. import OnlineCaviar, simulate
    from .._device import resolve_device
    from ..utils.metrics import r2_score

    ap = argparse.ArgumentParser(
        prog="python -m circuitmap_torch profile-online",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("N", type=int, nargs="?", default=500)
    ap.add_argument("block", type=int, nargs="?", default=256)
    ap.add_argument("iters", type=int, nargs="?", default=10)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    N, block, iters = args.N, args.block, args.iters
    n_blocks = 12

    np.random.seed(0)
    sim = simulate(N=N, trials=block * n_blocks, H=10,
                   connection_prob=0.05, verbose=False, batch_size=1000,
                   device=dev)

    # fixed capacity: no growth mid-measurement
    oc = OnlineCaviar(N, powers=[45.0, 55.0, 65.0],
                      capacity=block * n_blocks, device=dev)
    update_ms, readout_ms = [], []
    for b in range(n_blocks):
        sl = slice(b * block, (b + 1) * block)
        t0 = time.time()
        oc.update(sim["psc"][sl], sim["stim_matrix"][:, sl], iters=iters)
        # the posterior readout forces completion (update() ends in
        # queued device work; posterior() ends in a host pull)
        t1 = time.time()
        post = oc.posterior()
        t2 = time.time()
        update_ms.append((t1 - t0) * 1e3)
        readout_ms.append((t2 - t1) * 1e3)

    r2 = float(r2_score(sim["weights"], post["mu"]))
    # the honest closed-loop latency is update + readout
    total_ms = [u + r for u, r in zip(update_ms, readout_ms)]
    steady = sorted(total_ms[3:])  # skip the build/warm blocks
    print(json.dumps({
        "N": N, "block": block, "iters_per_update": iters,
        "blocks": n_blocks, "trials_total": block * n_blocks,
        "latency_ms_per_block": [round(u, 3) for u in total_ms],
        "steady_latency_ms_median": round(steady[len(steady) // 2], 3),
        "steady_latency_ms_best": round(steady[0], 3),
        "dispatch_ms_median": round(
            sorted(update_ms)[len(update_ms) // 2], 3),
        "final_r2_vs_truth": round(r2, 4),
        "device": str(dev),
    }))
