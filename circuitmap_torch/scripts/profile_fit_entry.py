"""Stage-by-stage wall breakdown of the main map's fit (port of
``scripts_tpu/profile_fit_entry.py``).

The fit-only time of the main path (``Model.fit`` on demixed device
traces, N=1000, K=20000, 50 iterations) is split into its stages as
``caviar()`` runs them: the observations (trace cast and activity mask),
the stim upload and init, the 50-iteration loop, the reconnect scan, and
the results' pull to the host. Each stage is closed by
``torch.cuda.synchronize`` (on the GPU), so a stage's time is its own
and no round-trip floor has to be subtracted; the floor of a bare
synchronised pull is still measured, for the JAX script's record keys.
The whole public fit (best of 4, same data) is timed beside the staged
sum.

Writes one JSON line to stdout. Run alone (a concurrent process on the
card or the host shifts every number).
"""

import argparse
import json
import time

import numpy as np

from . import add_device_argument

MAIN_MAP = dict(N=1000, K=20000, iters=50)  # the JAX script's shape


def main(argv=None):
    import torch

    from .._device import resolve_device
    from ..demix.demixer import NeuralDemixer
    from ..model import default_priors
    from ..simulation import simulate
    from ..solvers import caviar
    from ..solvers._common import (prepare_stim_and_init, prepare_traces,
                                   stim_upload_plan)
    from ..solvers.caviar import (_as, _reconnect_and_refit, _resolve_sweep,
                                  _run_caviar, power_counts_of,
                                  prepare_observations, seeded_generator)

    ap = argparse.ArgumentParser(
        prog="python -m circuitmap_torch profile-fit", description=__doc__)
    add_device_argument(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    N, K, iters = MAIN_MAP["N"], MAIN_MAP["K"], MAIN_MAP["iters"]

    def settle():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    np.random.seed(0)
    sim = simulate(N=N, trials=K, H=10, connection_prob=0.05,
                   verbose=False, batch_size=1000, device=dev)
    demixer = NeuralDemixer(path="demixers/nwd_ie_ChroME2f.npz", device=dev)
    priors = default_priors(N)
    dem = demixer(sim["psc"], verbose=False, keep_on_device=True,
                  transfer_dtype=np.int8)
    settle()

    # the floor: a one-element pull of a settled device tensor
    small = torch.ones(8, device=dev)
    rtts = []
    for _ in range(5):
        t0 = time.time()
        small[:1].cpu()
        rtts.append(time.time() - t0)

    dtype = torch.float32
    powers = [45.0, 55.0, 65.0]

    def run_once():
        t = {}
        t0 = time.time()
        y_psc = prepare_traces(dem, dtype, dev)
        y, active = prepare_observations(y_psc, 1e-2)
        settle()
        t["observations"] = time.time() - t0

        t0 = time.time()
        stim_np, plan = stim_upload_plan(sim["stim_matrix"], powers)
        stim_t, lam_mask, lam0, _, _, powers_dev_np, _ = (
            prepare_stim_and_init(stim_np, active, dtype, dev, plan))
        powers_t = _as(powers_dev_np, dtype, dev)
        hyper = tuple(_as(priors[k], dtype, dev) for k in (
            "mu", "beta", "shape", "rate", "phi", "phi_cov"))
        counts = power_counts_of(stim_t, powers_t, dtype)
        settle()
        t["stim_prep"] = time.time() - t0

        t0 = time.time()
        final, _, _ = _run_caviar(
            y, stim_t, lam0, lam_mask, powers_t, counts, hyper,
            [seeded_generator(0, dev)], iters=iters, num_mc_samples=100,
            minimum_spike_count=3, delay_spont_est=1, msrmp=0.3,
            scale_factor=0.75, penalty=5e0, max_backtrack_iters=20,
            tol=0.05, spont_orthogonality=0.1, analytic_mc=False,
            save_histories=False,
            # resolve EXACTLY like the public entry
            sweep_block_size=_resolve_sweep("auto", "auto", dev, k=K),
            update_order="random", track_elbo=False, elbo_tol=None)
        settle()
        t["fit_scan"] = time.time() - t0

        mu, beta, lam, shape, rate, phi, phi_cov, z, _ = final
        t0 = time.time()
        out = _reconnect_and_refit(stim_t, lam, mu, beta, z, powers_t, phi,
                                   phi_cov, hyper[4], hyper[5], 0.3, 3.0)
        settle()
        t["reconnect"] = time.time() - t0

        t0 = time.time()
        for a in (*out[:6], shape, rate):
            a.cpu().numpy()
        t["pull"] = time.time() - t0
        return t

    run_once()  # warm: kernel build, library handles, allocator pools
    best = {}
    for _ in range(3):
        t = run_once()
        for k, v in t.items():
            best[k] = min(best.get(k, float("inf")), v)

    # the whole public fit on the same data (best of 4), pulled to the host
    whole = float("inf")
    for _ in range(4):
        t0 = time.time()
        outw = caviar(dem, sim["stim_matrix"], priors["mu"], priors["beta"],
                      priors["shape"], priors["rate"], priors["phi"],
                      priors["phi_cov"], iters=iters, msrmp=0.3,
                      powers=powers, verbose=False, sweep_block_size=8,
                      device=dev)
        np.asarray(outw[0].cpu())
        whole = min(whole, time.time() - t0)

    print(json.dumps({
        "rtt_floor_ms": round(min(rtts) * 1e3, 3),
        "rtt_all_ms": [round(r * 1e3, 3) for r in rtts],
        "stages_best_ms": {k: round(v * 1e3, 3) for k, v in best.items()},
        "staged_sum_ms": round(sum(best.values()) * 1e3, 3),
        "whole_fit_ms": round(whole * 1e3, 3),
        "device": str(dev),
    }))
