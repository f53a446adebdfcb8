"""Over-cliff sharded demonstration (port of
``scripts_tpu/over_cliff_sharded.py``) -> OVER_CLIFF_TORCH.json.

A fit whose [N, K] arrays outgrow one device's memory routes to the
trial-sharded solvers (``parallel/sharded.py``: every [.., K] array
partitions over the mesh). This script runs ``caviar_sharded`` at the
JAX script's shapes on a mesh of every visible card by default (it
raises without one); ``--devices`` takes any other mesh, one device per
shard: ``cuda:0`` repeated, or ``cpu`` eight times for the JAX script's
virtual CPU mesh, with host RAM standing in for device memory:

  leg A ("memory"): N=10000, K=100000 (the JAX package's recorded
    single-TPU out-of-memory shape), 2 iterations: wall time, process
    peak RSS and the per-shard bytes of one [N, K/D] float32 slice;
  leg B ("recovery"): N=2500, K=300000, 15 iterations, long enough to
    resolve a simulated circuit: weight-recovery R2.

Trials are synthesised at the charge level (a [K, 2] column pair (y, y)
integrates to exactly y) through the hologram structure: O(H K) host
work and no [K, 900] trace block. The payload names the backend, the
host and both single-device cliffs: the TPU v5e's (the JAX record,
6.8e8 elements of one [N, K_pad] array) and one H100's
(MEMORY_CLIFF_H100.json's largest N x K that fit). Both legs lie past
the TPU's cliff and inside the H100's.

    python -m circuitmap_torch.scripts.over_cliff_sharded [--quick]
        [--devices cpu cpu ...] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import time
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
TPU_CLIFF_ELEMENTS = 6.8e8  # the JAX record's single-TPU-v5e cliff


def synth_charge_experiment(N, K, H=10, seed=0, connection_prob=0.05):
    """Charge-level simulated mapping experiment (no dense trace block):
    (psc2 [K, 2] whose trapezoid is the charge, stim [N, K] float32 built
    column-sparse, weights [N]). Spiking follows a saturating power
    curve; charges add per-target contributions plus gaussian noise."""
    rng = np.random.default_rng(seed)
    w = np.zeros(N)
    conn = rng.random(N) < connection_prob
    w[conn] = rng.uniform(5.0, 35.0, conn.sum())
    powers = np.array([45.0, 55.0, 65.0])
    tgt = rng.integers(0, N, size=(H, K))
    pw = rng.choice(powers, size=K)
    p_spike = 1.0 / (1.0 + np.exp(-(0.12 * pw - 5.0)))  # ~0.6-0.9
    spk = rng.random((H, K)) < p_spike[None, :]
    y = (w[tgt] * spk).sum(axis=0) + 0.5 * rng.standard_normal(K)
    stim = np.zeros((N, K), dtype=np.float32)
    for h in range(H):
        stim[tgt[h], np.arange(K)] = pw
    psc2 = np.stack([y, y], axis=1).astype(np.float32)  # trapz == y
    return psc2, stim, w


def h100_cliff():
    """MEMORY_CLIFF_H100.json's largest N x K that fit one card, and its
    device label; (None, None) without the record."""
    try:
        record = json.loads((_REPO / "MEMORY_CLIFF_H100.json").read_text())
    except (OSError, ValueError):
        return None, None
    fits = [r["N"] * r["K"] for r in record["results"] if r.get("ok")]
    return (max(fits) if fits else None), record.get("device")


def run_leg(N, K, iters, mesh, cliff, seed=0):
    import torch

    from ..model import default_priors
    from ..parallel.sharded import caviar_sharded
    from ..utils.metrics import r2_score

    t0 = time.time()
    psc2, stim, w = synth_charge_experiment(N, K, seed=seed)
    t_sim = time.time() - t0
    pri = default_priors(N)
    t0 = time.time()
    out = caviar_sharded(
        psc2, stim, pri["mu"], pri["beta"], pri["shape"], pri["rate"],
        pri["phi"], pri["phi_cov"], mesh, iters=iters, verbose=False,
        powers=[45.0, 55.0, 65.0], msrmp=0.3)
    mu = torch.as_tensor(out[0]).cpu().numpy()  # the pull ends the fit
    wall = time.time() - t0
    if not np.isfinite(mu).all():
        raise AssertionError(f"N={N} K={K}: a non-finite weight")
    k_pad = -(-K // 128) * 128  # the TPU's lane padding, for its cliff
    return dict(
        N=N, K=K, iters=iters, elements_nk=int(N) * int(K),
        over_tpu_cliff=bool(N * k_pad > TPU_CLIFF_ELEMENTS),
        over_h100_cliff=None if cliff is None else bool(N * K > cliff),
        sim_s=round(t_sim, 1), fit_wall_s=round(wall, 1),
        per_shard_nk_mb=round(N * (-(-K // mesh.size)) * 4 / 1e6, 1),
        peak_rss_gb=round(
            resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6, 2),
        r2=round(float(r2_score(w, mu)), 4),
    )


def main(argv=None):
    import torch

    from ..parallel.mesh import trial_mesh

    ap = argparse.ArgumentParser(
        prog="python -m circuitmap_torch.scripts.over_cliff_sharded",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="tiny shapes to smoke the harness")
    ap.add_argument("--devices", nargs="+", default=None,
                    help="the mesh, one device per shard (default every "
                         "visible card; e.g. cuda:0 cuda:0, or cpu eight "
                         "times for host RAM in place of device memory)")
    ap.add_argument("--out", default="OVER_CLIFF_TORCH.json")
    args = ap.parse_args(argv)

    mesh = trial_mesh(devices=args.devices)
    cliff, cliff_device = h100_cliff()
    host = {"cpus": os.cpu_count(),
            "mem_gb": round(os.sysconf("SC_PAGE_SIZE")
                            * os.sysconf("SC_PHYS_PAGES") / 1e9, 1)}
    cards = sorted({torch.cuda.get_device_name(d) for d in mesh.distinct
                    if d.type == "cuda"})
    backend = (f"{' + '.join(cards) or 'cpu'} ({mesh.size} shards, "
               f"{len(mesh.distinct)} distinct devices, one process)")
    legs = ([(100, 2000, 3), (50, 1500, 3)] if args.quick
            else [(2500, 300000, 15),     # recovery, past the TPU cliff
                  (10000, 100000, 2)])    # the JAX record's OOM shape
    rows = []
    for N, K, iters in legs:
        row = run_leg(N, K, iters, mesh, cliff)
        rows.append(row)
        print(json.dumps(row), flush=True)
        payload = dict(mesh_devices=[str(d) for d in mesh.devices],
                       backend=backend, host=host,
                       cliff_elements_tpu_v5e=TPU_CLIFF_ELEMENTS,
                       cliff_elements_h100=cliff,
                       cliff_h100_device=cliff_device, results=rows)
        with open(f"{args.out}.tmp", "w") as fh:
            json.dump(payload, fh, indent=1)
            fh.write("\n")
        os.replace(f"{args.out}.tmp", args.out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
