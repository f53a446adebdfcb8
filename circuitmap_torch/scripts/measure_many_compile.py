"""Measure ``caviar_many``'s cold and warm cost per compile_mode (port of
``scripts_tpu/measure_many_compile.py``).

In the JAX package a first ``caviar_many`` call paid XLA's compile of
the vmapped scan (minutes on the TPU). The port compiles nothing per
shape; its first call in a process pays the CUDA kernel library's nvcc
build when the build directory is cold (~30 s on an H100 host), the
CUDA context and library load, and the caching allocator's first
allocations. This script measures both modes in a fresh subprocess
each: cold = the first call, with an empty build directory of its own
(nvcc included; ``--warm-only`` keeps the current build directory, so
only the process's own set-up remains); warm = the second call in that
process. Writes COMPILE_STUDY_H100.json (the JAX record's keys).

    python -m circuitmap_torch compile-study [--warm-only] [--out FILE]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

from . import add_device_argument

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SIZE = dict(B=8, N=300, K=2000, iters=50)  # the JAX study's protocol

_WORKER = r"""
import os, sys, time, json
import numpy as np
sys.path.insert(0, %(repo)r)
mode, device = %(mode)r, %(device)r
import torch
from circuitmap_torch.model import default_priors
from circuitmap_torch.simulation import simulate
from circuitmap_torch.solvers import caviar_many

np.random.seed(0)
sim = simulate(N=%(N)d, trials=%(K)d, H=10, connection_prob=0.05,
               verbose=False, device="cpu")
B = %(B)d
pscs = np.stack([sim["psc"]] * B)
stims = np.stack([sim["stim_matrix"]] * B)
p = default_priors(%(N)d)
args = (pscs, stims, p["mu"], p["beta"], p["shape"], p["rate"], p["phi"],
        p["phi_cov"])
kw = dict(iters=%(iters)d, msrmp=0.3, seeds=list(range(B)), verbose=False,
          compile_mode=mode, device=device)

times = []
for rep in range(4):
    t0 = time.time()
    out = caviar_many(*args, **kw)  # results come back on the host
    times.append(time.time() - t0)
print("RESULT " + json.dumps({"mode": mode, "cold_s": round(times[0], 3),
                              "warm_s": round(times[1], 3),
                              "times": [round(t, 3) for t in times]}),
      flush=True)
"""


def main(argv=None):
    from .._device import resolve_device
    from ..ops._build import BUILD_DIR_ENV

    ap = argparse.ArgumentParser(
        prog="python -m circuitmap_torch compile-study",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--out",
                    default=os.path.join(REPO, "COMPILE_STUDY_H100.json"))
    ap.add_argument("--warm-only", action="store_true",
                    help="keep the current build directory (no nvcc in "
                         "the cold call)")
    add_device_argument(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    results = []
    for mode in ("sequential", "batched"):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
        with tempfile.TemporaryDirectory() as cold:
            if not args.warm_only:
                env[BUILD_DIR_ENV] = cold
            t0 = time.time()
            proc = subprocess.run(
                [sys.executable, "-c", _WORKER % dict(
                    repo=REPO, mode=mode, device=str(device), **SIZE)],
                env=env, capture_output=True, text=True, timeout=3600)
        if proc.returncode != 0:
            print(proc.stdout[-2000:], proc.stderr[-2000:])
            raise RuntimeError(f"{mode} worker failed")
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT ")][-1]
        rec = json.loads(line[len("RESULT "):])
        rec["wall_s"] = round(time.time() - t0, 1)
        results.append(rec)
        print(rec, flush=True)

    cold = ("the current build directory" if args.warm_only
            else "an empty build directory (nvcc included)")
    out = {
        "config": "B={B} N={N} K={K} iters={iters}, ".format(**SIZE)
                  + f"{device}, cold = first call in a fresh process "
                    f"with {cold}, warm = the second call (results on "
                    "the host)",
        "results": results,
    }
    with open(args.out, "w") as fh:
        json.dump(out, fh, indent=2)
    print(f"wrote {args.out}")
