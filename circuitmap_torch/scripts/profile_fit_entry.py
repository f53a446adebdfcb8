"""Stage breakdown of the main map's fit (port of
``scripts_tpu/profile_fit_entry.py``).

The fit-only time of the main path (``Model.fit`` on demixed device
traces, N=1000, K=20000, 50 iterations) is split into the fit's own
spans (``utils/profiling.py``), reported under the JAX script's stage
names: ``cm.fit.traces`` (observations: the trace cast and activity
mask), ``cm.fit.stim`` (stim_prep: the stim's sparsify, upload and
init), ``cm.fit.loop`` (fit_scan: the 50 iterations), ``cm.fit.scan``
(reconnect: the reconnection scan) and ``cm.fit.pull`` (pull: the
results to the host). Three warm fits run under ``profiling.trace``;
for each stage the record gives its spans' best host ms a fit
(``stages_best_ms``; the stim stage is two spans a fit, summed) and the
mean device ms a fit of the work launched under them
(``stages_device_ms``, from ``key_averages()``; 0 on the CPU). A span
never synchronises: a stage's host ms is the host's time in it, so the
device may still run a stage's work after the span closes, and a stage
that reads the device (the pull) holds the wait for it. The whole
public ``Model.fit``, its pull of every posterior field to the host
included (best of 4, untraced), is timed beside the spans' sum
(``whole_fit_ms``), and the floor of a bare synchronised pull is
measured for the JAX script's record keys.

Writes one JSON line to stdout. Run alone (a concurrent process on the
card or the host shifts every number).
"""

import argparse
import json
import tempfile
import time

import numpy as np

from . import add_device_argument

MAIN_MAP = dict(N=1000, K=20000, iters=50)  # the JAX script's shape
# the JAX script's stage names -> the fit's spans
STAGES = {"observations": "cm.fit.traces", "stim_prep": "cm.fit.stim",
          "fit_scan": "cm.fit.loop", "reconnect": "cm.fit.scan",
          "pull": "cm.fit.pull"}
TRACED_FITS = 3


def main(argv=None):
    import torch

    from .._device import resolve_device
    from ..demix.demixer import NeuralDemixer
    from ..model import Model
    from ..simulation import simulate
    from ..utils import profiling

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
    dem = demixer(sim["psc"], verbose=False, keep_on_device=True,
                  transfer_dtype=np.int8)
    settle()

    # the floor: a one-element pull of a settled device tensor
    small = torch.ones(8, device=dev)
    rtts = []
    for _ in range(5):
        t0 = time.perf_counter()
        small[:1].cpu()
        rtts.append(time.perf_counter() - t0)

    def fit():
        return Model(N).fit(dem, sim["stim_matrix"], device=dev,
                            fit_options=dict(iters=iters, msrmp=0.3,
                                             powers=[45.0, 55.0, 65.0],
                                             verbose=False))

    fit()  # warm: kernel build, library handles, allocator pools
    with tempfile.TemporaryDirectory() as tmp, \
            profiling.trace(tmp) as prof:
        for _ in range(TRACED_FITS):
            fit()
        settle()
    events = prof.events()
    fits = [e.time_range for e in events if e.name == "cm.fit"]
    totals = {k.key: k for k in prof.key_averages()}
    best, device = {}, {}
    for stage, name in STAGES.items():
        # a stage's spans summed a fit (the stim stage opens two)
        best[stage] = min(
            sum(e.time_range.elapsed_us() for e in events
                if e.name == name and f.start <= e.time_range.start < f.end)
            for f in fits) / 1e3
        device[stage] = (getattr(totals[name], "device_time_total", 0.0)
                         / len(fits) / 1e3)

    # the whole public fit on the same data (best of 4), on the host
    whole = float("inf")
    for _ in range(4):
        t0 = time.perf_counter()
        fit()
        whole = min(whole, time.perf_counter() - t0)

    print(json.dumps({
        "rtt_floor_ms": round(min(rtts) * 1e3, 3),
        "rtt_all_ms": [round(r * 1e3, 3) for r in rtts],
        "stages_best_ms": {k: round(v, 3) for k, v in best.items()},
        "stages_device_ms": {k: round(v, 3) for k, v in device.items()},
        "staged_sum_ms": round(sum(best.values()), 3),
        "whole_fit_ms": round(whole * 1e3, 3),
        "device": str(dev),
    }))
