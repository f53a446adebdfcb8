#!/usr/bin/env python3
"""Readings for the limits of a cell's compared numbers, on the card.

    python3 benchmarks/control.py --workload <cell> --seeds 1 2 3 ...

For each seed, in one process: the cell's data, one request of the
program through the cell's own driver (after one warm request), and the
control, the request kind's ``control`` (for ``map``: the plain
reference computed in float32 with TF32 on) in the program's place;
both judged against the float64 reference as a run judges the program. Prints one JSON line per seed and side, with every
compared number. The lower reading of a limit is the largest that the
program gives over the seeds, the upper the smallest that the control
gives.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["CIRCUITMAP_TORCH_BUILD_DIR"] = os.path.join(
    ROOT, "circuitmap_torch", "_build")
sys.path[:0] = [ROOT, os.path.join(ROOT, "benchmarks")]

import argparse  # noqa: E402
import json  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=None,
                    help="run the control on the first this many seeds")
    args = ap.parse_args()

    import torch

    from cmbench import harness
    from cmbench.spans import Spans

    spec = harness.Spec(ROOT, args.workload)
    cfg, traffic = spec.config, spec.traffic
    K = harness.kind(traffic)
    device = "cuda"
    if not torch.cuda.is_available():
        raise SystemExit("error: no CUDA device")
    for seed in args.seeds:
        t0 = time.perf_counter()
        data = K.make_data(cfg, seed, device, ROOT)
        drv = K.Driver(cfg, traffic, data, device, ROOT, {})
        keeper = harness.Keeper(seed, K.BIG)
        drv.request(Spans(False))  # warm
        keeper.add(drv.request(Spans(False)))
        drv.close()
        del drv
        torch.cuda.empty_cache()
        rows = [("program", keeper.small, keeper.sampled())]
        if args.control_seeds is None or \
                args.seeds.index(seed) < args.control_seeds:
            rows.append(("control", *K.control(cfg, traffic, data, device)))
        ref = K.reference(cfg, traffic, data, device)
        for side, small, sampled in rows:
            nums = K.numbers(cfg, traffic, ref, small, sampled)
            print(json.dumps({"seed": seed, "side": side, "numbers": nums,
                              "s": round(time.perf_counter() - t0, 1)}),
                  flush=True)
        del data
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
