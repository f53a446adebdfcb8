#!/usr/bin/env python3
"""The blocked spike sweep (B1) of this checkout against another
checkout's, in turns, on one GPU.

    git archive <commit> | tar -x -C _scratch/parent
    python3 sweep_turns.py _scratch/parent [--rows 8] [--reps 20]

Both kernels are built from their own ``circuitmap_torch/csrc`` (each
checkout's ``ops/_build.py``) and launched through their C entry points
on the same prepared inputs (the main path's shape,
``chip_smoke.sweep_inputs``: N=1000, K=20000, three power levels) at
``--rows`` rows a step with the gate on, each with its own launch plan
(the other checkout's ``cluster_plan`` at 16 CTAs). The two outputs are
compared; then each kernel's device time is taken in turns, other,
this, this, other, other, this: CUDA events around ``--reps`` launches enqueued back
to back (one launch queues far faster than it runs, so no host time is
inside), divided by their count. The same host work precedes every
launch on both sides. Prints the card's name and power limit, then one
JSON line.
"""

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="an unpacked checkout")
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("# sweep_turns.py needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import chip_smoke as cs
    from circuitmap_torch.ops import _build, sweep_cuda as sc

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    pkg = args.other.resolve() / "circuitmap_torch"
    other_build = load("other_build", pkg / "ops" / "_build.py")
    # its plan function only (the relative imports resolve to this
    # checkout's helpers, which the plan does not use)
    other_sc = load("circuitmap_torch.ops.other_sweep_cuda",
                    pkg / "ops" / "sweep_cuda.py")
    other_lib, lib = other_build.library(), _build.library()

    a = cs.sweep_inputs(block=args.rows)
    N, K, P, rows = cs.N, cs.K, len(cs.POWERS), args.rows
    plans = {"other": other_sc.cluster_plan(1, K, rows, P, 16),
             "this": sc.launch_plan(1, K, rows, P)}
    libs = {"other": (other_lib, other_build), "this": (lib, _build)}
    steps = a["border"][None].to(torch.int32).contiguous()

    def prepared(side):
        """A launch of ``side``'s kernel on freshly prepared arguments
        (r = mu @ lam is the kernel's scratch), and its output."""
        arrays, scalars, r = sc._kernel_args(
            *sc._expt_axis(a["y"], a["stim"], a["mu"], a["beta"], a["lam"]),
            0.1, *sc._expt_axis(a["m0"], a["m1"], a["lam_mask"]),
            a["powers"], a["power_counts"][None], 0.35, 3.0, 1.0, "sweep")
        out = torch.empty_like(arrays[3])
        plan, (clib, build) = plans[side], libs[side]

        def launch():
            err = clib.cm_sweep_cluster_f32(
                *(t.data_ptr() for t in arrays), steps.data_ptr(),
                scalars.data_ptr(), r.data_ptr(), out.data_ptr(), None, None,
                1, N, K, P, steps.shape[1], rows, rows, 1, plan.cluster,
                plan.cols,
                int(plan.on_chip), plan.depth, plan.smem_bytes,
                torch.cuda.current_stream().cuda_stream)
            build.check(clib, err, f"{side} sweep")

        return launch, out

    outs = {}
    for side in plans:
        launch, out = prepared(side)
        launch()
        outs[side] = out[0]
    diff = (outs["other"] - outs["this"]).abs().max().item()

    def device_ms(launch):
        for _ in range(3):
            launch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            launch()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    times = {"other": [], "this": []}
    launches = {side: prepared(side)[0] for side in plans}
    for turn in ("other", "this", "this", "other", "other", "this"):
        times[turn].append(device_ms(launches[turn]))
    print(json.dumps({
        "rows": rows, "N": N, "K": K, "P": P, "max_abs_diff": diff,
        "other_plan": plans["other"]._asdict(),
        "this_plan": plans["this"]._asdict(),
        "other_ms": times["other"], "this_ms": times["this"],
        "other_median_ms": statistics.median(times["other"]),
        "this_median_ms": statistics.median(times["this"])}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
