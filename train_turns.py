#!/usr/bin/env python3
"""One-device demixer training with the U-Net's resize as a product
with its weights (what ``circuitmap_torch/demix/unet._resize`` trains
with when ``torch.backends.cudnn.deterministic`` is set) against
``F.interpolate`` (what it trains with otherwise), in turns, in one
process, on one GPU. cuDNN keeps its default algorithms in both.

    python3 train_turns.py [--pairs 12800] [--turns 3]

Trains ``demixers/nwd_ie_ChroME2f.npz`` for one epoch (batch 64, lr
2e-3) on ``--pairs`` random pairs made from seed 0, each form in turn
(the order swaps every turn) after one warm epoch of each, then profiles
100 steps of each for its device time. Prints the card's name and power
limit, each turn's steps/s, and one JSON line.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pairs", type=int, default=12800)
    ap.add_argument("--turns", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("train_turns.py needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    from circuitmap_torch import NeuralDemixer
    from circuitmap_torch.demix import unet

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip(), flush=True)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((args.pairs, 900)).astype(np.float32) * 0.1
    y = np.maximum(x, 0) * 0.5
    batch = 64
    resize = unet._resize

    def product(h, size):
        return h @ unet._resize_weights(h.shape[-1], size, h.device, h.dtype)

    def interpolate(h, size):
        return F.interpolate(h, size=size, mode="linear",
                             align_corners=False)

    forms = {"product": product, "interpolate": interpolate}

    def epoch(form, rows=args.pairs):
        unet._resize = forms[form]
        try:
            d = NeuralDemixer(str(HERE / "demixers" / "nwd_ie_ChroME2f.npz"))
            d.training_data = (x[:rows], y[:rows])
            d.test_data = (x[:0], y[:0])
            torch.cuda.synchronize()
            t0 = time.time()
            d.train(epochs=1, learning_rate=2e-3, batch_size=batch,
                    verbose=False)
            torch.cuda.synchronize()
            return (rows // batch) / (time.time() - t0)
        finally:
            unet._resize = resize

    for form in forms:
        epoch(form)
    rec = {"steps_per_s": {form: [] for form in forms}, "device_ms_100": {}}
    for turn in range(args.turns):
        order = list(forms)[::-1] if turn % 2 else list(forms)
        got = {form: epoch(form) for form in order}
        for form, v in got.items():
            rec["steps_per_s"][form].append(v)
        print(f"turn {turn}: " + ", ".join(
            f"{form} {v:.1f} steps/s" for form, v in got.items()), flush=True)
    for form in forms:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            epoch(form, rows=100 * batch)
        rec["device_ms_100"][form] = sum(
            e.device_time for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
        print(f"{form}: 100 steps, device total "
              f"{rec['device_ms_100'][form]:.3f} ms", flush=True)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
