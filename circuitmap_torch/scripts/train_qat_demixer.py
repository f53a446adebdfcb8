"""Quantisation-aware fine-tune of an NWD demixer for the int4 trace
wires (port of ``scripts_tpu/train_qat_demixer.py``).

The int4 trace wire (``transfer_dtype="int4"``) halves the host-to-GPU
upload against int8, but a stock checkpoint never saw its quantisation
staircase. Fine-tuning on int4-quantised inputs (targets stay clean)
teaches the demixer to treat the quantisation floor as one more noise
source. ``--decimate 2`` trains for the int4d2 wire (mean-pool 2x, the
device's linear upsample).

Protocol: the dataset generator and presets of ``train-demixer``,
inputs quantised with the exact wire rule (``wire_transform``: per-trace
abs-peak / (2^{bits-1}-1), round-to-nearest, clip), SGD/MSE fine-tune
from the pretrained checkpoint. Writes the checkpoint and
``<out>.meta.json``.

Usage:
  python -m circuitmap_torch train-qat-demixer --epochs 150 --size 50000 \
      --pretrained demixers/nwd_ie_ChroME2f.npz \
      --out demixers/nwd_ie_ChroME2f_int4qat.npz
"""

import argparse
import json
import time
from pathlib import Path

from .train_demixer import training_data_kwargs

# the checkout's demixers/ (the defaults of --pretrained and --out)
DEMIXERS = Path(__file__).resolve().parents[2] / "demixers"


def wire_quantise(traces, bits=4, decimate=1):
    """The trace-wire transform on the host (``wire_transform``), so the
    corruption the network trains on is the transform the device
    reconstructs at serve time (the int4d2 mean-pool and linear upsample
    when ``decimate=2``)."""
    from ..demix.demixer import wire_transform

    return wire_transform(traces, bits=bits, decimate=decimate)


def device_name(device):
    """The card's name for a CUDA device, else the device's string."""
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return str(device)


def main(argv=None):
    from ..demix.demixer import NeuralDemixer

    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch train-qat-demixer",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--size", type=int, default=50000)
    parser.add_argument("--epochs", type=int, default=150)
    parser.add_argument("--bits", type=int, default=4)
    parser.add_argument("--decimate", type=int, default=1,
                        help="2 = the int4d2 wire (mean-pool 2x + "
                             "device upsample): quarter of the int8 "
                             "bytes")
    parser.add_argument("--learning_rate", type=float, default=2e-3)
    parser.add_argument("--pretrained",
                        default=str(DEMIXERS / "nwd_ie_ChroME2f.npz"))
    parser.add_argument("--preset", default="chrome2f_ie")
    parser.add_argument("--out",
                        default=str(DEMIXERS / "nwd_ie_ChroME2f_int4qat.npz"))
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--cpu", action="store_true",
                        help="train on the CPU (small-scale probes); "
                             "the same as --device cpu")
    parser.add_argument("--device", default=None,
                        help="torch device of the training (default cuda)")
    args = parser.parse_args(argv)

    demixer = NeuralDemixer(path=args.pretrained, seed=args.seed,
                            device="cpu" if args.cpu else args.device)
    demixer.generate_training_data(
        **training_data_kwargs(args.preset, args.size, args.seed))
    # quantise inputs with the wire rule; supervision targets stay clean
    tr_in, tr_tgt = demixer.training_data
    te_in, te_tgt = demixer.test_data
    demixer.training_data = (
        wire_quantise(tr_in, args.bits, args.decimate), tr_tgt)
    demixer.test_data = (
        wire_quantise(te_in, args.bits, args.decimate), te_tgt)

    t0 = time.time()
    history = demixer.train(
        epochs=args.epochs,
        learning_rate=args.learning_rate,
        save_path=args.out,
        seed=args.seed,
    )
    wall = time.time() - t0
    meta = {
        "pretrained": args.pretrained,
        "bits": args.bits,
        "decimate": args.decimate,
        "epochs": args.epochs,
        "size": args.size,
        "learning_rate": args.learning_rate,
        "preset": args.preset,
        "final_train_loss": history[-1]["train_loss"],
        "final_val_loss": history[-1]["val_loss"],
        "wall_seconds": round(wall, 1),
        "device": device_name(demixer.device),
    }
    with open(args.out + ".meta.json", "w") as fh:
        json.dump(meta, fh, indent=2)
    print(json.dumps(meta))
