"""Train an NWD demixer from simulated PSC data (port of
``scripts_tpu/train_demixer.py``), with the per-opsin time-constant
presets of the reference trainer. Writes the in-repo .npz checkpoint
format, which both packages read.

Usage:
  python -m circuitmap_torch train-demixer --size 50000 --epochs 500 \
      --preset chrome2f_ie --out demixer.npz
"""

import argparse

import numpy as np

from . import add_device_argument

# Opsin/synapse presets from the reference trainer's documented ranges:
# (tau_r_lower, tau_r_upper, tau_diff_lower, tau_diff_upper).
PRESETS = {
    "chrome2f_ie": (10, 40, 150, 340),       # ChroME2f interneuron -> pyramidal
    "chrome1_ee": (10, 40, 60, 120),         # ChroME1 pyramidal -> pyramidal
    "pyr_pv": (3, 20, 17, 90),               # pyramidal -> PV
    "chrome2s_ee_emx": (20, 40, 35, 100),    # ChroME2s pyramidal -> pyramidal
    "chrome2s_epv_emx": (8, 15, 1, 35),      # ChroME2s pyramidal -> PV (fast)
}


def training_data_kwargs(preset, size, seed):
    """``generate_training_data``'s keywords for a preset (both training
    commands draw the same dataset)."""
    tr_lo, tr_hi, td_lo, td_hi = PRESETS[preset]
    return dict(
        trial_dur=900,
        size=size,
        gp_scale=0.045,
        delta_lower=160,
        delta_upper=400,
        next_delta_lower=400,
        next_delta_upper=899,
        prev_delta_upper=150,
        tau_r_lower=tr_lo,
        tau_r_upper=tr_hi,
        tau_diff_lower=td_lo,
        tau_diff_upper=td_hi,
        noise_std_lower=0.001,
        noise_std_upper=0.02,
        gp_lengthscale=45,
        seed=seed,
    )


def main(argv=None):
    from ..demix.demixer import NeuralDemixer

    parser = argparse.ArgumentParser(
        prog="python -m circuitmap_torch train-demixer", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--size", type=int, default=50000)
    parser.add_argument("--epochs", type=int, default=500)
    parser.add_argument("--templates", default=None,
                        help=".npy of negative templates")
    parser.add_argument("--pretrained", default=None)
    parser.add_argument("--learning_rate", type=float, default=1e-2)
    parser.add_argument("--preset", choices=sorted(PRESETS),
                        default="chrome2f_ie")
    parser.add_argument("--out", default="demixer.npz")
    parser.add_argument("--seed", type=int, default=0)
    add_device_argument(parser)
    args = parser.parse_args(argv)

    templates = np.load(args.templates) if args.templates else None
    demixer = NeuralDemixer(path=args.pretrained, seed=args.seed,
                            device=args.device)
    demixer.generate_training_data(
        templates=templates,
        **training_data_kwargs(args.preset, args.size, args.seed))
    demixer.train(
        epochs=args.epochs,
        learning_rate=args.learning_rate,
        save_path=args.out,
    )
    print(f"Saved demixer to {args.out}")
