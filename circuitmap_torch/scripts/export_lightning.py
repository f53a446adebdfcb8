"""Export a demixer checkpoint as a Lightning .ckpt (port of
``scripts_tpu/export_lightning.py``).

A demixer trained by ``train-demixer`` or ``train-qat-demixer`` (the
in-repo .npz) becomes a checkpoint the reference ecosystem reads
directly (``NWDUNet().load_from_checkpoint(path)``). Pure re-keying on
the host: no GPU is used.

Usage:
    python -m circuitmap_torch export-ckpt demixers/nwd_ie_ChroME2f_scratch.npz out.ckpt
    python -m circuitmap_torch export-ckpt in.npz out.ckpt --epoch 150
"""

import argparse


def main(argv=None):
    from ..demix import convert

    ap = argparse.ArgumentParser(
        prog="python -m circuitmap_torch export-ckpt",
        description="export a trained demixer (.npz, or any loadable "
                    "checkpoint) as a reference-compatible Lightning "
                    ".ckpt")
    ap.add_argument("src", help="input checkpoint (.npz native format, "
                                "or .ckpt to re-export)")
    ap.add_argument("dst", help="output .ckpt path")
    ap.add_argument("--epoch", type=int, default=0,
                    help="epoch stamp for the checkpoint metadata")
    ap.add_argument("--global-step", type=int, default=0)
    args = ap.parse_args(argv)

    state_dict = convert.load_params(args.src)
    convert.save_lightning_checkpoint(args.dst, state_dict, epoch=args.epoch,
                                      global_step=args.global_step)
    # the parameters, not BatchNorm's num_batches_tracked counters
    n = sum(1 for v in state_dict.values() if v.is_floating_point())
    print(f"wrote {args.dst} ({n} tensors + BN counters, "
          "reference NWDUNet layout)")
