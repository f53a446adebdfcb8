"""map.mfu: the products a map needs (the U-Net's convolutions of every
trace where the map demixes, and every CAVIaR iteration's Gram matrix,
Cholesky factor and inverse), counted from the shapes, over the seconds
a map of the window's untraced requests takes on the host's clock (the
profiler's slice left out) times the card's float32 peak, in percent.
The map's products run in full float32: the fit's under
``float32_matmul_precision("highest")``, the demixer's with TF32 off."""

from cmbench import counts


def read(ctx):
    if not ctx.latencies or ctx.traffic.get("request") != "map":
        return None
    cfg = ctx.config
    flops = counts.map_flops(cfg["N"], cfg["trials"], cfg["T"],
                             int(cfg["fit"]["iters"]),
                             demix=bool(ctx.traffic["demix"]))
    seconds = sum(ctx.latencies) / len(ctx.latencies)
    return 100.0 * flops / (seconds * counts.PEAK_F32_FLOPS)
