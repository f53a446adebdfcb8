"""many.sweep_roofline: B5's least time (its bytes at the HBM peak; each
input read once, the output written once, for every fold) over its
device time a launch, in percent: the profiler's total for the cluster
kernel over the batched row sweep's launch count in the traced slice.
No other launch of the kernel runs in a fold-stack request."""

from cmbench import counts_many

KERNEL = "sweep_cluster_kernel"


def read(ctx):
    launches = ctx.launches.get("sweep_row_batched", 0)
    totals = ctx.trace.op_totals(KERNEL)
    if not launches or not totals:
        return None
    device_s = sum(t for t, _ in totals.values()) / 1e6 / launches
    cfg = ctx.config
    bound = counts_many.batched_sweep_bound_s(
        cfg["folds"], cfg["N"], counts_many.fold_trials(cfg),
        len(cfg["powers"]))
    return 100.0 * bound / device_s
