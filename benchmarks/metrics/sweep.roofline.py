"""sweep.roofline: B1's least time (its bytes at the HBM peak; each
input read once, the output written once) over its device time a launch,
in percent: the profiler's total for the kernel over the wrapper's
launch count in the traced slice."""

from cmbench import counts

KERNEL = "sweep_cluster_kernel"


def read(ctx):
    launches = ctx.launches.get("sweep_blocked", 0)
    totals = ctx.trace.op_totals(KERNEL)
    if not launches or not totals:
        return None
    device_s = sum(t for t, _ in totals.values()) / 1e6 / launches
    cfg = ctx.config
    bound = counts.sweep_bound_s(cfg["N"], cfg["trials"], len(cfg["powers"]))
    return 100.0 * bound / device_s
