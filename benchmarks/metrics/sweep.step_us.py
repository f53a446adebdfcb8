"""sweep.step_us: B1's device microseconds a dependent block step: the
profiler's total for the kernel in the traced slice, over the wrapper's
launch count in the slice, over the block steps a launch chains in the
plan that most of the run's launches took (N / 8 at 8 rows a step).
Comparable across plans of other widths and ring depths."""

from cmbench import plans

KERNEL = "sweep_cluster_kernel"


def read(ctx):
    plan = plans.main_plan()
    launches = ctx.launches.get("sweep_blocked", 0)
    totals = ctx.trace.op_totals(KERNEL)
    if plan is None or not launches or not totals:
        return None
    return sum(t for t, _ in totals.values()) / launches / plan.nsteps
