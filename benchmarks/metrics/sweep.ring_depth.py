"""sweep.ring_depth: the steps of stim and lam rows that B1 prefetches
into its shared-memory ring (``cp.async``; 0: no prefetch, each step
waits on its own loads), in the launch plan that most of the run's B1
launches took, from the program's count of launches by plan."""

from cmbench import plans


def read(ctx):
    plan = plans.main_plan()
    return None if plan is None else plan.depth
