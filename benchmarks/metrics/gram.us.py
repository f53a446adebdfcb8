"""gram.us: W1's device microseconds a CAVIaR iteration: the profiler's
total for the operations whose name holds ``costim_gram`` (the weight
update's Gram over the design's co-stimulation lists) in the traced
slice, over the blocked sweep's (B1's) launch count in the slice, one
Gram and one B1 launch an iteration. None where no such operation ran
(a program without W1, or a Gram that took the dense product)."""

KERNEL = "costim_gram"


def read(ctx):
    launches = ctx.launches.get("sweep_blocked", 0)
    totals = ctx.trace.op_totals(KERNEL)
    if not launches or not totals:
        return None
    return sum(t for t, _ in totals.values()) / launches
