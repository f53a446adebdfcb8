"""many.stim_ms: host milliseconds of a ``caviar_many`` call's stim
stage (the trace stack's upload, each design's host sparsify, upload
and device rebuild, the observations and the lam init): the
``cm.many.stim`` span inside each ``cm.many`` span of the traced slice,
the mean over those calls."""

from cmbench import program_spans as ps


def read(ctx):
    calls = ps.spans(ctx.trace, "cm.many")
    stims = ps.inside(calls, ps.spans(ctx.trace, "cm.many.stim"))
    return ps.mean_ms([sum(e - s for s, e in c) for c in stims if c])
