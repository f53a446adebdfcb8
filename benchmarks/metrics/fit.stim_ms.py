"""fit.stim_ms: host milliseconds of a fit's stim stage (the host
sparsify of the [N, K] design, its upload and the device rebuild, the
lam init and the power counts): the ``cm.fit.stim`` spans (two a
CAVIaR fit, on either side of the traces' stage) summed inside each
``cm.fit`` span of the traced slice, the mean over those fits."""

from cmbench import program_spans as ps


def read(ctx):
    fits = ps.spans(ctx.trace, "cm.fit")
    stims = ps.inside(fits, ps.spans(ctx.trace, "cm.fit.stim"))
    return ps.mean_ms([sum(e - s for s, e in c) for c in stims if c])
