"""fit.idle_ms: milliseconds of a ``Model.fit`` call in which no
operation ran on the device, each ``cm.fit`` span's length less the
union of the device's operations clipped to it, the mean over the
traced slice's fits."""

from cmbench import program_spans as ps


def read(ctx):
    if not ctx.trace.ops:
        return None
    return ps.mean_ms([(e - s) - ps.busy_us(ctx.trace, s, e)
                       for s, e in ps.spans(ctx.trace, "cm.fit")])
