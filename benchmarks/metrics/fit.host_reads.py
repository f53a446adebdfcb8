"""fit.host_reads: device-to-host copies a ``Model.fit`` call makes (every
``.tolist()``, ``.item()``, one-argument ``where`` and pull to the
host is one), the device operations named ``Memcpy DtoH`` that start
inside each ``cm.fit`` span, the mean over the traced slice's fits."""

from cmbench import program_spans as ps

PREFIX = "Memcpy DtoH"


def read(ctx):
    fits = ps.spans(ctx.trace, "cm.fit")
    if not fits or not ctx.trace.ops:
        return None
    starts = [(s, s) for n, s, _ in ctx.trace.ops if n.startswith(PREFIX)]
    counts = [len(c) for c in ps.inside(fits, starts)]
    return sum(counts) / len(counts)
