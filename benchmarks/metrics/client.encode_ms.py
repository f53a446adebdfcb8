"""client.encode_ms: host milliseconds of the fit client's request body
(``FitClient._body``: the trace wire, the sparse stim and the npz), the
mean of the ``cm.client.encode`` spans in the traced slice."""

from cmbench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx.trace, "cm.client.encode")
