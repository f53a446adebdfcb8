"""client.decode_ms: host milliseconds of the fit client's decode of a
``/fit`` response (the npz and the int8 ``lam`` wire), the mean of the
``cm.client.decode`` spans in the traced slice."""

from cmbench import program_spans


def read(ctx):
    return program_spans.span_ms(ctx.trace, "cm.client.decode")
