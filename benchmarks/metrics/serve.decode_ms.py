"""serve.decode_ms: the server's host milliseconds in the ``decode``
stage of a ``/fit`` request (the body's npz, its wire decodes and the
finite checks), from the ``stages`` of its ``--metrics`` request log
(the ``cm.serve.decode`` span), the mean over the window's untraced
requests. None where the log has no stages."""

from cmbench import program_spans


def read(ctx):
    return program_spans.stage_ms(ctx, "decode")
