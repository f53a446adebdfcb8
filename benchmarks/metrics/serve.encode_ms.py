"""serve.encode_ms: the server's host milliseconds in the ``encode``
stage of a ``/fit`` request (the field filter, the response wire and
the answer's npz), from the ``stages`` of its ``--metrics`` request log
(the ``cm.serve.encode`` span), the mean over the window's untraced
requests. None where the log has no stages."""

from cmbench import program_spans


def read(ctx):
    return program_spans.stage_ms(ctx, "encode")
