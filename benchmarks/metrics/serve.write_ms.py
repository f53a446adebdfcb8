"""serve.write_ms: the server's host milliseconds in the ``write``
stage of a ``/fit`` request (the response onto the socket), from the
``stages`` of its ``--metrics`` request log (the ``cm.serve.write``
span), the mean over the window's untraced requests. None where the log
has no stages."""

from cmbench import program_spans


def read(ctx):
    return program_spans.stage_ms(ctx, "write")
