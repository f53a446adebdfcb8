"""demix.encode_ms: host milliseconds a demix call spends encoding its
traces on the wire, the ``cm.wire.encode`` spans (one a chunk) summed
inside each ``cm.demix`` span of the traced slice, the mean over those
calls."""

from cmbench import program_spans as ps


def read(ctx):
    calls = ps.spans(ctx.trace, "cm.demix")
    chunks = ps.inside(calls, ps.spans(ctx.trace, "cm.wire.encode"))
    return ps.mean_ms([sum(e - s for s, e in c) for c in chunks])
