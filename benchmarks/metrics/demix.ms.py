"""demix.ms: device milliseconds of one demix call (raw traces on the
configuration's wire through ``NeuralDemixer.__call__``), the mean over
the traced slice's maps: CUDA events before the call and after it
returns, so the span ends with the last work it enqueued."""


def read(ctx):
    spans = ctx.spans.get("demix")
    if not spans:
        return None
    return sum(spans) / len(spans)
