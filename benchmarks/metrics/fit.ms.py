"""fit.ms: device milliseconds of one ``Model.fit`` call, from handing it
the demixed traces until the posterior is on the host (the stim's
sparsify and upload, the 50 CAVIaR iterations, the reconnection scan
and the pull), the mean over the traced slice's maps: CUDA events before
the call and after it returns."""


def read(ctx):
    spans = ctx.spans.get("fit")
    if not spans:
        return None
    return sum(spans) / len(spans)
