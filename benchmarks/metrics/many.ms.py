"""many.ms: device milliseconds of one ``caviar_many`` call, from handing
it the resident fold stack and the host designs until every fold's
posterior is on the host (the designs' sparsify and upload, the
observations, the batched CAVIaR iterations, the reconnection scans and
the pull), the mean over the traced slice's calls: CUDA events before
the call and after it returns."""


def read(ctx):
    spans = ctx.spans.get("many")
    if not spans:
        return None
    return sum(spans) / len(spans)
