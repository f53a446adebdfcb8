"""serve.handler_ms: the server's own seconds for a ``/fit`` request
(its ``--metrics`` request log: the handler from the request's arrival
to the response's last byte), the mean over the window's untraced
requests, in milliseconds."""


def read(ctx):
    rows = [r for r in (ctx.request_log or []) if r.get("status") == 200]
    if not rows:
        return None
    return 1e3 * sum(r["seconds"] for r in rows) / len(rows)
