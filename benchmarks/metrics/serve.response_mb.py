"""serve.response_mb: megabytes (1e6 bytes) of a ``/fit`` response, the
mean over the window's untraced requests (the server's request log)."""


def read(ctx):
    rows = [r for r in (ctx.request_log or []) if r.get("status") == 200]
    if not rows:
        return None
    return sum(r["bytes_out"] for r in rows) / len(rows) / 1e6
