"""device.idle.map: the share of the traced slice of maps in which no
operation ran on the device, in percent."""


def read(ctx):
    if not ctx.trace.ops:
        return None
    return 100.0 * ctx.trace.idle_share
