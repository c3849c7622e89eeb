"""device.idle_pct.serve: the share of the traced window in which no
device operation of the program ran, in % (serve cells; the copies to
host memory count as device time). The benchmark's own host spans (making
the next request's signal) are left out of the window, and its own device
operations out of the busy time."""


def read(ctx):
    if ctx.trace is None or not ctx.window_s:
        return None
    return 100.0 * ctx.trace.idle_share(ctx.window_s)
