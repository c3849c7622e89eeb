"""throughput_msps: input samples transformed over the whole window, over
the window's seconds (its last call included), in millions a second."""


def read(ctx):
    if "call_latency_s" not in ctx.records or not ctx.window_s:
        return None
    return ctx.samples / ctx.window_s / 1e6
