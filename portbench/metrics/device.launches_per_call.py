"""device.launches_per_call: device operations (kernels, copies, sets)
the traced window launched, over its calls."""


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    return ctx.trace.count() / ctx.calls
