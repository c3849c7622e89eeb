"""serve.d2h_ms: device ms a request of the copies from the card to host
memory (torch.profiler's 'Memcpy DtoH' operations) in the traced window."""


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    return ctx.trace.device_s(lambda n: "DtoH" in n) / ctx.calls * 1e3
