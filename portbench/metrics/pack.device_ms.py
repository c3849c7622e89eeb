"""pack.device_ms: device ms a call of the operations launched inside the
program's `ssq.pack` spans (the torch.complex packs of the outputs)."""
from core import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    if sp is None or not ctx.calls:
        return None
    return spans.per_call_ms(sp.device_us()["ssq.pack"], ctx)
