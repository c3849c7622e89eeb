"""entry.launch_ms: host ms a call in the program's `ssq.launch.<entry>`
spans (its calls into the kernel library: argument set-up, the launches,
kernel A's row-chunk loop on the host), less the runtime calls there that
wait for the device."""
from core import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    if sp is None or not ctx.calls:
        return None
    own, blocked = sp.self_us(), sp.blocked_by_span()
    us = sum(v - blocked[n] for n, v in own.items()
             if n.startswith("ssq.launch."))
    return spans.per_call_ms(us, ctx)
