"""entry.enqueue_ms: host ms from a call's start until it returns, before
any wait for the device, averaged over every call of the traced window
(the profiler's own host cost included)."""


def read(ctx):
    enq = ctx.records.get("call_enqueue_s")
    return sum(enq) / len(enq) * 1e3 if enq else None
