"""entry.blocked_ms: host ms a call in runtime calls that wait for the
device (cudaStreamSynchronize, cudaDeviceSynchronize, cudaEventSynchronize,
a cudaMemcpy that is not asynchronous: a copy from pageable host memory
waits for the stream) inside any of the program's `ssq.*` spans. Standard
error: the same time by the innermost span and runtime call."""
import sys

from core import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    if sp is None or not ctx.calls:
        return None
    by = sp.blocked_us()
    print(spans.line("spans: blocked ms a call", by, ctx), file=sys.stderr)
    return spans.per_call_ms(sum(by.values()), ctx)
