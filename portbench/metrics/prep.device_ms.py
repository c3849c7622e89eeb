"""prep.device_ms: device ms a call of the operations launched inside the
program's `ssq.prep` spans (NaN screen, cast, pad, filterbank sampling,
rfft). Standard error: device ms a call by the span that launched the
operations."""
import sys

from core import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    if sp is None or not ctx.calls:
        return None
    by = sp.device_us()
    print(spans.line("spans: device ms a call by launching span", by, ctx),
          file=sys.stderr)
    return spans.per_call_ms(by["ssq.prep"], ctx)
