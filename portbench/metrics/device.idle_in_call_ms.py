"""device.idle_in_call_ms: ms a call inside the program's entry span
(`ssq.ssq_cwt`, `ssq.ssq_stft`) in which no device operation of the
program ran. Standard error: the same idle time by the innermost `ssq.*`
span."""
import sys

from core import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    if sp is None or not ctx.calls or not sp.entry_spans():
        return None
    by = sp.idle_in_entry_us()
    print(spans.line("spans: idle ms a call in the entry span", by, ctx),
          file=sys.stderr)
    return spans.per_call_ms(sum(by.values()), ctx)
