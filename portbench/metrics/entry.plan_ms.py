"""entry.plan_ms: host ms a call in the program's `ssq.plan` spans (host
planning and the upload of its arrays), outside their child spans and less
the runtime calls there that wait for the device (those are
entry.blocked_ms). Standard error: the entry point's span a call beside
the loop's enqueue time, the share of it outside every stage, and each
span's own host ms a call."""
import sys

from core import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    if sp is None or not ctx.calls:
        return None
    own, blocked = sp.self_us(), sp.blocked_by_span()
    entry = sum(e - s for _, s, e in sp.entry_spans())
    if entry:
        outside = sum(own.get(n, 0.0) for n in spans.ENTRY)
        enq = ctx.records.get("call_enqueue_s")
        enq_ms = sum(enq) / len(enq) * 1e3 if enq else float("nan")
        print(f"spans: entry span {spans.per_call_ms(entry, ctx):.4f} ms a "
              f"call (enqueue {enq_ms:.4f}), outside its stages "
              f"{spans.per_call_ms(outside, ctx):.4f} "
              f"({100 * outside / entry:.2f} %)", file=sys.stderr)
    print(spans.line("spans: own host ms a call", own, ctx, k=12),
          file=sys.stderr)
    return spans.per_call_ms(own["ssq.plan"] - blocked["ssq.plan"], ctx)
