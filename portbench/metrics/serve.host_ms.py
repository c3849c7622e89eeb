"""serve.host_ms: host ms a request in the server's `ssq.serve.request`
span outside its children `ssq.serve.run` (the transform) and
`ssq.serve.fetch` (the trim and the copy to host memory): the bucket
choice and the reflect pad on the host. Standard error: each serve span's
own host ms a request."""
import sys

from core import spans


def read(ctx):
    sp = spans.of(ctx.trace)
    if sp is None or not ctx.calls:
        return None
    own = sp.self_us()
    if "ssq.serve.request" not in own:
        return None
    print(spans.line("spans: own host ms a request", {
        n: v for n, v in own.items() if n.startswith("ssq.serve.")}, ctx),
        file=sys.stderr)
    return spans.per_call_ms(own["ssq.serve.request"], ctx)
