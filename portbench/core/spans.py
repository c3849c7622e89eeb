"""What the readers of the program's own spans share. The program opens
torch.profiler record_function ranges named `ssq.*` while a profiler runs
(ssqueeze_rs_tpu_torch.trace: the entry point, ssq.plan, ssq.prep,
ssq.launch.<entry>, ssq.pack, the server's request, run and fetch); they
land among the traced run's host events. Each host instant inside them
belongs to its innermost span, and so does what happens there: a runtime
call that waits for the device, the device's idle time, a device operation
(by the span in which the runtime call that launched it began, matched by
correlation id). A program without the spans leaves nothing to read: `of`
gives None and every reader returns None."""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

ENTRY = ("ssq.ssq_cwt", "ssq.ssq_stft")
WAITS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")


def waits(name):
    """Is `name` a runtime call that waits for the device: a synchronise,
    or a copy that is not asynchronous."""
    return name in WAITS or (name.startswith("cudaMemcpy") and
                             not name.endswith("Async"))


def segments(spans):
    """[(start, end, name)]: the time inside `spans` ((name, start, end),
    nested by time) cut where the innermost span changes, each piece under
    its innermost span's name, by start."""
    out, stack = [], []             # stack: (end, name) of the open spans
    t = None

    def close_until(limit):
        nonlocal t
        while stack and stack[-1][0] <= limit:
            end, name = stack.pop()
            if end > t:
                out.append((t, end, name))
                t = end

    for name, s, e in sorted(spans, key=lambda v: (v[1], -v[2])):
        if t is not None:
            close_until(s)
            if stack and s > t:
                out.append((t, s, stack[-1][1]))
        stack.append((e, name))
        t = s if t is None else max(t, s)
    if stack:
        close_until(float("inf"))
    return out


class Spans:
    """The `ssq.*` spans of one traced run (`core.trace.Trace`), in us."""

    def __init__(self, trace):
        self.trace = trace
        self.spans = [v for v in trace.host if v[0].startswith("ssq.")]
        self.segs = segments(self.spans)
        self.starts = [s for s, _, _ in self.segs]
        self.waits = [v for v in trace.host if waits(v[0])]
        self._device = None

    def at(self, t):
        """The innermost span at host time t, or None."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t < self.segs[i][1]:
            return self.segs[i][2]
        return None

    def pieces(self, s, e):
        """[(start, end, name)] of [s, e) by innermost span."""
        i = max(bisect.bisect_right(self.starts, s) - 1, 0)
        out = []
        while i < len(self.segs) and self.segs[i][0] < e:
            a, b, name = self.segs[i]
            if b > s:
                out.append((max(a, s), min(b, e), name))
            i += 1
        return out

    def self_us(self):
        """{span: host us in it, outside its child spans}."""
        out = defaultdict(float)
        for s, e, name in self.segs:
            out[name] += e - s
        return out

    def blocked_us(self):
        """{(span, runtime call): host us of the calls that wait for the
        device, by the innermost span they ran in}."""
        out = defaultdict(float)
        for name, s, e in self.waits:
            span = self.at(s)
            if span is not None:
                out[(span, name)] += e - s
        return out

    def blocked_by_span(self):
        out = defaultdict(float)
        for (span, _), us in self.blocked_us().items():
            out[span] += us
        return out

    def entry_spans(self):
        """The entry points' spans not inside another."""
        out = []
        for name, s, e in sorted(self.spans, key=lambda v: v[1]):
            if name in ENTRY and not (out and s < out[-1][2]):
                out.append((name, s, e))
        return out

    def idle_in_entry_us(self):
        """{span: us inside the entry points' spans in which no device
        operation of the program ran, by the innermost span}."""
        busy = self.trace.busy_intervals()
        ends = [b for _, b in busy]
        out = defaultdict(float)
        for _, s, e in self.entry_spans():
            j = bisect.bisect_right(ends, s)
            t = s
            while t < e:
                if j < len(busy) and busy[j][0] <= t:
                    t = max(t, busy[j][1])
                    j += 1
                    continue
                nxt = min(e, busy[j][0]) if j < len(busy) else e
                for a, b, name in self.pieces(t, nxt):
                    out[name] += b - a
                t = nxt
        return out

    def device_us(self):
        """{span: us of device operations launched in it}: each device
        operation of the traced run by the innermost span at the start of
        the runtime call with its correlation id (torch.profiler's raw
        events walked again: the trace keeps no correlation ids)."""
        if self._device is not None:
            return self._device
        prof = getattr(self.trace, "prof", None)
        out = defaultdict(float)
        if prof is not None:
            cuda = torch.autograd.DeviceType.CUDA
            where, ops = {}, []
            for ev in prof.profiler.kineto_results.events():
                if ev.device_type() != cuda:
                    if ev.name().startswith("cu"):
                        span = self.at(ev.start_ns() / 1e3)
                        if span is not None:
                            where[ev.correlation_id()] = span
                elif not ev.is_user_annotation():
                    ops.append((ev.correlation_id(), ev.duration_ns() / 1e3))
            for corr, us in ops:
                span = where.get(corr)
                if span is not None:
                    out[span] += us
        self._device = out
        return out


def of(trace):
    """The Spans of a traced run, made once, or None without a trace or
    without the program's spans in it."""
    if trace is None:
        return None
    sp = getattr(trace, "ssq_spans", None)
    if sp is None:
        sp = Spans(trace)
        trace.ssq_spans = sp
    return sp if sp.spans else None


def per_call_ms(us, ctx):
    return us / ctx.calls / 1e3


def line(title, by_name, ctx, k=8):
    """`title`, then the k largest of {name: us} as ms a call."""
    top = sorted(by_name.items(), key=lambda v: -v[1])[:k]
    return title + ": " + ", ".join(
        f"{n if isinstance(n, str) else ' '.join(n)} "
        f"{per_call_ms(us, ctx):.4f}" for n, us in top)
