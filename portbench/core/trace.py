"""The traced run's reading of torch.profiler: every device operation
(kernel, copy, set) of the program and every host operation of the window
as intervals, the device's busy time (their union), and the breakdown the
result line carries. Device operations that the benchmark itself launched
(its inputs, its copies of the outputs it keeps: the host spans in
HARNESS) are no part of the program's: they are set apart in `harness`
and count as idle time."""
from __future__ import annotations

import bisect
from collections import defaultdict

import torch

HARNESS = ("portbench.input", "portbench.keep")


def short(name, most=120):
    """A kernel's name without its argument list, return type and
    anonymous namespaces, cut to `most` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, c in enumerate(name):
        depth += (c == "<") - (c == ">")
        if c == "(" and depth == 0 and i:
            name = name[:i]
            break
    return name.strip()[:most]


class Span:
    """A named host span of the benchmark's own (torch.profiler's
    record_function), so that idle gaps outside the program's own ops are
    named by what the benchmark was doing."""

    def __init__(self, name, on):
        self.ctx = torch.profiler.record_function(name) if on else None

    def __enter__(self):
        if self.ctx is not None:
            self.ctx.__enter__()

    def __exit__(self, *exc):
        if self.ctx is not None:
            self.ctx.__exit__(*exc)


class Trace:
    """torch.profiler over the window (CPU and CUDA activities); after the
    window, `device` and `host` hold (name, start_us, end_us) tuples,
    sorted by start."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.device, self.host, self.harness = [], [], []

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        if exc[0] is not None:
            return
        cuda = torch.autograd.DeviceType.CUDA
        # the raw events, without the profiler's per-event tree; a
        # record_function span's device-side copy (a user annotation) is
        # no device operation
        device, launches = [], {}
        for e in self.prof.profiler.kineto_results.events():
            s = e.start_ns() / 1e3
            iv = (e.name(), s, s + e.duration_ns() / 1e3)
            if e.device_type() != cuda:
                self.host.append(iv)
                if iv[0].startswith("cu"):   # a CUDA API call
                    launches[e.correlation_id()] = s
            elif not e.is_user_annotation():
                device.append((iv, e.correlation_id()))
        self.host.sort(key=lambda t: t[1])
        self.split(device, launches)

    def split(self, device, launches):
        """Sort device operations ((name, start, end), correlation id) into
        the program's (`device`) and the benchmark's own (`harness`): those
        whose launching runtime call (`launches`: correlation id -> host
        start) lies inside a HARNESS span."""
        spans = sorted((s, e) for n, s, e in self.host if n in HARNESS)
        starts = [s for s, _ in spans]
        for iv, corr in device:
            t = launches.get(corr)
            i = -1 if t is None else bisect.bisect_right(starts, t) - 1
            own = i >= 0 and t <= spans[i][1]
            (self.harness if own else self.device).append(iv)
        self.device.sort(key=lambda t: t[1])
        self.harness.sort(key=lambda t: t[1])

    def busy_intervals(self):
        """The union of the device operations' intervals, merged."""
        out = []
        for _, s, e in self.device:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def harness_s(self):
        """Device seconds of the benchmark's own operations."""
        return sum(e - s for _, s, e in self.harness) / 1e6

    def idle_share(self, window_s):
        """The share of the window, outside the benchmark's own host spans
        (HARNESS: making inputs, keeping outputs), in which no device
        operation of the program ran."""
        spans = sorted([s, e] for n, s, e in self.host if n in HARNESS)
        own = sum(e - s for s, e in spans) / 1e6
        busy = self.busy_intervals()
        both, j = 0.0, 0
        for s, e in spans:              # busy time inside those spans
            while j < len(busy) and busy[j][1] <= s:
                j += 1
            k = j
            while k < len(busy) and busy[k][0] < e:
                both += min(e, busy[k][1]) - max(s, busy[k][0])
                k += 1
        rest = window_s - own
        return 1.0 - (self.busy_s() - both / 1e6) / rest

    def busy_s(self):
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def device_s(self, match):
        """Seconds of device operations whose name `match` accepts."""
        return sum(e - s for n, s, e in self.device if match(n)) / 1e6

    def count(self):
        return len(self.device)

    def top_device_ops(self, k=10):
        """Device seconds by operation (names shortened by `short`), the
        k largest."""
        tot = defaultdict(float)
        for n, s, e in self.device:
            tot[short(n)] += (e - s) / 1e6
        return sorted(([n, v] for n, v in tot.items()),
                      key=lambda t: -t[1])[:k]

    @staticmethod
    def _host_at(t, events, starts, reach):
        """Of `events` that contain time t, the one that started last
        (the innermost), looking back `reach` events; or None."""
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(i - reach, -1), -1):
            name, s, e = events[j]
            if e >= t:
                return name
        return None

    def idle_gaps(self, k=10):
        """Idle device time between operations, summed by the innermost
        host operation running at each gap's midpoint (else the
        benchmark's own span there); the k largest."""
        starts = [s for _, s, _ in self.host]
        spans = [e for e in self.host if e[0].startswith("portbench.")]
        span_starts = [s for _, s, _ in spans]
        tot = defaultdict(float)
        busy = self.busy_intervals()
        for (_, e0), (s1, _) in zip(busy, busy[1:]):
            t = (e0 + s1) / 2
            name = (self._host_at(t, self.host, starts, 4000) or
                    self._host_at(t, spans, span_starts, 4) or
                    "(no host op)")
            tot[name] += (s1 - e0) / 1e6
        return sorted(([n, v] for n, v in tot.items()),
                      key=lambda t: -t[1])[:k]
