"""The readers of the program's own spans (`core/spans.py` and the seven
metrics on it) on made-up traces: host events with the program's `ssq.*`
spans, runtime calls and device operations matched by correlation id. A
trace without the spans (the program before it had them) and no trace at
all give nothing."""
import types

import pytest
import torch

from core import spans
from core.trace import Trace
from test_portbench_metrics import ctx, read

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


class Ev:
    """A kineto event as Trace and core/spans.py read it (times in us)."""

    def __init__(self, name, s, e, corr=0, device=False, annotation=False):
        self._v = (name, s, e, corr, device, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1] * 1000

    def duration_ns(self):
        return (self._v[2] - self._v[1]) * 1000

    def correlation_id(self):
        return self._v[3]

    def device_type(self):
        return CUDA if self._v[4] else CPU

    def is_user_annotation(self):
        return self._v[5]


def made_trace(events):
    """A Trace over `events` as its __exit__ would have read them."""
    t = Trace.__new__(Trace)
    t.device, t.host, t.harness = [], [], []
    t.prof = types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: list(events))))
    host = [e for e in events if not e._v[4]]
    t.host = sorted((e._v[:3] for e in host), key=lambda v: v[1])
    launches = {e._v[3]: e._v[1] for e in host if e._v[0].startswith("cu")}
    t.split([(e._v[:3], e._v[3]) for e in events
             if e._v[4] and not e._v[5]], launches)
    return t


def batch_call(t0):
    """One ssq_cwt call of 100 us from t0: plan 0-30 (a synchronising
    upload 10-25), prep 30-40 (a pad kernel, corr 1), A's launch 40-50
    (kernel, corr 2), pack 50-60 (kernel, corr 3), the entry span's own
    time 60-100. Device: pad 32-38, A 45-80, pack 82-90."""
    c = int(t0)
    return [
        Ev("portbench.call", t0 - 1, t0 + 101),
        Ev("ssq.ssq_cwt", t0, t0 + 100),
        Ev("ssq.plan", t0, t0 + 30),
        Ev("cudaMemcpyAsync", t0 + 9, t0 + 10, c + 9),
        Ev("cudaStreamSynchronize", t0 + 10, t0 + 25),
        Ev("ssq.prep", t0 + 30, t0 + 40),
        Ev("cudaLaunchKernel", t0 + 31, t0 + 32, c + 1),
        Ev("ssq.launch.ssq_cwt_phase", t0 + 40, t0 + 50),
        Ev("cudaLaunchKernel", t0 + 41, t0 + 42, c + 2),
        Ev("ssq.pack", t0 + 50, t0 + 60),
        Ev("cudaLaunchKernel", t0 + 51, t0 + 52, c + 3),
        Ev("ssq.ssq_cwt", t0 + 30, t0 + 30, annotation=True, device=True),
        Ev("pad_kernel", t0 + 32, t0 + 38, c + 1, device=True),
        Ev("cwt_d_stage1", t0 + 45, t0 + 80, c + 2, device=True),
        Ev("complex_kernel", t0 + 82, t0 + 90, c + 3, device=True),
    ]


@pytest.fixture
def batch():
    t = made_trace(batch_call(1000) + batch_call(2000))
    return ctx(calls=2, window_s=2e-3, trace=t,
               records={"call_enqueue_s": [100e-6, 100e-6]})


def test_segments_cut_by_innermost_span():
    segs = spans.segments([("A", 0, 100), ("B", 10, 20), ("C", 30, 40),
                           ("D", 30, 35)])
    assert segs == [(0, 10, "A"), (10, 20, "B"), (20, 30, "A"),
                    (30, 35, "D"), (35, 40, "C"), (40, 100, "A")]


def test_batch_readers(batch):
    # plan: 30 us less the 15 us synchronise; launch: 10 us; blocked 15
    assert read("metrics", "entry.plan_ms", batch) == pytest.approx(0.015)
    assert read("metrics", "entry.launch_ms", batch) == pytest.approx(0.010)
    assert read("metrics", "entry.blocked_ms", batch) == pytest.approx(0.015)
    # idle in 0-100: 0-32, 38-45, 80-82, 90-100 = 32 + 7 + 2 + 10
    assert read("metrics", "device.idle_in_call_ms", batch) == \
        pytest.approx(0.051)
    assert read("metrics", "prep.device_ms", batch) == pytest.approx(0.006)
    assert read("metrics", "pack.device_ms", batch) == pytest.approx(0.008)
    sp = spans.of(batch.trace)
    idle = sp.idle_in_entry_us()
    assert idle["ssq.plan"] == pytest.approx(2 * 30)
    assert idle["ssq.prep"] == pytest.approx(2 * 4)
    assert idle["ssq.launch.ssq_cwt_phase"] == pytest.approx(2 * 5)
    assert idle["ssq.ssq_cwt"] == pytest.approx(2 * 12)
    assert sp.blocked_us() == {("ssq.plan", "cudaStreamSynchronize"): 30}
    assert sp.device_us()["ssq.launch.ssq_cwt_phase"] == pytest.approx(70)


def test_serve_reader():
    """Request 0-100 with its run 10-50 and fetch 60-95: 25 us of its own."""
    ev = []
    for t0 in (0, 200):
        ev += [Ev("ssq.serve.request", t0, t0 + 100),
               Ev("ssq.serve.run", t0 + 10, t0 + 50),
               Ev("ssq.ssq_stft", t0 + 12, t0 + 48),
               Ev("ssq.serve.fetch", t0 + 60, t0 + 95)]
    c = ctx(calls=2, window_s=300e-6, trace=made_trace(ev))
    assert read("metrics", "serve.host_ms", c) == pytest.approx(0.025)


@pytest.mark.parametrize("name", [
    "entry.plan_ms", "entry.launch_ms", "entry.blocked_ms",
    "device.idle_in_call_ms", "prep.device_ms", "pack.device_ms",
    "serve.host_ms"])
def test_nothing_to_read(name):
    """No trace, or a trace of a program without the spans: None."""
    bare = made_trace([Ev("portbench.call", 0, 100),
                       Ev("cudaLaunchKernel", 1, 2, 1),
                       Ev("k", 5, 50, 1, device=True)])
    assert read("metrics", name, ctx(calls=1)) is None
    assert read("metrics", name, ctx(calls=1, window_s=1e-4,
                                     trace=bare)) is None
