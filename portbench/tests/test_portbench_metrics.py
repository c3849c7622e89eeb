"""The readers' arithmetic on made-up records and traces: rates over all
the work and all the time of the window, tails over every call, the
roofline counts at the headline shapes, the trace's busy time and idle
gaps."""
import types

import numpy as np
import pytest

from core import bench, peaks
from core.cell import Ctx
from core.trace import Trace

B = bench.Bench()
H100 = "NVIDIA H100 80GB HBM3"


def ctx(records=None, samples=0, window_s=None, calls=0, trace=None,
        shapes=None, device=H100):
    win = types.SimpleNamespace(records=records or {}, window_s=window_s,
                                attempted=calls, samples=samples,
                                peak_bytes=None)
    return Ctx(B, {}, {}, shapes or {}, win, trace, 1.0, device)


def read(kind, name, c):
    return B.module(kind, name).read(c)


def test_throughput_is_all_work_over_all_time():
    # uneven calls: a rate of each call's own, or of chunks, would differ
    lat = [0.01] * 90 + [0.5] * 10
    c = ctx({"call_latency_s": lat}, samples=100 * 1_280_000,
            window_s=sum(lat), calls=100)
    assert read("e2e", "throughput_msps", c) == pytest.approx(
        128.0 / sum(lat))
    chunk_medians = np.median([128.0 / np.sum(ch) for ch in
                               np.split(np.array(lat), 10)])
    assert read("e2e", "throughput_msps", c) != pytest.approx(chunk_medians)


@pytest.mark.parametrize("name,key", [("latency_p95_ms", "call_latency_s"),
                                      ("request_p95_ms", "request_latency_s")])
def test_tails_are_over_every_call(name, key):
    rng = np.random.default_rng(0)
    lat = list(rng.exponential(0.1, 400))
    c = ctx({key: lat})
    assert read("e2e", name, c) == pytest.approx(
        np.percentile(lat, 95) * 1e3)
    chunks = np.median([np.percentile(ch, 95) for ch in np.split(
        np.array(lat), 8)]) * 1e3
    assert read("e2e", name, c) != pytest.approx(chunks)
    assert read("e2e", name, ctx({})) is None


@pytest.mark.parametrize("kernel,shapes,ms", [
    # PERF.md's table of kernels, bound ms at the ssq_cwt headline (293 x
    # 160 000, M = 2^18) and at n_fft = 598 for G
    ("kernel_A", dict(batch=1, na=293, nf=293, n=160000, m=262144), 0.214),
    ("kernel_B", dict(batch=1, na=293, nf=293, n=160000, m=262144), 0.280),
    ("kernel_G", dict(batch=1, nf=300, n=160000, n_fft=598), 0.229),
])
def test_roofline_counts_match_the_table(kernel, shapes, ms):
    nbytes, flops = B.module("roofline", kernel).count(shapes)
    assert peaks.least_seconds(H100, nbytes, flops) * 1e3 == \
        pytest.approx(ms, abs=5e-4)


def fake_trace(device, host=()):
    t = Trace.__new__(Trace)
    t.device = sorted(device, key=lambda e: e[1])
    t.host = sorted(host, key=lambda e: e[1])
    return t


def test_trace_busy_union_and_gaps():
    t = fake_trace([("k1", 0, 10), ("k2", 5, 20), ("Memcpy DtoH", 30, 40),
                    ("k1", 100, 110)],
                   [("portbench.call", 0, 120), ("aten::copy_", 21, 29),
                    ("cudaLaunchKernel", 50, 52)])
    assert t.busy_intervals() == [[0, 20], [30, 40], [100, 110]]
    assert t.busy_s() == pytest.approx(40e-6)
    gaps = dict(t.idle_gaps())
    assert gaps["aten::copy_"] == pytest.approx(10e-6)
    assert gaps["portbench.call"] == pytest.approx(60e-6)
    assert t.count() == 4
    assert t.top_device_ops()[0] == ["k1", pytest.approx(20e-6)]


def test_per_layer_readers_on_a_trace():
    # kernel names as torch.profiler gave them on the card
    ns = "(anonymous namespace)::"
    t = fake_trace([(f"void {ns}cwt_d_stage1<9, 2, {ns}ALoad>(...)", 0, 3000),
                    (f"void {ns}cwt_d_stage2<9, {ns}PhaseStore>(float2 "
                     "const*)", 3000, 5000),
                    (f"void {ns}reassign_kernel<float, 32, 3>(float const*)",
                     5000, 6000),
                    ("elementwise_kernel", 6000, 6500),
                    ("Memcpy DtoH (Device -> Pageable)", 6500, 9500)])
    s = dict(batch=1, na=293, nf=293, n=160000, m=262144)
    c = ctx(calls=1, window_s=0.01, trace=t, shapes=s,
            records={"call_enqueue_s": [0.002, 0.004]})
    assert read("metrics", "kernel_A.roofline_pct", c) == pytest.approx(
        100 * 0.2143e-3 / 5e-3, rel=1e-3)
    assert read("metrics", "kernel_B.roofline_pct", c) == pytest.approx(
        100 * 0.27988e-3 / 1e-3, rel=1e-3)
    assert read("metrics", "glue.device_ms", c) == pytest.approx(3.5)
    assert read("metrics", "serve.d2h_ms", c) == pytest.approx(3.0)
    assert read("metrics", "device.launches_per_call", c) == 5
    assert read("metrics", "device.idle_pct.batch", c) == pytest.approx(5.0)
    assert read("metrics", "entry.enqueue_ms", c) == pytest.approx(3.0)
    # no launch of the kernel, an unknown card, or no trace: nothing read
    assert read("metrics", "kernel_G.roofline_pct", c) is None
    assert read("metrics", "kernel_A.roofline_pct",
                ctx(calls=1, trace=t, shapes=s, device="cpu")) is None
    assert read("metrics", "glue.device_ms", ctx(calls=1)) is None


def test_idle_share_leaves_out_the_benchmarks_spans():
    t = fake_trace([("k", 0, 10), ("k", 15, 30), ("k", 40, 50)],
                   [("portbench.input", 5, 20), ("portbench.call", 20, 60)])
    # spans 5-20 (15 us) hold busy 5-10 and 15-20: 10 us
    assert t.idle_share(60e-6) == pytest.approx(1 - (35 - 10) / 45)


def test_benchmark_device_work_is_set_apart():
    """Device operations launched inside the benchmark's own spans (its
    inputs, its kept copies) are no part of the program's: not busy time,
    not glue, not launches; the launch is matched by correlation id."""
    t = Trace.__new__(Trace)
    t.device, t.harness = [], []
    t.host = sorted([("portbench.input", 0, 10),
                     ("cudaLaunchKernel", 2, 3),        # input, corr 1
                     ("portbench.call", 10, 50),
                     ("cudaLaunchKernel", 12, 13),      # the program, 2
                     ("portbench.keep", 50, 60),
                     ("cudaMemcpyAsync", 52, 53)],      # a kept copy, 3
                    key=lambda e: e[1])
    t.split([(("randn_kernel", 4, 8), 1), (("cwt_d_stage1", 14, 40), 2),
             (("Memcpy DtoD", 54, 56), 3), (("no_launch_seen", 60, 61), 9)],
            {1: 2, 2: 12, 3: 52})
    assert [n for n, _, _ in t.device] == ["cwt_d_stage1", "no_launch_seen"]
    assert [n for n, _, _ in t.harness] == ["randn_kernel", "Memcpy DtoD"]
    assert t.busy_s() == pytest.approx(27e-6)
    assert t.harness_s() == pytest.approx(6e-6)
    # the window less the 20 us of the benchmark's spans: 41 us, of which
    # the program's operations are busy 27 (none inside those spans)
    assert t.idle_share(61e-6) == pytest.approx(1 - 27 / 41)
    c = ctx(calls=1, window_s=61e-6, trace=t)
    assert read("metrics", "device.idle_pct.serve", c) == pytest.approx(
        100 * (1 - 27 / 41))
    assert read("metrics", "device.launches_per_call", c) == 2
    assert read("metrics", "glue.device_ms", c) == pytest.approx(1e-3)
