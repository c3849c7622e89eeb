"""The port's spans and counters (`ssqueeze_rs_tpu_torch.trace`), on the
CPU: no span enters the profiler while none runs; under torch.profiler the
entry points record their stages nested by time; every call into the
kernel library is spanned and counted by `_build.launch`; TransformServer
counts the samples it was handed and those it transformed."""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from ssqueeze_rs_tpu_torch import _build, ssq_cwt, ssq_stft, trace
from ssqueeze_rs_tpu_torch.serve import TransformServer

N = 1024


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _signal(n=N, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(n)
                           .astype(np.float32))


CALLS = {
    "ssq_cwt": lambda x: ssq_cwt(x, "gmw", nv=8, fs=100.0),
    "ssq_stft": lambda x: ssq_stft(x, n_fft=64, fs=100.0),
}


def _host_events(prof):
    """(name, start_us, end_us) of every host event, by start."""
    cuda = torch.autograd.DeviceType.CUDA
    out = [(e.name(), e.start_ns() / 1e3,
            (e.start_ns() + e.duration_ns()) / 1e3)
           for e in prof.profiler.kineto_results.events()
           if e.device_type() != cuda]
    return sorted(out, key=lambda t: t[1])


def _inside(ev, outer):
    return outer[1] <= ev[1] and ev[2] <= outer[2]


def test_span_off_enters_no_record_function(monkeypatch):
    """With no profiler running, a span is the shared object that does
    nothing: the transforms and the server run with record_function made
    to raise."""
    def boom(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    assert trace.span("ssq.plan") is trace.span("ssq.prep")
    with trace.span("ssq.plan"):
        pass
    for call in CALLS.values():
        call(_signal())
    TransformServer("stft", buckets=(4096,), n_fft=16, device="cpu")(
        _signal(3000).numpy())


@pytest.mark.parametrize("name", sorted(CALLS))
def test_entry_spans_nest_by_time(name):
    """Under torch.profiler, a call records its entry span with ssq.plan,
    ssq.prep and ssq.pack inside it, and the pad's aten ops inside
    ssq.prep."""
    x = _signal()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        CALLS[name](x)
    ev = _host_events(prof)
    entry = [e for e in ev if e[0] == "ssq." + name]
    assert len(entry) == 1
    stages = {n: [e for e in ev if e[0] == n]
              for n in ("ssq.plan", "ssq.prep", "ssq.pack")}
    for n, found in stages.items():
        assert found, f"no {n} span"
        assert all(_inside(e, entry[0]) for e in found), n
    # padsignal's source index (aten::remainder) and gather lie in ssq.prep
    rem = [e for e in ev if e[0] == "aten::remainder"]
    assert rem and all(any(_inside(e, p) for p in stages["ssq.prep"])
                       for e in rem)
    # each ssq.pack holds a torch.complex (the plain kernels on the CPU
    # make complex spectra of their own outside it)
    packs = [e for e in ev if e[0] == "aten::complex"]
    assert all(any(_inside(c, p) for c in packs) for p in stages["ssq.pack"])


def test_serve_spans_nest_by_time():
    """ssq.serve.request holds ssq.serve.run (the entry span inside it) and
    then ssq.serve.fetch."""
    srv = TransformServer("ssq_stft", buckets=(4096,), n_fft=64,
                          device="cpu")
    x = _signal(3000).numpy()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        srv(x)
    ev = _host_events(prof)
    (req,) = [e for e in ev if e[0] == "ssq.serve.request"]
    (run,) = [e for e in ev if e[0] == "ssq.serve.run"]
    (fetch,) = [e for e in ev if e[0] == "ssq.serve.fetch"]
    (entry,) = [e for e in ev if e[0] == "ssq.ssq_stft"]
    assert _inside(run, req) and _inside(fetch, req)
    assert _inside(entry, run) and run[2] <= fetch[1]


@pytest.mark.parametrize("kind,samples,bucket_samples", [
    ("one", 160_000, 262_144),          # the benchmark's request
    ("channels", 2 * 3000, 2 * 4096),
    ("batch", 3000 + 4000 + 1000, 4 * 4096),    # 3 requests -> 4 rows
])
def test_server_counts_samples_and_bucket_samples(kind, samples,
                                                  bucket_samples):
    srv = TransformServer("stft", n_fft=16, device="cpu")
    rng = np.random.default_rng(1)
    before = (trace.COUNTS["serve.samples"],
              trace.COUNTS["serve.bucket_samples"])
    if kind == "one":
        srv(rng.standard_normal(160_000).astype(np.float32))
    elif kind == "channels":
        srv(rng.standard_normal((2, 3000)).astype(np.float32))
    else:
        srv.batch([rng.standard_normal(n).astype(np.float32)
                   for n in (3000, 4000, 1000)])
    assert (trace.COUNTS["serve.samples"] - before[0],
            trace.COUNTS["serve.bucket_samples"] - before[1]) == \
        (samples, bucket_samples)


@pytest.mark.parametrize("err", [0, 700])
def test_launch_spans_checks_and_counts(monkeypatch, err):
    """`_build.launch` calls the entry point inside ssq.launch.<entry>,
    raises on its error, and counts the call only when it succeeded."""
    seen = []

    class Lib:
        def ssq_stft_dft(self, *args):
            seen.append(args)
            return err

        def ssq_error_string(self, code):
            return b"cudaErrorIllegalAddress"

    lib = Lib()
    monkeypatch.setattr(_build, "lib", lambda: lib)
    before = trace.COUNTS["launch.ssq_stft_dft"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        if err:
            with pytest.raises(RuntimeError, match="stft_dft kernel"):
                _build.launch("ssq_stft_dft", 1, 2.0, what="stft_dft kernel")
        else:
            _build.launch("ssq_stft_dft", 1, 2.0, what="stft_dft kernel")
    assert seen == [(1, 2.0)]
    assert [e[0] for e in _host_events(prof)] == ["ssq.launch.ssq_stft_dft"]
    assert trace.COUNTS["launch.ssq_stft_dft"] - before == (0 if err else 1)


def test_counts_always_count():
    before = trace.COUNTS["test.things"]
    trace.count("test.things")
    trace.count("test.things", 4)
    assert trace.COUNTS["test.things"] - before == 5
