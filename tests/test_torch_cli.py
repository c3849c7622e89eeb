"""The port's console entry point (`ssqueeze_rs_tpu_torch.cli`, the
`ssqueeze-tpu-torch` script) against the JAX package's
(`ssqueeze_rs_tpu.cli`): the bare call prints the binding's hello line,
`info` reports without a GPU and builds nothing, `demo` plots headless,
and `bench` refuses with exit code 2 (the port has no benchmark yet).
"""
import os

import matplotlib
matplotlib.use("Agg")

import pytest  # noqa: E402

from ssqueeze_rs_tpu import cli as jcli  # noqa: E402
from ssqueeze_rs_tpu_torch import _build, native  # noqa: E402
from ssqueeze_rs_tpu_torch import compat  # noqa: E402
from ssqueeze_rs_tpu_torch.cli import main  # noqa: E402


def test_bare_prints_hello(capsys):
    assert main([]) == jcli.main([]) == 0
    ours, theirs = capsys.readouterr().out.splitlines()
    assert ours == compat.hello_from_bin() and "ssqueeze" in theirs


def test_info_builds_nothing(capsys, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("info must not compile")

    monkeypatch.setattr(native, "build_library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert out.startswith("ssqueeze_rs_tpu_torch 0.1.0\n")
    assert "CUDA available: False" in out
    loaded = os.path.exists(native.library_path())
    assert ("native host runtime: loaded" in out) == loaded
    assert "CUDA kernel library: not built" in out


def test_demo_runs_headless():
    import warnings
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message=".*non-interactive.*")
        assert main(["demo", "am_cosine", "-N", "512"]) == 0
    import matplotlib.pyplot as plt
    assert plt.get_fignums()
    plt.close("all")


def test_bench_refuses(capsys):
    assert main(["bench"]) == 2
    err = capsys.readouterr().err
    assert "no benchmark yet" in err and "item 10" in err
    with pytest.raises(SystemExit):
        main(["nope"])
