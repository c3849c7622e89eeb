"""The port's ini tier (`ssqueeze_rs_tpu_torch.config`) against the JAX
package's (`ssqueeze_rs_tpu.config`). Each case runs in a fresh process:
the ini is loaded at import and `load_config_ini` updates the module's
`DEFAULTS` in place, so a test process would carry one case's defaults
into the next. Defaults and `gdefaults` results are host values: equal.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SECTIONED = """
[global]
dtype = float64

[gmw]
gamma = 4.0
beta = 30
norm = energy

[morlet]
mu = 6.0

[make_scales]
downsample = 2

[my_section]
flag = true
name = 'abc'
"""

# ssqueezepy's own configs.ini dialect: '# name' opens a section, '##'
# lines are comments, nothing past '#### END' is read
REFERENCE = """
## wavelets
# gmw
gamma=3.5
beta=20.0
norm=bandpass
order=1
dtype=float64

# bump
mu=4.5
s=1.2

#### END
# morlet
mu=99
"""

GDEFAULTS_CALLS = [
    ("gmw", {"gamma": None, "beta": None}, {}),
    ("wavelets.gmw", {"gamma": 2.0, "beta": None, "extra": 1}, {}),
    ("gmw", {"beta": None}, {}),
    ("morlet", {"mu": None}, {"get_all": True}),
    ("gmw", {"order": None, "gamma": None, "zz": None},
     {"default_order": True}),
    ("bump", {}, {"get_all": True, "as_dict": False}),
    ("make_scales", {"downsample": None}, {"as_dict": True}),
    ("dtype", {"x": None}, {}),
    ("nope", {"a": None}, {}),
]


def _state(pkg, env=None, ini=None):
    """DEFAULTS and the gdefaults results of `pkg` in a fresh process,
    after loading `ini` if given."""
    code = textwrap.dedent(f"""
        import json, sys
        sys.path.insert(0, {REPO!r})
        import {pkg}.config as c
        if {ini!r} is not None:
            c.load_config_ini({ini!r})
        calls = {GDEFAULTS_CALLS!r}
        res = [c.gdefaults(m, **o, **kw) for m, kw, o in calls]
        print(json.dumps({{"DEFAULTS": c.DEFAULTS, "gdefaults": res}}))
    """)
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=300, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu", **(env or {})})
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


def _both(**kw):
    ours = _state("ssqueeze_rs_tpu_torch", **kw)
    theirs = _state("ssqueeze_rs_tpu", **kw)
    assert ours == theirs
    return ours


def test_shipped_defaults_equal():
    state = _both()
    assert state["DEFAULTS"]["gmw"] == {"gamma": 3.0, "beta": 60.0,
                                        "norm": "bandpass", "order": 0}
    assert state["DEFAULTS"]["dtype"] == "float32"


@pytest.mark.parametrize("dialect", ["sectioned", "reference"])
def test_load_config_ini(tmp_path, dialect):
    ini = tmp_path / "my.ini"
    ini.write_text(SECTIONED if dialect == "sectioned" else REFERENCE)
    state = _both(ini=str(ini))
    d = state["DEFAULTS"]
    if dialect == "sectioned":
        assert d["dtype"] == "float64" and d["gmw"]["gamma"] == 4.0
        assert d["gmw"]["beta"] == 30 and d["my_section"]["flag"] is True
        assert d["my_section"]["name"] == "abc"
    else:
        assert d["gmw"]["order"] == 1 and d["gmw"]["dtype"] == "float64"
        assert d["bump"] == {"mu": 4.5, "s": 1.2, "om": 0.0}
        assert d["morlet"]["mu"] == 13.4      # past '#### END'


def test_ssq_tpu_config_env(tmp_path):
    ini = tmp_path / "env.ini"
    ini.write_text(SECTIONED)
    state = _both(env={"SSQ_TPU_CONFIG": str(ini)})
    assert state["DEFAULTS"]["morlet"]["mu"] == 6.0
    assert state["gdefaults"][3] == {"mu": 6.0}
    assert state["gdefaults"][0] == [4.0, 30]


def test_missing_ini_raises(tmp_path):
    from ssqueeze_rs_tpu_torch.config import load_config_ini
    with pytest.raises(FileNotFoundError):
        load_config_ini(tmp_path / "missing.ini")
    for pkg in ("ssqueeze_rs_tpu_torch", "ssqueeze_rs_tpu"):
        res = subprocess.run(
            [sys.executable, "-c", f"import {pkg}.config"],
            capture_output=True, text=True, timeout=300, cwd=REPO,
            env={**os.environ, "JAX_PLATFORMS": "cpu",
                 "SSQ_TPU_CONFIG": str(tmp_path / "missing.ini")})
        assert res.returncode != 0 and "FileNotFoundError" in res.stderr
