"""The no-JAX check compares top-level module names whole; nothing the
harness or the port imports brings in JAX; the reference imports nothing
of the program."""
import ast
import glob
import os
import subprocess
import sys

import pytest

from conftest import PB
from core import guard


@pytest.mark.parametrize("mods,found", [
    (["ssqueeze_rs_tpu_torch", "ssqueeze_rs_tpu_torch.ops.cwt"], []),
    (["ssqueeze_rs_tpu", "numpy"], ["ssqueeze_rs_tpu"]),
    (["ssqueeze_rs_tpu.ops.cwt"], ["ssqueeze_rs_tpu"]),
    (["jax.numpy", "jaxlib.xla_client", "flax.linen"], ["flax", "jax",
                                                         "jaxlib"]),
    (["jaxtyping", "flaxen", "ssqueeze_rs_tpu_x", "my.jax"], []),
])
def test_top_level_names_compared_whole(mods, found):
    assert guard.forbidden(mods) == found


def test_harness_and_port_load_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "from core import bench, cell, check, control, window\n"
            "b = bench.Bench()\n"
            "for w in b.manifest['workloads']:\n"
            "    _, cfg, traffic = b.cell(w['name'])\n"
            "    b.module('systems', cfg['transform'])\n"
            "    b.module('loops', traffic['loop'])\n"
            "import ssqueeze_rs_tpu_torch as S\n"
            "from ssqueeze_rs_tpu_torch import ssq_cwt, ssq_stft, "
            "TransformServer\n"
            "from core import guard; print(guard.forbidden())\n"
            % (PB, os.path.dirname(PB)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_imports_nothing_of_the_program():
    for path in glob.glob(os.path.join(PB, "reference", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for n in names:
                assert n.split(".")[0] in ("numpy", "scipy", "torch",
                                           "__future__"), (path, n)
