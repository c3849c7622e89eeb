"""Console entry point of the port (``ssqueeze-tpu-torch``; counterpart of
``ssqueeze_rs_tpu/cli.py``).

    ssqueeze-tpu-torch               # the binding's hello line
    ssqueeze-tpu-torch info          # versions, CUDA devices, native runtime
    ssqueeze-tpu-torch demo [name]   # plot a TestSignals demo (-N samples)
    ssqueeze-tpu-torch bench         # the port has no benchmark yet: exit 2
"""
from __future__ import annotations

import argparse
import os
import sys


def _cmd_hello(_args) -> int:
    from .compat import hello_from_bin
    print(hello_from_bin())
    return 0


def _cmd_info(_args) -> int:
    """Report what is there; compile nothing."""
    import torch
    from . import __version__, _build, native

    print(f"ssqueeze_rs_tpu_torch {__version__}")
    cuda = torch.cuda.is_available()
    print(f"torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"CUDA available: {cuda}")
    if cuda:
        print(f"devices: {torch.cuda.device_count()} x "
              f"{torch.cuda.get_device_name(0)}")
    print("native host runtime: " +
          ("loaded" if native._load(build=False) is not None else
           "not built (compiled from native/ssq_native.cpp at first use; "
           "numpy fallback)"))
    print("CUDA kernel library: " +
          ("built" if os.path.exists(_build.library_path()) else
           "not built (nvcc compiles csrc/ at the first launch on a GPU)"))
    return 0


def _cmd_demo(args) -> int:
    from .signals import TestSignals
    TestSignals(N=args.N).demo(args.name)
    return 0


def _cmd_bench(_args) -> int:
    # bench.py times the JAX package; it has no torch route yet
    print("the torch port has no benchmark yet (ROADMAP Queue 1 item 10)",
          file=sys.stderr)
    return 2


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ssqueeze-tpu-torch",
                                description=__doc__)
    sub = p.add_subparsers(dest="cmd")
    sub.add_parser("info", help="versions / CUDA devices / native runtime")
    d = sub.add_parser("demo", help="plot a TestSignals demo")
    d.add_argument("name", nargs="?", default="all")
    d.add_argument("-N", type=int, default=2048)
    sub.add_parser("bench", help="benchmark (not yet: exits 2)")
    args = p.parse_args(argv)
    return {"info": _cmd_info, "demo": _cmd_demo,
            "bench": _cmd_bench, None: _cmd_hello}[args.cmd](args)


if __name__ == "__main__":
    raise SystemExit(main())
