"""The coarse split of kernel D's time (its launch pair
``cwt_d_stage1`` / ``cwt_d_stage2`` of ``csrc/cwt_pair.cuh`` on the
register-radix core, the intermediate Y in L2): the counterpart of the
TPU probe ``tools/cwt_kernel_probe.py`` (its `make_kernel(mode, R, off)`),
as modes of probe P1 (`ablate_cwt_kernel.ablate_cwt`,
``csrc/ablate_cwt.cu``).

    python -m ssqueeze_rs_tpu_torch.tools.cwt_kernel_probe [K] [--device cpu]

At the cwt headline with the derivative (293 rows, M = 2^18, 160 000
kept columns):

  dma    P1 `yonly`: the two launches' loads and stores with no compute
  glue   P1 `nofft`: everything but the radix passes (the Z build, the
         twiddle tables and multiply, the Y round trip, the epilogue)
  full   P1 `full`: kernel D

glue - dma is the arithmetic around the passes, full - glue the passes.
The TPU's `dots4` times its single-bf16 dots, which the port does not
have (ROADMAP, North star): no counterpart.
"""
from __future__ import annotations

from . import _common
from . import ablate_cwt_kernel as acw

__all__ = ["MODES", "run", "main"]

MODES = {"dma": "yonly", "glue": "nofft", "full": "full"}


def run(device, reps=5, size=None, seed=0):
    """Time each mode on `device` (the headline on CUDA, the small shape
    on the CPU unless `size` is given): rows as `ablate_cwt_kernel.run`."""
    size = size or (acw.HEADLINE if device.type == "cuda" else acw.SMALL)
    args, keep = acw.make_inputs(device, size["na"], size["M"], size["L"],
                                 seed)
    rows = []
    for mode, v in MODES.items():
        ms = _common.time_ms(lambda: acw.ablate_cwt(*args, keep, v), device,
                             reps)
        rows.append(_common.row(f"{mode} ({v})", ms,
                                *acw.variant_cost(v, args, keep)))
    return rows


def main(argv=None):
    a = _common.parse_args(argv, "Coarse split of kernel D (probe P1)")
    device = _common.pick_device(a.device)
    rows = run(device, a.K)
    _common.print_rows(rows, _common.card_line(device), width=14)
    return rows


if __name__ == "__main__":
    main()
