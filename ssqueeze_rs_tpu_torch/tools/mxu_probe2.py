"""The second round of the digit-split cost probe: J6
(``csrc/mxu_probe.cu``), the counterpart of the TPU probe
``tools/mxu_probe2.py``.

    python -m ssqueeze_rs_tpu_torch.tools.mxu_probe2 [K] [--device cpu]

GRID = 128 steps a call (8 times the first round) and the operand builds
in full, at the first round's widths:

  q_floor   x + 1 on an (8, 128) tile a step: the floor, J8's kernel
            (`grid_slope_probe`) with every block on the same output
  q_dots    GRID NG products (152, 296) @ (296, 768), bf16, summed
  q_dots4   the same with a 512-column B
  q_trans   an (NA, T) int32 transposed to float32 a step
  q_bcast   each group of G columns of an (NA, T) plane repeated 16 times
            (broadcast_to + reshape)
  q_abuild  the A-operand build (the first round's q_slice8s)
  q_bbuild  the B-operand build: select, halve, a three-way bf16 split of
            both and their concatenation, summed over the groups

The wrappers are `mxu_probe`'s (q_floor's is `grid_slope_probe`'s); the
rows and the device rule are the same.
"""
from __future__ import annotations

from . import _common, grid_slope_probe, mxu_probe
from .mxu_probe import (abuild, abuild_plain, bbuild, bbuild_plain, bcast,
                        bcast_plain, dots, dots_plain, trans, trans_plain)

__all__ = ["QUESTIONS", "HEADLINE", "SMALL", "make_inputs", "question",
           "cost", "run", "main"]

QUESTIONS = ("q_floor", "q_dots", "q_dots4", "q_trans", "q_bcast",
             "q_abuild", "q_bbuild")
# tools/mxu_probe2.py:22-26
HEADLINE = dict(mxu_probe.HEADLINE, GRID=128)
SMALL = dict(mxu_probe.SMALL, GRID=2)


def make_inputs(device, size, seed=0):
    """The round's operands at `size`, made on `device` from `seed`: the
    first round's, the floor's tile, a 512-column B and the
    pre-replicated digit and value planes of q_bbuild."""
    inp = mxu_probe.make_inputs(device, size, seed)
    g = _common.generator(device, seed + 1)
    NA, NG = size["NA"], size["NG"]
    inp.update(X=_common.randn(g, 8, 128),
               B4=_common.randn(g, NA, 512).to(inp["B"].dtype),
               KLR=_common.randint(g, 16, NA, 128 * NG),
               VRR=_common.randn(g, NA, 128 * NG))
    return inp


def question(name, inp, size, plain=False):
    """Question `name` on the operands of `make_inputs`: through its
    wrapper (the kernel on CUDA) or, with `plain`, its plain version."""
    grid, NG, G = size["GRID"], size["NG"], size["G"]
    if name == "q_floor":
        return (grid_slope_probe.grid_slope_plain if plain else
                grid_slope_probe.grid_slope)(inp["X"], grid, False)
    if name == "q_dots":
        return (dots_plain if plain else dots)(inp["A"], inp["B"], grid * NG)
    if name == "q_dots4":
        return (dots_plain if plain else dots)(inp["A"], inp["B4"], grid * NG)
    if name == "q_trans":
        return (trans_plain if plain else trans)(inp["K32"], grid)
    if name == "q_bcast":
        return (bcast_plain if plain else bcast)(inp["V"], G, grid)
    if name == "q_abuild":
        return (abuild_plain if plain else abuild)(inp["KHT"], NG, G,
                                                   size["F1"], grid)
    if name == "q_bbuild":
        return (bbuild_plain if plain else bbuild)(inp["KLR"], inp["VRR"], NG,
                                                   G, grid)
    raise ValueError(f"question must be one of {QUESTIONS} (got {name!r})")


def cost(name, size):
    """(bytes, operations, rate): `mxu_probe.cost`, and q_floor's as J8's
    constant-output tile."""
    if name == "q_floor":
        return (*grid_slope_probe.config_cost(8, 128, False, size["GRID"]),
                _common.F32_FLOP_S)
    return mxu_probe.cost(name, size)


def run(device, reps=5, size=None, seed=0):
    """Time every question on `device` (HEADLINE on CUDA, SMALL on the
    CPU unless `size` is given)."""
    size = size or (HEADLINE if device.type == "cuda" else SMALL)
    return mxu_probe.run_questions(device, QUESTIONS, question, cost,
                                   make_inputs(device, size, seed), size,
                                   reps)


def main(argv=None):
    a = _common.parse_args(argv, "Costs around the digit-split product "
                                 "(probe J6, round 2)")
    device = _common.pick_device(a.device)
    rows = run(device, a.K)
    _common.print_rows(rows, _common.card_line(device))
    return rows


if __name__ == "__main__":
    main()
