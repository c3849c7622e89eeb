"""kernel_A.roofline_pct: kernel A's share of its roofline: its least time
a call (roofline/kernel_A.py at the cell's shapes, over the card's peaks)
over its device time a call in the traced window, in %. A's launches are
D's launch pair under A's loader and store."""

NAMES = ("ALoad", "PhaseStore")


def read(ctx):
    return ctx.roofline_pct("kernel_A", lambda n: any(s in n for s in NAMES))
