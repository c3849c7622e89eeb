"""kernel_B.roofline_pct: kernel B's share of its roofline (roofline/
kernel_B.py at the cell's shapes, over the card's peaks, against its
device time a call in the traced window), in %."""

NAMES = ("reassign_kernel<",)


def read(ctx):
    return ctx.roofline_pct("kernel_B", lambda n: any(s in n for s in NAMES))
