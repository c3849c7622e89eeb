"""kernel_G.roofline_pct: kernel G's share of its roofline (roofline/
kernel_G.py at the cell's shapes, over the card's peaks, against its
device time a call in the traced window), in %."""

NAMES = ("ssq_stft_bluestein",)


def read(ctx):
    return ctx.roofline_pct("kernel_G", lambda n: any(s in n for s in NAMES))
