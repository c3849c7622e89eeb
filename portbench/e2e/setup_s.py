"""setup_s: seconds from the start of the run's process until its window
opens: importing torch and the program, reaching the card, loading (at a
checkout's first run, building) the kernels, planning, making the inputs
and warming the cell's shapes."""


def read(ctx):
    return ctx.setup_s
