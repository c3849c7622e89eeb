"""glue.device_ms: device ms a call of every device operation that is not
one of the program's own CUDA kernels (csrc/): padding, cuFFT, filterbank
sampling, the torch.complex packs, elementwise work, copies and sets. The
benchmark's own operations (its inputs, its kept copies) are set apart
by the trace and not counted."""

OWN = ("cwt_d_stage", "reassign", "stft_bluestein", "ola_partials")


def read(ctx):
    if ctx.trace is None or not ctx.calls:
        return None
    glue = ctx.trace.device_s(lambda n: not any(s in n for s in OWN))
    return glue / ctx.calls * 1e3
