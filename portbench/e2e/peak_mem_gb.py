"""peak_mem_gb: torch.cuda.max_memory_allocated() over the window (its
peak statistics reset as it opens), in 1e9 bytes."""


def read(ctx):
    return None if ctx.peak_bytes is None else ctx.peak_bytes / 1e9
