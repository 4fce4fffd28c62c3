"""``fit.peak_mem_gib``: the most device memory the allocator held during
the window (``torch.cuda.max_memory_allocated`` after a reset at its
start), in GiB."""


def read(ctx):
    b = ctx.get("window_peak_bytes")
    return b / 2**30 if b else None
