"""Peak device memory the run allocated (``torch.cuda.max_memory_allocated``),
read when the window closed and before the reference ran."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9
