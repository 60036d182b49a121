"""The engine clock's advance over the wall clock's across the window.
Below 1: the engine clock credits overlap of compute, I/O and decode that
the serial host did not deliver."""


def read(ctx):
    e = ctx["engine_s"]
    return e / ctx["window_s"] if e > 0 else None
