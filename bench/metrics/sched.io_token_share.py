"""Share (%) of the restored (token x layer) units that the I/O pointer
delivered, the rest being recomputed, over the ops the engine dispatched in
the window (the stamps' dispatch hook)."""


def read(ctx):
    io = comp = 0
    for _, kind, (t0, t1), (lo, hi) in ctx["ops"]:
        if kind == "load":
            io += (t1 - t0) * (hi - lo)
        elif kind == "compute":
            comp += (t1 - t0) * (hi - lo)
    return 100.0 * io / (io + comp) if io + comp else None
