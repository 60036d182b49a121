"""Share (%) of the chunk store's fetches in the window served from the
HBM tier: ``io_hits / (io_hits + fetches)``."""


def read(ctx):
    hits, fetches = ctx["delta"]["io_hits"], ctx["delta"]["fetches"]
    return 100.0 * hits / (hits + fetches) if hits + fetches else None
