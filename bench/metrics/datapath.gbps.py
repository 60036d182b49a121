"""The restore datapath's bytes over its measured seconds (GB/s) in the
window: ``RestoreDatapath``'s transfer streams, which time each load op
around a synchronised transfer."""


def read(ctx):
    b, s = ctx["delta"]["dp_bytes"], ctx["delta"]["dp_secs"]
    return b / s / 1e9 if s > 0 and b > 0 else None
