"""``flash_decode``'s share (%) of its roofline in the traced window: the sum over
its launches of max(bytes / 3.35 TB/s, products / 989 TFLOP/s), from each
launch's shapes (``bench.flops.flash_decode``), over the device time of its
kernels in the trace."""

from bench import flops


def read(ctx):
    tr, spy = ctx["trace"], ctx["spy"]
    secs = tr["kernel_s"].get("flash_decode", 0.0) if tr else 0.0
    launches = spy.counts("flash_decode") if spy else []
    if secs <= 0 or not launches:
        return None
    return 100.0 * sum(flops.bound_s(b, f) for f, b in launches) / secs
