"""``kv_restore``'s share (%) of its roofline in the traced window: the sum
over its launches (the fused dequantizing scatter of each restoration
load) of its bytes over 3.35 TB/s, from each launch's shapes
(``bench.flops.kv_restore``: the bf16 rows written and the scales read;
the staged rows are written by a copy that ends just before the launch and
may still sit in L2, so they are not counted), over the device time of its
kernel in the trace."""

from bench import flops


def read(ctx):
    tr, spy = ctx["trace"], ctx["spy"]
    secs = tr["kernel_s"].get("kv_restore", 0.0) if tr else 0.0
    launches = spy.counts("kv_restore") if spy else []
    if secs <= 0 or not launches:
        return None
    return 100.0 * sum(flops.bound_s(b, f) for f, b in launches) / secs
