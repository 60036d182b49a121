"""The whole step's share (%) of the chip's bf16 peak: the useful products
of every recompute op, suffix prefill and decode step of the window
(``bench.flops``: causal attention, routed experts only) over the window's
wall seconds times 989 TFLOP/s."""

from bench import flops


def read(ctx):
    shape, total = ctx["shape"], 0
    for _, kind, (t0, t1), (lo, hi) in ctx["ops"]:
        if kind == "compute":
            total += shape.span(t0, t1, lo, hi)
        elif kind == "prefill":
            total += shape.span(t0, t1, lo, hi, 1 if hi == shape.layers else 0)
    for _, step in ctx["decodes"]:
        for _, pos in step:
            total += shape.span(pos, pos + 1, 0, shape.layers, 1)
    return 100.0 * total / (ctx["window_s"] * flops.BF16_FLOP_PER_S)
