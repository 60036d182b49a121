"""Share (%) of the host's decode forwards in the window spent in their MoE
FFN calls: the ``model.moe`` spans whose parent is one of the window's
``executor.decode_forward`` spans, over those forwards.  None where the
program records no ``model.moe`` span in a decode forward."""


def read(ctx):
    lo, hi = ctx["t0"] * 1e9, ctx["t1"] * 1e9
    spans = getattr(ctx["stamps"], "spans", None) or []
    fwd = {i for i, s in enumerate(spans)
           if s[0] == "executor.decode_forward" and lo <= s[1] and s[2] <= hi}
    moe = sum(s[2] - s[1] for s in spans if s[0] == "model.moe" and s[3] in fwd)
    if not moe:
        return None
    return 100.0 * moe / sum(spans[i][2] - spans[i][1] for i in fwd)
