"""Share (%) of the window's wall clock that the host spends in the
program's MoE FFN calls: the ``model.moe`` spans of the window (one a MoE
layer's FFN, in restoration compute, suffix prefill and decode alike) over
the window.  The host issues the expert layer's launches and waits for
none of them, so this is its issue time.  None where the program records
no such span."""


def read(ctx):
    lo, hi = ctx["t0"] * 1e9, ctx["t1"] * 1e9
    ns = [s[2] - s[1] for s in getattr(ctx["stamps"], "spans", None) or ()
          if s[0] == "model.moe" and lo <= s[1] and s[2] <= hi]
    return 100.0 * sum(ns) / (hi - lo) if ns else None
