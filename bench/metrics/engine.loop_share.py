"""Share (%) of the window that no top-level span of the program covers:
the engine's event loop, its scheduler and hooks, and the serve calls'
own work, outside every op the loop dispatched (a restoration op, a
suffix prefill, a decode step, an admission or a restore's finish).  None
where the program records no spans."""

from bench import stats


def read(ctx):
    lo, hi = ctx["t0"] * 1e9, ctx["t1"] * 1e9
    top = [(s[1], s[2]) for s in getattr(ctx["stamps"], "spans", None) or ()
           if s[3] == -1 and lo <= s[1] and s[2] <= hi]
    if not top:
        return None
    return 100.0 * (1.0 - stats.union_length(top) / (hi - lo))
