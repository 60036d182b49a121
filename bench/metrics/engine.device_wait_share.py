"""Share (%) of the window in which the host waited for the device: the
program's wait spans (``engine.device_wait``, the synchronise after each
op; the restore datapath's ``ring_wait`` and ``measure_wait``;
``executor.token_read``, the read of a greedy token) in the window, over
its wall seconds.  None where the program records no spans."""

WAITS = ("engine.device_wait", "datapath.ring_wait", "datapath.measure_wait",
         "executor.token_read")


def read(ctx):
    lo, hi = ctx["t0"] * 1e9, ctx["t1"] * 1e9
    spans = [s for s in getattr(ctx["stamps"], "spans", None) or ()
             if lo <= s[1] and s[2] <= hi]
    if not spans:
        return None
    return 100.0 * sum(s[2] - s[1] for s in spans if s[0] in WAITS) / (hi - lo)
