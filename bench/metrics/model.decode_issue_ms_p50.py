"""Median wall milliseconds of the program's ``executor.decode_forward``
spans in the window: the host's time to issue one request's one-token
forward (every layer's launches, up to the read of its token).  None where
the program records no spans."""

import statistics


def read(ctx):
    lo, hi = ctx["t0"] * 1e9, ctx["t1"] * 1e9
    ms = [(s[2] - s[1]) / 1e6 for s in getattr(ctx["stamps"], "spans", None) or ()
          if s[0] == "executor.decode_forward" and lo <= s[1] and s[2] <= hi]
    return statistics.median(ms) if ms else None
