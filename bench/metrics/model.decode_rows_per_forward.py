"""Mean requests a forward in the window: the mean ``count`` of the
program's ``executor.decode_forward`` spans, a span without one (a program
that runs one forward a request) read as 1.  None where the program records
no spans."""


def read(ctx):
    lo, hi = ctx["t0"] * 1e9, ctx["t1"] * 1e9
    rows = [s[5] or 1 for s in getattr(ctx["stamps"], "spans", None) or ()
            if s[0] == "executor.decode_forward" and lo <= s[1] and s[2] <= hi]
    return sum(rows) / len(rows) if rows else None
