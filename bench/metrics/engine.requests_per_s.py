"""Requests that finished in the window over its wall seconds.  A window
finishes 6 to 9 of them, so one more or less moves it by 11-17%: too
coarse for an end-to-end bound (PERF.md, section 2)."""


def read(ctx):
    return ctx["requests"]["requests_per_s"] if ctx["requests"]["completed"] else None
