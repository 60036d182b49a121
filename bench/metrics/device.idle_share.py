"""Share (%) of the traced window in which no kernel or copy ran on the
device: 1 - (union of the device's operation intervals on every stream) /
the window, overlaps counted once."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None                 # a trace that caught no device operation
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
