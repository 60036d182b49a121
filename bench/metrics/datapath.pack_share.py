"""Share (%) of the restore datapath's load ops' wall time, in the window,
spent packing the stored chunks into the host staging buffers: the
program's ``datapath.pack`` spans over its ``datapath.restore_op`` spans.
None where the program records no spans or ran no load op through the
datapath."""


def read(ctx):
    lo, hi = ctx["t0"] * 1e9, ctx["t1"] * 1e9
    total = {"datapath.pack": 0, "datapath.restore_op": 0}
    for s in getattr(ctx["stamps"], "spans", None) or ():
        if s[0] in total and lo <= s[1] and s[2] <= hi:
            total[s[0]] += s[2] - s[1]
    op = total["datapath.restore_op"]
    return 100.0 * total["datapath.pack"] / op if op else None
