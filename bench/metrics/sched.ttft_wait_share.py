"""Median, over the requests whose first token came in the window, of the
share (%) of their wall ``first_token - admit`` that went to other work
than their own: 1 - (the request's own top-level spans between its admit
and first-token stamps: its admission, restoration ops, restore's finish
and suffix prefill) / (first_token - admit).  The rest is other requests'
ops and decode steps, and the engine loop.  None where the program records
no spans."""

import statistics


def read(ctx):
    st = ctx["stamps"]
    own = {}
    for name, a, b, parent, rid, _ in getattr(st, "spans", None) or ():
        if parent == -1 and rid is not None:
            own.setdefault(rid, []).append((a, b))
    shares = []
    for rid, first in st.first.items():
        if rid not in own or not ctx["t0"] <= first <= ctx["t1"]:
            continue
        lo, hi = st.admit[rid] * 1e9, first * 1e9
        busy = sum(b - a for a, b in own[rid] if lo <= a and b <= hi)
        shares.append(1.0 - busy / (hi - lo))
    return 100.0 * statistics.median(shares) if shares else None
