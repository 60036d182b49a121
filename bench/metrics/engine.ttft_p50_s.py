"""Median wall-clock time to first token (``first_token - admit``) over
every request whose first token came in the window: the restoration and
suffix prefill a returning user waits for, behind the other clients'
decode steps.  Its runs spread too wide to bear an end-to-end bound
(PERF.md, section 2)."""


def read(ctx):
    return ctx["requests"]["ttft_p50_s"]
