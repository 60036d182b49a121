"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished, drawn from the seed with the longest
among them, goes through the plain reference (float32, TF32 off): each
prompt — the session's prefix and the new turn — followed by the tokens
the program served, in one teacher-forced pass.  Two numbers come of it:

* ``logit_gap``: the widest gap, over every served token of the sample, by
  which the reference's logit of the served token lies below its best
  logit at that position.  Greedy tokens of a sound program sit at or
  within rounding of the reference's best.
* ``logit_rms``: the root mean square of the program's logits (the first
  token's and every decode step's, as served) less the reference's, over
  the sample's positions and vocabulary, relative to the root mean square
  of the reference's logits.
* ``logit_err``: for each request, the median over its positions of the
  relative error of the position's logits (the L2 norm of the difference
  over the reference's); the worst request's.  A router's flip at a few
  positions leaves it, a request restored or prefilled wrongly moves it.

A configuration's ``check.limits`` names the numbers that decide
``correct``, each with its limit.  The control (``control=True``) puts the
reference in the program's place one precision below the configuration's
(float8 for bfloat16): the gap of the token the float8 pass puts first at
each position of the same prompts and tokens, and its logits' error.
"""
from __future__ import annotations

import math
from typing import List

import numpy as np
import torch


def sample(finished: List[dict], seed: int, min_tokens: int) -> List[dict]:
    """The longest finished request (prompt and output), then others drawn
    from the seed until the sample holds ``min_tokens`` served tokens."""
    if not finished:
        return []
    size = [f["prefix_len"] + f["new_len"] + len(f["tokens"]) for f in finished]
    first = int(np.argmax(size))
    rng = np.random.default_rng([int(seed), 4])
    picked = [first]
    for i in rng.permutation(len(finished)):
        if sum(len(finished[j]["tokens"]) for j in picked) >= min_tokens:
            break
        if int(i) != first:
            picked.append(int(i))
    return [finished[i] for i in picked]


def _sequence(req: dict, device):
    prompt = np.concatenate([req["prefix_ids"], req["suffix_ids"]])
    served = np.asarray(req["tokens"], dtype=np.int64)
    ids = np.concatenate([prompt, served[:-1]]).astype(np.int64)
    return torch.from_numpy(ids).to(device), len(prompt) - 1, torch.from_numpy(served).to(device)


def numbers(hf: dict, weights: dict, reqs: List[dict], device, ref, *,
            control: bool = False) -> dict:
    """``logit_gap``, ``logit_rms`` and ``logit_err`` of the sample, and
    the share of served tokens that are not the reference's best (per
    request under ``per_request``): the program's, or with ``control`` the
    float8 control's.  ``ref`` is the reference module that the
    configuration names (its ``logits``)."""
    if not reqs:                     # nothing finished: nothing judged sound
        return {"logit_gap": None, "logit_rms": None, "logit_err": None,
                "flip_share": None, "per_request": {}}
    per, err2, ref2 = {}, 0.0, 0.0
    flips = served_n = 0
    for req in reqs:
        ids, first_row, served = _sequence(req, device)
        want = ref.logits(hf, weights, ids, first_row)
        if control:
            got = ref.logits(hf, weights, ids, first_row, precision="fp8")
            served = got.argmax(-1)
        else:
            got = req["logits"].to(device).float()
        best = want.max(-1).values
        gap = float((best - want.gather(1, served[:, None])[:, 0]).max())
        e2, r2 = float((got - want).square().sum()), float(want.square().sum())
        err2, ref2 = err2 + e2, ref2 + r2
        rel = (got - want).norm(dim=-1) / want.norm(dim=-1)
        flips += int((want.argmax(-1) != served).sum())
        served_n += served.numel()
        per[req["rid"]] = {"gap": gap, "rms": math.sqrt(e2 / r2),
                           "err": float(rel.median())}
        del want, got
    return {"logit_gap": max(p["gap"] for p in per.values()),
            "logit_rms": math.sqrt(err2 / ref2),
            "logit_err": max(p["err"] for p in per.values()),
            "flip_share": flips / served_n, "per_request": per}
