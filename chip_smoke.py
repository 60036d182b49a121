#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py                   # build + kernel phase + serve, dense, family, CLI phases
    python3 chip_smoke.py --kernels-only    # build + kernel phase only
    python3 chip_smoke.py --profile         # also trace one serve of each model
    python3 chip_smoke.py --decode-sweep    # kernel phase + flash_decode over S, B
    python3 chip_smoke.py --prefill-sweep   # kernel phase + flash_prefill over n_split
    python3 chip_smoke.py --wkv-sweep       # kernel phase + wkv6 over (chunk, cols)
    python3 chip_smoke.py --quant-sweep     # kernel phase + kv_quantize over (N, branch)
    python3 chip_smoke.py --rglru-sweep     # kernel phase + rglru_scan over (C, T, stages)
    python3 chip_smoke.py --quant-only      # build + kv_quantize alone (any tree)
    python3 chip_smoke.py --promote-profile # build + a traced qwen3 serve's promotion
    python3 chip_smoke.py --train-only      # build + the train phase alone
    python3 chip_smoke.py --wkv-bwd-only    # build + wkv6's backward check alone (any tree)
    python3 chip_smoke.py --dist-only       # build + the dist phase alone
    python3 chip_smoke.py --dryrun-only     # build + the dryrun phase alone

It builds every kernel of the port from ``src/repro_torch/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version at the shapes
of the port's three paths (qwen3-8b: Hq 32, Hkv 8, Dh 128, bf16;
recurrentgemma-2b: Hq 10, Hkv 1, Dh 256 over a 2048-slot ring with a
window, and the RG-LRU scan over width 2560 in f32; rwkv6-7b: the wkv
recurrence over 64 heads of 64 in f32), then serves four requests through
``RealServingEngine`` on each model at full width and depth with random
bf16 weights — qwen3-8b with CacheFlow two-pointer restoration from an int8
chunk store, recurrentgemma-2b with restoration of attention KV and RG-LRU
state, rwkv6-7b with layer-wise restoration of its wkv and token-shift
state — with suffix prefill, greedy decode and every restored cache
verified, and checks that each kernel of a path launched during that
path's serve (and that only the two ``wkv6`` kernels launched during the
RWKV serve).  The qwen3 int8 serve's schedule is captured: the trace is
saved under ``build/chip_smoke/``, linted (no finding), replayed analytically
(equal to the capture) and replayed on the card by a fresh executor with
its own int8 chunk store (the same ops log, every request verified within
the store's ``max_scale``; whether the greedy tokens match is printed).  The
crossover L_Δ between token- and layer-wise restoration is measured on
qwen3-8b (``profile_measured``, lengths 256-4096) beside the analytic H100
value.  The dense phase serves each dense config the port added
(llama3.1-8b from an int8 store, phi4-mini-3.8b, qwen1.5-0.5b, and
qwen1.5-110b and mistral-large-123b at full width cut to 8 layers), every
request verified, its attention kernels (and llama's store kernels)
launched and its greedy tokens held by a second unquantized serve; the
kernel phase checks both attention kernels at those configs' new shapes
(Dh 64 with G 1, G 3, G 12) and holds every ``flash_prefill`` entry to two
more checks (``rounding_ratio`` at most 1, and its error against f32 no
larger than the plain version's).  The family phase serves the MoE, MLA and
embedding-input configs the same way (qwen3-30b-a3b and deepseek-v2-236b,
cut to 4 of its 60 layers, from int8 stores; deepseek-moe-16b, pixtral-12b
and musicgen-large with none), every request verified on its cache's fields
(k/v, or the MLA latent ckv), its path's kernels launched, its greedy tokens
(the embedding models: first-token logits) held by another serve; the
kernel phase checks both attention kernels at their shapes (G 8 and G 1 at
Dh 128, 32 heads at Dh 64) and the three store kernels at their rows of
512 and 576 channels.  Last, ``python -m repro_torch.launch.serve`` runs in
process as a user runs it: a simulation, full-width int8 qwen3-8b for real
with ``--trace-out``, ``--replay`` of that trace analytically (with
``--timeline-out``) and on the card, full-width recurrentgemma-2b and
rwkv6-7b for real, the int8 qwen3-8b call again under ``--sanitize
--telemetry --metrics-out --timeline-out``, llama3.1-8b and the MoE
qwen3-30b-a3b simulated, and qwen3-30b-a3b and llama3.1-8b for real, each
``--real`` call required to launch its path's kernels; one ``{"cli": [...]}`` line gives
each call's wall seconds, TTFT, TPOT and launches.  Then the sanitizer's
copy-on-write check runs on a CUDA block pool.  Last, the train phase
trains through the port in f32: ``rglru_scan``'s gradient Function (its
backward the same kernels over reversed time) against autograd of the
plain loop on the card and against the CPU at W 2560; one step of
full-width qwen1.5-0.5b and of full-width recurrentgemma-2b cut to three
layers (which launches ``rglru_scan`` both ways), each against the CPU,
every parameter's gradient finite and non-zero; 100 steps of full-width
qwen1.5-0.5b through ``launch.train.run`` (ms a step, tokens/s, peak
memory) and the reduced model's loss falling at the reference test's
setting; a restart from a manifest after an injected failure; wkv6's
backward kernel against its plain version and autograd of the plain scan,
both in f64, at S = 1-256 (bit for bit across two calls), and timed at S 64
and at S 4096 (there held to the f64 plain version alone); one step of
full-width rwkv6-7b cut to two layers against the CPU (which launches wkv6
forward and backward); and the reduced rwkv6-7b through ``launch.train.run``
with its loss falling.  Then the dist phase: four ranks spawned on the one
card over gloo (the kernel library built by this process first) run
``lse_decode_attention`` at qwen3-8b's attention width over a 4096-slot
cache sharded 1024 slots a rank with a 16-slot tail on rank 0, each rank's
partial through ``flash_decode_partials`` (the combine kernel's partials
mode), held to one-process ``flash_decode`` over [cache || tail] and to
f32, with a shard and a row that see no slot; ``error_feedback_psum``
over the ranks, equal to their run on host tensors; and one sharded
``decode_step`` each of full-width qwen3-8b (2 layers: the cache's 8
kv-heads over the ranks, ``flash_decode`` on 2 a rank), recurrentgemma-2b
(3 layers: its one kv-head, so the cache along its sequence through
``flash_decode_partials`` and the LSE combine, and the RG-LRU one-step
kernel on 640 of 2560 lanes) and rwkv6-7b (2 layers: ``wkv6``'s one-step
kernel on 16 of 64 heads) held to the step in one process (logits by
``rounding_check``, the greedy token), each rank's launches and its
kernels' local shapes asserted.  Last, the dryrun phase: steps of
qwen3-8b (4 layers: decode at B 8 over 4096 slots, a 256-token chunk over
3840), recurrentgemma-2b (3 layers) and rwkv6-7b (2 layers; a 256-token
prefill and a decode step each) counted by ``repro_torch.launch.op_cost``
on the card and traced on meta: dot_flops equal, the kernels' notes equal
to their launches, every output's and wrapper's meta shapes equal to the
card's.  After the dense phase, append-buffer decode
(``Model.decode_step_append``) on full-width qwen3-8b over a 2048-token
prefix against ``decode_step`` on the same tokens; in the family phase,
qwen3-30b-a3b's ``moe_groups`` and einsum-dispatch checks.  The
second-to-last line of stdout is a ``{"kernels": [...]}`` summary; the last
line is the ok/device record.  Any failure raises (exit code != 0).  Imports nothing of JAX or
``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

OUT_DIR = os.path.join(HERE, "build", "chip_smoke")   # ignored by git: traces, timelines
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
# Largest |kernel - plain| the attention checks accept.  Outputs of the N(0,1)
# inputs reach 0.1-0.6.  Measured on an H100 (PERF.md): prefill differs by at
# most 3.91e-3 (2^-8), one bf16 step of an output in [0.5, 1): both round
# their output to bf16, and each rounds its probabilities to bf16 before P.V
# (the plain version the normalised ones, the kernel the unnormalised ones),
# so one step apart is expected; decode, f32 in both but summed in another
# order over the splits of the cache, by at most 2.44e-4, one bf16 step of an
# output near 0.05.  The decode bound is about four times that.
PREFILL_TOL = 4e-3
DECODE_TOL = 1e-3
# Two more checks hold each prefill entry at its timed shape, element by
# element and against f32:
#  * rounding_ratio <= 1: |kernel - plain| within the two sides' roundings,
#    one bf16 rounding of every probability on each side (relative 2^-9
#    each, so 2^-8 * sum_j p_j |v_j| together, sum_j p_j |v_j| computed in
#    f32) plus one bf16 step of max(|kernel|, |plain|) for the two output
#    roundings.  A bound of one bf16 step of the output alone does not hold
#    where the output is near 0 and the sum cancels (the step shrinks with
#    the output, the probabilities' rounding does not): the entries print
#    that ratio as max_bf16_steps.
#  * the kernel's largest |kernel - f32| is no larger than the plain
#    version's largest |plain - f32| (f32 being the plain version run in f32).
# rglru_scan repeats its plain version's IEEE arithmetic step by step (expf,
# a multiply, then an add, all in f32), so it is held to equality.
RGLRU_TOL = 0.0
# wkv6, the one-step kernel (S = 1): max |kernel - plain| / max |plain|.  Its
# state update repeats the plain version's IEEE arithmetic (a product, a
# product, a sum), so s_last is held to equality; y sums its 64-term dot
# products in another order.  Measured on an H100 (PERF.md): y within 1.6e-7
# of max |y|; the bound is about three times that.
WKV6_Y_TOL = 5e-7
WKV6_S_TOL = 0.0
# wkv6, the chunked kernel (S >= 2): max |kernel - f64| / max |f64| on y and
# on s_last, f64 being the plain sequential version run in float64.  The
# chunked form sums in another order than the sequential scan, so neither
# output is bit-exact against the f32 plain version; on the CPU the product
# form and the f32 sequential scan both land 1e-7 to 7e-7 from f64
# (tests/test_torch_wkv6.py), and the bound is about three times that.
WKV6_F64_TOL = 1e-6
# wkv6's backward kernel (f32) against wkv6_backward_plain run in float64, and
# against autograd of wkv6_plain run in float64, both on the card: max |kernel
# - f64| / max |f64| for each of the six gradients.  On the CPU the f32 plain
# backward lands up to 5.6e-7 from f64 at S <= 256
# (tests/test_torch_wkv6_backward.py); the bound is about three times that.
WKV6_BWD_TOL = 2e-6
# The backward kernel at the reference's train_4k sequence length, (1, 4096,
# 64, 64) at the model's decays, s0 zero and ds_last None, against the plain
# backward in f64 (max |kernel - f64| / max |f64| for each gradient).  Its
# reason: what the earlier step-by-step backward kernel reached there on an
# H100 (PERF.md), times at most 3: 2.08e-6 (du, a sum over 4096 steps; the
# other gradients 4.2e-7 to 7.2e-7).
WKV6_BWD_LONG = 4096
WKV6_BWD_LONG_TOL = 6e-6


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def bound(nbytes: float, flops: float, flop_rate: float = BF16_FLOP_PER_S):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, *, iters: int = 21, flush=None):
    """Median device time of ``fn`` over ``iters`` launches, CUDA events
    around each launch; ``flush`` (run outside the timed window) evicts L2
    first so the kernel finds its inputs in device memory, as the serving
    path does.  A 1 ms spin on the device before the first event keeps it
    busy until the host has enqueued the whole call, so the window holds
    device time only, not the host's time to launch."""
    import statistics

    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        torch.cuda._sleep(2_000_000)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def kernels_us(fn, flush=None, iters: int = 5, match="flash_decode"):
    """Device time per call of each kernel ``fn`` launches whose name holds
    ``match`` (one substring or a tuple of them; torch.profiler), after
    ``flush`` as in ``time_ms`` or, without one, with the inputs warm in L2
    from the call before.  A trace that holds a kernel a number of times
    that is not a multiple of ``iters`` lost some of its launches and is
    tried again.  None (printed null, and listed on the
    ``kernels_us_missing`` line) when every try's trace came back without
    them or without some of their launches, so a missing reading never
    reads as an empty or a short one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # a trace now and then comes back without the device's events, or
    # without some launches: up to three tries
    for _ in range(3):
        out, whole = {}, True
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = getattr(e, "self_cuda_time_total", 0)
            if any(m in e.key for m in ((match,) if isinstance(match, str) else match)) and us:
                name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
                out[name.removeprefix("void ").split("::")[-1].strip()] = us / iters
                whole = whole and e.count % iters == 0
        if out and whole:
            return out
    return None


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def ptxas_spills(log: str) -> dict:
    """{source: [function, ...]} of every kernel the ptxas report shows
    spilling (nonzero spill stores or loads)."""
    import re
    out, src, fn = {}, None, None
    for line in log.splitlines():
        if line.startswith("== "):
            src = line[3:].strip()
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and (int(m.group(1)) or int(m.group(2))):
            out.setdefault(src, []).append(fn)
    return out


def prefill_timing(q, k, v, kpos, q_off: int, window: int, flush, sm: int) -> dict:
    """flash_prefill at one shape: kernel, plain version and SDPA (boolean
    mask over K/V expanded to every query head) by CUDA events, inputs cold
    in L2; each of the kernel's launches (split kernel, combine) by
    torch.profiler, cold and warm; the bound from the visible (query, key)
    pairs of this run's kpos; the plan's M tile and n_split."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_prefill import _plan, flash_prefill, flash_prefill_plain

    b, sq, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    scale = dh ** -0.5
    kw = dict(scale=scale, window=window)
    qpos = q_off + torch.arange(sq, device=q.device)
    mask = (kpos[None] >= 0) & (kpos[None] <= qpos[:, None])
    if window > 0:
        mask &= kpos[None] > qpos[:, None] - window
    pairs = int(mask.sum())
    out = flash_prefill(q, k, v, kpos, q_off, **kw)
    bms, by = bound(nbytes(q, k, v, kpos, out), 4 * hq * dh * pairs * b)
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)

    def call():
        return flash_prefill(q, k, v, kpos, q_off, **kw)
    ms = time_ms(call, flush=flush)
    m_tile, n_split, split_slots = _plan(b, hkv, sq, hq // hkv, s, sm)
    # the kernel and the plain version against the f32 answer (the plain
    # version in f32 throughout), and element by element against each other
    plain = flash_prefill_plain(q, k, v, kpos, q_off, **kw)
    ref32 = flash_prefill_plain(q.float(), k.float(), v.float(), kpos, q_off, **kw)
    return dict(
        ms=ms,
        err_vs_f32=float((out.float() - ref32).abs().max()),
        plain_err_vs_f32=float((plain.float() - ref32).abs().max()),
        **rounding_check(out, plain, flash_prefill_plain(
            q.float(), k.float(), v.float().abs(), kpos, q_off, **kw)),
        plain_ms=time_ms(lambda: flash_prefill_plain(q, k, v, kpos, q_off, **kw),
                         flush=flush, iters=7),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale), flush=flush),
        bound_ms=bms, bound_by=by, bound_share=bms / ms,
        kernels_us=kernels_us(call, flush, match="flash_prefill"),
        kernels_us_warm=kernels_us(call, match="flash_prefill"),
        m_tile=m_tile, n_split=n_split, split_slots=split_slots)


def bf16_step(x):
    """One bf16 step (unit in the last place) at each |x|: 2^(e - 8) for x
    in [2^(e-1), 2^e)."""
    import torch
    _, e = torch.frexp(x)
    return torch.ldexp(torch.ones_like(x), e - 8)


def rounding_check(out, plain, abs_weighted) -> dict:
    """|out - plain| element by element against the two sides' bf16
    roundings: ``rounding_ratio`` is the largest |out - plain| / (2^-8 *
    sum_j p_j |v_j| + one bf16 step of max(|out|, |plain|)), ``abs_weighted``
    being sum_j p_j |v_j| in f32; ``max_bf16_steps`` the largest
    |out - plain| in bf16 steps of max(|out|, |plain|) alone."""
    import torch
    d = (out.float() - plain.float()).abs()
    step = bf16_step(torch.maximum(out.float().abs(), plain.float().abs()))
    return dict(rounding_ratio=float((d / (2 ** -8 * abs_weighted + step)).max()),
                max_bf16_steps=float((d / step).max()))


def decode_timing(q, k, v, kpos, q_pos: int, window: int, flush, sm: int) -> dict:
    """flash_decode at one shape: kernel, plain version and SDPA (boolean mask
    over K/V expanded to every query head) by CUDA events, inputs cold in L2;
    its two kernels by torch.profiler, cold and warm; the bound from the
    bytes of the whole cache (decode reads every slot); the plan's n_split."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import _split_plan, flash_decode, flash_decode_plain

    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    kw = dict(scale=dh ** -0.5, window=window)
    out = flash_decode(q, k, v, kpos, q_pos, **kw)
    bms, by = bound(nbytes(q, k, v, kpos, out), 4 * hq * dh * s * b)
    mask = (kpos >= 0) & (kpos <= q_pos)
    if window > 0:
        mask &= kpos > q_pos - window
    kt = k.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)

    def call():
        return flash_decode(q, k, v, kpos, q_pos, **kw)
    ms = time_ms(call, flush=flush)
    return dict(
        ms=ms,
        plain_ms=time_ms(lambda: flash_decode_plain(q, k, v, kpos, q_pos, **kw), flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            q[:, :, None], kt, vt, attn_mask=mask[None], scale=kw["scale"]), flush=flush),
        bound_ms=bms, bound_by=by, bound_share=bms / ms,
        kernels_us=kernels_us(call, flush), kernels_us_warm=kernels_us(call),
        n_split=_split_plan(b, hkv, s, sm)[1])


# ---------------------------------------------------------------------------
# Kernel phase: each kernel against its plain version at the path's shapes
# ---------------------------------------------------------------------------


def kernel_phase(dev, card: str) -> dict:
    import torch
    from repro_torch.kernels.flash_decode import (_split_plan, flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.flash_prefill import flash_prefill, flash_prefill_plain

    g = torch.Generator(device=dev).manual_seed(1)
    hq, hkv, dh, s = 32, 8, 128, 4096
    scale = dh ** -0.5
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB

    def flush():
        scratch.zero_()

    res = {}
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    def attn_case(kernel, plain, q, s_, valid, q_last, *at):
        """One check laid out like the serve's cache: slot j holds position
        j for j < valid and is empty (kpos -1) after.  Slots no query may
        see (empty, or past the last query position q_last) hold V = 100,
        so attending to one moves the output by far more than the
        tolerance; a wrongly skipped key tile shows as a plain error."""
        k_, v_ = randn(1, s_, hkv, dh), randn(1, s_, hkv, dh)
        kp = torch.arange(s_, dtype=torch.int32, device=dev)
        kp[valid:] = -1
        v_[:, (kp < 0) | (kp > q_last)] = 100.0
        out = kernel(q, k_, v_, kp, *at, scale=scale)
        ref = plain(q, k_, v_, kp, *at, scale=scale)
        return dict(max_abs_err=float((out.float() - ref.float()).abs().max()),
                    max_abs_ref=float(ref.float().abs().max()), slots=s_,
                    valid=valid, at=at[0])

    # 1. flash_prefill: the last 256-token chunk of a 4096-token prefix
    # (timed), then two checks: a 200-row recompute chunk at position 1024
    # of a cache whose loaded slots run to 3000 (the key tiles past the
    # chunk are skipped) and a 64-token suffix prefill after a 3000-token
    # prefix in a cache grown to 3100 slots (trailing empty slots); then
    # the serve's longest suffix (timed): 64 rows at 4096 over its
    # 4176-slot cache, slots past 4159 empty; and rows that see no slot:
    # a 256-row chunk at 0 over 1024 slots, 512 of them at position 128 and
    # 512 at 5000 (rows 0-127 see nothing, rows 128-255 see 512 slots; the
    # M tiles fill the card, so the kernel's own epilogue takes them), V N(0, 1)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    from repro_torch.kernels.flash_prefill import _plan
    sq, q_off = 256, s - 256
    q = randn(1, sq, hq, dh)
    k = randn(1, s, hkv, dh)
    v = randn(1, s, hkv, dh)
    kpos = torch.arange(s, dtype=torch.int32, device=dev)
    out = flash_prefill(q, k, v, kpos, q_off, scale=scale)
    ref = flash_prefill_plain(q, k, v, kpos, q_off, scale=scale)
    cases = [dict(max_abs_err=float((out.float() - ref.float()).abs().max()),
                  max_abs_ref=float(ref.float().abs().max()), slots=s,
                  valid=s, at=q_off, rows=sq),
             attn_case(flash_prefill, flash_prefill_plain, randn(1, 200, hq, dh),
                       4150, 3000, 1223, 1024) | dict(rows=200),
             attn_case(flash_prefill, flash_prefill_plain, randn(1, 64, hq, dh),
                       3100, 3064, 3063, 3000) | dict(rows=64),
             attn_case(flash_prefill, flash_prefill_plain, randn(1, 64, hq, dh),
                       4176, 4160, 4159, 4096) | dict(rows=64)]
    qm, km, vm = randn(1, 256, hq, dh), randn(1, 1024, hkv, dh), randn(1, 1024, hkv, dh)
    kpm = torch.full((1024,), 5000, dtype=torch.int32, device=dev)
    kpm[:512] = 128
    ref = flash_prefill_plain(qm, km, vm, kpm, 0, scale=scale)
    cases.append(dict(max_abs_err=float((flash_prefill(qm, km, vm, kpm, 0, scale=scale)
                                         .float() - ref.float()).abs().max()),
                      max_abs_ref=float(ref.float().abs().max()), slots=1024, at=0,
                      rows=256, rows_seeing_nothing=128, tol=PREFILL_TOL))
    for c in cases:
        c["m_tile"], c["n_split"] = _plan(1, hkv, c["rows"], hq // hkv, c["slots"], sm)[:2]
    torch.cuda.synchronize()
    err = max(c["max_abs_err"] for c in cases)
    res["flash_prefill"] = dict(
        max_abs_err=err, tol=PREFILL_TOL, cases=cases,
        **prefill_timing(q, k, v, kpos, q_off, 0, flush, sm),
        shape=f"q (1,{sq},{hq},{dh}) over {s} keys, q_offset {q_off}, bf16")
    qs_, ks_, vs_ = randn(1, 64, hq, dh), randn(1, 4176, hkv, dh), randn(1, 4176, hkv, dh)
    kps_ = torch.arange(4176, dtype=torch.int32, device=dev)
    kps_[4160:] = -1
    ref = flash_prefill_plain(qs_, ks_, vs_, kps_, 4096, scale=scale)
    res["flash_prefill_suffix"] = dict(
        max_abs_err=float((flash_prefill(qs_, ks_, vs_, kps_, 4096, scale=scale).float()
                           - ref.float()).abs().max()), tol=PREFILL_TOL,
        **prefill_timing(qs_, ks_, vs_, kps_, 4096, 0, flush, sm),
        shape="q (1,64,32,128) at q_offset 4096 over 4176 slots, 4160-4175 empty, bf16")
    del qs_, ks_, vs_, qm, km, vm

    # 2. flash_decode: one token over 4096 slots (timed), then checks at the
    # edges of its split over the cache: position 3000 of a 4096-slot cache
    # whose slots run to 3500 (slots 3001-3499 masked by position, 3500 on
    # empty: whole splits masked); position 100 of a full 4096-slot cache
    # (every split but the first masked); the serve's four cache lengths,
    # none a whole number of tiles, at their last position; two batch rows
    # with their own K/V and a masked tail; a query below every kpos (no
    # slot visible: the mean of V, V N(0, 1)).  Each case names its n_split.
    qd = randn(1, hq, dh)
    out = flash_decode(qd, k, v, kpos, s - 1, scale=scale)
    ref = flash_decode_plain(qd, k, v, kpos, s - 1, scale=scale)
    cases = [dict(max_abs_err=float((out.float() - ref.float()).abs().max()),
                  max_abs_ref=float(ref.float().abs().max()), slots=s,
                  valid=s, at=s - 1),
             attn_case(flash_decode, flash_decode_plain, qd, s, 3500, 3000, 3000),
             attn_case(flash_decode, flash_decode_plain, qd, s, s, 100, 100)]
    for sl in (592, 1616, 2640, 4176):
        cases.append(attn_case(flash_decode, flash_decode_plain, qd, sl, sl,
                               sl - 1, sl - 1))
    kpm = kpos + 100
    ref = flash_decode_plain(qd, k, v, kpm, 50, scale=scale)
    cases.append(dict(max_abs_err=float((flash_decode(qd, k, v, kpm, 50, scale=scale)
                                         .float() - ref.float()).abs().max()),
                      max_abs_ref=float(ref.float().abs().max()), slots=s, at=50,
                      seeing_nothing=True, tol=DECODE_TOL))
    for c in cases:
        c["n_split"] = _split_plan(1, hkv, c["slots"], sm)[1]
    q2, k2, v2 = randn(2, hq, dh), randn(2, 2640, hkv, dh), randn(2, 2640, hkv, dh)
    kp2 = torch.arange(2640, dtype=torch.int32, device=dev)
    kp2[2600:] = -1
    v2[:, 2600:] = 100.0
    ref = flash_decode_plain(q2, k2, v2, kp2, 2599, scale=scale)
    cases.append(dict(
        max_abs_err=float((flash_decode(q2, k2, v2, kp2, 2599, scale=scale).float()
                           - ref.float()).abs().max()),
        max_abs_ref=float(ref.float().abs().max()), batch=2, slots=2640,
        valid=2600, at=2599, n_split=_split_plan(2, hkv, 2640, sm)[1]))
    # the instantiations off the model paths: 40 query heads on 2 KV heads
    # (G 20: two groups, 16 and 4 padded to 16), 24 on 4 (G 6 padded to 10)
    kp2 = torch.arange(1000, dtype=torch.int32, device=dev)
    for hq2, hkv2 in ((40, 2), (24, 4)):
        q2, k2, v2 = randn(1, hq2, dh), randn(1, 1000, hkv2, dh), randn(1, 1000, hkv2, dh)
        ref = flash_decode_plain(q2, k2, v2, kp2, 999, scale=scale)
        cases.append(dict(
            max_abs_err=float((flash_decode(q2, k2, v2, kp2, 999, scale=scale).float()
                               - ref.float()).abs().max()),
            max_abs_ref=float(ref.float().abs().max()), heads=f"{hq2} on {hkv2}",
            slots=1000, valid=1000, at=999, n_split=_split_plan(1, hkv2, 1000, sm)[1]))
    del q2, k2, v2
    torch.cuda.synchronize()
    err = max(c["max_abs_err"] for c in cases)
    res["flash_decode"] = dict(
        max_abs_err=err, tol=DECODE_TOL, cases=cases,
        **decode_timing(qd, k, v, kpos, s - 1, 0, flush, sm),
        shape=f"q (1,{hq},{dh}) over {s} slots, bf16")
    del q, k, v

    # 3. kv_restore
    restore_cases(dev, g, flush, res)

    # 4. kv_quant
    quant_cases(dev, g, flush, res)

    hybrid_kernel_cases(dev, g, flush, res)
    rwkv_kernel_cases(dev, g, flush, res)
    dense_kernel_cases(dev, g, flush, res)
    family_store_cases(dev, g, flush, res)

    for name, r in res.items():
        line = {("max_err" if k == "max_abs_err" else "kernel_ms" if k == "ms" else k): v
                for k, v in r.items()}
        print(json.dumps({"kernel_check": name, "card": card, **line}))
    # each entry's checked error is relative where it names one
    bad = [n for n, r in res.items()
           if not r.get("max_rel_err", r["max_abs_err"]) <= r["tol"]
           or r.get("bit_exact") is False or r.get("invariant_512") is False
           or r.get("finite") is False
           or not r.get("s_last_max_rel_err", 0.0) <= r.get("s_last_tol", 0.0)
           # within the two sides' bf16 roundings (see rounding_check)
           or not r.get("rounding_ratio", 0.0) <= 1
           or not r.get("err_vs_f32", 0.0) <= r.get("plain_err_vs_f32", float("inf"))
           or not all(c["rounding_ratio"] <= 1 and c["err_vs_f32"] <= c["plain_err_vs_f32"]
                      for c in r.get("cases", []) if "rounding_ratio" in c)]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return res


def rows_plan_fields(p) -> dict:
    """The fields of a dequant_rows plan to print: channels a unit (16, or 1
    for the scalar instance), rows a thread, grid."""
    return dict(unit=p.unit, rows_a_thread=p.rpt, grid=list(p.grid))


def restore_cases(dev, g, flush, res: dict):
    """kv_restore against kv_restore_plain by torch.equal, each case printing
    its plan: the serve's load op (int8, 2 fields x 18 of 36 slots x 256
    tokens at C 1024 into bf16 caches of 4096 slots from t0 1024, 16-token
    chunks; timed), its raw copy in bf16 (timed, beside one ``copy_`` a
    field) and in f32, int8 into f32 caches, a ragged last chunk (40 rows),
    rows < T (t0 100 below S: the prefix's tail past S dropped), C 1000 and a
    staging view 4 bytes off alignment (both the scalar instance)."""
    import torch
    from repro_torch.kernels.kv_restore import (kv_restore_plain, kv_restore_plan,
                                                kv_restore_scatter)

    bf = torch.bfloat16
    a, s, c, cs, ns, t0 = 36, 4096, 1024, 16, 18, 1024

    def inputs(t, c=c, dtype=bf, quant=True, offset=0):
        caches = [torch.randn(a, s, c, generator=g, device=dev).to(dtype) for _ in range(2)]
        if not quant:
            return caches, [torch.randn(a, t, c, generator=g, device=dev).to(dtype)
                            for _ in range(2)], None
        staged = [torch.randint(-127, 128, (offset + a * t * c,), generator=g, device=dev,
                                dtype=torch.int8)[offset:].view(a, t, c) for _ in range(2)]
        scl = [torch.rand(-(-t // cs), c, generator=g, device=dev) * 0.05 for _ in range(2)]
        return caches, staged, scl

    def check(name, caches, staged, scl, t0=t0):
        kw = dict(t0=t0, slot_lo=0, n_slots=ns, chunk_size=cs)
        got = [x.clone() for x in caches]
        want = [x.clone() for x in caches]
        kv_restore_scatter(got, staged, scl, **kw)
        kv_restore_plain(want, staged, scl, **kw)
        torch.cuda.synchronize()
        out = dict(case=name, staged=list(staged[0].shape), dtype=str(caches[0].dtype)[6:],
                   int8=scl is not None, t0=t0, rows=min(staged[0].shape[1], s - t0),
                   bit_exact=all(torch.equal(x, y) for x, y in zip(got, want)),
                   max_abs_err=max(float((x.float() - y.float()).abs().max())
                                   for x, y in zip(got, want)),
                   **rows_plan_fields(kv_restore_plan(got, staged, scl, **kw)))
        print(json.dumps({"kv_restore_case": out}))
        return out

    def timing(caches, staged, scl, moved):
        kw = dict(t0=t0, slot_lo=0, n_slots=ns, chunk_size=cs)
        t = staged[0].shape[1]

        def call():
            return kv_restore_scatter(caches, staged, scl, **kw)
        bms, by = bound(moved, 0 if scl is None else 2 * ns * t * c)
        return dict(ms=time_ms(call, flush=flush),
                    kernels_us=kernels_us(call, flush, match="kv_restore"),
                    kernels_us_warm=kernels_us(call, match="kv_restore"),
                    plain_ms=time_ms(lambda: kv_restore_plain(caches, staged, scl, **kw),
                                     flush=flush),
                    bound_ms=bms, bound_by=by,
                    **rows_plan_fields(kv_restore_plan(caches, staged, scl, **kw)))

    cases = []
    caches, staged, scl = inputs(256)
    cases.append(check("serve op", caches, staged, scl))
    t = timing(caches, staged, scl, 2 * (ns * 256 * c * (1 + 2)) + nbytes(*scl))
    res["kv_restore"] = dict(max_abs_err=0.0, tol=0.0, bit_exact=True, cases=cases, **t,
                             library_ms=None,
                             shape=f"int8 (36,256,{c}) x2 fields -> slots 0..{ns} of bf16 "
                                   f"(36,{s},{c}) at t0 {t0}")
    raw_cases = []
    for dtype in (bf, torch.float32):
        caches, staged, _ = inputs(256, dtype=dtype, quant=False)
        raw_cases.append(check(f"raw {str(dtype)[6:]}", caches, staged, None))
        if dtype == bf:
            t = timing(caches, staged, None, 2 * ns * 256 * c * 4)
            res["kv_restore_raw"] = dict(
                max_abs_err=0.0, tol=0.0, bit_exact=True, cases=raw_cases, **t,
                library_ms=time_ms(lambda: [x[:ns, t0:t0 + 256].copy_(y[:ns])
                                            for x, y in zip(caches, staged)], flush=flush),
                library="Tensor.copy_ a field",
                shape=f"bf16 (36,256,{c}) x2 fields -> slots 0..{ns} of bf16 (36,{s},{c}) "
                      f"at t0 {t0}")
        del caches, staged
    cases.append(check("int8 -> f32", *inputs(64, dtype=torch.float32)))
    cases.append(check("ragged last chunk", *inputs(40)))
    cases.append(check("rows < T", *inputs(256), t0=s - 100))
    cases.append(check("C 1000 (scalar)", *inputs(64, c=1000)))
    cases.append(check("staging 4 bytes off (scalar)", *inputs(64, offset=4)))
    for r in (res["kv_restore"], res["kv_restore_raw"]):
        r["max_abs_err"] = max(x["max_abs_err"] for x in r["cases"])
        r["bit_exact"] = all(x["bit_exact"] for x in r["cases"])
    units = [x["unit"] for x in cases]
    if units[-2:] != [1, 1] or set(units[:-2]) != {16}:
        raise AssertionError(f"kv_restore: unexpected units {units}")


def quant_plan_of(x, **force):
    """The plan ``kv_quantize`` launches for ``x`` (``force`` as
    ``quant_plan`` takes it), and its fields to print: cluster size,
    clusters, rows a block, branch (slab in shared memory, or re-read from
    L2), unit, shared memory a block."""
    from repro_torch.kernels.kv_quant import quant_plan
    c = x.shape[-1]
    p = quant_plan(x.numel() // c, c, x.element_size(),
                   aligned=x.data_ptr() % 16 == 0, **force)
    return p, dict(cluster=p.n, clusters=p.clusters, rows_per=p.rows_per,
                   branch="slab" if p.slab else "reread", vec=p.vec, smem=p.smem)


def quant_cases(dev, g, flush, res: dict):
    """kv_quantize against kv_quantize_plain, bit for bit (codes and
    scales), each case printing its plan: one 16-token chunk of qwen3-8b's
    36 layers' K (timed), the same chunk in f32, with an all-zero channel
    (the 1e-12 clamp), ties at scale 1 (half to even), R 5 below N, a
    64-token bf16 chunk and a 32-token f32 chunk (both re-read), rows of 12
    channels and an unaligned view (one element at a time), and a tail
    chunk through ``ChunkStore._quantize``: an int8 store on the HBM tier
    demotes tokens 32-40 of a 40-token request, a strided view of its pool
    block.  Then kv_dequantize's cases (``dequant_cases``) on the serve's
    chunk's codes."""
    import torch
    from repro_torch.kernels.kv_quant import kv_quantize, kv_quantize_plain
    from repro_torch.storage import ChunkStore

    bf = torch.bfloat16
    a, cs, hkv, dh = 36, 16, 8, 128

    def randn(*shape, dtype=bf):
        return (torch.randn(*shape, generator=g, device=dev) * 3).to(dtype)

    def check(name, x):
        q, s_ = kv_quantize(x)
        qp, sp = kv_quantize_plain(x)
        torch.cuda.synchronize()
        return dict(case=name, shape=list(x.shape), dtype=str(x.dtype)[6:],
                    bit_exact=torch.equal(q, qp) and torch.equal(s_, sp),
                    max_abs_err=float((q.float() - qp.float()).abs().max()),
                    scale_max_abs_err=float((s_ - sp).abs().max()), **quant_plan_of(x)[1])

    x = randn(a, 1, cs, hkv, dh)
    zero = x.clone()
    zero[..., 5] = 0
    ties = torch.randint(-126, 127, (a * cs * hkv, dh), generator=g, device=dev).float()
    ties += 0.5 * (torch.rand(ties.shape, generator=g, device=dev) < 0.5)
    ties = ties.clamp(-126.5, 126.5)
    ties[0] = 127.0
    buf = randn(1 + 64 * dh)
    cases = [check("serve chunk", x), check("serve chunk f32", x.float()),
             check("zero channel", zero), check("ties at scale 1", ties.to(bf)),
             check("R 5 < N", randn(5, dh)), check("64 tokens", randn(a, 1, 64, hkv, dh)),
             check("32 tokens f32", randn(a, 1, 32, hkv, dh, dtype=torch.float32)),
             check("12 channels", randn(7, 3, 12)),
             check("unaligned view", buf[1:].view(64, dh))]
    # the tail chunk through the store
    n = 40
    k, v = randn(a, 1, n, hkv, dh), randn(a, 1, n, hkv, dh)
    kpos = torch.arange(n, dtype=torch.int32, device=dev).expand(a, n).contiguous()
    store = ChunkStore(chunk_size=cs, quant="int8", default_tier="hbm", device=dev)
    key = store.put_request("tail", torch.arange(n, dtype=torch.int32)[None],
                            {"k": k, "v": v, "kpos": kpos})[-1]
    strided = not store.device_view(key)["k"].is_contiguous()
    store._move(key, "hbm", "host")
    host = store.chunks[key].reprs["host"]
    errs, exact = [], strided
    for f, arr in (("k", k), ("v", v)):
        qp, sp = kv_quantize_plain(arr[:, :, 32:])
        exact &= torch.equal(host[f]["q"], qp.cpu()) and torch.equal(host[f]["scales"], sp.cpu())
        errs.append(float((host[f]["q"].float() - qp.cpu().float()).abs().max()))
    cases.append(dict(case="tail chunk via ChunkStore._quantize", shape=[a, 1, n - 32, hkv, dh],
                      dtype="bfloat16", view_strided=strided, bit_exact=exact,
                      max_abs_err=max(errs), **quant_plan_of(k[:, :, 32:].contiguous())[1]))
    del store, k, v, zero, ties, buf

    qk, sk = kv_quantize(x)
    torch.cuda.synchronize()

    def call():
        return kv_quantize(x)
    bms, by = bound(nbytes(x, qk, sk), 3 * x.numel())
    res["kv_quantize"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases), tol=0.0,
        bit_exact=all(c["bit_exact"] for c in cases), cases=cases,
        ms=time_ms(call, flush=flush),
        kernels_us=kernels_us(call, flush, match="kv_quantize"),
        kernels_us_warm=kernels_us(call, match="kv_quantize"),
        plain_ms=time_ms(lambda: kv_quantize_plain(x), flush=flush),
        library_ms=None, bound_ms=bms, bound_by=by, **quant_plan_of(x)[1],
        shape=f"x (36,1,{cs},{hkv},{dh}) bf16 -> int8 + f32 ({dh},)")

    dequant_cases(dev, g, flush, res, x, qk, sk)


def dequant_cases(dev, g, flush, res: dict, x, qk, sk):
    """kv_dequantize against kv_dequantize_plain by torch.equal, each case
    printing its plan.  One chunk, as the store decodes it: codes (36, 1,
    16, 8, 128) of ``x`` with (128,) scales, to bf16 (timed) and f32.  A
    transfer run as the datapath promotes it: 36 slots x 8 chunks x 16
    tokens x 1024 channels x 2 fields with (8, 1024) per-chunk scales, every
    chunk of the output against a plain call on that chunk's codes and
    scales (timed; beside it the per-chunk form the datapath replaced:
    ``.contiguous()`` of each chunk's columns and a one-chunk call, a chunk
    and a field), then the run with a 10-token last chunk (strided views),
    C 1000 and a staging view 4 bytes off alignment (the scalar instance)."""
    import torch
    from repro_torch.kernels.kv_quant import (kv_dequantize, kv_dequantize_plain,
                                              kv_dequantize_plan)

    bf = torch.bfloat16
    a, cs, n = 36, 16, 8

    def one(name, dtype):
        got, want = kv_dequantize(qk, sk, dtype), kv_dequantize_plain(qk, sk, dtype)
        torch.cuda.synchronize()
        out = dict(case=name, q=list(qk.shape), dtype=str(dtype)[6:],
                   bit_exact=torch.equal(got, want),
                   max_abs_err=float((got.float() - want.float()).abs().max()),
                   **rows_plan_fields(kv_dequantize_plan(qk, sk, dtype)))
        print(json.dumps({"kv_dequantize_case": out}))
        return out

    def run_inputs(c=1024, t=n * cs, offset=0):
        q = [torch.randint(-127, 128, (offset + a * n * cs * c,), generator=g, device=dev,
                           dtype=torch.int8)[offset:].view(a, n * cs, c)[:, :t]
             for _ in range(2)]
        scl = [torch.rand(-(-t // cs), c, generator=g, device=dev) * 0.05 for _ in range(2)]
        return q, scl

    def run(name, q, scl):
        t = q[0].shape[1]
        got = kv_dequantize(q, scl, bf, chunk_size=cs)
        exact, err = True, 0.0
        for chunks, x, s in zip(got, q, scl):
            exact &= len(chunks) == s.shape[0]
            for ch, o in enumerate(chunks):
                part = slice(ch * cs, min(t, (ch + 1) * cs))
                want = kv_dequantize_plain(x[:, part].contiguous(), s[ch], bf)
                exact &= torch.equal(o, want)
                err = max(err, float((o.float() - want.float()).abs().max()))
        torch.cuda.synchronize()
        out = dict(case=name, q=list(q[0].shape), fields=len(q), contiguous=q[0].is_contiguous(),
                   bit_exact=exact, max_abs_err=err,
                   **rows_plan_fields(kv_dequantize_plan(q, scl, bf, chunk_size=cs)))
        print(json.dumps({"kv_dequantize_case": out}))
        return out

    cases = [one("one chunk", bf), one("one chunk f32", torch.float32)]
    dk = kv_dequantize(qk, sk, bf)

    def call():
        return kv_dequantize(qk, sk, bf)
    bms, by = bound(nbytes(qk, sk, dk), x.numel())
    res["kv_dequantize"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases), tol=0.0,
        bit_exact=all(c["bit_exact"] for c in cases), cases=cases,
        ms=time_ms(call, flush=flush),
        kernels_us=kernels_us(call, flush, match="kv_dequantize"),
        kernels_us_warm=kernels_us(call, match="kv_dequantize"),
        plain_ms=time_ms(lambda: kv_dequantize_plain(qk, sk, bf), flush=flush),
        library_ms=None, bound_ms=bms, bound_by=by,
        **rows_plan_fields(kv_dequantize_plan(qk, sk, bf)),
        shape="q (36,1,16,8,128) int8, scales (128,) -> bf16")

    q, scl = run_inputs()
    rcases = [run("run of 8 chunks", q, scl)]

    def call():
        return kv_dequantize(q, scl, bf, chunk_size=cs)

    def per_chunk():
        for x, s in zip(q, scl):
            for ch in range(n):
                kv_dequantize(x[:, ch * cs:(ch + 1) * cs].contiguous(), s[ch], bf)
    bms, by = bound(nbytes(*q, *scl) + 2 * q[0].numel() * 2, 2 * q[0].numel())
    timed = dict(ms=time_ms(call, flush=flush),
                 kernels_us=kernels_us(call, flush, match="kv_dequantize"),
                 kernels_us_warm=kernels_us(call, match="kv_dequantize"),
                 plain_ms=time_ms(lambda: kv_dequantize_plain(q, scl, bf, chunk_size=cs),
                                  flush=flush),
                 per_chunk_ms=time_ms(per_chunk, flush=flush))
    rcases.append(run("10-token last chunk (strided)", *run_inputs(t=(n - 1) * cs + 10)))
    rcases.append(run("C 1000 (scalar)", *run_inputs(c=1000)))
    rcases.append(run("staging 4 bytes off (scalar)", *run_inputs(offset=4)))
    res["kv_dequantize_run"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in rcases), tol=0.0,
        bit_exact=all(c["bit_exact"] for c in rcases), cases=rcases, **timed,
        library_ms=None, bound_ms=bms, bound_by=by,
        **rows_plan_fields(kv_dequantize_plan(q, scl, bf, chunk_size=cs)),
        shape=f"2 fields of q (36,{n * cs},1024) int8, scales ({n},1024) -> bf16")
    units = [c["unit"] for c in cases + rcases]
    if units != [16, 16, 16, 16, 1, 1]:
        raise AssertionError(f"kv_dequantize: unexpected units {units}")


# the three store kernels at the family phase's widths: (entry suffix, arch,
# attention slots of the served model, slots of one stage's load op, fields,
# channels of a field's row, the quantizer's chunk of one field, and its
# other chunks to check).  qwen3-30b-a3b's k/v rows are 4 x 128 = 512
# channels over 48 slots; deepseek-v2-236b's one latent row is 512 + 64 = 576
# channels over the 4 layers it is served with (60 at full depth).
FAMILY_STORE = (
    ("q30", "qwen3-30b-a3b", 48, 24, 2, 512, (48, 1, 16, 4, 128),
     (("tail", (48, 1, 10, 4, 128)),)),
    ("mla", "deepseek-v2-236b", 4, 2, 1, 576, (4, 1, 16, 576),
     (("60 layers", (60, 1, 16, 576)), ("tail", (4, 1, 10, 576)))),
)


def family_store_cases(dev, g, flush, res: dict):
    """kv_quantize, kv_dequantize (one chunk and a transfer run) and
    kv_restore against their plain versions by torch.equal at the shapes the
    family phase's int8 serves give them (``FAMILY_STORE``), each timed with
    its plan printed: the quantizer's 16-token chunk of one field (and a
    10-token tail; deepseek-v2-236b also at full depth); its decode; a run
    of 8 chunks of every field; the serve's load op (int8, one stage's slots
    x 256 tokens from t0 1024 into bf16 caches of 4176 slots) and a 40-row
    ragged last chunk."""
    import torch
    from repro_torch.kernels.kv_quant import (kv_dequantize, kv_dequantize_plain,
                                              kv_dequantize_plan, kv_quantize,
                                              kv_quantize_plain)
    from repro_torch.kernels.kv_restore import (kv_restore_plain, kv_restore_plan,
                                                kv_restore_scatter)

    bf = torch.bfloat16
    cs, n, t0, s = 16, 8, 1024, 4176
    for tag, arch, a, ns, nf, c, chunk, extra in FAMILY_STORE:
        def randn(*shape):
            return (torch.randn(*shape, generator=g, device=dev) * 3).to(bf)

        def qcase(name, x):
            q, s_ = kv_quantize(x)
            qp, sp = kv_quantize_plain(x)
            torch.cuda.synchronize()
            return dict(case=name, shape=list(x.shape), bit_exact=torch.equal(q, qp)
                        and torch.equal(s_, sp), max_abs_err=float((q.float() - qp.float())
                                                                   .abs().max()),
                        **quant_plan_of(x)[1])
        x = randn(*chunk)
        cases = [qcase("serve chunk", x)] + [qcase(nm, randn(*sh)) for nm, sh in extra]
        qk, sk = kv_quantize(x)
        torch.cuda.synchronize()

        def call():
            return kv_quantize(x)
        bms, by = bound(nbytes(x, qk, sk), 3 * x.numel())
        res[f"kv_quantize_{tag}"] = dict(
            max_abs_err=max(cc["max_abs_err"] for cc in cases), tol=0.0, arch=arch,
            bit_exact=all(cc["bit_exact"] for cc in cases), cases=cases,
            ms=time_ms(call, flush=flush),
            kernels_us=kernels_us(call, flush, match="kv_quantize"),
            kernels_us_warm=kernels_us(call, match="kv_quantize"),
            plain_ms=time_ms(lambda: kv_quantize_plain(x), flush=flush),
            library_ms=None, bound_ms=bms, bound_by=by, **quant_plan_of(x)[1],
            shape=f"x {tuple(chunk)} bf16 -> int8 + f32 ({chunk[-1]},)")

        got, want = kv_dequantize(qk, sk, bf), kv_dequantize_plain(qk, sk, bf)
        torch.cuda.synchronize()

        def call():
            return kv_dequantize(qk, sk, bf)
        bms, by = bound(nbytes(qk, sk, got), x.numel())
        res[f"kv_dequantize_{tag}"] = dict(
            max_abs_err=float((got.float() - want.float()).abs().max()), tol=0.0,
            arch=arch, bit_exact=torch.equal(got, want), ms=time_ms(call, flush=flush),
            kernels_us=kernels_us(call, flush, match="kv_dequantize"),
            kernels_us_warm=kernels_us(call, match="kv_dequantize"),
            plain_ms=time_ms(lambda: kv_dequantize_plain(qk, sk, bf), flush=flush),
            library_ms=None, bound_ms=bms, bound_by=by,
            **rows_plan_fields(kv_dequantize_plan(qk, sk, bf)),
            shape=f"q {tuple(chunk)} int8, scales ({chunk[-1]},) -> bf16")

        q = [torch.randint(-127, 128, (a, n * cs, c), generator=g, device=dev,
                           dtype=torch.int8) for _ in range(nf)]
        scl = [torch.rand(n, c, generator=g, device=dev) * 0.05 for _ in range(nf)]
        chunks = kv_dequantize(q, scl, bf, chunk_size=cs)
        exact, err = True, 0.0
        for field, xq, sc in zip(chunks, q, scl):
            for ch, o in enumerate(field):
                w = kv_dequantize_plain(xq[:, ch * cs:(ch + 1) * cs].contiguous(), sc[ch], bf)
                exact &= torch.equal(o, w)
                err = max(err, float((o.float() - w.float()).abs().max()))

        def call():
            return kv_dequantize(q, scl, bf, chunk_size=cs)
        bms, by = bound(nbytes(*q, *scl) + 2 * nf * q[0].numel(), nf * q[0].numel())
        res[f"kv_dequantize_run_{tag}"] = dict(
            max_abs_err=err, tol=0.0, arch=arch, bit_exact=exact,
            ms=time_ms(call, flush=flush),
            kernels_us=kernels_us(call, flush, match="kv_dequantize"),
            kernels_us_warm=kernels_us(call, match="kv_dequantize"),
            plain_ms=time_ms(lambda: kv_dequantize_plain(q, scl, bf, chunk_size=cs),
                             flush=flush),
            library_ms=None, bound_ms=bms, bound_by=by,
            **rows_plan_fields(kv_dequantize_plan(q, scl, bf, chunk_size=cs)),
            shape=f"{nf} field(s) of q ({a},{n * cs},{c}) int8, scales ({n},{c}) -> bf16")
        del q, scl, chunks

        kw = dict(t0=t0, slot_lo=0, n_slots=ns, chunk_size=cs)
        caches = [torch.randn(a, s, c, generator=g, device=dev).to(bf) for _ in range(nf)]
        rcases = []
        for name, t in (("serve op", 256), ("ragged last chunk", 40)):
            staged = [torch.randint(-127, 128, (a, t, c), generator=g, device=dev,
                                    dtype=torch.int8) for _ in range(nf)]
            sc = [torch.rand(-(-t // cs), c, generator=g, device=dev) * 0.05
                  for _ in range(nf)]
            got = kv_restore_scatter([x_.clone() for x_ in caches], staged, sc, **kw)
            want = kv_restore_plain([x_.clone() for x_ in caches], staged, sc, **kw)
            torch.cuda.synchronize()
            rcases.append(dict(case=name, staged=list(staged[0].shape), t0=t0,
                               bit_exact=all(torch.equal(u, w) for u, w in zip(got, want)),
                               max_abs_err=max(float((u.float() - w.float()).abs().max())
                                               for u, w in zip(got, want)),
                               **rows_plan_fields(kv_restore_plan(caches, staged, sc, **kw))))
            if name == "serve op":
                timed_in = (staged, sc)
            del got, want
        staged, sc = timed_in

        def call():
            return kv_restore_scatter(caches, staged, sc, **kw)
        bms, by = bound(nf * ns * 256 * c * (1 + 2) + nbytes(*sc), nf * ns * 256 * c)
        res[f"kv_restore_{tag}"] = dict(
            max_abs_err=max(r["max_abs_err"] for r in rcases), tol=0.0, arch=arch,
            bit_exact=all(r["bit_exact"] for r in rcases), cases=rcases,
            ms=time_ms(call, flush=flush),
            kernels_us=kernels_us(call, flush, match="kv_restore"),
            kernels_us_warm=kernels_us(call, match="kv_restore"),
            plain_ms=time_ms(lambda: kv_restore_plain(caches, staged, sc, **kw),
                             flush=flush),
            library_ms=None, bound_ms=bms, bound_by=by,
            **rows_plan_fields(kv_restore_plan(caches, staged, sc, **kw)),
            shape=f"int8 ({a},256,{c}) x{nf} field(s) -> slots 0..{ns} of bf16 "
                  f"({a},{s},{c}) at t0 {t0}")
        units = {r["unit"] for r in rcases} | {res[f"kv_dequantize{k}_{tag}"]["unit"]
                                               for k in ("", "_run")}
        if units != {16} or {cc["vec"] for cc in cases} != {8}:
            raise AssertionError(f"{tag}: expected 16-byte units, got {units}, "
                                 f"{[cc['vec'] for cc in cases]}")
        del caches, staged, sc, x, qk, sk


def quant_sweep(dev):
    """kv_quantize at the serve's chunk (36 layers x 16 tokens) and at its
    longest tail (10 tokens) over cluster sizes 4, 8 and 16 on both
    branches, where the slab fits, with 1 to 16 clusters (at most 128
    blocks): each checked against the plain version bit for bit, timed by
    CUDA events and torch.profiler (L2 flushed)."""
    import torch
    from repro_torch.kernels.kv_quant import kv_quantize, kv_quantize_plain

    g = torch.Generator(device=dev).manual_seed(5)
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB
    for tokens in (16, 10):
        x = (torch.randn(36, 1, tokens, 8, 128, generator=g, device=dev) * 3).bfloat16()
        qp, sp = kv_quantize_plain(x)
        for n, slab, k in itertools.product((4, 8, 16), (True, False), (1, 2, 4, 8, 12, 16)):
            if n * k > 128:
                continue
            try:
                plan, fields = quant_plan_of(x, n=n, slab=slab, clusters=k)
            except ValueError:
                if k == 1:
                    print(json.dumps({"quant_sweep": dict(tokens=tokens, cluster=n,
                                                          branch="slab", fits=False)}))
                continue

            def call(plan=plan):
                return kv_quantize(x, plan=plan)
            q, s_ = call()
            torch.cuda.synchronize()
            print(json.dumps({"quant_sweep": dict(
                tokens=tokens, **fields, bit_exact=torch.equal(q, qp) and torch.equal(s_, sp),
                ms=time_ms(call, flush=scratch.zero_),
                kernels_us=kernels_us(call, scratch.zero_, match="kv_quantize"),
                kernels_us_warm=kernels_us(call, match="kv_quantize"))}))


def quant_only(dev, card: str) -> dict:
    """kv_quantize alone at the serve's chunk, through the wrapper's public
    call only, so that the same script times an older tree's quantizer:
    bit-exactness against the plain version, the call's time by CUDA events
    and each device operation it issues (kernels and memsets) by
    torch.profiler, L2 flushed (by a fill kernel, not a memset) and warm."""
    import torch
    from repro_torch.kernels.kv_quant import kv_quantize, kv_quantize_plain

    g = torch.Generator(device=dev).manual_seed(6)
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB

    def flush():
        scratch.fill_(7)
    x = (torch.randn(36, 1, 16, 8, 128, generator=g, device=dev) * 3).bfloat16()
    q, s_ = kv_quantize(x)
    qp, sp = kv_quantize_plain(x)
    torch.cuda.synchronize()

    def call():
        return kv_quantize(x)
    match = ("quant", "absmax", "Memset")
    out = dict(card=card, bit_exact=torch.equal(q, qp) and torch.equal(s_, sp),
               ms=time_ms(call, flush=flush), kernels_us=kernels_us(call, flush, match=match),
               kernels_us_warm=kernels_us(call, match=match),
               shape="x (36,1,16,8,128) bf16")
    print(json.dumps({"quant_only": out}))
    if not out["bit_exact"]:
        raise AssertionError("kv_quantize disagrees with its plain version")
    return out


def ring_kpos(s: int, q_pos: int, dev):
    """kpos of a ring cache of ``s`` slots after position ``q_pos`` was
    written: slot j holds the latest position p <= q_pos with p % s == j."""
    import torch
    j = torch.arange(s, dtype=torch.int32, device=dev)
    return q_pos - ((q_pos - j) % s)


def hybrid_kernel_cases(dev, g, flush, res: dict):
    """recurrentgemma-2b's kernels at its shapes: attention with Hq 10 on one
    KV head at Dh 256 over a 2048-slot ring cache with a 2048 window, and
    the RG-LRU scan over (1, S, 2560) f32."""
    import torch
    from repro_torch.kernels.flash_decode import (_split_plan, flash_decode,
                                                  flash_decode_plain)
    from repro_torch.kernels.flash_prefill import flash_prefill, flash_prefill_plain

    hq, hkv, dh, s, win = 10, 1, 256, 2048, 2048
    scale = dh ** -0.5
    bf = torch.bfloat16

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    def err(out, ref):
        return float((out.float() - ref.float()).abs().max())

    def stale(kp, q_last, n, v_):
        """Make n random slots hold a position one ring turn older (outside
        the window of every query up to q_last) with V = 100 there."""
        idx = torch.randperm(kp.numel(), generator=g, device=dev)[:n]
        kp[idx] -= s
        v_[:, kp <= q_last - win] = 100.0

    # flash_prefill: the last 256-token chunk of a 2048-token prefix over the
    # full cache (timed); the 64-token suffix at 2048 over the ring it just
    # wrapped (slots 0-63 now hold 2048-2111; timed); the same with stale
    # slots; and, under a 512-token window, rows whose whole window holds
    # stale slots (every slot at position 100, but for 1024 at 2090: rows
    # 2048-2089 see nothing, rows 2090-2111 see 1024 slots), V N(0, 1)
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    from repro_torch.kernels.flash_prefill import _plan
    sq, q_off = 256, s - 256
    q = randn(1, sq, hq, dh)
    k, v = randn(1, s, hkv, dh), randn(1, s, hkv, dh)
    kpos = torch.arange(s, dtype=torch.int32, device=dev)
    kw = dict(scale=scale, window=win)
    out = flash_prefill(q, k, v, kpos, q_off, **kw)
    cases = [dict(max_abs_err=err(out, flash_prefill_plain(q, k, v, kpos, q_off, **kw)),
                  slots=s, at=q_off, rows=sq, ring="full")]
    qs_ = randn(1, 64, hq, dh)
    kr = ring_kpos(s, s + 63, dev)
    cases.append(dict(max_abs_err=err(flash_prefill(qs_, k, v, kr, s, **kw),
                                      flash_prefill_plain(qs_, k, v, kr, s, **kw)),
                      slots=s, at=s, rows=64, ring="wrapped"))
    v2 = v.clone()
    kr2 = kr.clone()
    stale(kr2, s, 200, v2)
    cases.append(dict(max_abs_err=err(flash_prefill(qs_, k, v2, kr2, s, **kw),
                                      flash_prefill_plain(qs_, k, v2, kr2, s, **kw)),
                      slots=s, at=s, rows=64, ring="wrapped, 200 stale slots"))
    kr3 = torch.full_like(kr, 100)
    kr3[:1024] = 2090
    kw3 = dict(scale=scale, window=512)
    cases.append(dict(max_abs_err=err(flash_prefill(qs_, k, v, kr3, s, **kw3),
                                      flash_prefill_plain(qs_, k, v, kr3, s, **kw3)),
                      slots=s, at=s, rows=64, window=512, tol=PREFILL_TOL,
                      ring="rows 0-41 see only stale slots"))
    for c in cases:
        c["m_tile"], c["n_split"] = _plan(1, hkv, c["rows"], hq // hkv, s, sm)[:2]
    torch.cuda.synchronize()
    res["flash_prefill_dh256"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases), tol=PREFILL_TOL,
        cases=cases, **prefill_timing(q, k, v, kpos, q_off, win, flush, sm),
        shape=f"q (1,{sq},{hq},{dh}) over {s} keys, q_offset {q_off}, window {win}, bf16")
    res["flash_prefill_dh256_suffix"] = dict(
        max_abs_err=cases[1]["max_abs_err"], tol=PREFILL_TOL,
        **prefill_timing(qs_, k, v, kr, s, win, flush, sm),
        shape=f"q (1,64,{hq},{dh}) at q_offset {s} over the {s}-slot ring wrapped "
              f"to {s + 63}, window {win}, bf16")

    # flash_decode: the last decode step of the serve's longest request
    # (position 2126) over the wrapped ring (timed), then with stale slots
    # (about three in each 32-slot split), then with every slot one ring
    # turn older than the window (no slot visible: the mean of V, V N(0, 1))
    n_split = _split_plan(1, hkv, s, sm)[1]
    qd = randn(1, hq, dh)
    qp = s + 64 + 14
    kr = ring_kpos(s, qp, dev)
    out = flash_decode(qd, k, v, kr, qp, **kw)
    cases = [dict(max_abs_err=err(out, flash_decode_plain(qd, k, v, kr, qp, **kw)),
                  slots=s, at=qp, ring="wrapped", n_split=n_split)]
    kr2, v2 = kr.clone(), v.clone()
    stale(kr2, qp, 200, v2)
    cases.append(dict(max_abs_err=err(flash_decode(qd, k, v2, kr2, qp, **kw),
                                      flash_decode_plain(qd, k, v2, kr2, qp, **kw)),
                      slots=s, at=qp, ring="wrapped, 200 stale slots",
                      n_split=n_split))
    kr3 = kr - s
    cases.append(dict(max_abs_err=err(flash_decode(qd, k, v, kr3, qp, **kw),
                                      flash_decode_plain(qd, k, v, kr3, qp, **kw)),
                      slots=s, at=qp, ring="every slot stale", tol=DECODE_TOL,
                      n_split=n_split))
    # the instantiations off the model path: 8 query heads on 4 KV heads
    # (G 2 padded to 4), 32 on 2 (G 16)
    kph = ring_kpos(1000, 1400, dev)
    for hq2, hkv2 in ((8, 4), (32, 2)):
        qh, kh, vh = randn(1, hq2, dh), randn(1, 1000, hkv2, dh), randn(1, 1000, hkv2, dh)
        cases.append(dict(max_abs_err=err(flash_decode(qh, kh, vh, kph, 1400, **kw),
                                          flash_decode_plain(qh, kh, vh, kph, 1400, **kw)),
                          heads=f"{hq2} on {hkv2}", slots=1000, at=1400, ring="wrapped",
                          n_split=_split_plan(1, hkv2, 1000, sm)[1]))
    del qh, kh, vh
    torch.cuda.synchronize()
    res["flash_decode_dh256"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases), tol=DECODE_TOL,
        cases=cases, **decode_timing(qd, k, v, kr, qp, win, flush, sm),
        shape=f"q (1,{hq},{dh}) over a {s}-slot ring at position {qp}, window {win}, bf16")
    del q, k, v, v2

    rglru_cases(dev, g, flush, res)


# the dense configs' attention shapes the kernel phase checks: (entry
# suffix, arch, Hq, Hkv, Dh)
DENSE_SHAPES = (("dh64", "qwen1.5-0.5b", 16, 16, 64),
                ("g3", "phi4-mini-3.8b", 24, 8, 128),
                ("g12", "mistral-large-123b", 96, 8, 128),
                # the family phase's: G 8, MHA at Dh 128, MHA of 32 heads at Dh 64
                # (pixtral-12b's 32 on 8 at Dh 128 is qwen3-8b's shape)
                ("g8", "qwen3-30b-a3b", 32, 4, 128),
                ("mha128", "deepseek-moe-16b", 16, 16, 128),
                ("mha64", "musicgen-large", 32, 32, 64))


def dense_kernel_cases(dev, g, flush, res: dict):
    """Both attention kernels at the dense and family configs' new shapes
    (``DENSE_SHAPES``: Dh 64 with 16 and 32 heads at G 1, G 1, 3, 8 and 12
    at Dh 128), at the smoke's own positions: a 256-row
    chunk at 3840 over 4096 keys and the serve's longest suffix, 64 rows at
    4096 over 4176 slots, 4160-4175 empty (both timed), and decode at 4095
    over 4096 slots (timed) and at 3999 over 4096 slots, 4000-4095 empty.
    Slots no query may see hold V = 100.  Each prefill entry also checks
    rows that see no slot, which take the mean of V (V N(0, 1)): a 256-row
    chunk at 0 over 1024 slots, 512 at position 128 and 512 at 5000 (rows
    0-127 see nothing), and under a 512-token window the 64-row suffix at
    4096 over 4096 slots at position 100 but for 1024 at 4130 (rows
    4096-4129 see nothing); at Dh 64 both split their keys, so the combine
    kernel writes those rows (see ``empty_rows_check``)."""
    import torch
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    from repro_torch.kernels.flash_prefill import _plan, flash_prefill, flash_prefill_plain

    bf = torch.bfloat16
    sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(bf)

    def err(out, ref):
        return float((out.float() - ref.float()).abs().max())

    for tag, arch, hq, hkv, dh in DENSE_SHAPES:
        scale = dh ** -0.5
        s = 4096
        k, v = randn(1, s, hkv, dh), randn(1, s, hkv, dh)
        kpos = torch.arange(s, dtype=torch.int32, device=dev)
        q = randn(1, 256, hq, dh)
        cases = [dict(at=s - 256, rows=256, slots=s, max_abs_err=err(
            flash_prefill(q, k, v, kpos, s - 256, scale=scale),
            flash_prefill_plain(q, k, v, kpos, s - 256, scale=scale)))]
        kpm = torch.full((1024,), 5000, dtype=torch.int32, device=dev)
        kpm[:512] = 128
        km, vm = k[:, :1024].contiguous(), v[:, :1024].contiguous()
        cases.append(dict(at=0, rows=256, slots=1024, rows_seeing_nothing=128,
                          **empty_rows_check(q, km, vm, kpm, 0, 0, 128)))
        kpw = torch.full_like(kpos, 100)
        kpw[:1024] = 4130
        cases.append(dict(at=s, rows=64, slots=s, window=512, rows_seeing_nothing=34,
                          **empty_rows_check(q[:, :64].contiguous(), k, v, kpw, s, 512, 34)))
        for c in cases:
            c["n_split"] = _plan(1, hkv, c["rows"], hq // hkv, c["slots"], sm)[1]
        res[f"flash_prefill_{tag}"] = dict(
            max_abs_err=max([cases[0]["max_abs_err"]]
                            + [c["empty_rows_max_abs_err"] for c in cases[1:]]),
            tol=PREFILL_TOL, arch=arch, cases=cases,
            **prefill_timing(q, k, v, kpos, s - 256, 0, flush, sm),
            shape=f"q (1,256,{hq},{dh}) over {s} keys, q_offset {s - 256}, bf16")
        ks, vs = randn(1, 4176, hkv, dh), randn(1, 4176, hkv, dh)
        kps = torch.arange(4176, dtype=torch.int32, device=dev)
        kps[4160:] = -1
        vs[:, 4160:] = 100.0
        qs = randn(1, 64, hq, dh)
        e = err(flash_prefill(qs, ks, vs, kps, 4096, scale=scale),
                flash_prefill_plain(qs, ks, vs, kps, 4096, scale=scale))
        res[f"flash_prefill_{tag}_suffix"] = dict(
            max_abs_err=e, tol=PREFILL_TOL, arch=arch,
            **prefill_timing(qs, ks, vs, kps, 4096, 0, flush, sm),
            shape=f"q (1,64,{hq},{dh}) at q_offset 4096 over 4176 slots, "
                  f"4160-4175 empty, bf16")
        del ks, vs, qs
        qd = randn(1, hq, dh)
        cases = [dict(at=s - 1, valid=s, max_abs_err=err(
            flash_decode(qd, k, v, kpos, s - 1, scale=scale),
            flash_decode_plain(qd, k, v, kpos, s - 1, scale=scale)))]
        kpm, vm = kpos.clone(), v.clone()
        kpm[4000:] = -1
        vm[:, 4000:] = 100.0
        cases.append(dict(at=3999, valid=4000, max_abs_err=err(
            flash_decode(qd, k, vm, kpm, 3999, scale=scale),
            flash_decode_plain(qd, k, vm, kpm, 3999, scale=scale))))
        torch.cuda.synchronize()
        res[f"flash_decode_{tag}"] = dict(
            max_abs_err=max(c["max_abs_err"] for c in cases), tol=DECODE_TOL,
            arch=arch, cases=cases,
            **decode_timing(qd, k, v, kpos, s - 1, 0, flush, sm),
            shape=f"q (1,{hq},{dh}) over {s} slots, bf16")
        del q, k, v, kpm, vm


def empty_rows_check(q, k, v, kpos, q_off: int, window: int, n_empty: int) -> dict:
    """flash_prefill against its plain version where the first ``n_empty``
    rows see no slot.  Those rows (the mean of V, rounded to bf16 once on
    each side) are held to PREFILL_TOL (``empty_rows_max_abs_err``).  The
    rows after them attend to 512-1024 slots, not 3840-4096, so their
    outputs are larger, and the two sides' bf16 roundings of the
    probabilities alone can part them by more than PREFILL_TOL; they are
    held to the rounding-model bound (``rounding_ratio`` <= 1) and, against
    the same attention in f32, to no larger an error than the plain
    version's, as the timed entries are."""
    from repro_torch.kernels.flash_prefill import flash_prefill, flash_prefill_plain
    kw = dict(scale=q.shape[-1] ** -0.5, window=window)
    out = flash_prefill(q, k, v, kpos, q_off, **kw).float()
    plain = flash_prefill_plain(q, k, v, kpos, q_off, **kw).float()
    ref32 = flash_prefill_plain(q.float(), k.float(), v.float(), kpos, q_off, **kw)
    return dict(
        max_abs_err=float((out - plain).abs().max()),
        empty_rows_max_abs_err=float((out - plain)[:, :n_empty].abs().max()),
        err_vs_f32=float((out - ref32).abs().max()),
        plain_err_vs_f32=float((plain - ref32).abs().max()),
        **rounding_check(out, plain, flash_prefill_plain(
            q.float(), k.float(), v.float().abs(), kpos, q_off, **kw)))


def rglru_inputs(g, dev, bsz: int, sl: int, w: int = 2560, offset: int = 0):
    """log_a in [-0.5, 0) as the gates give, b and h0 ~ N(0, 1), f32; with
    ``offset`` each tensor is a contiguous view that many elements into its
    storage (4 bytes off 16-byte alignment at offset 1)."""
    import torch

    def draw(fn, *shape):
        n = 1
        for d in shape:
            n *= d
        return fn(n + offset, generator=g, device=dev)[offset:].view(*shape)
    return (-0.5 * draw(torch.rand, bsz, sl, w), draw(torch.randn, bsz, sl, w),
            draw(torch.randn, bsz, w))


def rglru_plan_of(la, bb, h0) -> dict:
    """The plan ``rglru_scan`` launches for these inputs (its outputs are
    fresh allocations, 16-byte aligned), as a dict to print."""
    from repro_torch.kernels.rglru_scan import rglru_plan
    bsz, sl, w = la.shape
    aligned = all(t.data_ptr() % 16 == 0 for t in (la, bb, h0))
    return rglru_plan(bsz, sl, w, aligned)._asdict()


def rglru_cases(dev, g, flush, res: dict):
    """rglru_scan's two kernels against the plain version by torch.equal (h
    and h_last), each case printing its plan: S = 256 (a restoration chunk,
    timed), 512 (a layer-wise pass), 64 (suffix prefill, timed), 40 and 300
    (a ragged last tile), 2, and 1 (decode: the one-step kernel, timed), at
    B = 1 and 2 over W = 2560; then W = 2558 (a ragged strip, 4-byte copies)
    and inputs 4 bytes off 16-byte alignment; then one call over 512 steps
    against two chained calls over 256."""
    import torch
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_plain

    def case(la, bb, h0, **extra):
        h, hl = rglru_scan(la, bb, h0)
        hp, hlp = rglru_scan_plain(la, bb, h0)
        torch.cuda.synchronize()
        err = max(float((h - hp).abs().max()), float((hl - hlp).abs().max()))
        return dict(B=la.shape[0], S=la.shape[1], W=la.shape[2], **extra,
                    plan=rglru_plan_of(la, bb, h0), max_abs_err=err,
                    bit_exact=torch.equal(h, hp) and torch.equal(hl, hlp),
                    h_last_apart=hl.untyped_storage().data_ptr()
                    != h.untyped_storage().data_ptr())

    cases, timed = [], {}
    for bsz, sl in itertools.product((1, 2), (256, 512, 64, 40, 2, 1, 300)):
        la, bb, h0 = rglru_inputs(g, dev, bsz, sl)
        cases.append(case(la, bb, h0))
        if bsz == 1 and sl in (256, 64, 1):
            h, hl = rglru_scan(la, bb, h0)
            bms, by = bound(nbytes(la, bb, h0, h, hl), 3 * la.numel(), F32_FLOP_PER_S)

            def call(la=la, bb=bb, h0=h0):
                return rglru_scan(la, bb, h0)
            timed[sl] = dict(
                ms=time_ms(call, flush=flush),
                kernels_us=kernels_us(call, flush, match="rglru_scan"),
                kernels_us_warm=kernels_us(call, match="rglru_scan"),
                plain_ms=time_ms(lambda: rglru_scan_plain(la, bb, h0), flush=flush,
                                 iters=7),
                bound_ms=bms, bound_by=by, plan=rglru_plan_of(la, bb, h0))
    for bsz, sl, w, off in ((2, 256, 2558, 0), (2, 1, 2558, 0), (1, 64, 2560, 1),
                            (1, 1, 2560, 1)):
        cases.append(case(*rglru_inputs(g, dev, bsz, sl, w, off), offset_bytes=4 * off))
    for bsz in (1, 2):
        la, bb, h0 = rglru_inputs(g, dev, bsz, 512)
        h, hl = rglru_scan(la, bb, h0)
        h1, mid = rglru_scan(la[:, :256].contiguous(), bb[:, :256].contiguous(), h0)
        h2, hl2 = rglru_scan(la[:, 256:].contiguous(), bb[:, 256:].contiguous(), mid)
        torch.cuda.synchronize()
        cases.append(dict(B=bsz, S=512, chained="256 + 256",
                          bit_exact=torch.equal(h, torch.cat([h1, h2], dim=1))
                          and torch.equal(hl, hl2),
                          max_abs_err=float((h - torch.cat([h1, h2], dim=1)).abs().max())))
    tile = [c for c in cases if c.get("plan", {}).get("kernel") != "step"]
    step = [c for c in cases if c.get("plan", {}).get("kernel") == "step"]
    w = 2560
    res["rglru_scan"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in tile), tol=RGLRU_TOL,
        bit_exact=all(c["bit_exact"] for c in tile)
        and all(c["h_last_apart"] for c in tile if "h_last_apart" in c),
        cases=tile, **timed[256], library_ms=None, s64=timed[64],
        shape=f"log_a, b (1,256,{w}) f32, h0 (1,{w}) f32")
    res["rglru_scan_step"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in step), tol=RGLRU_TOL,
        bit_exact=all(c["bit_exact"] and c["h_last_apart"] for c in step),
        cases=step, **timed[1], library_ms=None,
        shape=f"log_a, b (1,1,{w}) f32, h0 (1,{w}) f32")


def rglru_sweep(dev):
    """The tiled rglru_scan kernel at every variant it is built for
    (channels a strip, steps a tile, ring stages), and the one-step kernel:
    each checked against the plain version by torch.equal, then timed (CUDA
    events, L2 flushed) at S = 256, 64 and 1 (B = 1) and S = 256 at B = 2,
    with its own device time by torch.profiler at B = 1.  The tiled kernel
    runs at S = 1 as well, to show what the one-step kernel saves."""
    import torch
    from repro_torch.kernels.rglru_scan import TILE_VARIANTS, rglru_scan, rglru_scan_plain

    g = torch.Generator(device=dev).manual_seed(4)
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB

    def flush():
        scratch.zero_()

    shapes = ((1, 256), (1, 64), (1, 1), (2, 256))
    ins = {bs: rglru_inputs(g, dev, *bs) for bs in shapes}
    want = {bs: rglru_scan_plain(*ins[bs]) for bs in shapes}
    builds = [dict(kernel="step")] + [dict(variant=v) for v in TILE_VARIANTS]
    bad = []
    for force in builds:
        kw = {} if "kernel" in force else force
        row = dict(force)
        for bs in shapes:
            if "kernel" in force and bs[1] != 1:
                continue
            h, hl = rglru_scan(*ins[bs], **kw)
            torch.cuda.synchronize()
            exact = torch.equal(h, want[bs][0]) and torch.equal(hl, want[bs][1])
            if not exact:
                bad.append((force, bs))
            tag = f"{bs[1]}" if bs[0] == 1 else f"{bs[1]}_b{bs[0]}"
            row[f"bit_exact_{tag}"] = exact
            row[f"ms_{tag}"] = time_ms(lambda bs=bs: rglru_scan(*ins[bs], **kw), flush=flush)
            if bs[0] == 1:
                row[f"kernels_us_{tag}"] = kernels_us(
                    lambda bs=bs: rglru_scan(*ins[bs], **kw), flush, match="rglru_scan")
        print(json.dumps({"rglru_sweep": row}))
    if bad:
        raise AssertionError(f"rglru_scan builds disagree with the plain version: {bad}")


def rwkv_kernel_cases(dev, g, flush, res: dict):
    """rwkv6-7b's wkv recurrence, 64 heads of 64 in f32; s0 != 0 and w drawn
    as the model's decay, exp(-exp(N(mu, 1))).  The one-step kernel at S = 1
    (decode, timed) against the plain version: s_last bit for bit.  The
    chunked kernel against the plain version run in f64 at S = 256 (a
    restoration chunk, timed; once more with zeros planted in w and once at
    the model's own decays, mu = -6), 4096 (one long pass, timed: no serve
    call is this long, the RWKV serve's histogram shows S = 256, 64 and 1
    only), 64 (suffix prefill, timed), 40 (a ragged last chunk) and 2.  Then
    the invariance layer-wise restoration relies on: one call over 512 steps
    equals two chained calls over 256, bit for bit."""
    import torch
    from repro_torch.kernels.rwkv6_scan import wkv6, wkv6_chunked_plain, wkv6_plain

    h, dh = 64, 64

    def inputs(sl, mu=0.0, zeros=False):
        r, k, v = (torch.randn(1, sl, h, dh, generator=g, device=dev) for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(1, sl, h, dh, generator=g, device=dev) + mu))
        if zeros:
            w.view(-1)[::997] = 0.0
        return r, k, v, w, torch.randn(1, h, dh, dh, generator=g, device=dev)

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()) / float(b.abs().max())

    def timing(sl, r, k, v, w, s0, y, last):
        # five operations per state element per step (y: a product and a
        # sum; S: two products and a sum) and four per row of the bonus
        bms, by = bound(nbytes(r, k, v, w, u, s0, y, last),
                        (5 * dh + 4) * sl * h * dh, F32_FLOP_PER_S)
        def call():
            return wkv6(r, k, v, w, u, s0)
        return dict(ms=time_ms(call, flush=flush),
                    plain_ms=time_ms(lambda: wkv6_plain(r, k, v, w, u, s0), flush=flush,
                                     iters=3 if sl > 256 else 7),
                    bound_ms=bms, bound_by=by,
                    kernels_us=kernels_us(call, flush, match="wkv6"),
                    kernels_us_warm=kernels_us(call, match="wkv6"))

    u = 0.1 * torch.randn(h, dh, generator=g, device=dev)
    # the one-step kernel
    r, k, v, w, s0 = inputs(1)
    y, last = wkv6(r, k, v, w, u, s0)
    yp, lastp = wkv6_plain(r, k, v, w, u, s0)
    torch.cuda.synchronize()
    res["wkv6_step"] = dict(
        max_abs_err=max(float((y - yp).abs().max()), float((last - lastp).abs().max())),
        max_rel_err=rel(y, yp), tol=WKV6_Y_TOL, s_last_max_rel_err=rel(last, lastp),
        s_last_tol=WKV6_S_TOL, bit_exact=torch.equal(last, lastp),
        max_abs_y=float(yp.abs().max()), max_abs_s_last=float(lastp.abs().max()),
        **timing(1, r, k, v, w, s0, y, last), library_ms=None,
        shape=f"r, k, v, w (1,1,{h},{dh}) f32, u ({h},{dh}), s0 (1,{h},{dh},{dh})")

    # the chunked kernel against f64
    cases, timed = [], {}
    for sl, mu, zeros in ((256, 0.0, False), (256, 0.0, True), (256, -6.0, False),
                          (4096, 0.0, False), (64, 0.0, False), (40, 0.0, True),
                          (2, 0.0, False)):
        r, k, v, w, s0 = inputs(sl, mu, zeros)
        y, last = wkv6(r, k, v, w, u, s0)
        y64, last64 = wkv6_plain(r, k, v, w, u, s0, dtype=torch.float64)
        yp, lastp = wkv6_plain(r, k, v, w, u, s0)
        yc, lastc = wkv6_chunked_plain(r, k, v, w, u, s0)
        torch.cuda.synchronize()
        cases.append(dict(
            S=sl, mu=mu, zeros_in_w=int((w == 0).sum()),
            finite=bool(torch.isfinite(y).all() and torch.isfinite(last).all()),
            y_rel_err_f64=rel(y, y64), s_last_rel_err_f64=rel(last, last64),
            plain_y_rel_err_f64=rel(yp, y64), plain_s_last_rel_err_f64=rel(lastp, last64),
            chunked_plain_y_rel_err_f64=rel(yc, y64),
            chunked_plain_s_last_rel_err_f64=rel(lastc, last64),
            y_rel_err_plain=rel(y, yp), s_last_rel_err_plain=rel(last, lastp),
            max_abs_err=max(float((y.double() - y64).abs().max()),
                            float((last.double() - last64).abs().max())),
            max_abs_y=float(y64.abs().max()), max_abs_s_last=float(last64.abs().max())))
        if mu == 0.0 and not zeros and sl in (256, 4096, 64):
            timed[sl] = timing(sl, r, k, v, w, s0, y, last)
        del y64, last64
    r, k, v, w, s0 = inputs(512)
    y, last = wkv6(r, k, v, w, u, s0)
    halves = [t[:, :256].contiguous() for t in (r, k, v, w)]
    y1, mid = wkv6(*halves, u, s0)
    halves = [t[:, 256:].contiguous() for t in (r, k, v, w)]
    y2, last2 = wkv6(*halves, u, mid)
    torch.cuda.synchronize()
    invariant = torch.equal(y, torch.cat([y1, y2], dim=1)) and torch.equal(last, last2)
    res["wkv6"] = dict(
        max_abs_err=max(c["max_abs_err"] for c in cases),
        max_rel_err=max(c["y_rel_err_f64"] for c in cases), tol=WKV6_F64_TOL,
        s_last_max_rel_err=max(c["s_last_rel_err_f64"] for c in cases),
        s_last_tol=WKV6_F64_TOL, finite=all(c["finite"] for c in cases),
        invariant_512=invariant, cases=cases, **timed[256], library_ms=None,
        s4096=timed[4096], s64=timed[64],
        shape=f"r, k, v, w (1,256,{h},{dh}) f32, u ({h},{dh}), s0 (1,{h},{dh},{dh})")


def wkv_sweep(dev):
    """The chunked wkv6 kernel at every variant it is built for (steps a
    chunk, state columns a block, state columns a lane): each checked
    against the f64 plain version at S = 256, then timed at S = 256, 4096
    and 64 (CUDA events, L2 flushed; torch.profiler at S = 256)."""
    import torch
    from repro_torch.kernels.rwkv6_scan import CHUNKED_VARIANTS, wkv6, wkv6_plain

    g = torch.Generator(device=dev).manual_seed(2)
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB
    h, dh = 64, 64

    def flush():
        scratch.zero_()

    def inputs(sl):
        r, k, v = (torch.randn(1, sl, h, dh, generator=g, device=dev) for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(1, sl, h, dh, generator=g, device=dev)))
        return r, k, v, w, torch.randn(1, h, dh, dh, generator=g, device=dev)

    u = 0.1 * torch.randn(h, dh, generator=g, device=dev)
    ins = {sl: inputs(sl) for sl in (256, 4096, 64)}
    r, k, v, w, s0 = ins[256]
    y64, last64 = wkv6_plain(r, k, v, w, u, s0, dtype=torch.float64)
    for var in CHUNKED_VARIANTS:
        y, last = wkv6(r, k, v, w, u, s0, variant=var)
        torch.cuda.synchronize()
        row = dict(chunk=var[0], cols=var[1], lane_cols=var[2],
                   y_rel_err_f64=float((y.double() - y64).abs().max() / y64.abs().max()),
                   s_last_rel_err_f64=float((last.double() - last64).abs().max()
                                            / last64.abs().max()))
        for sl, (r_, k_, v_, w_, s0_) in ins.items():
            row[f"ms_{sl}"] = time_ms(
                lambda: wkv6(r_, k_, v_, w_, u, s0_, variant=var), flush=flush)
        row["kernels_us_256"] = kernels_us(
            lambda: wkv6(r, k, v, w, u, s0, variant=var), flush, match="wkv6")
        print(json.dumps({"wkv_sweep": row}))


def decode_sweep(dev):
    """flash_decode over the cache lengths and batch rows its split plan
    meets, at both model shapes: the plan and the device time of each of
    its two kernels (torch.profiler), inputs cold in L2 and warm."""
    import torch
    from repro_torch.kernels.flash_decode import _split_plan, flash_decode

    g = torch.Generator(device=dev).manual_seed(3)
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB
    sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for hq, hkv, dh in ((32, 8, 128), (10, 1, 256)):
        for b in (1, 2):
            for s in (32, 592, 1616, 2640, 4176, 8192):
                q = torch.randn(b, hq, dh, generator=g, device=dev).bfloat16()
                k, v = (torch.randn(b, s, hkv, dh, generator=g, device=dev).bfloat16()
                        for _ in range(2))
                kp = torch.arange(s, dtype=torch.int32, device=dev)

                def call():
                    return flash_decode(q, k, v, kp, s - 1, scale=dh ** -0.5)
                per, n = _split_plan(b, hkv, s, sm)
                print(json.dumps({"decode_sweep": dict(
                    dh=dh, hq=hq, hkv=hkv, b=b, s=s, split_slots=per, n_split=n,
                    blocks=b * hkv * n, cold_us=kernels_us(call, scratch.zero_),
                    warm_us=kernels_us(call))}))


def prefill_sweep(dev):
    """flash_prefill at its four timed shapes with the cache cut into the
    plan's n_split and into one split, about half and about twice as many:
    device time by CUDA events (L2 flushed) and the error against the plain
    version, so the plan's choice can be read against its neighbours."""
    import torch
    import repro_torch.kernels.flash_prefill as fp

    g = torch.Generator(device=dev).manual_seed(4)
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB
    sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def rnd(*shape):
        return torch.randn(*shape, generator=g, device=dev).bfloat16()

    # name: (Sq, Hq, Hkv, Dh, S, q_offset, window, kpos)
    shapes = {
        "qwen3": (256, 32, 8, 128, 4096, 3840, 0, torch.arange(4096, device=dev)),
        "qwen3_suffix": (64, 32, 8, 128, 4176, 4096, 0,
                         torch.where(torch.arange(4176, device=dev) < 4160,
                                     torch.arange(4176, device=dev), -1)),
        "hybrid": (256, 10, 1, 256, 2048, 1792, 2048, torch.arange(2048, device=dev)),
        "hybrid_suffix": (64, 10, 1, 256, 2048, 2048, 2048, ring_kpos(2048, 2111, dev)),
    }
    plan = fp._plan
    try:
        for name, (sq, hq, hkv, dh, s, q_off, win, kp) in shapes.items():
            q, k, v = rnd(1, sq, hq, dh), rnd(1, s, hkv, dh), rnd(1, s, hkv, dh)
            kp = kp.to(torch.int32)
            kw = dict(scale=dh ** -0.5, window=win)
            ref = fp.flash_prefill_plain(q, k, v, kp, q_off, **kw).float()
            m_tile, n0, _ = plan(1, hkv, sq, hq // hkv, s, sm)
            tiles = -(-s // fp.TILE)
            for want in sorted({1, max(1, n0 // 2), n0, min(tiles, 2 * n0)}):
                per = -(-tiles // want)
                n = -(-tiles // per)
                fp._plan = lambda *a, n=n, per=per: (m_tile, n, per * fp.TILE)

                def call():
                    return fp.flash_prefill(q, k, v, kp, q_off, **kw)
                err = float((call().float() - ref).abs().max())
                print(json.dumps({"prefill_sweep": dict(
                    shape=name, n_split=n, plan=n == n0, blocks=hkv * -(-sq * hq // hkv // m_tile) * n,
                    ms=time_ms(call, flush=scratch.zero_), max_abs_err=err)}))
    finally:
        fp._plan = plan


# ---------------------------------------------------------------------------
# Serve phase: the port's main path at full width
# ---------------------------------------------------------------------------


# the kernels each path must launch: qwen3-8b restores from an int8 chunk
# store through the fused datapath; recurrentgemma-2b's windowed caches take
# no chunk store (its loads copy the ground-truth payload)
QWEN3_KERNELS = ("flash_prefill", "flash_decode", "kv_restore", "kv_quantize",
                 "kv_dequantize")
HYBRID_KERNELS = ("rglru_scan", "rglru_scan_step", "flash_prefill", "flash_decode")
# the CLI's on-card replay restores with no chunk store (loads copy ground truth)
REPLAY_KERNELS = ("flash_prefill", "flash_decode")
# rwkv6-7b is attention-free and takes no chunk store: only the two wkv6
# kernels may launch (chunked for prefill and recompute, one step for decode)
RWKV_KERNELS = ("wkv6", "wkv6_step")


def counters():
    """{name: (wrapper, its count attribute)}."""
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_partials
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.kv_quant import kv_dequantize, kv_quantize
    from repro_torch.kernels.kv_restore import kv_restore_scatter
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import wkv6
    return {"flash_prefill": (flash_prefill, "launches"),
            "flash_decode": (flash_decode, "launches"),
            "flash_decode_partials": (flash_decode_partials, "launches"),
            "kv_restore": (kv_restore_scatter, "launches"),
            "kv_quantize": (kv_quantize, "launches"),
            "kv_dequantize": (kv_dequantize, "launches"),
            "kv_dequantize_run": (kv_dequantize, "run_launches"),
            "rglru_scan": (rglru_scan, "launches"),
            "rglru_scan_step": (rglru_scan, "step_launches"),
            "rglru_scan_reverse": (rglru_scan, "reverse_launches"),
            "wkv6": (wkv6, "launches"), "wkv6_step": (wkv6, "step_launches"),
            "wkv6_backward": (wkv6, "backward_launches")}


def zero_counters():
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import wkv6
    for w, attr in counters().values():
        setattr(w, attr, 0)
    wkv6.launches_by_len.clear()
    rglru_scan.launches_by_len.clear()


def read_counters() -> dict:
    """Launches of each kernel since ``zero_counters``.  ``wkv6.launches``
    and ``rglru_scan.launches`` count both kernels of their wrapper: the
    chunked (tiled) kernel's are those less the one-step kernel's.
    ``kv_dequantize`` counts both of its forms; ``kv_dequantize_run`` the run
    form alone (the datapath's promotions), and ``kv_dequantize_chunk`` the
    one-chunk form (``ChunkStore._decode_device``).  ``rglru_scan_reverse``
    counts the calls over reversed time that its gradient Function's
    backward makes (among both kernels' counts); ``wkv6_backward`` the
    calls of wkv6's backward kernel (apart from ``wkv6``'s)."""
    out = {n: getattr(w, attr) for n, (w, attr) in counters().items()}
    out["kv_dequantize_chunk"] = out["kv_dequantize"] - out["kv_dequantize_run"]
    out["wkv6"] -= out["wkv6_step"]
    out["rglru_scan"] -= out["rglru_scan_step"]
    return out


# substrings of the port's CUDA kernel names in a profiler trace
PORT_KERNEL_NAMES = ("flash_prefill", "flash_decode", "kv_restore", "kv_quantize",
                     "kv_dequantize", "rglru_scan", "wkv6")
# the program's own spans (repro_torch.obs.SPAN_CATALOG), record_function
# ranges of a traced qwen3 serve with telemetry on: the kernels each launched
# (the datapath's promotion of transfer runs, and within it the pool's copies)
PROMOTE_RANGES = ("datapath.promote", "store.promote_staged")


def profile_serve(serve, ranges=(), names=PORT_KERNEL_NAMES) -> dict:
    """One more serve (``serve()``) under torch.profiler: device time by
    kernel (the 15 largest, and every one of the port's own kernels, those
    whose names hold one of ``names``) and the share of the traced wall time
    the device spent in kernels and copies (summed over streams); for each
    record_function range in ``ranges``, its calls and the device time of
    the kernels and copies launched inside it.  Separate from the timed
    runs: tracing slows the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def device_us(e, own):
        us = getattr(e, ("self_" if own else "") + "device_time_total", None)
        return us if us is not None else getattr(e, ("self_" if own else "") + "cuda_time_total", 0)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve()
        wall = time.perf_counter() - t0
    rows, spans = [], {}
    for e in prof.key_averages():
        if e.key in ranges:
            if "CUDA" not in str(getattr(e, "device_type", "")):
                spans[e.key] = dict(calls=e.count, device_ms=device_us(e, False) / 1e3)
            continue
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        rows.append((device_us(e, True), e.count, e.key[:80]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    return dict(traced_wall_s=wall, device_s=busy,
                device_share=busy / wall if wall else None,
                top=[dict(name=n, calls=c, device_ms=us / 1e3) for us, c, n in rows[:15]],
                port_kernels=[dict(name=n, calls=c, device_ms=us / 1e3) for us, c, n in rows
                              if any(m in n for m in names)],
                ranges=spans)


def qwen3_server(dev):
    """qwen3-8b at full width and depth with random bf16 weights from seed 0,
    and ``serve(quant)``: four requests (prefixes 512-4096, 64 new tokens, 16
    output tokens each) through RealServingEngine from a ChunkStore of that
    quantization on the host tier, verify on, its schedule recorded into
    ``trace`` when one is given; returns (engine, store, requests, report,
    seconds).  Only interfaces older trees share, so that
    ``--promote-profile`` runs there too."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ChunkStore, RealServingEngine, Request

    cfg = get_config("qwen3-8b")
    model = Model(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                  device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    def serve(quant, trace=None, telemetry=None):
        store = ChunkStore(chunk_size=16, quant=quant, default_tier="host", device=dev)
        eng = RealServingEngine(model, params, system="cacheflow", stages=2,
                                chunk_size=256, l_delta=1024, max_batch=2,
                                kvstore=store, datapath="fused", device=dev, seed=0,
                                telemetry=telemetry)
        reqs = [Request(f"r{n}", 0.0, n, 64, decode_len=16)
                for n in (512, 1536, 2560, 4096)]
        t0 = time.perf_counter()
        rep = eng.serve(reqs, verify=True, trace=trace)
        torch.cuda.synchronize()
        return eng, store, reqs, rep, time.perf_counter() - t0
    return cfg, model, params, serve


def first_difference(a: dict, b: dict):
    """(request, step) of the first greedy token two serves disagree on, or
    None."""
    for rid in a:
        for step, (x, y) in enumerate(itertools.zip_longest(a[rid], b.get(rid, []))):
            if x != y:
                return [rid, step]
    return None


def serve_phase(dev, card: str, profile: bool = False) -> dict:
    import torch
    from repro_torch.core.trace import TraceRecorder

    t0 = time.perf_counter()
    cfg, model, params, serve = qwen3_server(dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.num_params(params)

    # the main path: every launch counter from 0 just before, read just after;
    # its schedule is captured (recording observes, it decides nothing)
    recorder = TraceRecorder()
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    eng, store, reqs, rep, serve_s = serve("int8", trace=recorder)
    launches = read_counters()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the same requests from an unquantized store: loads are then raw copies,
    # so verify's error is the recompute path's own (token- vs layer-wise).
    # Served twice: whether its greedy tokens hold from serve to serve
    # (printed, not asserted: decode batches vary with measured op times)
    eng_raw, _, _, _, raw_s = serve("none")
    recompute_err = eng_raw.executor.verify_errs
    tokens_none = {r.request_id: eng_raw.executor.outputs(r.request_id)["tokens"]
                   for r in reqs}
    del eng_raw
    eng_raw, _, _, _, _ = serve("none")
    tokens_again = {r.request_id: eng_raw.executor.outputs(r.request_id)["tokens"]
                    for r in reqs}
    del eng_raw
    diff = first_difference(tokens_none, tokens_again)
    if profile:
        print(json.dumps({"profile": profile_serve(lambda: serve("int8", telemetry=True),
                                                   ranges=PROMOTE_RANGES)}))

    ex = eng.executor
    strategies = {r.request_id: ex._live[r.request_id]["plans"][0].strategy
                  for r in reqs}
    out, bad = {}, []
    for r in reqs:
        o = ex.outputs(r.request_id)
        logits = o["first_logits"].float()
        # the first output token comes from the suffix prefill, the rest
        # from decode steps: decode_len tokens in all
        if (tuple(logits.shape) != (1, cfg.vocab_size)
                or not bool(torch.isfinite(logits).all())
                or len(o["tokens"]) != r.decode_len):
            bad.append(r.request_id)
        out[r.request_id] = dict(strategy=strategies[r.request_id],
                                 verify_max_err=ex.verify_errs[r.request_id],
                                 verify_max_err_none=recompute_err[r.request_id],
                                 n_tokens=len(o["tokens"]), tokens=o["tokens"][:6])
    dp = eng.datapath
    result = dict(
        card=card, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        params=n_params, init_s=init_s, serve_s=serve_s, serve_none_s=raw_s,
        peak_mem_gb=peak_gb, stats=rep.stats, compute_busy=rep.compute_busy,
        io_busy=rep.io_busy, decode_busy=rep.decode_busy,
        overlap_decode_restore=rep.overlap_decode_restore,
        ttfts=rep.ttfts, restore_secs=rep.restore_secs,
        verify_within_max_scale=max(v for r in out.values()
                                    for v in r["verify_max_err"].values()) <= store.max_scale,
        tokens_none=tokens_none, tokens_stable=diff is None, tokens_first_difference=diff,
        datapath=dict(ops=dp.ops, runs=dp.runs, kernel_launches=dp.kernel_launches,
                      resident_copies=dp.resident_copies,
                      bandwidth_gbps=[b / 1e9 if b else None for b in dp.bandwidths()],
                      fused_loads=ex.fused_loads, legacy_loads=ex.legacy_loads,
                      load_dispatches=ex.load_dispatches),
        store=dict(puts=store.puts, fetches=store.fetches, io_hits=store.io_hits,
                   dedup_hits=store.dedup_hits, bytes_transferred=store.bytes_transferred,
                   skipped_transfers=store.skipped_transfers, max_scale=store.max_scale),
        requests=out, launches=launches)
    print(json.dumps({"serve": result}, default=str))
    if bad:
        raise AssertionError(f"bad outputs (logits shape/finite, token count): {bad}")
    # raw copies restore the unquantized store's bytes: nothing but 0 verifies
    none_err = max(v for r in out.values() for v in r["verify_max_err_none"].values())
    if none_err != 0:
        raise AssertionError(f"unquantized serve verifies to {none_err}, not 0")
    missing = [n for n in QWEN3_KERNELS if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched during serve: {missing}")
    # one run-form kv_dequantize for each transfer run the datapath promoted
    if launches["kv_dequantize_run"] != dp.kernel_launches:
        raise AssertionError(f"kv_dequantize run launches {launches['kv_dequantize_run']} "
                             f"!= transfer runs {dp.kernel_launches}")
    if sorted(set(strategies.values())) != ["layer", "token"]:
        raise AssertionError(f"expected layer- and token-wise plans: {strategies}")
    result["replay"] = replay_check(dev, card, model, params, eng, reqs, recorder.trace)
    result["crossover"] = crossover_phase(dev, card, cfg, model, params)
    return result


def replay_check(dev, card: str, model, params, eng, reqs, trace) -> dict:
    """The int8 qwen3 serve's captured schedule: saved under OUT_DIR,
    linted (no finding), replayed analytically (equal to the captured
    result), then replayed on the card by a fresh executor on the same
    model and weights with its own int8 chunk store (16-token blocks, host
    tier) and fused datapath, fed the serve's inputs and suffixes: the same
    ops log and restore finishes, every request verified within the store's
    ``max_scale``.  Prints whether the replay's greedy tokens equal the
    serve's (and the first request and step where they differ) and the
    kernels launched by the replay's executor (its ``remember`` included)."""
    import torch
    from repro_torch.analysis.trace_lint import lint_trace_file
    from repro_torch.core.datapath import RestoreDatapath
    from repro_torch.core.executor import RestorationExecutor
    from repro_torch.core.trace import ScheduleTrace, replay_trace
    from repro_torch.storage import ChunkStore

    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, "qwen3_int8_serve.trace.json")
    trace.save(path)
    findings = [str(f) for f in lint_trace_file(path)]
    loaded = ScheduleTrace.load(path)
    captured = loaded.captured_result()
    analytic_equal = replay_trace(loaded) == captured

    store = ChunkStore(chunk_size=16, quant="int8", default_tier="host", device=dev)
    ex0 = eng.executor
    zero_counters()
    t0 = time.perf_counter()
    ex = RestorationExecutor(model, params, chunk_size=ex0.chunk_size, stages=ex0.stages,
                             chunk_store=store,
                             datapath=RestoreDatapath.for_channels(1, device=dev))
    for r in reqs:
        ex.remember(r.request_id, eng._inputs(r.prefix_len))
        ex.set_suffix(r.request_id, eng._inputs(r.new_len), decode_len=r.decode_len)
    res = replay_trace(loaded, ex, verify=True,
                       verify_atol=2e-2 + store.quant_tolerance())
    torch.cuda.synchronize()
    replay_s = time.perf_counter() - t0
    launches = read_counters()
    tokens = {r.request_id: ex0.outputs(r.request_id)["tokens"] for r in reqs}
    tokens_replay = {r.request_id: ex.outputs(r.request_id)["tokens"] for r in reqs}
    worst = max(v for e in ex.verify_errs.values() for v in e.values())
    out = dict(card=card, trace=os.path.relpath(path, HERE), events=len(loaded.events),
               dispatches=len(loaded.dispatches()), decode_steps=len(loaded.decode_steps()),
               lint_findings=findings, analytic_equal=analytic_equal,
               ops_log_equal=res.ops_log == captured.ops_log,
               restore_finish_equal=res.restore_finish == captured.restore_finish,
               verified=sorted(ex.verify_errs), verify_max_err=worst,
               max_scale=store.max_scale, replay_s=replay_s,
               tokens_equal=tokens_replay == tokens,
               tokens_first_difference=first_difference(tokens, tokens_replay),
               launches=launches)
    print(json.dumps({"serve_replay": out}))
    if findings:
        raise AssertionError(f"lint findings in the captured trace: {findings[:5]}")
    if not analytic_equal:
        raise AssertionError("analytic replay differs from the captured result")
    if not (out["ops_log_equal"] and out["restore_finish_equal"]):
        raise AssertionError("on-device replay left the captured schedule")
    if out["verified"] != sorted(r.request_id for r in reqs) or worst > store.max_scale:
        raise AssertionError(f"replay verify: {out['verified']}, worst {worst} "
                             f"> max_scale {store.max_scale}")
    return out


CROSSOVER_LENGTHS = (256, 512, 1024, 2048, 4096)


def crossover_phase(dev, card: str, cfg, model, params) -> dict:
    """The crossover L_Δ between token- and layer-wise restoration (paper
    Fig. 3) measured by ``profile_measured`` on a qwen3-8b executor at full
    width (bf16, chunk 256, 2 stages, no chunk store), best of 3 at each
    length, each restored cache verified; printed beside the analytic L_Δ
    of the H100 cost model at 10 Gbps and the 1024 the serves fix."""
    import torch
    from repro_torch.config import HARDWARE, IO_BANDWIDTHS
    from repro_torch.core.cost_model import CostModel
    from repro_torch.core.executor import RestorationExecutor
    from repro_torch.core.profiler import profile_analytic, profile_measured

    ex = RestorationExecutor(model, params, chunk_size=256, stages=2)
    gen = torch.Generator().manual_seed(3)
    t0 = time.perf_counter()
    prof = profile_measured(
        ex, lambda n: torch.randint(0, cfg.vocab_size, (1, n), generator=gen,
                                    dtype=torch.int32),
        lengths=list(CROSSOVER_LENGTHS), repeats=3)
    seconds = time.perf_counter() - t0
    errs = {n: max(ex.verify(f"prof-{n}").values()) for n in CROSSOVER_LENGTHS}
    cost = CostModel(cfg, HARDWARE["h100"], IO_BANDWIDTHS["10Gbps"])
    analytic = profile_analytic(cost, list(CROSSOVER_LENGTHS))
    out = dict(card=card, lengths=prof.lengths, t_token_s=prof.t_token,
               t_layer_s=prof.t_layer, l_delta=prof.l_delta,
               analytic_t_token_s=analytic.t_token, analytic_t_layer_s=analytic.t_layer,
               l_delta_analytic_h100_10gbps=cost.crossover_l_delta(),
               l_delta_serves=1024, verify_max_err=errs, seconds=seconds)
    print(json.dumps({"crossover": out}))
    return out


def cli_phase(dev, card: str) -> dict:
    """``python -m repro_torch.launch.serve`` as a user runs it, in process:
    a paper-scale simulation; full-width int8 qwen3-8b for real with its
    schedule captured (each of the five qwen3 kernels must launch); the
    capture replayed analytically (equal to it) with a Perfetto timeline,
    then on the card (verify on); full-width recurrentgemma-2b and rwkv6-7b
    for real (their scan kernels must launch); the int8 qwen3-8b call again
    with every opt-in (``--sanitize --telemetry --metrics-out
    --timeline-out``: no violation, the sanitizer and telemetry blocks in
    the report, telemetry's ``datapath.kernel_launches_total`` equal to the
    datapath's transfer-run launches, which are the call's ``kv_restore``
    launches less its resident-run copies, and the timeline's tier-bytes
    counter tracks); llama3.1-8b and the MoE qwen3-30b-a3b in simulation;
    qwen3-30b-a3b (full width and depth, 61 GB of bf16 weights) and
    llama3.1-8b for real from an int8 store (the five qwen3 kernels must
    launch).  Prints one ``{"cli": ...}``
    line: each call's wall seconds, its report's TTFT p50 and mean TPOT,
    and its launches by kernel."""
    import io

    import torch
    from repro_torch.core.trace import ScheduleTrace, replay_trace
    from repro_torch.launch import serve as cli

    os.makedirs(OUT_DIR, exist_ok=True)
    trace = os.path.join(OUT_DIR, "cli_qwen3_int8.trace.json")
    timeline = os.path.join(OUT_DIR, "cli_qwen3_int8.timeline.json")
    metrics = os.path.join(OUT_DIR, "cli_qwen3_observed.metrics.json")
    observed_timeline = os.path.join(OUT_DIR, "cli_qwen3_observed.timeline.json")
    calls = [
        ("sim", ["--requests", "64", "--workload", "swe_bench"], ()),
        ("real_qwen3", ["--real", "--arch", "qwen3-8b", "--requests", "4",
                        "--kv-quant", "int8", "--trace-out", trace], QWEN3_KERNELS),
        ("replay", ["--replay", trace, "--timeline-out", timeline], ()),
        ("replay_real", ["--replay", trace, "--real"], REPLAY_KERNELS),
        ("real_hybrid", ["--real", "--arch", "recurrentgemma-2b", "--requests", "4"],
         HYBRID_KERNELS),
        ("real_rwkv", ["--real", "--arch", "rwkv6-7b", "--requests", "4"], RWKV_KERNELS),
        ("real_qwen3_observed", ["--real", "--arch", "qwen3-8b", "--requests", "4",
                                 "--kv-quant", "int8", "--sanitize", "--telemetry",
                                 "--metrics-out", metrics, "--timeline-out",
                                 observed_timeline], QWEN3_KERNELS),
        ("sim_llama", ["--arch", "llama3.1-8b", "--requests", "64"], ()),
        ("sim_moe", ["--arch", "qwen3-30b-a3b", "--requests", "64"], ()),
        ("real_moe", ["--real", "--arch", "qwen3-30b-a3b", "--requests", "4",
                      "--kv-quant", "int8"], QWEN3_KERNELS),
        ("real_llama", ["--real", "--arch", "llama3.1-8b", "--requests", "4",
                        "--kv-quant", "int8"], QWEN3_KERNELS),
    ]
    rows = []
    for name, argv, must_launch in calls:
        zero_counters()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            cli.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        # the engines and executors hold each other: free the full-width
        # model before the next call builds one
        gc.collect()
        torch.cuda.empty_cache()
        report = json.loads(buf.getvalue())
        stats = report.get("lifecycle", {})
        rows.append(dict(call=name, argv=[os.path.relpath(a, HERE) if a.startswith(OUT_DIR)
                                          else a for a in argv],
                         mode=report.get("mode", "sim"), wall_s=wall,
                         ttft_p50_s=stats.get("p50"), tpot_mean_s=stats.get("tpot_mean"),
                         completed=stats.get("completed"),
                         launches={k: v for k, v in launches.items() if v}))
        missing = [n for n in must_launch if launches[n] == 0]
        if missing:
            print(json.dumps({"cli": rows}))
            raise AssertionError(f"cli {name}: kernels not launched: {missing}")
        if name == "replay":
            loaded = ScheduleTrace.load(trace)
            if replay_trace(loaded) != loaded.captured_result():
                raise AssertionError("cli replay differs from the captured result")
            with open(timeline) as f:
                rows[-1]["timeline_events"] = len(json.load(f)["traceEvents"])
            if not rows[-1]["timeline_events"]:
                raise AssertionError("cli timeline holds no event")
        if name.startswith("real") and stats.get("completed") != 4:
            raise AssertionError(f"cli {name}: {stats.get('completed')} of 4 completed")
        if name == "real_qwen3_observed":
            rows[-1].update(observed_check(report, launches, metrics, observed_timeline))
            rows[-1]["unobserved_wall_s"] = next(r["wall_s"] for r in rows
                                                 if r["call"] == "real_qwen3")
    print(json.dumps({"cli": rows}))
    return {r["call"]: r for r in rows}


def observed_check(report: dict, launches: dict, metrics: str, timeline: str) -> dict:
    """What the observed qwen3 call must show: the sanitizer's counters (it
    raises SanitizerViolation on any drift, so reaching here means none),
    telemetry's counters in the report and its snapshot in ``metrics``, the
    datapath's launches counted alike by telemetry, the report and the
    wrappers, and tier-bytes counter tracks in ``timeline``."""
    counters = report.get("telemetry", {}).get("counters", {})
    dp = report.get("datapath", {})
    with open(metrics) as f:
        snapshot = json.load(f)
    with open(timeline) as f:
        tracks = sorted({e["name"] for e in json.load(f)["traceEvents"]
                         if e.get("ph") == "C" and e["name"].startswith("tier_bytes:")})
    out = dict(sanitizer=report.get("sanitizer"),
               kernel_launches_total=counters.get("datapath.kernel_launches_total"),
               datapath_kernel_launches=dp.get("kernel_launches"),
               resident_copies=dp.get("resident_copies"),
               tier_tracks=tracks, snapshot_counters=len(snapshot["metrics"]["counters"]))
    if not out["sanitizer"] or not out["sanitizer"].get("dispatches"):
        raise AssertionError(f"observed call: no sanitizer counters: {out}")
    transfer = launches["kv_restore"] - dp.get("resident_copies", 0)
    if not (out["kernel_launches_total"] == dp.get("kernel_launches") == transfer
            == launches["kv_dequantize_run"]):
        raise AssertionError(f"observed call: telemetry's datapath.kernel_launches_total "
                             f"{out['kernel_launches_total']} != transfer-run launches "
                             f"(kv_restore {launches['kv_restore']} less resident copies "
                             f"{dp.get('resident_copies')}, kv_dequantize run "
                             f"{launches['kv_dequantize_run']})")
    if not tracks or snapshot["metrics"]["counters"] != counters:
        raise AssertionError(f"observed call: tier tracks {tracks}, snapshot counters "
                             f"equal to the report's: {snapshot['metrics']['counters'] == counters}")
    return out


def promote_profile(dev, card: str) -> dict:
    """qwen3-8b's int8 serve once untraced, then once traced with the
    datapath's promotion inside PROMOTE_RANGES, the program's spans (on
    with telemetry): the device time of what ``_promote_run`` launches (its
    dequantize launches and copies, and the pool's block writes under
    ``promote_staged``) and of each port kernel.  Uses only interfaces older
    trees share; a tree older than the spans has no such ranges, and its
    ``ranges`` come out empty.  ``dequant_kernel`` is the one-chunk
    dequantize kernel's name before it shared dequant_rows.cuh."""
    import torch
    _, _, _, serve = qwen3_server(dev)
    serve("int8")
    prof = profile_serve(lambda: serve("int8", telemetry=True), ranges=PROMOTE_RANGES,
                         names=PORT_KERNEL_NAMES + ("dequant_kernel",))
    torch.cuda.synchronize()
    out = dict(card=card, **{k: prof[k] for k in ("traced_wall_s", "device_s", "device_share",
                                                   "port_kernels", "ranges")})
    print(json.dumps({"promote_profile": out}))
    return out


def hybrid_serve_phase(dev, card: str, profile: bool = False) -> dict:
    """The port's second path: recurrentgemma-2b at full width and depth (26
    layers: 18 RG-LRU, 8 local attention) with random bf16 weights, four
    requests whose prefixes stay within the 2048-token window (so the ring
    wraps only in suffix prefill and decode), verify on — attention KV and
    the RG-LRU conv/lru state of every restored cache."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.models import Model
    from repro_torch.serving import RealServingEngine, Request

    cfg = get_config("recurrentgemma-2b")
    t0 = time.perf_counter()
    model = Model(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                  device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0

    def serve():
        eng = RealServingEngine(model, params, system="cacheflow", stages=2,
                                chunk_size=256, l_delta=1024, max_batch=2,
                                kvstore=None, device=dev, seed=0)
        reqs = [Request(f"r{n}", 0.0, n, 64, decode_len=16)
                for n in (512, 1024, 1536, 2048)]
        t0 = time.perf_counter()
        rep = eng.serve(reqs, verify=True)
        torch.cuda.synchronize()
        return eng, reqs, rep, time.perf_counter() - t0

    # this path: every launch counter from 0 just before, read just after
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, rep, serve_s = serve()
    launches = read_counters()
    by_len = dict(sorted(rglru_scan.launches_by_len.items()))
    print(json.dumps({"hybrid_rglru_scan_launches_by_S": by_len}))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if profile:
        print(json.dumps({"hybrid_profile": profile_serve(serve)}))

    ex = eng.executor
    strategies = {r.request_id: ex._live[r.request_id]["plans"][0].strategy
                  for r in reqs}
    out, bad = {}, []
    for r in reqs:
        o = ex.outputs(r.request_id)
        logits = o["first_logits"].float()
        errs = ex.verify_errs.get(r.request_id, {})
        if (tuple(logits.shape) != (1, cfg.vocab_size)
                or not bool(torch.isfinite(logits).all())
                or len(o["tokens"]) != r.decode_len
                or not {"k", "v", "kpos", "conv", "lru"} <= set(errs)):
            bad.append(r.request_id)
        out[r.request_id] = dict(strategy=strategies[r.request_id],
                                 verify_max_err=errs, n_tokens=len(o["tokens"]),
                                 tokens=o["tokens"][:6])
    result = dict(
        card=card, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        params=model.num_params(params), init_s=init_s, serve_s=serve_s,
        peak_mem_gb=peak_gb, stats=rep.stats, compute_busy=rep.compute_busy,
        io_busy=rep.io_busy, decode_busy=rep.decode_busy,
        overlap_decode_restore=rep.overlap_decode_restore, ttfts=rep.ttfts,
        restore_secs=rep.restore_secs, requests=out, launches=launches,
        rglru_scan_launches_by_S=by_len)
    print(json.dumps({"hybrid_serve": result}, default=str))
    if bad:
        raise AssertionError(f"bad outputs (logits shape/finite, token count, "
                             f"verified fields): {bad}")
    missing = [n for n in HYBRID_KERNELS if launches[n] == 0]
    if missing:
        raise AssertionError(f"kernels not launched during the hybrid serve: {missing}")
    want = {"r512": "layer", "r1024": "token", "r1536": "token", "r2048": "token"}
    if strategies != want:
        raise AssertionError(f"expected strategies {want}, got {strategies}")
    return result


def row_invariance(model, params, dev, m: int = 512, c: int = 256) -> dict:
    """Which op of an RWKV layer gives other rows at M = m than at M = c:
    for each product (and norm) of layer 0, on the same random bf16 input,
    max |op(a)[:c] - op(a[:c])|.  Nonzero means the library picked another
    kernel (another summation order) for the other row count — what
    layer-wise recompute over the whole prefix would not repeat of
    ``remember``'s chunks."""
    import torch
    from repro_torch.models.layers import apply_norm

    p = params["layers"][0]["rwkv"]
    cfg = model.cfg
    g = torch.Generator(device=dev).manual_seed(2)
    rank = cfg.rwkv.tokenshift_lora_rank
    bf = torch.bfloat16
    def shape(name):
        return "x".join(map(str, p[name].shape))

    ops = {
        f"mix_w1 {shape('mix_w1')}": (cfg.d_model, bf, lambda a: a @ p["mix_w1"]),
        f"einsum mix_w2 {shape('mix_w2')}": (5 * rank, bf, lambda a: torch.einsum(
            "...nr,nrd->...nd", a.reshape(1, -1, 5, rank), p["mix_w2"])),
        f"w_r {shape('w_r')}": (cfg.d_model, bf, lambda a: a @ p["w_r"]),
        f"decay_w1 {shape('decay_w1')}": (cfg.d_model, bf, lambda a: a @ p["decay_w1"]),
        f"f32 decay_w2 {shape('decay_w2')}": (cfg.rwkv.decay_lora_rank, torch.float32,
                                             lambda a: a @ p["decay_w2"].float()),
        f"cm_k {shape('cm_k')}": (cfg.d_model, bf, lambda a: a @ p["cm_k"]),
        f"cm_v {shape('cm_v')}": (cfg.d_ff, bf, lambda a: a @ p["cm_v"]),
        "layernorm": (cfg.d_model, bf, lambda a: apply_norm(
            cfg.norm, params["layers"][0]["norm1"], a, cfg.norm_eps)),
    }
    out = {}
    for name, (width, dt, fn) in ops.items():
        a = torch.randn(1, m, width, generator=g, device=dev).to(dt)
        out[name] = float((fn(a)[:, :c].float() - fn(a[:, :c]).float()).abs().max())
    return out


def rwkv_serve_phase(dev, card: str, profile: bool = False) -> dict:
    """The port's third path: rwkv6-7b at full width and depth (32 RWKV-6
    layers, d_model 4096, 64 wkv heads of 64, d_ff 14336) with random bf16
    weights, four requests, verify on.  Attention-free: every plan is
    layer-wise (the compute pointer recomputes whole layers over the prefix,
    the I/O pointer applies a layer's end-of-prefix state snapshot), and the
    restored state is each layer's wkv matrix and two token shifts."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_scan import wkv6
    from repro_torch.models import Model
    from repro_torch.serving import RealServingEngine, Request

    cfg = get_config("rwkv6-7b")
    t0 = time.perf_counter()
    model = Model(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                  device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rows = row_invariance(model, params, dev)
    print(json.dumps({"rwkv_row_invariance_512_vs_256": rows}))

    def serve():
        eng = RealServingEngine(model, params, system="cacheflow", stages=2,
                                chunk_size=256, l_delta=1024, max_batch=2,
                                kvstore=None, device=dev, seed=0)
        reqs = [Request(f"r{n}", 0.0, n, 64, decode_len=16)
                for n in (512, 1024, 2048, 4096)]
        t0 = time.perf_counter()
        rep = eng.serve(reqs, verify=True)
        torch.cuda.synchronize()
        return eng, reqs, rep, time.perf_counter() - t0

    # this path: every launch counter from 0 just before, read just after
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, rep, serve_s = serve()
    launches = read_counters()
    by_len = dict(sorted(wkv6.launches_by_len.items()))
    print(json.dumps({"rwkv_wkv6_launches_by_S": by_len}))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if profile:
        print(json.dumps({"rwkv_profile": profile_serve(serve)}))

    ex = eng.executor
    plans = {r.request_id: sorted({p.strategy for p in
                                   ex._live[r.request_id]["plans"].values()})
             for r in reqs}
    out, bad = {}, []
    for r in reqs:
        o = ex.outputs(r.request_id)
        logits = o["first_logits"].float()
        errs = ex.verify_errs.get(r.request_id, {})
        if (tuple(logits.shape) != (1, cfg.vocab_size)
                or not bool(torch.isfinite(logits).all())
                or len(o["tokens"]) != r.decode_len
                or set(errs) != {"wkv", "shift_tm", "shift_cm"}):
            bad.append(r.request_id)
        out[r.request_id] = dict(strategies=plans[r.request_id], verify_max_err=errs,
                                 n_tokens=len(o["tokens"]), tokens=o["tokens"][:6])
    result = dict(
        card=card, arch=cfg.name, layers=cfg.num_layers, d_model=cfg.d_model,
        params=model.num_params(params), init_s=init_s, serve_s=serve_s,
        peak_mem_gb=peak_gb, stats=rep.stats, compute_busy=rep.compute_busy,
        io_busy=rep.io_busy, decode_busy=rep.decode_busy,
        overlap_decode_restore=rep.overlap_decode_restore, ttfts=rep.ttfts,
        restore_secs=rep.restore_secs, row_invariance=rows, requests=out,
        launches=launches, wkv6_launches_by_S=by_len)
    print(json.dumps({"rwkv_serve": result}, default=str))
    if bad:
        raise AssertionError(f"bad outputs (logits shape/finite, token count, "
                             f"verified fields): {bad}")
    missing = [n for n in RWKV_KERNELS if launches[n] == 0]
    stray = [n for n, c in launches.items() if c and n not in RWKV_KERNELS]
    if missing or stray:
        raise AssertionError(f"RWKV serve: kernels not launched {missing}, "
                             f"launched off its path {stray}")
    if any(s != ["layer"] for s in plans.values()):
        raise AssertionError(f"expected layer-wise plans only: {plans}")
    return result


# (arch, layers run or None for all, int8 chunk store, prefixes) of the
# dense phase: the two configs past one card's memory at full depth run at
# full width, cut to 8 layers
DENSE_SERVES = (
    ("llama3.1-8b", None, True, (512, 1536, 2560, 4096)),
    ("phi4-mini-3.8b", None, False, (512, 1536, 2560, 4096)),
    ("qwen1.5-0.5b", None, False, (512, 1536, 2560, 4096)),
    ("qwen1.5-110b", 8, False, (512, 1024, 1536, 2048)),
    ("mistral-large-123b", 8, False, (512, 1024, 1536, 2048)),
)
DENSE_KERNELS = ("flash_prefill", "flash_decode")
STORE_KERNELS = ("kv_restore", "kv_quantize", "kv_dequantize")


def verified_fields(cfg) -> set:
    """The cache fields a verified request of ``cfg`` must report: the MLA
    latent or the K/V of its attention layers, and their positions."""
    return {"ckv", "kpos"} if cfg.mla is not None else {"k", "v", "kpos"}


def dense_phase(dev, card: str) -> dict:
    """One real serve of each dense config the port added: bf16, random
    weights from seed 0, verify on, the smoke's serve shape (4 requests at
    t = 0, 64 new and 16 output tokens, chunk 256, 2 stages, l_delta 1024,
    max_batch 2); llama3.1-8b from an int8 chunk store (so the three store
    kernels run on its path), the others with no store.  Each serve is
    served again with no quantized store (llama: twice from an unquantized
    store) and its greedy tokens must not move.  One ``{"dense_serve": ...}``
    line each."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ChunkStore, RealServingEngine, Request

    results = {}
    for arch, layers, int8, prefixes in DENSE_SERVES:
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
        t0 = time.perf_counter()
        model = Model(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                      device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0

        def serve(quant):
            store = (None if quant is None else
                     ChunkStore(chunk_size=16, quant=quant, default_tier="host", device=dev))
            eng = RealServingEngine(model, params, system="cacheflow", stages=2,
                                    chunk_size=256, l_delta=1024, max_batch=2,
                                    kvstore=store, datapath="fused", device=dev, seed=0)
            reqs = [Request(f"r{n}", 0.0, n, 64, decode_len=16) for n in prefixes]
            t0 = time.perf_counter()
            rep = eng.serve(reqs, verify=True)
            torch.cuda.synchronize()
            tokens = {r.request_id: eng.executor.outputs(r.request_id)["tokens"] for r in reqs}
            return eng, reqs, rep, tokens, time.perf_counter() - t0

        # this path: every launch counter from 0 just before, read just after
        zero_counters()
        torch.cuda.reset_peak_memory_stats()
        eng, reqs, rep, tokens, serve_s = serve("int8" if int8 else None)
        launches = read_counters()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ex = eng.executor
        errs = {r.request_id: ex.verify_errs.get(r.request_id, {}) for r in reqs}
        bad = [r.request_id for r in reqs
               if len(ex.outputs(r.request_id)["tokens"]) != r.decode_len
               or not bool(torch.isfinite(ex.outputs(r.request_id)["first_logits"]).all())
               or not verified_fields(cfg) <= set(errs[r.request_id])]
        del eng
        if int8:
            tokens_a = serve("none")[3]
            tokens_b = serve("none")[3]
        else:
            tokens_a, tokens_b = tokens, serve(None)[3]
        diff = first_difference(tokens_a, tokens_b)
        out = dict(
            card=card, arch=arch, layers=cfg.num_layers, config_layers=full.num_layers,
            cut=None if layers is None else f"{layers} of {full.num_layers} layers, full width",
            d_model=cfg.d_model, hq=cfg.num_heads, hkv=cfg.num_kv_heads, dh=cfg.head_dim,
            params=model.num_params(params), init_s=init_s, serve_s=serve_s,
            ttft_p50_s=rep.stats["p50"], tpot_mean_s=rep.stats["tpot_mean"],
            serve_wall_s=rep.stats["serve_wall"], completed=rep.stats["completed"],
            peak_mem_gb=peak_gb, store="int8" if int8 else None,
            verify_max_err=max(x for e in errs.values() for x in e.values()),
            verified=sorted(r for r, e in errs.items() if e),
            strategies={r.request_id: ex._live[r.request_id]["plans"][0].strategy
                        for r in reqs},
            tokens_stable=diff is None, tokens_first_difference=diff,
            launches={k: v for k, v in launches.items() if v})
        print(json.dumps({"dense_serve": out}))
        results[arch] = dict(out, launches=launches)
        del model, params, ex
        gc.collect()
        torch.cuda.empty_cache()
        if rep.stats["completed"] != 4 or bad:
            raise AssertionError(f"{arch}: {rep.stats['completed']} of 4 completed, "
                                 f"bad outputs or unverified requests {bad}")
        missing = [n for n in DENSE_KERNELS + (STORE_KERNELS if int8 else ())
                   if launches[n] == 0]
        if missing:
            raise AssertionError(f"{arch}: kernels not launched during its serve: {missing}")
        if diff is not None:
            raise AssertionError(f"{arch}: greedy tokens moved between two unquantized "
                                 f"serves at {diff}")
    return results


# (arch, layers run or None for all, int8 chunk store, prefixes) of the
# family phase: deepseek-v2-236b's 471 GB of bf16 weights at full depth
# cannot fit one card, so it runs at full width cut to 4 of its 60 layers
# (the dense first layer and 3 MoE layers)
# Append-buffer decode on full-width qwen3-8b: a PREFIX-token prefix built by
# prefill_chunk in CHUNK-token chunks, then STEPS steps of decode_step_append
# into a tail of WINDOW slots, against decode_step writing the same tokens
# into the prefix cache grown by WINDOW slots.  Both attend through
# flash_decode over the same 2064 slots in the same order with the same kpos,
# so the logits should agree to the bit; the bound is one bf16 step of the
# largest logit (2^-8 of it).
APPEND = dict(arch="qwen3-8b", B=2, PREFIX=2048, WINDOW=16, STEPS=16, CHUNK=256)
APPEND_TOL = 2.0 ** -8


def append_decode_phase(dev, card: str) -> dict:
    """``Model.decode_step_append`` at full width (APPEND), bf16 random weights
    from seed 0: every step's logits against ``decode_step``'s on the same
    fed tokens (APPEND_TOL of the largest logit) and the greedy tokens
    equal; flash_decode launched once a layer a step (counters from 0
    just before the appended steps, read just after) and nothing else; ms a
    step (host clock ended by a synchronise) beside decode_step's; the prefix
    cache untouched.  flash_decode at the append shape (one layer's [cache ||
    tail]) is timed for the kernels line.  One ``{"append_decode": ...}``
    line."""
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    from repro_torch.models import Model
    from repro_torch.models.kvcache import grow_cache

    cfg = get_config(APPEND["arch"])
    bsz, pre, wdw, n, ch = (APPEND[x] for x in ("B", "PREFIX", "WINDOW", "STEPS", "CHUNK"))
    model = Model(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (bsz, pre),
                           generator=torch.Generator().manual_seed(4))

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with torch.no_grad():
        cache = model.init_cache(bsz, pre)
        for c0 in range(0, pre, ch):
            last, cache = model.prefill_chunk(params, tokens[:, c0:c0 + ch], cache, c0)
        before = {f: t.clone() for f, t in cache.items()}
        grown = grow_cache(cfg, {f: t.clone() for f, t in cache.items()}, pre + wdw)
        tail = model.init_tail(bsz, wdw)
        fed, app_logits, app_ms = [last.argmax(-1)], [], []
        zero_counters()
        for i in range(n):
            (lg, tail), ms = timed(lambda: model.decode_step_append(params, fed[-1], cache,
                                                                    tail, i, pre + i))
            app_logits.append(lg.float())
            app_ms.append(ms)
            fed.append(lg.argmax(-1))
        launches = read_counters()
        dec_ms, err, biggest, equal = [], 0.0, 0.0, []
        for i in range(n):
            (lg, grown), ms = timed(lambda: model.decode_step(params, fed[i], grown, pre + i))
            dec_ms.append(ms)
            err = max(err, float((lg.float() - app_logits[i]).abs().max()))
            biggest = max(biggest, float(lg.float().abs().max()))
            equal.append(bool(torch.equal(lg.argmax(-1), fed[i + 1])))
        untouched = all(torch.equal(cache[f], before[f]) for f in before)
        # flash_decode at the append shape: layer 0's [cache || tail] after the steps
        q = torch.randn(bsz, cfg.num_heads, cfg.head_dim, generator=torch.Generator(
            device=dev).manual_seed(5), device=dev).to(torch.bfloat16)
        k = torch.cat([cache["k"][0], tail["k"][0]], dim=1)
        v = torch.cat([cache["v"][0], tail["v"][0]], dim=1)
        kp = torch.cat([cache["kpos"][0], tail["kpos"][0]])
        scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB
        kw = dict(scale=cfg.head_dim ** -0.5, window=0)
        q_pos = pre + n - 1
        kerr = float((flash_decode(q, k, v, kp, q_pos, **kw).float()
                      - flash_decode_plain(q, k, v, kp, q_pos, **kw).float()).abs().max())
        kt = decode_timing(q, k, v, kp, q_pos, 0, scratch.zero_,
                           torch.cuda.get_device_properties(dev).multi_processor_count)
    tol = APPEND_TOL * biggest
    out = dict(card=card, arch=cfg.name, layers=cfg.num_layers, B=bsz, prefix=pre,
               window=wdw, steps=n, prefill_chunk=ch, max_abs_logit_diff=err,
               max_abs_logit=biggest, tol=tol, greedy_equal=all(equal),
               greedy_equal_by_step=equal, prefix_cache_untouched=untouched,
               append_ms_median=statistics.median(app_ms[2:]),
               decode_step_ms_median=statistics.median(dec_ms[2:]),
               append_ms=app_ms, decode_step_ms=dec_ms,
               launches={k_: v_ for k_, v_ in launches.items() if v_},
               flash_decode_append=dict(max_abs_err=kerr, **kt, shape=(
                   f"q ({bsz},{cfg.num_heads},{cfg.head_dim}) bf16, k/v ({bsz},{pre + wdw},"
                   f"{cfg.num_kv_heads},{cfg.head_dim}) bf16: [cache || tail] at step {n}")))
    print(json.dumps({"append_decode": out}))
    del model, params, cache, grown, tail
    gc.collect()
    torch.cuda.empty_cache()
    want = {"flash_decode": cfg.num_layers * n}
    got = {k_: v_ for k_, v_ in launches.items() if v_}
    if not (err <= tol and all(equal) and untouched and got == want
            and kerr <= DECODE_TOL):
        raise AssertionError(f"append-buffer decode on the card: {out}; launches {got}, "
                             f"want {want}")
    return out


FAMILY_SERVES = (
    ("qwen3-30b-a3b", None, True, (512, 1536, 2560, 4096)),
    ("deepseek-moe-16b", None, False, (512, 1536, 2560, 4096)),
    ("deepseek-v2-236b", 4, True, (512, 1024, 1536, 2048)),
    ("pixtral-12b", None, False, (512, 1536, 2560, 4096)),
    ("musicgen-large", None, False, (512, 1536, 2560, 4096)),
)
# record_function ranges of a traced MoE serve: the whole MoE layer's routed
# part (router, dispatch, experts, combine) and the expert products in it
MOE_RANGES = ("moe_group", "moe_experts")


@contextlib.contextmanager
def moe_ranges():
    """``moe.moe_group`` and ``moe._expert_ffn`` run inside record_function
    ranges named as MOE_RANGES."""
    from torch.profiler import record_function

    from repro_torch.models import moe

    group, experts = moe.moe_group, moe._expert_ffn

    def moe_group(*args, **kw):
        with record_function(MOE_RANGES[0]):
            return group(*args, **kw)

    def expert_ffn(*args, **kw):
        with record_function(MOE_RANGES[1]):
            return experts(*args, **kw)
    moe.moe_group, moe._expert_ffn = moe_group, expert_ffn
    try:
        yield
    finally:
        moe.moe_group, moe._expert_ffn = group, experts


def moe_row_invariance(model, params, dev, m: int = 512, c: int = 256) -> dict:
    """As ``row_invariance`` for RWKV: on the same random bf16 input, max
    |op(a)[:c] - op(a[:c])| for the first MoE layer's router product (f32),
    its expert products over an (E, m, D) buffer, and the whole layer
    (``apply_moe``).  Nonzero means another row count took another
    summation order; ``remember``'s chunks are what recompute repeats."""
    import torch
    from repro_torch.models import moe

    cfg = model.cfg
    p = next(layer["moe"] for layer in params["layers"] if "moe" in layer)
    g = torch.Generator(device=dev).manual_seed(2)
    a = torch.randn(1, m, cfg.d_model, generator=g, device=dev).to(torch.bfloat16)
    buf = torch.randn(cfg.moe.num_experts, m, cfg.d_model, generator=g,
                      device=dev).to(torch.bfloat16)
    # (input, its row axis, op)
    ops = {"router f32": (a[0], 0, lambda x: x.float() @ p["router"]),
           "expert products (E, M, D)": (buf, 1, lambda x: moe._expert_ffn(
               p, x, cfg.activation)),
           "apply_moe": (a, 1, lambda x: moe.apply_moe(p, x, cfg)[0])}
    out = {}
    for name, (x, axis, fn) in ops.items():
        full = fn(x).narrow(axis, 0, c)
        out[name] = float((full.float() - fn(x.narrow(axis, 0, c)).float()).abs().max())
    return out


# Model(moe_groups=...) and the einsum dispatch on qwen3-30b-a3b (bf16), at
# the first MoE layer on one random 512-row input and on a 512-token
# prefill_chunk.  Groups of 128 rows against all 512 change only the row
# counts of the router's f32 product and of the expert products (the routing
# of a row does not depend on its group): the router logits within
# MOE_ROUTER_TOL of their largest value (PR 24 measured 1-2e-6 between 512
# and 256 rows), the layer's output within MOE_LAYER_TOL of its largest
# value (two bf16 steps: the expert products' rounding and the combine's);
# the model's last logits after 48 layers within MOE_LOGIT_TOL (a bf16
# residual stream carries such a difference through every layer).  The
# einsum dispatch contracts one-hot tensors (the combine's sum over top-k in
# f32 inside the product) where the scatter form rounds each weighted product
# to bf16 before the sum, so the two differ by those roundings: each is held
# to the same group run in f32 (weights and input upcast exactly, so the
# routing is the same), and the einsum form's error may not exceed the
# scatter form's, or one bf16 step (2^-8) of the largest output; aux within
# 1e-6 relative.
MOE_GROUPS = 4
MOE_ROUTER_TOL = 1e-5
MOE_LAYER_TOL = 2.0 ** -7
MOE_LOGIT_TOL = 5e-2


def moe_option_checks(model, params, dev, m: int = 512) -> dict:
    """``moe_groups`` MOE_GROUPS against 1, and ``DISPATCH = "einsum"``
    against ``"scatter"`` on the capacity path (``moe_group`` with
    ``dropless=False`` at the config's capacity factor), as the constants
    above say."""
    import torch
    from repro_torch.models import moe

    def rel(a, b):
        return float((a.float() - b.float()).abs().max()) / float(b.float().abs().max())

    cfg = model.cfg
    p = next(layer["moe"] for layer in params["layers"] if "moe" in layer)
    a = torch.randn(1, m, cfg.d_model, generator=torch.Generator(device=dev).manual_seed(7),
                    device=dev).to(torch.bfloat16)
    sg = m // MOE_GROUPS
    with torch.no_grad():
        router = a[0].float() @ p["router"]
        router_g = torch.cat([a[0, i * sg:(i + 1) * sg].float() @ p["router"]
                              for i in range(MOE_GROUPS)])
        y1, _ = moe.apply_moe(p, a, cfg, num_groups=1)
        yg, _ = moe.apply_moe(p, a, cfg, num_groups=MOE_GROUPS)
        toks = torch.randint(0, cfg.vocab_size, (1, m), generator=torch.Generator().manual_seed(8))
        last = {}
        for groups in (1, MOE_GROUPS):
            model.moe_groups = groups
            last[groups], _ = model.prefill_chunk(params, toks, model.init_cache(1, m), 0)
        model.moe_groups = 0
        ys = {}
        try:
            for dispatch in ("scatter", "einsum"):
                moe.DISPATCH = dispatch
                ys[dispatch] = moe.moe_group(p, a[0], cfg.moe, cfg.activation, dropless=False)
        finally:
            moe.DISPATCH = "scatter"
        p32 = {n: w.float() for n, w in p.items() if n != "shared"}
        y32, _ = moe.moe_group(p32, a[0].float(), cfg.moe, cfg.activation, dropless=False)
        del p32
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    out = dict(groups=MOE_GROUPS, rows=m,
               router_rel_diff=rel(router_g, router), router_tol=MOE_ROUTER_TOL,
               router_top_k_equal=bool(torch.equal(torch.topk(router_g, k).indices.sort().values,
                                                   torch.topk(router, k).indices.sort().values)),
               layer_rel_diff=rel(yg, y1), layer_tol=MOE_LAYER_TOL,
               prefill_logit_rel_diff=rel(last[MOE_GROUPS], last[1]), logit_tol=MOE_LOGIT_TOL,
               prefill_logits_equal=bool(torch.equal(last[MOE_GROUPS], last[1])),
               prefill_greedy_equal=bool(torch.equal(last[MOE_GROUPS].argmax(-1),
                                                     last[1].argmax(-1))),
               capacity=max(1, int(m * k / e * cfg.moe.capacity_factor)),
               einsum_rel_diff=rel(ys["einsum"][0], ys["scatter"][0]),
               einsum_rel_err_f32=rel(ys["einsum"][0], y32),
               scatter_rel_err_f32=rel(ys["scatter"][0], y32),
               einsum_aux=float(ys["einsum"][1]), scatter_aux=float(ys["scatter"][1]))
    ok = (out["router_rel_diff"] <= MOE_ROUTER_TOL and out["layer_rel_diff"] <= MOE_LAYER_TOL
          and out["prefill_logit_rel_diff"] <= MOE_LOGIT_TOL
          and out["einsum_rel_err_f32"] <= max(out["scatter_rel_err_f32"], 2.0 ** -8)
          and abs(out["einsum_aux"] - out["scatter_aux"]) <= 1e-6 * abs(out["scatter_aux"]))
    print(json.dumps({"moe_options": out}))
    if not ok:
        raise AssertionError(f"moe_groups / einsum dispatch on the card: {out}")
    return out


def family_phase(dev, card: str, profile: bool = False) -> dict:
    """One real serve of each MoE, MLA and embedding-input config
    (``FAMILY_SERVES``): bf16, random weights from seed 0, verify on, the
    smoke's serve shape (4 requests at t = 0, 64 new and 16 output tokens,
    chunk 256, 2 stages, l_delta 1024, max_batch 2); qwen3-30b-a3b and
    deepseek-v2-236b from an int8 chunk store (the three store kernels run
    on k/v rows of 512 channels and on the 576-channel latent row), the
    others with no store.  Each must complete 4 of 4 with every request
    verified on its cache's fields, launch its path's kernels (the MLA
    serve's absorbed attention is plain products, as in the reference: only
    the store kernels), and hold its greedy tokens across two unquantized
    serves, and their first-token logits by torch.equal.
    The MoE configs print their ``moe_row_invariance``; qwen3-30b-a3b its
    ``moe_option_checks`` (moe_groups, the einsum dispatch).  With ``profile``,
    one more qwen3-30b-a3b serve is traced: device time by kernel, and in
    the MoE ranges.  One ``{"family_serve": ...}`` line each."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ChunkStore, RealServingEngine, Request

    results = {}
    for arch, layers, int8, prefixes in FAMILY_SERVES:
        full = get_config(arch)
        cfg = full if layers is None else dataclasses.replace(full, num_layers=layers)
        t0 = time.perf_counter()
        model = Model(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                      device=dev)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        rows = moe_row_invariance(model, params, dev) if cfg.moe is not None else None
        options = moe_option_checks(model, params, dev) if arch == "qwen3-30b-a3b" else None

        def serve(quant):
            store = (None if quant is None else
                     ChunkStore(chunk_size=16, quant=quant, default_tier="host", device=dev))
            eng = RealServingEngine(model, params, system="cacheflow", stages=2,
                                    chunk_size=256, l_delta=1024, max_batch=2,
                                    kvstore=store, datapath="fused", device=dev, seed=0)
            reqs = [Request(f"r{n}", 0.0, n, 64, decode_len=16) for n in prefixes]
            t0 = time.perf_counter()
            rep = eng.serve(reqs, verify=True)
            torch.cuda.synchronize()
            outs = {r.request_id: eng.executor.outputs(r.request_id) for r in reqs}
            return (eng, reqs, rep, {r: o["tokens"] for r, o in outs.items()},
                    {r: o["first_logits"].clone() for r, o in outs.items()},
                    time.perf_counter() - t0)

        # this path: every launch counter from 0 just before, read just after
        zero_counters()
        torch.cuda.reset_peak_memory_stats()
        eng, reqs, rep, tokens, logits, serve_s = serve("int8" if int8 else None)
        launches = read_counters()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        ex = eng.executor
        errs = {r.request_id: ex.verify_errs.get(r.request_id, {}) for r in reqs}
        bad = [r.request_id for r in reqs
               if len(ex.outputs(r.request_id)["tokens"]) != r.decode_len
               or tuple(logits[r.request_id].shape) != (1, cfg.vocab_size)
               or not bool(torch.isfinite(logits[r.request_id]).all())
               or set(errs[r.request_id]) != verified_fields(cfg)]
        strategies = {r.request_id: ex._live[r.request_id]["plans"][0].strategy
                      for r in reqs}
        del eng, ex
        if int8:
            _, _, _, tokens_a, logits_a, _ = serve("none")
            _, _, _, tokens_b, logits_b, _ = serve("none")
        else:
            tokens_a, logits_a = tokens, logits
            _, _, _, tokens_b, logits_b, _ = serve(None)
        diff = first_difference(tokens_a, tokens_b)
        logits_stable = all(torch.equal(logits_a[r], logits_b[r]) for r in logits_a)
        prof = None
        if profile and arch == "qwen3-30b-a3b":
            with moe_ranges():
                prof = profile_serve(lambda: serve("int8"), ranges=MOE_RANGES)
            print(json.dumps({"moe_profile": prof}))
        out = dict(
            card=card, arch=arch, layers=cfg.num_layers, config_layers=full.num_layers,
            cut=None if layers is None else f"{layers} of {full.num_layers} layers, "
                                            f"full width",
            d_model=cfg.d_model, hq=cfg.num_heads, hkv=cfg.num_kv_heads, dh=cfg.head_dim,
            mla=cfg.mla is not None,
            experts=None if cfg.moe is None else f"{cfg.moe.num_experts} top-"
                                                 f"{cfg.moe.top_k}",
            input_mode=cfg.input_mode, params=model.num_params(params), init_s=init_s,
            serve_s=serve_s, ttft_p50_s=rep.stats["p50"], tpot_mean_s=rep.stats["tpot_mean"],
            serve_wall_s=rep.stats["serve_wall"], completed=rep.stats["completed"],
            peak_mem_gb=peak_gb, store="int8" if int8 else None,
            verify_max_err=max(x for e in errs.values() for x in e.values()),
            verified=sorted(r for r, e in errs.items() if e), strategies=strategies,
            tokens_stable=diff is None, tokens_first_difference=diff,
            first_logits_stable=logits_stable, tokens={r: t[:6] for r, t in tokens.items()},
            row_invariance_512_vs_256=rows, moe_options=options,
            launches={k: v for k, v in launches.items() if v})
        print(json.dumps({"family_serve": out}))
        results[arch] = dict(out, launches=launches, profile=prof)
        del model, params
        gc.collect()
        torch.cuda.empty_cache()
        if rep.stats["completed"] != 4 or bad:
            raise AssertionError(f"{arch}: {rep.stats['completed']} of 4 completed, "
                                 f"bad outputs or unverified requests {bad}")
        path = (() if cfg.mla is not None else DENSE_KERNELS) + (STORE_KERNELS if int8 else ())
        missing = [n for n in path if launches[n] == 0]
        stray = [n for n in DENSE_KERNELS if cfg.mla is not None and launches[n]]
        if missing or stray:
            raise AssertionError(f"{arch}: kernels not launched during its serve {missing}, "
                                 f"attention kernels on the MLA path {stray}")
        if not logits_stable or diff is not None:
            raise AssertionError(f"{arch}: outputs moved between two unquantized serves: "
                                 f"tokens at {diff}, first logits equal {logits_stable}")
    return results


def sanitizer_cow_check(dev, card: str) -> dict:
    """The sanitizer's copy-on-write check on the card: a BlockPool of CUDA
    tensors, one block written, then ``pool.copy`` through the sanitizer's
    wrapper (snapshot by clone, compare by torch.equal on the device);
    ``cow_checks`` must read 1, the copy must equal its parent, and the
    wrapper must unwrap at run end."""
    import torch
    from repro_torch.analysis.sanitizer import EngineSanitizer
    from repro_torch.models.kvcache import BlockPool

    class Store:
        def __init__(self, pool):
            self.pool = pool

        def audit(self):
            self.pool.audit()

    class Core:
        max_active = 0

        def __init__(self, kvstore):
            self.kvstore = kvstore

    g = torch.Generator(device=dev).manual_seed(4)
    pool = BlockPool(16)
    bid = pool.alloc({"k": torch.randn(36, 1, 16, 8, 128, generator=g, device=dev).to(torch.bfloat16),
                      "v": torch.randn(36, 1, 16, 8, 128, generator=g, device=dev).to(torch.bfloat16),
                      "kpos": torch.arange(16, dtype=torch.int32, device=dev).expand(36, 16)})
    original = pool.copy
    san = EngineSanitizer(Core(Store(pool)))
    san.bind(ops_log=[], busy_comp={0: 0.0}, busy_io={0: 0.0})
    new = pool.copy(bid)
    equal = all(torch.equal(pool.read(bid)[f], pool.read(new)[f]) for f in ("k", "v", "kpos"))
    san.on_run_end(active=set(), pending=[], suspended=set())
    out = dict(card=card, device=str(pool.read(new)["k"].device), cow_checks=san.counters.cow_checks,
               copy_equal=equal, unwrapped=pool.copy == original)
    print(json.dumps({"cow_check": out}))
    if not (out["cow_checks"] == 1 and equal and out["unwrapped"]
            and out["device"].startswith("cuda")):
        raise AssertionError(f"sanitizer CoW check on the card: {out}")
    return out


# ---------------------------------------------------------------------------
# The train phase: training through the port on the card
# ---------------------------------------------------------------------------

# rglru_scan's backward (the same kernels over reversed time) against autograd
# of the plain loop on the card: the same products in the same order, and the
# kernels repeat the plain version's arithmetic, so equal bit for bit.
# Against the same Function on the CPU: the CPU's expf and the card's differ in
# the last bit, and the difference rides the chain of up to 256 steps, so
# max |card - CPU| <= RGLRU_GRAD_CPU_TOL * max |CPU| per gradient (measured:
# PERF.md).
RGLRU_GRAD_CPU_TOL = 1e-4
# One train step's loss, grad_norm and gradients, card against CPU, both f32
# (TF32 off): cuBLAS and the CPU's BLAS sum in other orders.  |Δloss| <=
# STEP_LOSS_TOL * loss, |Δgrad_norm| <= STEP_NORM_TOL * grad_norm, and every
# leaf's max |Δ| <= STEP_LEAF_TOL * its largest CPU gradient.
STEP_LOSS_TOL = 1e-4
STEP_NORM_TOL = 1e-3
STEP_LEAF_TOL = 1e-2
# A run resumed from its manifest on the card against an uninterrupted run:
# the losses after the resume within RESUME_TOL * loss (the card's reductions
# need not repeat bit for bit from one run to the next).
RESUME_TOL = 1e-3
TRAIN_ARCH = "qwen1.5-0.5b"
TRAIN_CLI_STEPS = 100        # full width: B 8, S 128
# The full-width run's peak learning rate: AdamWConfig's default.  The CLI's
# default, 3e-3 (the reference's for its reduced models), made the
# full-width loss rise over 100 steps (PERF.md).
TRAIN_CLI_LR = 3e-4
HYBRID_TRAIN = dict(B=2, S=64, layers=3)   # recurrentgemma-2b cut to (rec, rec, attn)
RWKV_TRAIN = dict(B=2, S=64, layers=2)     # rwkv6-7b at full width cut to 2 layers
RWKV_CLI_STEPS = 25                        # the reduced rwkv6-7b through launch.train


def rglru_backward_check(dev, card: str) -> dict:
    """(a) rglru_scan's gradient Function at W 2560, B 2, S = 1, 64, 256,
    random gh and gl: on the card against autograd of rglru_scan_plain on
    the card (torch.equal) and against the same Function on the CPU
    (RGLRU_GRAD_CPU_TOL); each case counts the forward and reverse launches.
    Then the reversed call alone at the hybrid's train shape (B 2, S 64),
    timed beside the plain version, for the kernels line."""
    import torch
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_grad, rglru_scan_plain

    def grads(fn, ins, gh, gl):
        ts = [t.clone().requires_grad_(True) for t in ins]
        h, hl = fn(*ts)
        return torch.autograd.grad((h, hl), ts, (gh, gl))

    g = torch.Generator().manual_seed(25)
    cases = []
    for s in (1, 64, 256):
        cpu = [-0.5 * torch.rand(2, s, 2560, generator=g), torch.randn(2, s, 2560, generator=g),
               torch.randn(2, 2560, generator=g)]
        gh, gl = torch.randn(2, s, 2560, generator=g), torch.randn(2, 2560, generator=g)
        ins = [t.to(dev) for t in cpu]
        zero_counters()
        got = grads(rglru_scan_grad, ins, gh.to(dev), gl.to(dev))
        torch.cuda.synchronize()
        fwd = rglru_scan.launches - rglru_scan.reverse_launches
        rev = rglru_scan.reverse_launches
        plain = grads(rglru_scan_plain, ins, gh.to(dev), gl.to(dev))
        host = grads(rglru_scan_grad, cpu, gh, gl)
        names = ("log_a", "b", "h0")
        case = dict(B=2, S=s, W=2560, forward_launches=fwd, reverse_launches=rev,
                    bit_exact_vs_plain={n: torch.equal(a, b) for n, a, b in zip(names, got, plain)},
                    max_abs_err_vs_plain=max(float((a - b).abs().max()) for a, b in zip(got, plain)),
                    rel_err_vs_cpu={n: float((a.cpu() - b).abs().max() / b.abs().max())
                                    for n, a, b in zip(names, got, host)})
        cases.append(case)
        ok = (all(case["bit_exact_vs_plain"].values()) and fwd == 1 and rev == 1
              and max(case["rel_err_vs_cpu"].values()) <= RGLRU_GRAD_CPU_TOL)
        if not ok:
            raise AssertionError(f"rglru_scan backward on the card: {case}")
    # the reversed call the backward makes at the hybrid's train shape
    bsz, s = HYBRID_TRAIN["B"], HYBRID_TRAIN["S"]
    la = (-0.5 * torch.rand(bsz, s, 2560, generator=g)).to(dev)
    la_rev = torch.cat([torch.zeros_like(la[:, :1]), la.flip(1)[:, :-1]], 1).contiguous()
    b_rev = torch.randn(bsz, s, 2560, generator=g).to(dev)
    h0 = torch.zeros(bsz, 2560, device=dev)
    h, hl = rglru_scan(la_rev, b_rev, h0, reverse=True)
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB

    def flush():
        scratch.zero_()
    bms, by = bound(nbytes(la_rev, b_rev, h0, h, hl), 3 * la_rev.numel(), F32_FLOP_PER_S)

    def call():
        return rglru_scan(la_rev, b_rev, h0, reverse=True)
    out = dict(card=card, cases=cases, tol_vs_cpu=RGLRU_GRAD_CPU_TOL, tol_vs_plain=0.0,
               max_abs_err=max(c["max_abs_err_vs_plain"] for c in cases),
               ms=time_ms(call, flush=flush),
               kernels_us=kernels_us(call, flush, match="rglru_scan"),
               kernels_us_warm=kernels_us(call, match="rglru_scan"),
               plain_ms=time_ms(lambda: rglru_scan_plain(la_rev, b_rev, h0), flush=flush,
                                iters=7),
               bound_ms=bms, bound_by=by, library_ms=None, plan=rglru_plan_of(la_rev, b_rev, h0),
               shape=f"reversed log_a, b ({bsz},{s},2560) f32, h0 ({bsz},2560) f32")
    print(json.dumps({"train_rglru_backward": out}))
    return out


def grad_report(grads) -> dict:
    """Every gradient leaf not None, finite and not all zero."""
    import torch
    from repro_torch.models.model import _leaves
    leaves = list(_leaves(grads))
    bad = [i for i, g in enumerate(leaves)
           if g is None or not bool(torch.isfinite(g).all()) or float(g.abs().max()) == 0]
    return dict(leaves=len(leaves), bad_leaves=bad)


def card_vs_cpu_step(cfg, dev, card: str, bsz: int, s: int, must_launch=()) -> dict:
    """One training step's loss, grad_norm and gradients of ``cfg`` (f32,
    remat "dots"), weights from Model.init on the CPU copied to the card,
    the batch from ``batch_at`` on the CPU: card against CPU.  The card's
    step runs between zero_counters and read_counters, and each counter in
    ``must_launch`` must read more than 0."""
    import torch
    from repro_torch.models import build_model
    from repro_torch.models.model import _leaves
    from repro_torch.training import DataConfig, batch_at, lm_loss, value_and_grad
    from repro_torch.training.optimizer import global_norm
    from repro_torch.training.train_step import tree_like

    host_m = build_model(cfg, device="cpu", remat_policy="dots")
    host_p = host_m.init(torch.Generator().manual_seed(0))
    card_m = build_model(cfg, device=dev, remat_policy="dots")
    card_p = tree_like(host_p, [t.to(dev) for t in _leaves(host_p)])
    batch = batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=bsz), 0)
    t0 = time.perf_counter()
    (host_loss, _), host_g = value_and_grad(lm_loss, host_m, host_p, batch)
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    (card_loss, _), card_g = value_and_grad(lm_loss, card_m, card_p,
                                            {k: v.to(dev) for k, v in batch.items()})
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = read_counters()
    hn, cn = float(global_norm(host_g)), float(global_norm(card_g))
    leaf_err = max(float((c.cpu() - h).abs().max()) / max(float(h.abs().max()), 1e-30)
                   for c, h in zip(_leaves(card_g), _leaves(host_g)))
    out = dict(card=card, arch=cfg.name, layers=cfg.num_layers, B=bsz, S=s,
               params=sum(t.numel() for t in _leaves(host_p)),
               loss_card=float(card_loss), loss_cpu=float(host_loss),
               grad_norm_card=cn, grad_norm_cpu=hn, worst_leaf_rel_err=leaf_err,
               tol=dict(loss=STEP_LOSS_TOL, grad_norm=STEP_NORM_TOL, leaf=STEP_LEAF_TOL),
               grads=grad_report(card_g), card_s=card_s, cpu_s=host_s,
               launches={k: v for k, v in launches.items() if v})
    ok = (abs(out["loss_card"] - out["loss_cpu"]) <= STEP_LOSS_TOL * abs(out["loss_cpu"])
          and abs(cn - hn) <= STEP_NORM_TOL * hn and leaf_err <= STEP_LEAF_TOL
          and not out["grads"]["bad_leaves"])
    ok = ok and all(launches[n] > 0 for n in must_launch)
    if not ok:
        raise AssertionError(f"train step on the card against the CPU: {out}")
    return out


def train_cli_check(dev, card: str) -> dict:
    """(d) ``launch.train.run`` at full width and depth on the card, and the
    reduced model at the reference test's setting."""
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as train_cli
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, DataConfig, batch_at, init_opt_state,
                                      make_train_step)

    bsz, s = 8, 128
    res = train_cli.run(TRAIN_ARCH, reduced=False, steps=TRAIN_CLI_STEPS, global_batch=bsz,
                        seq_len=s, peak_lr=TRAIN_CLI_LR, log_every=20, device=dev)
    losses = [res.losses[i] for i in range(TRAIN_CLI_STEPS)]
    ms = [res.step_seconds[i] * 1e3 for i in range(2, TRAIN_CLI_STEPS)]
    step_ms = statistics.median(ms)
    first10, last10 = statistics.fmean(losses[:10]), statistics.fmean(losses[-10:])
    full = dict(card=card, arch=TRAIN_ARCH, steps=TRAIN_CLI_STEPS, B=bsz, S=s,
                peak_lr=TRAIN_CLI_LR, step_ms_median=step_ms,
                step_ms_first=[res.step_seconds[i] * 1e3 for i in (0, 1)],
                tokens_per_s=bsz * s / (step_ms / 1e3), peak_gb=res.peak_bytes / 1e9,
                loss_first=losses[0], loss_last=losses[-1], mean_first10=first10,
                mean_last10=last10, all_finite=all(math.isfinite(x) for x in losses),
                **step_split(dev, bsz, s))
    print(json.dumps({"train_cli": full}))
    if not (full["all_finite"] and last10 < first10):
        raise AssertionError(f"training {TRAIN_ARCH} through launch.train on the card: {full}")
    cfg = get_config(TRAIN_ARCH).reduced()
    m = build_model(cfg, remat_policy="dots", device=dev)
    params = m.init(torch.Generator(dev).manual_seed(0))
    step = make_train_step(m, AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=50))
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8)
    state, reduced_losses = init_opt_state(params), []
    for i in range(25):
        params, state, metrics = step(params, state, batch_at(dc, i, dev))
        reduced_losses.append(float(metrics["loss"]))
    red = dict(card=card, arch=cfg.name, steps=25, peak_lr=3e-3, warmup=5, S=32, B=8,
               loss_first=reduced_losses[0], loss_last=reduced_losses[-1],
               fall=reduced_losses[0] - reduced_losses[-1])
    print(json.dumps({"train_reduced": red}))
    if not red["fall"] > 0.3:
        raise AssertionError(f"reduced {TRAIN_ARCH} on the card: loss fell {red['fall']}")
    return dict(full=full, reduced=red)


def step_split(dev, bsz: int, s: int) -> dict:
    """Where a full-width step's time goes: the median host-clock ms (ended
    by a synchronise) of a whole train step under remat "none" and "dots",
    and of its gradient alone (forward and backward) under "none"; steps 3
    to 5 of five, the batch of step 0."""
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.training import (AdamWConfig, DataConfig, batch_at, init_opt_state,
                                      lm_loss, make_train_step, value_and_grad)

    cfg = get_config(TRAIN_ARCH)
    batch = batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=s, global_batch=bsz), 0, dev)

    def median_ms(fn):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[2:])

    out = {}
    for policy in ("none", "dots"):
        m = build_model(cfg, remat_policy=policy, device=dev)
        params = m.init(torch.Generator(dev).manual_seed(0))
        state = [init_opt_state(params)]
        step = make_train_step(m, AdamWConfig(peak_lr=TRAIN_CLI_LR))
        out[f"step_ms_remat_{policy}"] = median_ms(lambda: step(params, state[0], batch))
        if policy == "none":
            out["grad_ms_remat_none"] = median_ms(lambda: value_and_grad(lm_loss, m, params, batch))
        del m, params, state, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def train_restart_check(dev, card: str) -> dict:
    """(e) 24 steps of the reduced model, a checkpoint every 4, a host failure
    injected at step 10: the run resumes from step 8's manifest and reaches
    step 23, its losses after the resume within RESUME_TOL of an
    uninterrupted run's."""
    import shutil

    from repro_torch.launch import train as train_cli
    kw = dict(reduced=True, steps=24, global_batch=8, seq_len=32, ckpt_every=4,
              log_every=8, device=dev)
    dirs = [os.path.join(OUT_DIR, f"train_ckpt_{n}") for n in ("cut", "whole")]
    for d in dirs:
        shutil.rmtree(d, ignore_errors=True)
    cut = train_cli.run(TRAIN_ARCH, ckpt_dir=dirs[0], fail_at_step=10, **kw)
    whole = train_cli.run(TRAIN_ARCH, ckpt_dir=dirs[1], **kw)
    after = range(cut.resumed_from[0] + 1, 24) if cut.resumed_from else range(0)
    err = max((abs(cut.losses[i] - whole.losses[i]) / abs(whole.losses[i]) for i in after),
              default=None)
    out = dict(card=card, last_step=cut.last_step, restarts=cut.restarts,
               resumed_from=cut.resumed_from, max_rel_loss_diff_after_resume=err,
               bit_exact=all(cut.losses[i] == whole.losses[i] for i in after), tol=RESUME_TOL)
    print(json.dumps({"train_restart": out}))
    if not (cut.last_step == 23 and cut.restarts == 1 and cut.resumed_from == [8]
            and err is not None and err <= RESUME_TOL):
        raise AssertionError(f"restart on the card: {out}")
    return out


def scratch_bytes(bsz: int, sl: int, h: int, dh: int):
    """Bytes of scratch the backward wrapper allocates for one call (None on
    a tree whose wrapper does not say)."""
    from repro_torch.kernels import rwkv6_scan
    shapes = getattr(rwkv6_scan, "bwd_scratch_shapes", None)
    if shapes is None:
        return None
    return sum(4 * math.prod(x) for x in shapes(bsz, sl, h, dh).values())


def wkv6_backward_check(dev, card: str) -> dict:
    """(f) wkv6's backward kernel at 64 heads of 64, B 2, s0 != 0, at S = 1,
    16, 37 (a ragged last chunk of its 16-step chunks), 40, 64 and 256, at
    the model's decays
    (exp(-exp(N(-6, 1)))), strong decay (N(0, 1)) and decays with every 7th
    entry 0 (N(-1, 1)), with ds_last zero (None) and drawn: each gradient
    against wkv6_backward_plain in f64 and against autograd of wkv6_plain in
    f64 (WKV6_BWD_TOL of its largest value), two calls equal bit for bit,
    one launch a call.  The same at 4 heads of 32 (the reduced config's
    head size, which the reduced training run takes) at S = 1, 37 and 64,
    where the forward kernels are also held to the plain version (the
    chunked kernel within WKV6_F64_TOL of f64, the one-step kernel's y within
    WKV6_Y_TOL and s_last bit for bit).  Then the call at the RWKV train
    shape (B 2, S 64, ds_last None, as in training), timed beside the plain
    version, for the kernels line; and the call at (1, WKV6_BWD_LONG, 64,
    64), timed, its scratch bytes printed, and held to the plain version in
    f64 within WKV6_BWD_LONG_TOL."""
    import torch
    from repro_torch.kernels.rwkv6_scan import (wkv6, wkv6_backward, wkv6_backward_plain,
                                                wkv6_plain)

    bsz = 2
    g = torch.Generator(device=dev).manual_seed(26)
    names = ("r", "k", "v", "w", "u", "s0")

    def draw(sl, decay, h=64, dh=64, b=bsz):
        r, k, v, dy = (torch.randn(b, sl, h, dh, generator=g, device=dev) for _ in range(4))
        mu = {"model": -6.0, "strong": 0.0, "zeros": -1.0}[decay]
        w = torch.exp(-torch.exp(torch.randn(b, sl, h, dh, generator=g, device=dev) + mu))
        if decay == "zeros":
            w.view(-1)[::7] = 0.0
        u = 0.1 * torch.randn(h, dh, generator=g, device=dev)
        s0, ds = (torch.randn(b, h, dh, dh, generator=g, device=dev) for _ in range(2))
        return r, k, v, w, u, s0, dy, ds

    def rels(got, want):
        return {n: float((a.double() - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                for n, a, b in zip(names, got, want)}

    def rel(a, b):
        return float((a.double() - b.double()).abs().max()) / float(b.abs().max())

    cases = []
    for (h, dh), sl in itertools.chain(itertools.product([(64, 64)], (1, 16, 37, 40, 64, 256)),
                                       itertools.product([(4, 32)], (1, 37, 64))):
        for decay in ("model", "strong", "zeros"):
            r, k, v, w, u, s0, dy, drawn = draw(sl, decay, h, dh)
            fwd = {}
            if dh == 32:
                y, last = wkv6(r, k, v, w, u, s0)
                if sl == 1:
                    yp, lastp = wkv6_plain(r, k, v, w, u, s0)
                    fwd = dict(y_rel_err_plain=rel(y, yp), s_last_bit_exact=torch.equal(last, lastp))
                    fwd_ok = fwd["y_rel_err_plain"] <= WKV6_Y_TOL and fwd["s_last_bit_exact"]
                else:
                    y64, last64 = wkv6_plain(r, k, v, w, u, s0, dtype=torch.float64)
                    fwd = dict(y_rel_err_f64=rel(y, y64), s_last_rel_err_f64=rel(last, last64))
                    fwd_ok = max(fwd.values()) <= WKV6_F64_TOL
                if not fwd_ok:
                    raise AssertionError(f"wkv6 forward at head size 32, S {sl}: {fwd}")
            for ds in (None, drawn):
                zero_counters()
                got = wkv6_backward(r, k, v, w, u, s0, dy, ds)
                again = wkv6_backward(r, k, v, w, u, s0, dy, ds)
                torch.cuda.synchronize()
                launches = read_counters()["wkv6_backward"]
                p64 = wkv6_backward_plain(r, k, v, w, u, s0, dy, ds, dtype=torch.float64)
                ins = [t.double().requires_grad_(True) for t in (r, k, v, w, u, s0)]
                y, last = wkv6_plain(*ins, dtype=torch.float64)
                outs, gr = ((y,), (dy.double(),)) if ds is None else \
                    ((y, last), (dy.double(), ds.double()))
                ag = [torch.zeros_like(t) if x is None else x for t, x in zip(
                    ins, torch.autograd.grad(outs, ins, gr, allow_unused=True))]
                case = dict(H=h, Dh=dh, S=sl, decay=decay, ds_last=ds is not None, forward=fwd,
                            zeros_in_w=int((w == 0).sum()), launches=launches,
                            bit_exact_two_calls=all(torch.equal(a, b) for a, b in zip(got, again)),
                            finite=all(bool(torch.isfinite(x).all()) for x in got),
                            rel_err_vs_plain_f64=rels(got, p64),
                            rel_err_vs_autograd_f64=rels(got, ag),
                            plain_f64_vs_autograd=max(rels(p64, ag).values()),
                            max_abs_err=max(float((a.double() - b).abs().max())
                                            for a, b in zip(got, p64)))
                cases.append(case)
                ok = (case["bit_exact_two_calls"] and case["finite"] and launches == 2
                      and max(case["rel_err_vs_plain_f64"].values()) <= WKV6_BWD_TOL
                      and max(case["rel_err_vs_autograd_f64"].values()) <= WKV6_BWD_TOL)
                if not ok:
                    raise AssertionError(f"wkv6 backward kernel: {case}")
                del p64, ag, ins, y, last
    # the call a train step makes (s_last unused: ds_last None, s0 zero): at
    # the 2-layer rwkv6-7b step's shape (B 2, S 64) and at the reference's
    # train_4k sequence length (B 1, S 4096, one sequence of a layer's call)
    scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)   # 256 MB

    def flush():
        scratch.zero_()

    def timed(b, sl, plain: bool):
        r, k, v, w, u, s0, dy, _ = draw(sl, "model", b=b)
        s0 = torch.zeros_like(s0)
        got = wkv6_backward(r, k, v, w, u, s0, dy)

        def call():
            return wkv6_backward(r, k, v, w, u, s0, dy)
        # per state element a step: the state rebuilt (3), the four products
        # and their sums (8) and G's update (3) -- the step-by-step walk's
        # count, kept whatever the kernel implements so that timings compare
        bms, by = bound(nbytes(r, k, v, w, u, s0, dy, *got), 14 * b * sl * 64 * 64 * 64,
                        F32_FLOP_PER_S)
        res = dict(ms=time_ms(call, flush=flush),
                   kernels_us=kernels_us(call, flush, match="wkv6_bwd"),
                   kernels_us_warm=kernels_us(call, match="wkv6_bwd"),
                   bound_ms=bms, bound_by=by, library_ms=None,
                   scratch_bytes=scratch_bytes(b, sl, 64, 64),
                   shape=f"r, k, v, w, dy ({b},{sl},64,64) f32, u (64,64), "
                         f"s0 ({b},64,64,64) zero, ds_last None")
        if plain:
            res["plain_ms"] = time_ms(lambda: wkv6_backward_plain(r, k, v, w, u, s0, dy),
                                      flush=flush, iters=7)
        res["bound_share"] = bms / res["ms"]
        return res, (r, k, v, w, u, s0, dy), got

    train, _, _ = timed(bsz, RWKV_TRAIN["S"], plain=True)
    long, ins, got = timed(1, WKV6_BWD_LONG, plain=False)
    # the long call against the plain backward in f64 (no autograd: its
    # 4096-step graph is not needed to hold the kernel)
    p64 = wkv6_backward_plain(*ins, dtype=torch.float64)
    long.update(rel_err_vs_plain_f64=rels(got, p64),
                max_abs_err=max(float((a.double() - b).abs().max()) for a, b in zip(got, p64)),
                finite=all(bool(torch.isfinite(x).all()) for x in got),
                tol=WKV6_BWD_LONG_TOL)
    del p64
    out = dict(card=card, cases=cases, tol=WKV6_BWD_TOL,
               max_abs_err=max(c["max_abs_err"] for c in cases),
               max_rel_err=max(max(c["rel_err_vs_plain_f64"].values()) for c in cases),
               max_rel_err_vs_autograd=max(max(c["rel_err_vs_autograd_f64"].values())
                                           for c in cases),
               **train, long=long)
    print(json.dumps({"train_wkv6_backward": out}))
    if not (long["finite"] and max(long["rel_err_vs_plain_f64"].values()) <= WKV6_BWD_LONG_TOL):
        raise AssertionError(f"wkv6 backward kernel at S {WKV6_BWD_LONG}: {long}")
    return out


def rwkv_cli_check(dev, card: str) -> dict:
    """(h) ``launch.train.run`` on the reduced rwkv6-7b (2 heads of 64) for
    RWKV_CLI_STEPS steps at the CLI's defaults (B 8, S 64, peak lr 3e-3):
    every loss finite, the mean of the last five below the first five's,
    and wkv6's backward kernel launched every step."""
    import statistics

    from repro_torch.launch import train as train_cli
    zero_counters()
    res = train_cli.run("rwkv6-7b", reduced=True, steps=RWKV_CLI_STEPS, log_every=5,
                        device=dev)
    launches = read_counters()
    losses = [res.losses[i] for i in range(RWKV_CLI_STEPS)]
    out = dict(card=card, arch="rwkv6-7b reduced", steps=RWKV_CLI_STEPS, B=8, S=64,
               loss_first=losses[0], loss_last=losses[-1],
               mean_first5=statistics.fmean(losses[:5]), mean_last5=statistics.fmean(losses[-5:]),
               all_finite=all(math.isfinite(x) for x in losses),
               step_ms_median=statistics.median(res.step_seconds[i] * 1e3
                                                for i in range(2, RWKV_CLI_STEPS)),
               peak_gb=res.peak_bytes / 1e9,
               launches={k: v for k, v in launches.items() if v})
    print(json.dumps({"train_rwkv_cli": out}))
    if not (out["all_finite"] and out["mean_last5"] < out["mean_first5"]
            and launches["wkv6_backward"] >= RWKV_CLI_STEPS):
        raise AssertionError(f"reduced rwkv6-7b through launch.train on the card: {out}")
    return out


def train_phase(dev, card: str) -> dict:
    """Training through the port on the card: (a) rglru_scan's backward, (b)
    one full-width qwen1.5-0.5b step against the CPU, (c) a 3-layer
    full-width recurrentgemma-2b step against the CPU (the hybrid's train
    path, which launches rglru_scan both ways), (d) launch.train at full
    width and the reduced model's loss, (e) restart from a manifest, (f)
    wkv6's backward kernel, (g) a 2-layer full-width rwkv6-7b step against
    the CPU (wkv6 forward, with remat's recomputation, and backward), (h)
    the reduced rwkv6-7b through launch.train."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    res = {"rglru_backward": rglru_backward_check(dev, card)}
    res["qwen_step"] = card_vs_cpu_step(get_config(TRAIN_ARCH), dev, card, 2, 64)
    print(json.dumps({"train_step": res["qwen_step"]}))
    gc.collect()
    torch.cuda.empty_cache()
    hyb = dataclasses.replace(get_config("recurrentgemma-2b"), num_layers=HYBRID_TRAIN["layers"])
    assert hyb.layer_kinds() == ("recurrent", "recurrent", "attention")
    res["hybrid_step"] = card_vs_cpu_step(hyb, dev, card, HYBRID_TRAIN["B"], HYBRID_TRAIN["S"],
                                          ("rglru_scan", "rglru_scan_reverse"))
    print(json.dumps({"train_step": res["hybrid_step"]}))
    gc.collect()
    torch.cuda.empty_cache()
    res["cli"] = train_cli_check(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    res["restart"] = train_restart_check(dev, card)
    res["wkv6_backward"] = wkv6_backward_check(dev, card)
    gc.collect()
    torch.cuda.empty_cache()
    rwkv = dataclasses.replace(get_config("rwkv6-7b"), num_layers=RWKV_TRAIN["layers"])
    res["rwkv_step"] = card_vs_cpu_step(rwkv, dev, card, RWKV_TRAIN["B"], RWKV_TRAIN["S"],
                                        ("wkv6", "wkv6_backward"))
    print(json.dumps({"train_step": res["rwkv_step"]}))
    counts = res["rwkv_step"]["launches"]
    # remat "dots" runs each layer's forward again in the backward pass
    if (counts.get("wkv6"), counts.get("wkv6_backward")) != (2 * rwkv.num_layers,
                                                            rwkv.num_layers):
        raise AssertionError(f"rwkv6-7b train step: wkv6 launches {counts}")
    gc.collect()
    torch.cuda.empty_cache()
    res["rwkv_cli"] = rwkv_cli_check(dev, card)
    print(json.dumps({"train_phase_s": time.perf_counter() - t0}))
    return res


# ---------------------------------------------------------------------------
# Dist phase: the sequence-sharded decode and the compressed all-reduce over
# ranks sharing the one card
# ---------------------------------------------------------------------------
# The dry run's counts: a step on the card against its trace on meta
# ---------------------------------------------------------------------------

# (name, arch, layers, step, B, length): "decode" one step at position length
# over a cache of length + 1 slots (qwen3: 4096 slots), "chunk" a 256-token
# prefill_chunk over length slots already there, "prefill" length tokens
DRYRUN_CASES = (("qwen3_decode", "qwen3-8b", 4, "decode", 8, 4095),
                ("qwen3_chunk", "qwen3-8b", 4, "chunk", 8, 3840),
                ("hybrid_prefill", "recurrentgemma-2b", 3, "prefill", 2, 256),
                ("hybrid_decode", "recurrentgemma-2b", 3, "decode", 2, 256),
                ("rwkv_prefill", "rwkv6-7b", 2, "prefill", 2, 256),
                ("rwkv_decode", "rwkv6-7b", 2, "decode", 2, 256))
DRYRUN_CHUNK = 256
# the model modules' names of the kernel wrappers a step reaches
KERNEL_SITES = (("repro_torch.models.attention", "flash_decode"),
                ("repro_torch.models.attention", "flash_prefill"),
                ("repro_torch.distributed.collectives", "flash_decode_partials"),
                ("repro_torch.models.rglru", "rglru_scan_grad"),
                ("repro_torch.models.rwkv6", "wkv6"))


def _flat_tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        x = list(x.values())
    return [t for y in (x or []) for t in _flat_tensors(y)]


@contextlib.contextmanager
def kernel_spy(calls: dict):
    """Record the first call of each model-side kernel wrapper: the wrapper,
    its inputs (kept) and its outputs' shapes and dtypes."""
    import importlib
    undo = []
    for mod_name, name in KERNEL_SITES:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            out = _fn(*a, **kw)
            if _name not in calls:
                calls[_name] = (_fn, a, kw, [(tuple(t.shape), str(t.dtype))
                                             for t in _flat_tensors(out)])
            return out
        setattr(mod, name, spy)
        undo.append((mod, name, fn))
    try:
        yield
    finally:
        for mod, name, fn in undo:
            setattr(mod, name, fn)


def dryrun_case(dev, arch: str, layers: int, step: str, bsz: int, length: int) -> dict:
    """``op_cost.analyze`` of one step on the card (full width, ``layers``
    deep, bf16 random weights from seed 0) and of the same step on meta:
    dot_flops, the kernel notes against the launches read around the card
    call, the step's outputs' shapes and dtypes, and each kernel wrapper's
    meta route against its CUDA call at the step's shapes."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import op_cost
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    slots = length + 1 if step == "decode" else length + DRYRUN_CHUNK

    def build(device):
        model = Model(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                      device=device)
        if device == "meta":
            params = model.param_specs()
            tokens = torch.zeros(bsz, max(length, DRYRUN_CHUNK), dtype=torch.int32,
                                 device="meta")
        else:
            params = model.init(torch.Generator(device=dev).manual_seed(0))
            tokens = torch.randint(0, cfg.vocab_size, (bsz, max(length, DRYRUN_CHUNK)),
                                   generator=torch.Generator().manual_seed(1)).to(dev)
        cache = None if step == "prefill" else model.init_cache(bsz, slots)

        def run():
            with torch.no_grad():
                if step == "prefill":
                    return model.prefill(params, tokens[:, :length])
                if step == "chunk":
                    return model.prefill_chunk(params, tokens[:, :DRYRUN_CHUNK], cache, length)
                return model.decode_step(params, tokens[:, 0], cache, length)
        return run

    card_run, meta_run = build(dev), build("meta")
    card_run()                                   # warm: the kernel library, cuBLAS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card_run()
    torch.cuda.synchronize()
    card_plain_s = time.perf_counter() - t0
    calls: dict = {}
    zero_counters()
    t0 = time.perf_counter()
    with kernel_spy(calls):
        card_out, card = op_cost.analyze(card_run)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    launches = {k: v for k, v in read_counters().items() if v}
    t0 = time.perf_counter()
    meta_out, meta = op_cost.analyze(meta_run)
    meta_s = time.perf_counter() - t0
    # each wrapper's meta route at the card call's shapes (not on the path)
    routes = {}
    for name, (fn, args, kw, shapes) in calls.items():
        margs = [torch.empty_like(a, device="meta") if isinstance(a, torch.Tensor) else a
                 for a in args]
        with torch.no_grad():
            got = [(tuple(t.shape), str(t.dtype)) for t in _flat_tensors(fn(*margs, **kw))]
        routes[name] = dict(cuda=shapes, meta=got, equal=got == shapes)
    notes_as_launches = {
        "flash_decode": launches.get("flash_decode", 0),
        "flash_prefill": launches.get("flash_prefill", 0),
        "rglru_scan": launches.get("rglru_scan", 0) + launches.get("rglru_scan_step", 0),
        "wkv6": launches.get("wkv6", 0) + launches.get("wkv6_step", 0)}
    notes_as_launches = {k: v for k, v in notes_as_launches.items() if v}
    return dict(
        arch=arch, layers=layers, step=step, B=bsz, length=length, slots=slots,
        dot_flops_card=card["dot_flops"], dot_flops_meta=meta["dot_flops"],
        dot_flops_equal=card["dot_flops"] == meta["dot_flops"],
        notes_card=card["kernel_notes"], notes_meta=meta["kernel_notes"],
        launches=launches, notes_equal_launches=(card["kernel_notes"] == notes_as_launches
                                                 == meta["kernel_notes"]),
        outputs_equal=[(tuple(t.shape), t.dtype) for t in _flat_tensors(card_out)]
        == [(tuple(t.shape), t.dtype) for t in _flat_tensors(meta_out)],
        routes=routes, routes_equal=all(r["equal"] for r in routes.values()),
        collectives_card=card["collective_counts"],
        card_s=card_s, card_plain_s=card_plain_s, meta_trace_s=meta_s)


def dryrun_phase(dev, card: str) -> dict:
    """Each DRYRUN_CASES step counted on the card and traced on meta
    (``dryrun_case``): dot_flops equal exactly, the kernel notes equal to the
    launches the counters read, the outputs' and each wrapper's meta route's
    shapes and dtypes equal to the card's.  One ``{"dryrun": ...}`` line;
    the seconds are host seconds (the card call's ended by a synchronise)."""
    import torch
    t0 = time.perf_counter()
    cases = {}
    for name, arch, layers, step, bsz, length in DRYRUN_CASES:
        cases[name] = dryrun_case(dev, arch, layers, step, bsz, length)
        gc.collect()
        torch.cuda.empty_cache()
    res = {"card": card, "cases": cases, "dryrun_phase_s": time.perf_counter() - t0}
    print(json.dumps({"dryrun": res}))
    for name, c in cases.items():
        if not (c["dot_flops_equal"] and c["notes_equal_launches"] and c["outputs_equal"]
                and c["routes_equal"] and c["launches"]):
            raise AssertionError(f"dryrun {name}: {c}")
    return res


# ---------------------------------------------------------------------------

# qwen3-8b's attention at full width over a 4096-slot cache cut into 1024
# slots a rank, a 16-slot tail on seq-rank 0
DIST = dict(ranks=4, B=2, HQ=32, HKV=8, DH=128, SLOTS=4096, TAIL=16)
DIST_EF = (4, 4096 * 256)        # error_feedback_psum: a (4096 x 256) f32 tensor a rank
DIST_EF_REL = 0.02
DIST_PARTIAL_REL = 1e-5          # m and l of the partials mode against its plain version


def dist_inputs(case: str, dev):
    """One lse case's whole inputs, the same on every rank (seed 5):
    ``main`` (some slots empty, the tail half visible), ``empty_shard``
    (rank 1's 1024 slots all empty) and ``nothing_visible`` (the query's
    position below every slot's, the tail's too)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(5)
    b, hq, hkv, dh, s, t = (DIST[x] for x in ("B", "HQ", "HKV", "DH", "SLOTS", "TAIL"))

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
    q, k, v = randn(b, 1, hq, dh), randn(b, s, hkv, dh), randn(b, s, hkv, dh)
    tk, tv = randn(b, t, hkv, dh), randn(b, t, hkv, dh)
    kpos = torch.arange(s, dtype=torch.int32, device=dev)
    tkp = torch.arange(s, s + t, dtype=torch.int32, device=dev)
    q_pos = s + t // 2
    if case == "main":
        kpos[100:140] = -1
    elif case == "empty_shard":
        kpos[s // 4:s // 2] = -1
    else:
        kpos += 100
        tkp += 100
        q_pos = 50
    return q, k, v, kpos, (tk, tv, tkp), q_pos


# sharded decode_step on (1, 4) against one process, full width cut in depth:
# (name, arch, layers); B 2, a 64-token prefix in a 128-slot cache
DIST_DECODE = (("qwen3_heads", "qwen3-8b", 2),
               ("hybrid_sequence", "recurrentgemma-2b", 3),
               ("rwkv_heads", "rwkv6-7b", 2))
DIST_DECODE_SHAPE = dict(B=2, PREFIX=64, SLOTS=128)
# The logits' bound (rounding_check): 2^-8 (layers + 1) |h| @ |unembed| + one
# bf16 step, h the one-process final hidden state.  Each layer's sharded
# output products (wo, w_down, w_out, w_o, cm_v) add the ranks' bf16 partial
# sums in another order than one product over the whole inputs, a rounding
# of up to one bf16 step of that layer's output carried on in the residual
# stream; the final norm's output is rounded once more.  (A bound of one
# rounding, 2^-8 |h| @ |unembed|, was exceeded 1.1-2.0 times by the reduced
# configs on the CPU.)
# launches each rank's step must make, and the local shapes its kernels take:
# qwen3-8b's 8 kv-heads over 4 ranks (2 a rank, 8 of 32 query heads);
# recurrentgemma-2b's one kv-head: the cache along its sequence (32 slots a
# rank) through the partials and the LSE combine, its RG-LRU state along
# the width (640 of 2560 lanes); rwkv6-7b's 64 wkv heads (16 a rank)
DIST_DECODE_LAUNCHES = {"qwen3_heads": {"flash_decode": 2},
                        "hybrid_sequence": {"flash_decode_partials": 1, "rglru_scan_step": 2},
                        "rwkv_heads": {"wkv6_step": 2}}
# (the first two tensors a wrapper takes: q and k, log_a and b, r and k)
DIST_DECODE_LOCAL = {"qwen3_heads": {"flash_decode": [(2, 8, 128), (2, 128, 2, 128)]},
                     "hybrid_sequence": {"flash_decode_partials": [(2, 10, 256), (2, 32, 1, 256)],
                                         "rglru_scan_grad": [(2, 1, 640), (2, 1, 640)]},
                     "rwkv_heads": {"wkv6": [(2, 1, 16, 64), (2, 1, 16, 64)]}}


def place_local(tree, spec_tree, mesh):
    """``tree``'s leaves (the same on every rank) as DTensors placed by
    ``spec_tree``, each rank slicing its own shard: no collective."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch.distributed.elastic import _flat
    from repro_torch.distributed.sharding import _map_with_path, to_placements
    specs = dict(_flat(spec_tree))

    def put(path, t):
        pl = to_placements(mesh, specs[path])
        shape, off = compute_local_shape_and_global_offset(t.shape, mesh, pl)
        local = t[tuple(slice(o, o + n) for o, n in zip(off, shape))].contiguous()
        return DTensor.from_local(local, mesh, pl, run_check=False)
    return _map_with_path(put, tree)


def sharded_decode_case(dev, mesh, arch: str, layers: int) -> dict:
    """One decode_step of ``arch`` (full width, ``layers`` deep, bf16 weights
    from seed 0 on every rank) on CUDA DTensors over ``mesh``, against the
    same step in this process on plain tensors: the logits by
    ``rounding_check``, the greedy token, this rank's launches
    (counts from 0 just before the sharded step, read just after) and the
    local shapes its kernels took."""
    import copy

    import torch
    from repro_torch.configs import get_config
    from repro_torch.distributed import sharding as shr
    from repro_torch.distributed.constraints import use_mesh
    from repro_torch.models import Model
    from repro_torch.models.kvcache import grow_cache
    from repro_torch.models.layers import apply_norm
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    b, pre, slots = (DIST_DECODE_SHAPE[x] for x in ("B", "PREFIX", "SLOTS"))
    model = Model(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    prompt = torch.randint(0, cfg.vocab_size, (b, pre),
                           generator=torch.Generator().manual_seed(2)).to(dev)
    with torch.no_grad():
        last, cache = model.prefill(params, prompt)
        cache = grow_cache(cfg, cache, slots)
        tok = last.argmax(-1).to(torch.int32)
        one, _ = model.decode_step(params, tok, copy.deepcopy(cache), pre)
        positions = torch.full((b, 1), pre, dtype=torch.int32)
        x = model.embed(params, tok[:, None], positions)
        x, _ = model.stack_chunk(params, x, positions, copy.deepcopy(cache))
        h = apply_norm(cfg.norm, params["final_norm"], x, cfg.norm_eps)[:, 0]
        table = params["embed"].T if cfg.tie_embeddings else params["unembed"]
        weighted = h.float().abs() @ table.float().abs()
    p_sh = place_local(params, shr.param_pspecs(model, "serve_tp"), mesh)
    c_sh = place_local(cache, shr.cache_pspecs(model, mesh, b, slots), mesh)
    t_sh = place_local(tok, shr.data_pspecs(cfg, mesh, "decode", b), mesh)
    calls: dict = {}
    torch.cuda.synchronize()
    zero_counters()
    t0 = time.perf_counter()
    with kernel_spy(calls), use_mesh(mesh), torch.no_grad():
        logits, _ = model.decode_step(p_sh, t_sh, c_sh, pre)
        logits = logits.full_tensor()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: v for k, v in read_counters().items() if v}
    local = {name: [list(a.shape) for a in args if isinstance(a, torch.Tensor)][:2]
             for name, (_fn, args, _kw, _shapes) in calls.items()}
    r = dict(arch=arch, layers=layers, B=b, prefix=pre, slots=slots,
             cache_specs={f: list(sp) for f, sp in shr.cache_pspecs(model, mesh, b, slots).items()},
             launches=launches, local_shapes=local, step_ms=step_ms,
             max_abs_logit_diff=float((logits.float() - one.float()).abs().max()),
             max_abs_logit=float(one.float().abs().max()),
             greedy_equal=bool(torch.equal(logits.argmax(-1), one.argmax(-1))),
             **rounding_check(logits, one, (layers + 1) * weighted))
    del model, params, cache, p_sh, c_sh
    gc.collect()
    torch.cuda.empty_cache()
    return r


def dist_rank(rank: int, world: int, store: str, out_path: str):
    """One rank of the dist phase (spawned): joins the group (gloo: the
    ranks share one card), loads the kernel library the parent built, and
    writes its readings to ``out_path`` (an ``error`` key on failure)."""
    import faulthandler

    import torch
    faulthandler.enable()                   # a crash prints each thread's stack
    out = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        dev = torch.device("cuda", 0)
        import torch.distributed as dist
        from torch.distributed.device_mesh import init_device_mesh
        from torch.distributed.tensor import DTensor

        from repro_torch.distributed.collectives import lse_decode_attention
        from repro_torch.distributed.constraints import use_mesh
        from repro_torch.distributed.sharding import to_placements
        from repro_torch.kernels import _build
        from repro_torch.kernels.flash_decode import (flash_decode, flash_decode_partials,
                                                      flash_decode_partials_plain,
                                                      flash_decode_plain)
        from repro_torch.launch.mesh import init_process_group
        from repro_torch.training.compression import error_feedback_psum
        out["backend"] = init_process_group(rank, world, store, device="cuda")
        _build.lib()
        mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
        sl = DIST["SLOTS"] // world
        scale = DIST["DH"] ** -0.5
        kw = dict(scale=scale)

        def shard(t, dim):
            loc = t.narrow(dim, rank * sl, sl)
            pl = [None] * 4 if t.dim() == 4 else [None]
            pl[dim] = "model"
            return DTensor.from_local(loc, mesh, to_placements(mesh, pl), run_check=False)

        # the partials mode against its plain version on this rank's shard
        # and tail (off the main path: the counts are zeroed below)
        q, k, v, kpos, tail, q_pos = dist_inputs("main", dev)
        ql = q[:, 0].contiguous()
        kl = torch.cat([k[:, rank * sl:(rank + 1) * sl], tail[0]], dim=1)
        vl = torch.cat([v[:, rank * sl:(rank + 1) * sl], tail[1]], dim=1)
        kpl = torch.cat([kpos[rank * sl:(rank + 1) * sl],
                         tail[2] if rank == 0 else torch.full_like(tail[2], -1)])
        acc, m, l = flash_decode_partials(ql, kl, vl, kpl, q_pos, **kw)
        pacc, pm, pl_ = flash_decode_partials_plain(ql, kl, vl, kpl, q_pos, **kw)
        out_k, out_p = acc / l[..., None], pacc / pl_[..., None]
        weighted = flash_decode_plain(ql.float(), kl.float(), vl.float().abs(), kpl, q_pos, **kw)
        out["partials"] = dict(
            m_rel=float(((m - pm).abs() / pm.abs().clamp_min(1e-30)).max()),
            l_rel=float(((l - pl_).abs() / pl_.abs()).max()),
            acc_max_abs_err=float((acc - pacc).abs().max()),
            **rounding_check(out_k, out_p, weighted))
        # a shard with no visible slot: the reference's finite mask
        e_acc, e_m, e_l = flash_decode_partials(
            ql, kl, vl, torch.full_like(kpl, -1), q_pos, **kw)
        out["partials"]["empty"] = dict(
            m=float(e_m.max()), l_min=float(e_l.min()), l_max=float(e_l.max()),
            acc_err=float((e_acc - vl.float().sum(1).repeat_interleave(
                DIST["HQ"] // DIST["HKV"], dim=1)).abs().max()))
        torch.cuda.synchronize()

        # the main path: lse_decode_attention over the sharded cache
        cases = ("main", "empty_shard", "nothing_visible")
        inputs = {c: dist_inputs(c, dev) for c in cases}
        dist.barrier()
        flash_decode_partials.launches = 0
        flash_decode.launches = 0
        res = {}
        with use_mesh(mesh):
            for c in cases:
                q, k, v, kpos, tail, q_pos = inputs[c]
                res[c] = lse_decode_attention(q, shard(k, 1), shard(v, 1), shard(kpos, 0),
                                              q_pos, tail=tail, **kw)
        torch.cuda.synchronize()
        out["launches"] = {"flash_decode_partials": flash_decode_partials.launches,
                           "flash_decode": flash_decode.launches}
        out["cases"] = {}
        for c in cases:
            q, k, v, kpos, tail, q_pos = inputs[c]
            o = res[c][:, 0]
            kf, vf = torch.cat([k, tail[0]], 1), torch.cat([v, tail[1]], 1)
            kpf = torch.cat([kpos, tail[2]])
            single = flash_decode(q[:, 0].contiguous(), kf, vf, kpf, q_pos, **kw)
            f32 = flash_decode_plain(q[:, 0].float(), kf.float(), vf.float(), kpf, q_pos, **kw)
            r = dict(finite=bool(torch.isfinite(o).all()),
                     err_vs_f32=float((o.float() - f32).abs().max()),
                     single_err_vs_f32=float((single.float() - f32).abs().max()))
            if c == "nothing_visible":
                # every rank's slots and its copy of the tail weigh alike:
                # the mean of V over S + ranks x T slots
                want = ((v.float().sum(1) + world * tail[1].float().sum(1))
                        / (DIST["SLOTS"] + world * DIST["TAIL"]))
                want = want.repeat_interleave(DIST["HQ"] // DIST["HKV"], dim=1)
                r["err_vs_semantics"] = float((o.float() - want).abs().max())
            else:
                weighted = flash_decode_plain(q[:, 0].float(), kf.float(), vf.float().abs(),
                                              kpf, q_pos, **kw)
                r.update(rounding_check(o, single, weighted))
                r["f32_rounding_ratio"] = rounding_check(o, f32, weighted)["rounding_ratio"]
            out["cases"][c] = r

        # the call's wall time (host clock ended by a synchronise) and the
        # combine's alone: gloo stages CUDA operands through the host
        import statistics
        q, k, v, kpos, tail, q_pos = inputs["main"]
        ks, vs, kps = shard(k, 1), shard(v, 1), shard(kpos, 0)
        walls, combines = [], []
        from repro_torch.distributed.collectives import lse_combine
        grp = mesh.get_group("model")
        for _ in range(11):
            dist.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with use_mesh(mesh):
                lse_decode_attention(q, ks, vs, kps, q_pos, tail=tail, **kw)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
            dist.barrier()
            t0 = time.perf_counter()
            lse_combine(acc, m, l, grp)
            torch.cuda.synchronize()
            combines.append((time.perf_counter() - t0) * 1e3)
        out["lse_call_ms"] = statistics.median(walls)
        out["combine_ms"] = statistics.median(combines)

        # error_feedback_psum: on the card, and the same inputs on the host
        g = torch.Generator(device=dev).manual_seed(9)
        x = torch.randn(*DIST_EF, generator=g, device=dev)
        dist.barrier()
        t0 = time.perf_counter()
        mean, resid = error_feedback_psum(x[rank])
        torch.cuda.synchronize()
        out["ef_ms"] = (time.perf_counter() - t0) * 1e3
        exact = x.mean(0)
        mean_h, resid_h = error_feedback_psum(x[rank].cpu())
        out["ef"] = dict(
            rel=float(torch.linalg.norm(mean - exact) / torch.linalg.norm(exact)),
            equal_to_cpu=bool(torch.equal(mean.cpu(), mean_h)
                              and torch.equal(resid.cpu(), resid_h)))

        # the kernel timed alone on rank 0 at the per-rank shape (the other
        # ranks wait at a barrier)
        dist.barrier()
        if rank == 0:
            import torch.nn.functional as F
            b, hq, hkv, dh = (DIST[x] for x in ("B", "HQ", "HKV", "DH"))
            qs, kk, vv = ql, k[:, :sl].contiguous(), v[:, :sl].contiguous()
            kp = kpos[:sl].contiguous()
            scratch = torch.empty(64 << 20, dtype=torch.int32, device=dev)

            def flush():
                scratch.zero_()

            def call():
                return flash_decode_partials(qs, kk, vv, kp, q_pos, **kw)
            a_, m_, l_ = call()
            bms, by = bound(nbytes(qs, kk, vv, kp, a_, m_, l_), 4 * hq * dh * sl * b)
            mask = (kp >= 0) & (kp <= q_pos)
            kt = kk.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
            vt = vv.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
            ms = time_ms(call, flush=flush)
            out["timing"] = dict(
                shape=[b, sl, hkv, dh], ms=ms,
                plain_ms=time_ms(lambda: flash_decode_partials_plain(qs, kk, vv, kp, q_pos, **kw),
                                 flush=flush),
                library_ms=time_ms(lambda: F.scaled_dot_product_attention(
                    qs[:, :, None], kt, vt, attn_mask=mask[None], scale=scale), flush=flush),
                bound_ms=bms, bound_by=by, bound_share=bms / ms,
                kernels_us=kernels_us(call, flush), kernels_us_warm=kernels_us(call),
                max_abs_err=out["partials"]["acc_max_abs_err"])
        dist.barrier()
        # sharded decode_steps: each rank's kernels on its own shards
        out["decode"] = {}
        for name, arch, layers in DIST_DECODE:
            dist.barrier()
            out["decode"][name] = sharded_decode_case(dev, mesh, arch, layers)
        dist.barrier()
        dist.destroy_process_group()
    except Exception:                       # reported by the parent, which fails
        import traceback
        out["error"] = traceback.format_exc()
    with open(out_path, "w") as f:
        json.dump(out, f)


def dist_phase(card: str) -> dict:
    """``lse_decode_attention`` and ``error_feedback_psum`` over DIST["ranks"]
    ranks spawned on the one card (gloo: NCCL takes one rank a card), the
    kernel library built by the parent before the spawn.  Every rank's
    partial through ``flash_decode_partials`` (its count zeroed just before
    the three lse calls and read just after: one launch a call on every
    rank); each case held to one-process ``flash_decode`` over [cache ||
    tail] by ``rounding_check`` and to the f32 plain version (the case with
    no visible slot to the reference's semantics, the mean of V over every
    rank's slots); the partials mode to its plain version; the compressed
    mean within DIST_EF_REL of the exact one and equal to the same ranks'
    run on host tensors.  One ``{"dist": ...}`` line with the phase's
    seconds."""
    import torch
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    n = DIST["ranks"]
    work = os.path.join(OUT_DIR, "dist")
    os.makedirs(work, exist_ok=True)
    store = os.path.join(work, "store")
    if os.path.exists(store):
        os.remove(store)
    paths = [os.path.join(work, f"rank{r}.json") for r in range(n)]
    for p in paths:
        if os.path.exists(p):
            os.remove(p)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=dist_rank, args=(r, n, store, paths[r])) for r in range(n)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=400)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    missing = [r for r, p in enumerate(paths) if not os.path.exists(p)]
    if missing:
        raise AssertionError(f"dist: ranks {missing} wrote nothing "
                             f"(exit codes {[p.exitcode for p in procs]})")
    outs = []
    for p in paths:
        with open(p) as f:
            outs.append(json.load(f))
    for o in outs:
        if "error" in o:
            raise AssertionError(f"dist rank {o['rank']}:\n{o['error']}")
    launches = [o["launches"]["flash_decode_partials"] for o in outs]
    res = {"card": card, "torch": torch.__version__, "ranks": n, "backend": outs[0]["backend"],
           "launches_by_rank": launches,
           "flash_decode_launches_by_rank": [o["launches"]["flash_decode"] for o in outs],
           "cases": outs[0]["cases"], "partials": [o["partials"] for o in outs],
           "lse_call_ms_by_rank": [o["lse_call_ms"] for o in outs],
           "combine_ms_by_rank": [o["combine_ms"] for o in outs],
           "ef": [o["ef"] for o in outs], "ef_ms_by_rank": [o["ef_ms"] for o in outs],
           "timing": outs[0]["timing"],
           "decode": {name: {**outs[0]["decode"][name],
                             "launches_by_rank": [o["decode"][name]["launches"] for o in outs],
                             "rounding_ratio_by_rank": [o["decode"][name]["rounding_ratio"]
                                                        for o in outs]}
                      for name, _a, _l in DIST_DECODE}}
    res["dist_phase_s"] = time.perf_counter() - t0
    print(json.dumps({"dist": res}))
    assert len({o["backend"] for o in outs}) == 1 and res["backend"] == "gloo", res["backend"]
    assert launches == [3] * n, launches
    assert res["flash_decode_launches_by_rank"] == [0] * n
    for o in outs:
        for c, r in o["cases"].items():
            assert r["finite"], (o["rank"], c)
            if c == "nothing_visible":       # f32 one-process: the mean over S + T slots
                assert r["err_vs_semantics"] <= DECODE_TOL, (o["rank"], c, r)
            else:
                assert r["rounding_ratio"] <= 1.0 and r["f32_rounding_ratio"] <= 1.0, \
                    (o["rank"], c, r)
        pa = o["partials"]
        assert pa["m_rel"] <= DIST_PARTIAL_REL and pa["l_rel"] <= DIST_PARTIAL_REL, pa
        assert pa["rounding_ratio"] <= 1.0, pa
        e = pa["empty"]
        assert e["m"] == float(torch.tensor(-1e30)) and e["l_min"] == e["l_max"] == DIST["SLOTS"] // n + DIST["TAIL"], e
        assert e["acc_err"] <= 1e-2, e
        assert o["ef"]["rel"] < DIST_EF_REL and o["ef"]["equal_to_cpu"], o["ef"]
        for name, d in o["decode"].items():
            assert d["launches"] == DIST_DECODE_LAUNCHES[name], (o["rank"], name, d)
            assert d["greedy_equal"] and d["rounding_ratio"] <= 1.0, (o["rank"], name, d)
            for k, shapes in DIST_DECODE_LOCAL[name].items():
                assert [tuple(x) for x in d["local_shapes"][k]] == shapes, (o["rank"], name, d)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, skip the serve")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one more serve of each path with torch.profiler")
    ap.add_argument("--decode-sweep", action="store_true",
                    help="after the kernel checks, time flash_decode's two kernels "
                         "over cache lengths and batch rows; skip the serves")
    ap.add_argument("--prefill-sweep", action="store_true",
                    help="after the kernel checks, time flash_prefill at its four "
                         "shapes over n_split around the plan's; skip the serves")
    ap.add_argument("--wkv-sweep", action="store_true",
                    help="after the kernel checks, time the chunked wkv6 kernel at "
                         "every variant it is built for; skip the serves")
    ap.add_argument("--quant-sweep", action="store_true",
                    help="after the kernel checks, time kv_quantize over cluster "
                         "sizes 4, 8, 16 on both branches; skip the serves")
    ap.add_argument("--rglru-sweep", action="store_true",
                    help="after the kernel checks, check and time rglru_scan at every "
                         "(C, T, stages) it is built for; skip the serves")
    ap.add_argument("--promote-profile", action="store_true",
                    help="build, then trace one qwen3 int8 serve and print the device "
                         "time of the datapath's promotion, read from the program's "
                         "spans (a tree without them prints the kernels alone)")
    ap.add_argument("--quant-only", action="store_true",
                    help="build, then check and time kv_quantize alone at the serve's "
                         "chunk through its public call (runs on older trees too)")
    ap.add_argument("--train-only", action="store_true",
                    help="build, then run the train phase alone (its kernels line "
                         "holds rglru_scan's reversed call and wkv6's backward only)")
    ap.add_argument("--wkv-bwd-only", action="store_true",
                    help="build, then check and time wkv6's backward kernel alone "
                         "(the train phase's check; runs on older trees too)")
    ap.add_argument("--dist-only", action="store_true",
                    help="build, then run the dist phase alone (ranks sharing the card; "
                         "its kernels line holds flash_decode_partials only)")
    ap.add_argument("--dryrun-only", action="store_true",
                    help="build, then run the dryrun phase alone (steps counted on the "
                         "card against their traces on meta; no kernels line)")
    args = ap.parse_args(argv)
    sys.stdout.reconfigure(line_buffering=True)   # lines survive a kill

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build

    card = card_line()
    print(card)
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    so = _build.build()
    print(json.dumps({"build": str(so.relative_to(HERE)),
                      "build_s": time.perf_counter() - t0}))
    log = so.with_suffix(".log").read_text()
    for line in log.splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill")) \
                or line.startswith("=="):
            print(line.strip())
    spills = ptxas_spills(log)
    print(json.dumps({"ptxas_spills": spills}))
    if args.quant_only:
        quant_only(dev, card)
        return 0
    if args.promote_profile:
        promote_profile(dev, card)
        return 0
    if args.wkv_bwd_only:
        wkv6_backward_check(dev, card)
        return finish(spills)
    if args.train_only:
        print(json.dumps({"kernels": train_rows(train_phase(dev, card))}))
        return finish(spills)
    if args.dist_only:
        print(json.dumps({"kernels": [dist_row(dist_phase(card))]}))
        return finish(spills)
    if args.dryrun_only:
        dryrun_phase(dev, card)
        return finish(spills)

    t0 = time.perf_counter()
    kres = kernel_phase(dev, card)
    print(json.dumps({"kernel_phase_s": time.perf_counter() - t0}))
    sres = hres = rres = dres = ares = fres = tres = xres = None
    if args.decode_sweep:
        decode_sweep(dev)
    if args.prefill_sweep:
        prefill_sweep(dev)
    if args.wkv_sweep:
        wkv_sweep(dev)
    if args.quant_sweep:
        quant_sweep(dev)
    if args.rglru_sweep:
        rglru_sweep(dev)
    if not (args.kernels_only or args.decode_sweep or args.prefill_sweep
              or args.wkv_sweep or args.quant_sweep or args.rglru_sweep):
        sres = serve_phase(dev, card, args.profile)
        # the engine and executor hold each other: collect the cycle so the
        # next path's peak memory does not count the last path's leftovers
        gc.collect()
        torch.cuda.empty_cache()
        hres = hybrid_serve_phase(dev, card, args.profile)
        gc.collect()
        torch.cuda.empty_cache()
        rres = rwkv_serve_phase(dev, card, args.profile)
        gc.collect()
        torch.cuda.empty_cache()
        dres = dense_phase(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        ares = append_decode_phase(dev, card)
        t0 = time.perf_counter()
        fres = family_phase(dev, card, args.profile)
        print(json.dumps({"family_phase_s": time.perf_counter() - t0}))
        cli_phase(dev, card)
        sanitizer_cow_check(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        tres = train_phase(dev, card)
        gc.collect()
        torch.cuda.empty_cache()
        xres = dist_phase(card)
        dryrun_phase(dev, card)

    fp = ("src/repro_torch/csrc/flash_prefill.cu",
          "src/repro/kernels/flash_prefill/kernel.py:81")
    fd = ("src/repro_torch/csrc/flash_decode.cu",
          "src/repro/kernels/flash_decode/kernel.py:69")
    kr = ("src/repro_torch/csrc/kv_restore.cu", "src/repro/kernels/kv_restore/kernel.py:55")
    kd = ("src/repro_torch/csrc/kv_quant.cu", "src/repro/kernels/kv_quant/kernel.py:84")
    kq = ("src/repro_torch/csrc/kv_quant.cu", "src/repro/kernels/kv_quant/kernel.py:54")
    rg = ("src/repro_torch/csrc/rglru_scan.cu", "src/repro/kernels/rglru_scan/kernel.py:49")
    wk = ("src/repro_torch/csrc/wkv6.cu", "src/repro/kernels/rwkv6_scan/kernel.py:56")
    # (entry, the wrapper's count it reads, source, TPU kernel, the serve
    # whose shapes it has): the suffix and raw entries time the same wrapper
    # (kv_dequantize_run counts the run form apart)
    table = [("flash_prefill", "flash_prefill", *fp, sres),
             ("flash_prefill_suffix", "flash_prefill", *fp, sres),
             ("flash_decode", "flash_decode", *fd, sres),
             ("kv_restore", "kv_restore", *kr, sres),
             ("kv_restore_raw", "kv_restore", *kr, sres),
             ("kv_quantize", "kv_quantize", *kq, sres),
             ("kv_dequantize", "kv_dequantize", *kd, sres),
             ("kv_dequantize_run", "kv_dequantize_run", *kd, sres),
             ("flash_prefill_dh256", "flash_prefill", *fp, hres),
             ("flash_prefill_dh256_suffix", "flash_prefill", *fp, hres),
             ("flash_decode_dh256", "flash_decode", *fd, hres),
             ("rglru_scan", "rglru_scan", *rg, hres),
             ("rglru_scan_step", "rglru_scan_step", *rg, hres),
             ("wkv6", "wkv6", *wk, rres),
             ("wkv6_step", "wkv6_step", *wk, rres)]
    served_by = {**(dres or {}), **(fres or {})}
    for tag, arch, *_ in DENSE_SHAPES:
        served = served_by.get(arch)
        table += [(f"flash_prefill_{tag}", "flash_prefill", *fp, served),
                  (f"flash_prefill_{tag}_suffix", "flash_prefill", *fp, served),
                  (f"flash_decode_{tag}", "flash_decode", *fd, served)]
    for tag, arch, *_ in FAMILY_STORE:
        served = served_by.get(arch)
        table += [(f"kv_quantize_{tag}", "kv_quantize", *kq, served),
                  (f"kv_dequantize_{tag}", "kv_dequantize", *kd, served),
                  (f"kv_dequantize_run_{tag}", "kv_dequantize_run", *kd, served),
                  (f"kv_restore_{tag}", "kv_restore", *kr, served)]
    rows = []
    for name, counter, src, replaces, served in table:
        k = kres[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": served["launches"][counter] if served else None,
                     "path": served["arch"] if served else None,
                     "max_abs_err": k.get("max_abs_err"), "ms": k.get("ms"),
                     "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
                     "bound_by": k.get("bound_by"), "library_ms": k.get("library_ms"),
                     "bound_share": k["bound_ms"] / k["ms"],
                     **{x: k[x] for x in ("kernels_us", "cluster", "branch", "plan", "unit",
                                          "rows_a_thread", "rounding_ratio") if x in k}})
        if name == "rglru_scan" and served:
            rows[-1]["launches_by_S"] = served["rglru_scan_launches_by_S"]
    if ares is not None:
        k = ares["flash_decode_append"]
        rows.append({"name": "flash_decode_append", "route": "cuda", "source": fd[0],
                     "replaces": fd[1], "launches": ares["launches"]["flash_decode"],
                     "path": f"append decode {ares['arch']}",
                     **{x: k[x] for x in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms", "kernels_us",
                                          "kernels_us_warm", "n_split")},
                     "bound_share": k["bound_ms"] / k["ms"]})
    if tres is not None:
        rows += train_rows(tres)
    if xres is not None:
        rows.append(dist_row(xres))
    # own µs that no trace read: named, not left to pass as empty
    print(json.dumps({"kernels_us_missing": sorted(
        f"{name}.{key}" for name, k in kres.items() if isinstance(k, dict)
        for key, v in k.items() if key.startswith("kernels_us") and v is None)}))
    print(json.dumps({"kernels": rows}))
    return finish(spills)


def train_rows(tres: dict) -> list:
    """The kernels line's entries of the train phase: rglru_scan's call over
    reversed time (the backward of its gradient Function), timed at the
    hybrid's train shape, launches from the hybrid's train step; and wkv6's
    backward kernel, timed at the RWKV train shape (and, under ``long``, at
    S 4096), launches from the 2-layer rwkv6-7b train step."""
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "kernels_us", "kernels_us_warm")
    k = tres["rglru_backward"]
    b = tres["wkv6_backward"]
    return [{"name": "rglru_scan_reverse", "route": "cuda",
             "source": "src/repro_torch/csrc/rglru_scan.cu",
             "replaces": "src/repro/kernels/rglru_scan/kernel.py:49",
             "launches": tres["hybrid_step"]["launches"].get("rglru_scan_reverse", 0),
             "path": "train " + tres["hybrid_step"]["arch"],
             **{x: k[x] for x in keys + ("plan",)}, "bound_share": k["bound_ms"] / k["ms"]},
            {"name": "wkv6_backward", "route": "cuda",
             "source": "src/repro_torch/csrc/wkv6_bwd.cu",
             "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:56",
             "launches": tres["rwkv_step"]["launches"].get("wkv6_backward", 0),
             "path": "train " + tres["rwkv_step"]["arch"],
             **{x: b[x] for x in keys}, "bound_share": b["bound_ms"] / b["ms"],
             "long": {x: b["long"][x] for x in ("shape", "ms", "bound_ms", "bound_by",
                                                "kernels_us", "kernels_us_warm",
                                                "scratch_bytes", "max_abs_err")}}]


def dist_row(xres: dict) -> dict:
    """The kernels line's entry of the dist phase: flash_decode's partials
    mode timed at the per-rank shape, launches from rank 0's lse calls."""
    k = xres["timing"]
    return {"name": "flash_decode_partials", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_decode/kernel.py:69",
            "launches": xres["launches_by_rank"][0],
            "launches_by_rank": xres["launches_by_rank"],
            "path": f"lse_decode_attention over {xres['ranks']} ranks ({xres['backend']})",
            **{x: k[x] for x in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "kernels_us", "kernels_us_warm", "shape")},
            "bound_share": k["bound_ms"] / k["ms"]}


def finish(spills: dict) -> int:
    """Fail on a spilling instantiation; else print the ok/device record."""
    import torch
    for src in ("flash_prefill.cu", "wkv6.cu", "wkv6_bwd.cu", "kv_quant.cu", "kv_restore.cu",
                "rglru_scan.cu"):
        if spills.get(src):
            raise AssertionError(f"{src} spills: {spills[src]}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
