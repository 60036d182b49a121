#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py                   # build + kernel phase + serve phases
    python3 chip_smoke.py --kernels-only    # build + kernel phase only
    python3 chip_smoke.py --profile         # also trace one serve of each model
    python3 chip_smoke.py --decode-sweep    # kernel phase + flash_decode over S, B
    python3 chip_smoke.py --prefill-sweep   # kernel phase + flash_prefill over n_split
    python3 chip_smoke.py --wkv-sweep       # kernel phase + wkv6 over (chunk, cols)
    python3 chip_smoke.py --quant-sweep     # kernel phase + kv_quantize over (N, branch)
    python3 chip_smoke.py --rglru-sweep     # kernel phase + rglru_scan over (C, T, stages)
    python3 chip_smoke.py --quant-only      # build + kv_quantize alone (any tree)
    python3 chip_smoke.py --promote-profile # build + a traced qwen3 serve's promotion (any tree)

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
RWKV serve).  The second-to-last line of stdout is a ``{"kernels": [...]}``
summary; the last line is the ok/device record.
Any failure raises (exit code != 0).  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import itertools
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
# Largest |kernel - plain| the attention checks accept.  Outputs of the N(0,1)
# inputs reach 0.1-0.6.  Measured on an H100 (PERF.md): prefill differs by at
# most 1.95e-3, one bf16 step at its largest output 0.27 (the plain version
# rounds scores to bf16, the kernel keeps them in f32); decode, f32 in both
# but summed in another order over the splits of the cache, by at most
# 2.44e-4, one bf16 step of an output near 0.05.  The bounds are about twice
# and four times that.
PREFILL_TOL = 4e-3
DECODE_TOL = 1e-3
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


def kernels_us(fn, flush=None, iters: int = 5, match="flash_decode") -> dict:
    """Device time per call of each kernel ``fn`` launches whose name holds
    ``match`` (one substring or a tuple of them; torch.profiler), after
    ``flush`` as in ``time_ms`` or, without one, with the inputs warm in L2
    from the call before."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            if flush is not None:
                flush()
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        if any(m in e.key for m in ((match,) if isinstance(match, str) else match)) and us:
            name = e.key.replace("(anonymous namespace)::", "").split("(")[0]
            out[name.removeprefix("void ").split("::")[-1].strip()] = us / iters
    return out


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
    # version in f32 throughout)
    ref32 = flash_prefill_plain(q.float(), k.float(), v.float(), kpos, q_off, **kw)
    return dict(
        ms=ms,
        err_vs_f32=float((out.float() - ref32).abs().max()),
        plain_err_vs_f32=float((flash_prefill_plain(q, k, v, kpos, q_off, **kw).float()
                                - ref32).abs().max()),
        plain_ms=time_ms(lambda: flash_prefill_plain(q, k, v, kpos, q_off, **kw),
                         flush=flush, iters=7),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale), flush=flush),
        bound_ms=bms, bound_by=by, bound_share=bms / ms,
        kernels_us=kernels_us(call, flush, match="flash_prefill"),
        kernels_us_warm=kernels_us(call, match="flash_prefill"),
        m_tile=m_tile, n_split=n_split, split_slots=split_slots)


# ---------------------------------------------------------------------------
# Kernel phase: each kernel against its plain version at the path's shapes
# ---------------------------------------------------------------------------


def kernel_phase(dev, card: str) -> dict:
    import torch
    import torch.nn.functional as F
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
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)

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
    bms, by = bound(nbytes(qd, k, v, kpos, out), 4 * hq * dh * s)
    qdt = qd[:, :, None]
    ms = time_ms(lambda: flash_decode(qd, k, v, kpos, s - 1, scale=scale), flush=flush)
    def call():
        return flash_decode(qd, k, v, kpos, s - 1, scale=scale)
    probe = dict(kernels_us=kernels_us(call, flush), kernels_us_warm=kernels_us(call))
    res["flash_decode"] = dict(**probe,
        max_abs_err=err, tol=DECODE_TOL, cases=cases, ms=ms,
        plain_ms=time_ms(lambda: flash_decode_plain(qd, k, v, kpos, s - 1, scale=scale),
                         flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qdt, kt, vt, attn_mask=(kpos >= 0)[None], scale=scale), flush=flush),
        bound_ms=bms, bound_by=by, bound_share=bms / ms,
        n_split=_split_plan(1, hkv, s, sm)[1],
        shape=f"q (1,{hq},{dh}) over {s} slots, bf16")
    del q, k, v, qt, kt, vt

    # 3. kv_restore
    restore_cases(dev, g, flush, res)

    # 4. kv_quant
    quant_cases(dev, g, flush, res)

    hybrid_kernel_cases(dev, g, flush, res)
    rwkv_kernel_cases(dev, g, flush, res)

    for name, r in res.items():
        line = {("max_err" if k == "max_abs_err" else "kernel_ms" if k == "ms" else k): v
                for k, v in r.items()}
        print(json.dumps({"kernel_check": name, "card": card, **line}))
    # each entry's checked error is relative where it names one
    bad = [n for n, r in res.items()
           if not r.get("max_rel_err", r["max_abs_err"]) <= r["tol"]
           or r.get("bit_exact") is False or r.get("invariant_512") is False
           or r.get("finite") is False
           or not r.get("s_last_max_rel_err", 0.0) <= r.get("s_last_tol", 0.0)]
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
    import torch.nn.functional as F
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

    def sdpa_args(q4, k_, v_, kp, qpos):
        mask = (kp[None] >= 0) & (kp[None] <= qpos[:, None]) \
            & (kp[None] > qpos[:, None] - win)
        return (q4.transpose(1, 2), k_.transpose(1, 2).repeat_interleave(hq // hkv, 1),
                v_.transpose(1, 2).repeat_interleave(hq // hkv, 1), mask)

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
    bms, by = bound(nbytes(qd, k, v, kr, out), 4 * hq * dh * s)
    qt, kt, vt, mask = sdpa_args(qd[:, None], k, v, kr,
                                 torch.tensor([qp], device=dev))
    ms = time_ms(lambda: flash_decode(qd, k, v, kr, qp, **kw), flush=flush)
    def call():
        return flash_decode(qd, k, v, kr, qp, **kw)
    probe = dict(kernels_us=kernels_us(call, flush), kernels_us_warm=kernels_us(call))
    res["flash_decode_dh256"] = dict(**probe,
        max_abs_err=max(c["max_abs_err"] for c in cases), tol=DECODE_TOL,
        cases=cases, ms=ms,
        plain_ms=time_ms(lambda: flash_decode_plain(qd, k, v, kr, qp, **kw),
                         flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale), flush=flush),
        bound_ms=bms, bound_by=by, bound_share=bms / ms, n_split=n_split,
        shape=f"q (1,{hq},{dh}) over a {s}-slot ring at position {qp}, window {win}, bf16")
    del q, k, v, v2, qt, kt, vt, mask

    rglru_cases(dev, g, flush, res)


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
# rwkv6-7b is attention-free and takes no chunk store: only the two wkv6
# kernels may launch (chunked for prefill and recompute, one step for decode)
RWKV_KERNELS = ("wkv6", "wkv6_step")


def counters():
    """{name: (wrapper, its count attribute)}."""
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.kv_quant import kv_dequantize, kv_quantize
    from repro_torch.kernels.kv_restore import kv_restore_scatter
    from repro_torch.kernels.rglru_scan import rglru_scan
    from repro_torch.kernels.rwkv6_scan import wkv6
    return {"flash_prefill": (flash_prefill, "launches"),
            "flash_decode": (flash_decode, "launches"),
            "kv_restore": (kv_restore_scatter, "launches"),
            "kv_quantize": (kv_quantize, "launches"),
            "kv_dequantize": (kv_dequantize, "launches"),
            "kv_dequantize_run": (kv_dequantize, "run_launches"),
            "rglru_scan": (rglru_scan, "launches"),
            "rglru_scan_step": (rglru_scan, "step_launches"),
            "wkv6": (wkv6, "launches"), "wkv6_step": (wkv6, "step_launches")}


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
    one-chunk form (``ChunkStore._decode_device``)."""
    out = {n: getattr(w, attr) for n, (w, attr) in counters().items()}
    out["kv_dequantize_chunk"] = out["kv_dequantize"] - out["kv_dequantize_run"]
    out["wkv6"] -= out["wkv6_step"]
    out["rglru_scan"] -= out["rglru_scan_step"]
    return out


# substrings of the port's CUDA kernel names in a profiler trace
PORT_KERNEL_NAMES = ("flash_prefill", "flash_decode", "kv_restore", "kv_quantize",
                     "kv_dequantize", "rglru_scan", "wkv6")
# record_function ranges of a traced qwen3 serve: the kernels each launched
# (the datapath's promotion of transfer runs, and within it the pool's copies)
PROMOTE_RANGES = ("promote_run", "promote_staged")


@contextlib.contextmanager
def promote_ranges():
    """RestoreDatapath._promote_run and ChunkStore.promote_staged run inside
    record_function ranges named as PROMOTE_RANGES."""
    from torch.profiler import record_function

    from repro_torch.core.datapath import RestoreDatapath
    from repro_torch.storage import ChunkStore

    run_sm, staged_fn = RestoreDatapath.__dict__["_promote_run"], ChunkStore.promote_staged

    def promote_run(*args, **kw):
        with record_function(PROMOTE_RANGES[0]):
            return run_sm.__func__(*args, **kw)

    def promote_staged(self, *args, **kw):
        with record_function(PROMOTE_RANGES[1]):
            return staged_fn(self, *args, **kw)
    RestoreDatapath._promote_run = staticmethod(promote_run)
    ChunkStore.promote_staged = promote_staged
    try:
        yield
    finally:
        RestoreDatapath._promote_run = run_sm
        ChunkStore.promote_staged = staged_fn


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
    quantization on the host tier, verify on; returns (engine, store,
    requests, report, seconds).  Only interfaces older trees share, so that
    ``--promote-profile`` runs there too."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ChunkStore, RealServingEngine, Request

    cfg = get_config("qwen3-8b")
    model = Model(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                  device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))

    def serve(quant):
        store = ChunkStore(chunk_size=16, quant=quant, default_tier="host", device=dev)
        eng = RealServingEngine(model, params, system="cacheflow", stages=2,
                                chunk_size=256, l_delta=1024, max_batch=2,
                                kvstore=store, datapath="fused", device=dev, seed=0)
        reqs = [Request(f"r{n}", 0.0, n, 64, decode_len=16)
                for n in (512, 1536, 2560, 4096)]
        t0 = time.perf_counter()
        rep = eng.serve(reqs, verify=True)
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

    t0 = time.perf_counter()
    cfg, model, params, serve = qwen3_server(dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.num_params(params)

    # the main path: every launch counter from 0 just before, read just after
    zero_counters()
    torch.cuda.reset_peak_memory_stats()
    eng, store, reqs, rep, serve_s = serve("int8")
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
        with promote_ranges():
            print(json.dumps({"profile": profile_serve(lambda: serve("int8"),
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
    return result


def promote_profile(dev, card: str) -> dict:
    """qwen3-8b's int8 serve once untraced, then once traced with the
    datapath's promotion inside PROMOTE_RANGES: the device time of what
    ``_promote_run`` launches (its dequantize launches and copies, and the
    pool's block writes under ``promote_staged``) and of each port kernel.
    Uses only what older trees share, so the script copied into an older
    checkout measures that tree the same way.  ``dequant_kernel`` is the
    one-chunk dequantize kernel's name before it shared dequant_rows.cuh."""
    import torch
    _, _, _, serve = qwen3_server(dev)
    serve("int8")
    with promote_ranges():
        prof = profile_serve(lambda: serve("int8"), ranges=PROMOTE_RANGES,
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
                         "time of the datapath's promotion (runs on older trees too)")
    ap.add_argument("--quant-only", action="store_true",
                    help="build, then check and time kv_quantize alone at the serve's "
                         "chunk through its public call (runs on older trees too)")
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

    t0 = time.perf_counter()
    kres = kernel_phase(dev, card)
    print(json.dumps({"kernel_phase_s": time.perf_counter() - t0}))
    sres = hres = rres = None
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

    # (kernel-phase entry, source, TPU kernel, the serve whose shapes it has)
    fp = ("src/repro_torch/csrc/flash_prefill.cu",
          "src/repro/kernels/flash_prefill/kernel.py:81")
    fd = ("src/repro_torch/csrc/flash_decode.cu",
          "src/repro/kernels/flash_decode/kernel.py:69")
    kr = ("src/repro_torch/csrc/kv_restore.cu", "src/repro/kernels/kv_restore/kernel.py:55")
    kd = ("src/repro_torch/csrc/kv_quant.cu", "src/repro/kernels/kv_quant/kernel.py:84")
    table = [("flash_prefill", *fp, sres), ("flash_prefill_suffix", *fp, sres),
             ("flash_decode", *fd, sres),
             ("kv_restore", *kr, sres), ("kv_restore_raw", *kr, sres),
             ("kv_quantize", "src/repro_torch/csrc/kv_quant.cu",
              "src/repro/kernels/kv_quant/kernel.py:54", sres),
             ("kv_dequantize", *kd, sres), ("kv_dequantize_run", *kd, sres),
             ("flash_prefill_dh256", *fp, hres), ("flash_prefill_dh256_suffix", *fp, hres),
             ("flash_decode_dh256", *fd, hres),
             ("rglru_scan", "src/repro_torch/csrc/rglru_scan.cu",
              "src/repro/kernels/rglru_scan/kernel.py:49", hres),
             ("rglru_scan_step", "src/repro_torch/csrc/rglru_scan.cu",
              "src/repro/kernels/rglru_scan/kernel.py:49", hres),
             ("wkv6", "src/repro_torch/csrc/wkv6.cu",
              "src/repro/kernels/rwkv6_scan/kernel.py:56", rres),
             ("wkv6_step", "src/repro_torch/csrc/wkv6.cu",
              "src/repro/kernels/rwkv6_scan/kernel.py:56", rres)]
    rows = []
    for name, src, replaces, served in table:
        k = kres[name]
        # the suffix and raw entries time the same wrapper: its count covers
        # both (kv_dequantize_run counts the run form apart)
        counter = name.replace("_dh256", "").replace("_suffix", "").replace("_raw", "")
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": served["launches"][counter] if served else None,
                     "path": served["arch"] if served else None,
                     "max_abs_err": k.get("max_abs_err"), "ms": k.get("ms"),
                     "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
                     "bound_by": k.get("bound_by"), "library_ms": k.get("library_ms"),
                     "bound_share": k["bound_ms"] / k["ms"],
                     **{x: k[x] for x in ("kernels_us", "cluster", "branch", "plan", "unit",
                                          "rows_a_thread") if x in k}})
        if name == "rglru_scan" and served:
            rows[-1]["launches_by_S"] = served["rglru_scan_launches_by_S"]
    print(json.dumps({"kernels": rows}))
    for src in ("flash_prefill.cu", "wkv6.cu", "kv_quant.cu", "kv_restore.cu", "rglru_scan.cu"):
        if spills.get(src):
            raise AssertionError(f"{src} spills: {spills[src]}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
