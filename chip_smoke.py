#!/usr/bin/env python3
"""On-card smoke test of the PyTorch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py                   # build + kernel phase + serve phase
    python3 chip_smoke.py --kernels-only    # build + kernel phase only
    python3 chip_smoke.py --profile         # also trace one serve

It builds every kernel of the port from ``src/repro_torch/csrc`` with
``nvcc``, holds each kernel against its plain PyTorch version at the main
path's shapes (qwen3-8b: Hq 32, Hkv 8, Dh 128, bf16), then serves four
requests through ``RealServingEngine`` on qwen3-8b at full width and
depth with random bf16 weights (CacheFlow two-pointer restoration from an int8 chunk store, suffix
prefill, greedy decode, every restored cache verified) and checks that each
kernel launched during the serve.  The second-to-last line of stdout is a
``{"kernels": [...]}`` summary; the last line is the ok/device record.
Any failure raises (exit code != 0).  Imports nothing of JAX or ``repro``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory (data sheet)
BF16_FLOP_PER_S = 989e12       # H100 SXM dense bf16 tensor-core peak
# Largest |kernel - plain| the attention checks accept.  Outputs of the N(0,1)
# inputs reach 0.1-0.3.  Measured on an H100 (PERF.md): prefill differs by at
# most 1.95e-3, one bf16 step at its largest output 0.27 (the plain version
# rounds scores to bf16, the kernel keeps them in f32); decode, f32 in both,
# by at most 1.2e-4.  The bounds are about twice and eight times that.
PREFILL_TOL = 4e-3
DECODE_TOL = 1e-3


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], check=True,
                         capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, *, iters: int = 21, flush=None):
    """Median device time of ``fn`` over ``iters`` launches, CUDA events
    around each launch; ``flush`` (run outside the timed window) evicts L2
    first so the kernel finds its inputs in device memory, as the serving
    path does."""
    import statistics

    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        if flush is not None:
            flush()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# Kernel phase: each kernel against its plain version at the path's shapes
# ---------------------------------------------------------------------------


def kernel_phase(dev, card: str) -> dict:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode, flash_decode_plain
    from repro_torch.kernels.flash_prefill import flash_prefill, flash_prefill_plain
    from repro_torch.kernels.kv_quant import (kv_dequantize, kv_dequantize_plain,
                                              kv_quantize, kv_quantize_plain)
    from repro_torch.kernels.kv_restore import kv_restore_plain, kv_restore_scatter

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
    # prefix in a cache grown to 3100 slots (trailing empty slots)
    sq, q_off = 256, s - 256
    q = randn(1, sq, hq, dh)
    k = randn(1, s, hkv, dh)
    v = randn(1, s, hkv, dh)
    kpos = torch.arange(s, dtype=torch.int32, device=dev)
    out = flash_prefill(q, k, v, kpos, q_off, scale=scale)
    ref = flash_prefill_plain(q, k, v, kpos, q_off, scale=scale)
    cases = [dict(max_abs_err=float((out.float() - ref.float()).abs().max()),
                  max_abs_ref=float(ref.float().abs().max()), slots=s,
                  valid=s, at=q_off),
             attn_case(flash_prefill, flash_prefill_plain, randn(1, 200, hq, dh),
                       4150, 3000, 1223, 1024),
             attn_case(flash_prefill, flash_prefill_plain, randn(1, 64, hq, dh),
                       3100, 3064, 3063, 3000)]
    torch.cuda.synchronize()
    err = max(c["max_abs_err"] for c in cases)
    qpos = q_off + torch.arange(sq, device=dev)
    pairs = int(((kpos[None] >= 0) & (kpos[None] <= qpos[:, None])).sum())
    bms, by = bound(nbytes(q, k, v, kpos, out), 4 * hq * dh * pairs)
    qt = q.transpose(1, 2)
    kt = k.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    vt = v.transpose(1, 2).repeat_interleave(hq // hkv, dim=1)
    mask = (kpos[None] <= qpos[:, None]) & (kpos[None] >= 0)
    res["flash_prefill"] = dict(
        max_abs_err=err, tol=PREFILL_TOL, cases=cases,
        ms=time_ms(lambda: flash_prefill(q, k, v, kpos, q_off, scale=scale), flush=flush),
        plain_ms=time_ms(lambda: flash_prefill_plain(q, k, v, kpos, q_off, scale=scale),
                         flush=flush, iters=7),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, scale=scale), flush=flush),
        bound_ms=bms, bound_by=by,
        shape=f"q (1,{sq},{hq},{dh}) over {s} keys, q_offset {q_off}, bf16")

    # 2. flash_decode: one token over 4096 slots (timed), then a check at
    # position 3000 of a 4096-slot cache whose slots run to 3500: slots
    # 3001-3499 are masked by position, 3500 on are empty
    qd = randn(1, hq, dh)
    out = flash_decode(qd, k, v, kpos, s - 1, scale=scale)
    ref = flash_decode_plain(qd, k, v, kpos, s - 1, scale=scale)
    cases = [dict(max_abs_err=float((out.float() - ref.float()).abs().max()),
                  max_abs_ref=float(ref.float().abs().max()), slots=s,
                  valid=s, at=s - 1),
             attn_case(flash_decode, flash_decode_plain, qd, s, 3500, 3000, 3000)]
    torch.cuda.synchronize()
    err = max(c["max_abs_err"] for c in cases)
    bms, by = bound(nbytes(qd, k, v, kpos, out), 4 * hq * dh * s)
    qdt = qd[:, :, None]
    res["flash_decode"] = dict(
        max_abs_err=err, tol=DECODE_TOL, cases=cases,
        ms=time_ms(lambda: flash_decode(qd, k, v, kpos, s - 1, scale=scale), flush=flush),
        plain_ms=time_ms(lambda: flash_decode_plain(qd, k, v, kpos, s - 1, scale=scale),
                         flush=flush),
        library_ms=time_ms(lambda: F.scaled_dot_product_attention(
            qdt, kt, vt, attn_mask=(kpos >= 0)[None], scale=scale), flush=flush),
        bound_ms=bms, bound_by=by, shape=f"q (1,{hq},{dh}) over {s} slots, bf16")
    del q, k, v, qt, kt, vt, mask

    # 3. kv_restore: one int8 load op of 256 tokens x 18 slots (stage 0 of 2)
    a, t, t0, cs, ns, c = 36, 256, 1024, 16, 18, hkv * dh
    caches = [torch.randn(a, s, c, generator=g, device=dev).to(bf) for _ in range(2)]
    staged = [torch.randint(-127, 128, (a, t, c), generator=g, device=dev,
                            dtype=torch.int8) for _ in range(2)]
    scl = [torch.rand(t // cs, c, generator=g, device=dev) * 0.05 for _ in range(2)]
    kw = dict(t0=t0, slot_lo=0, n_slots=ns, chunk_size=cs)
    got = [x.clone() for x in caches]
    want = [x.clone() for x in caches]
    kv_restore_scatter(got, staged, scl, **kw)
    kv_restore_plain(want, staged, scl, **kw)
    raw = [x.to(bf) for x in staged]
    got_raw = [x.clone() for x in caches]
    want_raw = [x.clone() for x in caches]
    kv_restore_scatter(got_raw, raw, None, **kw)
    kv_restore_plain(want_raw, raw, None, **kw)
    torch.cuda.synchronize()
    exact = all(torch.equal(x, y) for x, y in zip(got + got_raw, want + want_raw))
    err = max(float((x.float() - y.float()).abs().max()) for x, y in zip(got, want))
    moved = 2 * (ns * t * c * (1 + 2)) + nbytes(*scl)
    bms, by = bound(moved, 2 * ns * t * c)
    res["kv_restore"] = dict(
        max_abs_err=err, tol=0.0, bit_exact=exact,
        ms=time_ms(lambda: kv_restore_scatter(got, staged, scl, **kw), flush=flush),
        plain_ms=time_ms(lambda: kv_restore_plain(want, staged, scl, **kw), flush=flush),
        library_ms=None, bound_ms=bms, bound_by=by,
        shape=f"int8 (36,{t},{c}) x2 fields -> slots 0..{ns} of bf16 (36,{s},{c}) at t0 {t0}")
    del caches, staged, got, want, raw, got_raw, want_raw

    # 4. kv_quant: one 16-token chunk of all 36 layers' K
    x = (torch.randn(a, 1, cs, hkv, dh, generator=g, device=dev) * 3).to(bf)
    qk, sk = kv_quantize(x)
    qp, sp = kv_quantize_plain(x)
    dk = kv_dequantize(qk, sk, bf)
    dp = kv_dequantize_plain(qp, sp, bf)
    torch.cuda.synchronize()
    exact_q = torch.equal(qk, qp) and torch.equal(sk, sp)
    exact_d = torch.equal(dk, dp)
    bms, by = bound(nbytes(x, qk, sk), 3 * x.numel())
    res["kv_quantize"] = dict(
        max_abs_err=float((qk.float() - qp.float()).abs().max()), tol=0.0,
        bit_exact=exact_q,
        ms=time_ms(lambda: kv_quantize(x), flush=flush),
        plain_ms=time_ms(lambda: kv_quantize_plain(x), flush=flush),
        library_ms=None, bound_ms=bms, bound_by=by,
        shape=f"x (36,1,{cs},{hkv},{dh}) bf16 -> int8 + f32 ({dh},)")
    bms, by = bound(nbytes(qk, sk, dk), x.numel())
    res["kv_dequantize"] = dict(
        max_abs_err=float((dk.float() - dp.float()).abs().max()), tol=0.0,
        bit_exact=exact_d,
        ms=time_ms(lambda: kv_dequantize(qk, sk, bf), flush=flush),
        plain_ms=time_ms(lambda: kv_dequantize_plain(qk, sk, bf), flush=flush),
        library_ms=None, bound_ms=bms, bound_by=by,
        shape=f"q (36,1,{cs},{hkv},{dh}) int8 -> bf16")

    for name, r in res.items():
        line = {("max_err" if k == "max_abs_err" else "kernel_ms" if k == "ms" else k): v
                for k, v in r.items()}
        print(json.dumps({"kernel_check": name, "card": card, **line}))
    bad = [n for n, r in res.items()
           if not r["max_abs_err"] <= r["tol"] or r.get("bit_exact") is False]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: {bad}")
    return res


# ---------------------------------------------------------------------------
# Serve phase: the port's main path at full width
# ---------------------------------------------------------------------------


def counters():
    from repro_torch.kernels.flash_decode import flash_decode
    from repro_torch.kernels.flash_prefill import flash_prefill
    from repro_torch.kernels.kv_quant import kv_dequantize, kv_quantize
    from repro_torch.kernels.kv_restore import kv_restore_scatter
    return {"flash_prefill": flash_prefill, "flash_decode": flash_decode,
            "kv_restore": kv_restore_scatter, "kv_quantize": kv_quantize,
            "kv_dequantize": kv_dequantize}


def profile_serve(serve) -> dict:
    """One more serve under torch.profiler: device time by kernel and the
    share of the traced wall time the device spent in kernels and copies
    (summed over streams).  Separate from the timed runs: tracing slows
    the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve("int8")
        wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        if "CUDA" not in str(getattr(e, "device_type", "")):
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((us, e.count, e.key[:80]))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    return dict(traced_wall_s=wall, device_s=busy,
                device_share=busy / wall if wall else None,
                top=[dict(name=n, calls=c, device_ms=us / 1e3) for us, c, n in rows[:15]])


def serve_phase(dev, card: str, profile: bool = False) -> dict:
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import Model
    from repro_torch.serving import ChunkStore, RealServingEngine, Request

    cfg = get_config("qwen3-8b")
    t0 = time.perf_counter()
    model = Model(cfg, param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
                  device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = model.num_params(params)
    wrappers = counters()

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

    # the main path: every launch counter from 0 just before, read just after
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    eng, store, reqs, rep, serve_s = serve("int8")
    launches = {n: w.launches for n, w in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    # the same requests from an unquantized store: loads are then raw copies,
    # so verify's error is the recompute path's own (token- vs layer-wise)
    eng_raw, _, _, _, raw_s = serve("none")
    recompute_err = eng_raw.executor.verify_errs
    if profile:
        print(json.dumps({"profile": profile_serve(serve)}))

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
        card=card, layers=cfg.num_layers, d_model=cfg.d_model,
        params=n_params, init_s=init_s, serve_s=serve_s, serve_none_s=raw_s,
        peak_mem_gb=peak_gb, stats=rep.stats, compute_busy=rep.compute_busy,
        io_busy=rep.io_busy, decode_busy=rep.decode_busy,
        overlap_decode_restore=rep.overlap_decode_restore,
        ttfts=rep.ttfts, restore_secs=rep.restore_secs,
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
    missing = [n for n, c in launches.items() if c == 0]
    if missing:
        raise AssertionError(f"kernels not launched during serve: {missing}")
    if sorted(set(strategies.values())) != ["layer", "token"]:
        raise AssertionError(f"expected layer- and token-wise plans: {strategies}")
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels-only", action="store_true",
                    help="build and check the kernels, skip the serve")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one serve with torch.profiler")
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
    for line in so.with_suffix(".log").read_text().splitlines():
        if "registers" in line or line.startswith("=="):
            print(line.strip())

    t0 = time.perf_counter()
    kres = kernel_phase(dev, card)
    print(json.dumps({"kernel_phase_s": time.perf_counter() - t0}))
    sres = None if args.kernels_only else serve_phase(dev, card, args.profile)

    sources = {"flash_prefill": ("src/repro_torch/csrc/flash_prefill.cu",
                                 "src/repro/kernels/flash_prefill/kernel.py:81"),
               "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                                "src/repro/kernels/flash_decode/kernel.py:69"),
               "kv_restore": ("src/repro_torch/csrc/kv_restore.cu",
                              "src/repro/kernels/kv_restore/kernel.py:55"),
               "kv_quantize": ("src/repro_torch/csrc/kv_quant.cu",
                               "src/repro/kernels/kv_quant/kernel.py:54"),
               "kv_dequantize": ("src/repro_torch/csrc/kv_quant.cu",
                                 "src/repro/kernels/kv_quant/kernel.py:84")}
    rows = []
    for name, (src, replaces) in sources.items():
        k = kres[name]
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": replaces,
                     "launches": sres["launches"][name] if sres else None,
                     "max_abs_err": k.get("max_abs_err"), "ms": k.get("ms"),
                     "plain_ms": k.get("plain_ms"), "bound_ms": k.get("bound_ms"),
                     "bound_by": k.get("bound_by"), "library_ms": k.get("library_ms")})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
