"""The port's distribution layer held to the JAX reference on the CPU, f32.

Four ranks (``tests/_torch_dist_worker.py``) are spawned once for the
module with ``torch.multiprocessing`` over gloo through a file rendezvous
under ``tmp_path``, one intra-op thread each, and run every job in turn:

* one sharded train step (``make_train_step`` on DTensor parameters,
  optimizer state and batch placed by ``param_pspecs`` / ``opt_pspecs`` /
  ``data_pspecs``, under ``use_mesh``) and one sharded ``decode_step``
  (cache placed by ``cache_pspecs``: kv-heads over "model") on a (2, 2)
  data x model mesh, against the reference's single-device ``jit(step)``
  and ``decode_step`` — the reference test's config (reduced qwen1.5-0.5b,
  4 heads, 4 kv-heads, d_model 128, d_ff 256, B 8, S 32) and tolerances:
  every leaf 2e-4, loss 1e-4, logits 2e-3 — with remat "none" (the
  reference test's) and "dots" (the selective checkpoint on DTensors);
* ``decode_step_append`` on a (1, 4) mesh for reduced qwen3-8b (2
  kv-heads: the cache is sharded along its sequence, 16 of its 64 slots a
  rank, the last rank's shard holding no visible slot): 8 greedy steps
  into a 16-slot tail against the reference's single-device append
  decode, logits 2e-5 every step, the same greedy tokens, the tail's k/v
  2e-5 and its kpos equal, and every layer's attention through
  ``lse_decode_attention`` (the LSE branch, not the concatenation);
* ``lse_decode_attention`` alone on (1, 4) (with and without a tail, a
  window, a shard with no visible slot, rows with no visible slot on any
  rank) against the reference's own sharded run on a (1, 4) mesh with Auto
  axes in a subprocess of 8 host devices, within 1e-6;
* ``error_feedback_psum`` over the 4 ranks against the mean of the
  reference's ``compress_decompress`` of each rank's input (1e-6), the
  residuals equal;
* parameters placed on (2, 2), checkpointed (gathered to the host),
  restored and re-placed on (1, 4): bit-equal;
* ``io_channel_ranks`` on both meshes against the reference's
  ``io_channel_devices`` device ids;
* one ``decode_step`` a case on (1, 4) against the port's own step in one
  process: reduced qwen3-8b with 4 kv-heads (the cache's heads over
  "model": ``flash_decode`` on each rank's heads), recurrentgemma-2b (MQA:
  the cache along its sequence, ``flash_decode_partials`` and the LSE
  combine; the RG-LRU scan on each rank's 32 of 128 lanes) and rwkv6-7b
  (``wkv6`` on each rank's head), every kernel wrapper spied to have been
  handed local tensors only (ROUTING_TOL).

In process: ``flash_decode_partials_plain`` against the reference's
``_partial_decode``; ``compress_decompress`` bit-equal to the reference's
(residual included); the error-feedback convergence test of
``tests/test_training.py`` on the port.
"""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.distributed.collectives import _partial_decode  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.kvcache import grow_cache as j_grow_cache  # noqa: E402
from repro.training import AdamWConfig as JAdamW  # noqa: E402
from repro.training import init_opt_state as j_init_opt  # noqa: E402
from repro.training import make_train_step as j_make_step  # noqa: E402
from repro.training.compression import compress_decompress as j_compress  # noqa: E402
from repro_torch.kernels.flash_decode import flash_decode_partials_plain  # noqa: E402
from repro_torch.models import params_from_jax  # noqa: E402
from repro_torch.models.model import _leaves  # noqa: E402
from repro_torch.training.compression import compress_decompress  # noqa: E402

import _torch_dist_worker  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
OVERRIDES = dict(num_heads=4, num_kv_heads=4, d_model=128, d_ff=256)
B, S = 8, 32                      # the train batch (S + 1 tokens a row)
A_B, A_PREFIX, A_SLOTS, A_WINDOW, A_STEPS = 2, 40, 64, 16, 8
APPEND_TOL = 2e-5
# sharded decode_step on (1, 4) against one process: reduced configs (qwen3-8b
# with 4 kv-heads so that they divide the ranks), B 4, a 40-token prefix in a
# 64-slot cache
ROUTING = {"heads": ("qwen3-8b", {"num_heads": 8, "num_kv_heads": 4}),
           "sequence": ("recurrentgemma-2b", {}),
           "wkv_heads": ("rwkv6-7b", {})}
R_B, R_PREFIX = 4, 40
# The logits and every cache field within ROUTING_TOL (f32) of one
# process's, relative to the field's largest magnitude (at least 1): the
# output projections' products (wo, w_out, w_o, cm_v) sum over
# "model"-sharded inputs on each rank and an all-reduce adds the partial
# sums, in another order than one product over the whole inputs, and the
# next layers carry that rounding on (the wkv state reaches |20|).
# The fields no sum over a sharded dim reaches (kpos; the cache rows each
# rank writes from its own heads) are held bit for bit where listed.
ROUTING_TOL = 1e-5
ROUTING_EXACT = {"heads": ("kpos",), "sequence": ("kpos",), "wkv_heads": ()}
# gqa_flash on (1, 4): (Hq, Hkv, window) -> q's heads over "model" with the
# KV heads each rank's heads group with (2 of 8 heads a rank over 2 KV heads;
# MQA; KV heads sharded with them), or its rows when the heads do not divide
GQA_CASES = {"grouped": (8, 2, 0), "mqa": (8, 1, 5), "kv_sharded": (8, 4, 0),
             "rows": (6, 2, 0)}
GQA_TOL = 1e-6
# the wrappers each case must reach (each call with local tensors only)
ROUTING_KERNELS = {"heads": {"flash_decode"},
                   "sequence": {"flash_decode_partials", "rglru_scan_grad"},
                   "wkv_heads": {"wkv6"}}
LSE_TOL = 1e-6


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


def _lse_cases():
    """Inputs of the lse cases: B 2, Hq 4, Hkv 2, Dh 32, 64 slots (16 a
    rank), a tail of 8."""
    rng = np.random.default_rng(7)
    b, hq, hkv, dh, s, t = 2, 4, 2, 32, 64, 8

    def case(kpos, q_pos, window=0, tail_kpos=None):
        c = {"q": rng.normal(size=(b, 1, hq, dh)).astype(np.float32),
             "k": rng.normal(size=(b, s, hkv, dh)).astype(np.float32),
             "v": rng.normal(size=(b, s, hkv, dh)).astype(np.float32),
             "kpos": np.asarray(kpos, np.int32), "q_pos": q_pos, "window": window,
             "scale": 1.0 / np.sqrt(dh)}
        if tail_kpos is not None:
            c["tk"] = rng.normal(size=(b, t, hkv, dh)).astype(np.float32)
            c["tv"] = rng.normal(size=(b, t, hkv, dh)).astype(np.float32)
            c["tkp"] = np.asarray(tail_kpos, np.int32)
        return c

    kp = np.arange(s)
    kp[5:9] = -1
    empty = np.arange(s)
    empty[16:32] = -1                          # rank 1's whole shard
    return {
        "plain": case(kp, 50),
        "tail": case(kp, 66, tail_kpos=[64, 65, 66, -1, -1, -1, -1, -1]),
        "window": case(kp, 50, window=20, tail_kpos=[-1] * t),
        "empty_shard": case(empty, 60, tail_kpos=[64, -1, -1, -1, -1, -1, -1, -1]),
        "nothing_visible": case(np.arange(10, 10 + s), 5,
                                tail_kpos=[70, 71, -1, -1, -1, -1, -1, -1]),
        "nothing_visible_no_tail": case(np.arange(10, 10 + s), 5),
    }


def _reference_subprocess(job_dir):
    """The reference's sharded lse run and io-channel devices on meshes
    with Auto axes, in a process of 8 host devices."""
    code = textwrap.dedent(f"""
        import json, pickle
        import jax, jax.numpy as jnp, numpy as np
        from jax.sharding import Mesh, AxisType
        from repro.distributed.collectives import lse_decode_attention
        from repro.distributed.sharding import io_channel_devices
        cases = pickle.load(open({str(job_dir / 'lse.pkl')!r}, 'rb'))
        devs = np.array(jax.devices()[:4])
        auto = (AxisType.Auto, AxisType.Auto)
        meshes = {{(2, 2): Mesh(devs.reshape(2, 2), ('data', 'model'), axis_types=auto),
                   (1, 4): Mesh(devs.reshape(1, 4), ('data', 'model'), axis_types=auto)}}
        out = {{'lse': {{}}, 'io': {{}}}}
        for name, c in cases.items():
            tail = None
            if 'tk' in c:
                tail = (jnp.asarray(c['tk']), jnp.asarray(c['tv']), jnp.asarray(c['tkp']))
            qp = jnp.full((c['q'].shape[0], 1), c['q_pos'], jnp.int32)
            with meshes[(1, 4)]:
                o = lse_decode_attention(jnp.asarray(c['q']), jnp.asarray(c['k']),
                                         jnp.asarray(c['v']), jnp.asarray(c['kpos']), qp,
                                         scale=c['scale'], window=c['window'], tail=tail)
            out['lse'][name] = np.asarray(o)
        for shape, mesh in meshes.items():
            for n in (None, 1, 3, 8):
                out['io'][(shape, n)] = [d.id for d in io_channel_devices(mesh, n)]
        pickle.dump(out, open({str(job_dir / 'ref.pkl')!r}, 'wb'))
    """)
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Spawn the ranks and the reference subprocess, compute the
    single-device reference meanwhile; returns (ranks' outputs, reference)."""
    d = tmp_path_factory.mktemp("dist")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    ref = {}
    try:
        # ---- the train / decode job and its reference
        cfg_j = j_get_config("qwen1.5-0.5b").reduced(**OVERRIDES)
        jm = j_build(cfg_j)
        jp = jm.init(jax.random.PRNGKey(0))
        tree = _tree_np(jp)
        rng = np.random.default_rng(0)
        tokens = rng.integers(0, cfg_j.vocab_size, (B, S + 1)).astype(np.int32)
        last, cache = jax.jit(jm.prefill)(jp, jnp.asarray(tokens[:, :16]))
        cache = j_grow_cache(cfg_j, cache, 32)
        dec_tok = np.asarray(jnp.argmax(last, -1)).astype(np.int32)
        # ---- append decode: reduced qwen3-8b, a prefix grown to 64 slots
        cfg_a = j_get_config("qwen3-8b").reduced()
        am = j_build(cfg_a)
        ap = am.init(jax.random.PRNGKey(1))
        a_x = np.random.default_rng(3).integers(0, cfg_a.vocab_size,
                                                (A_B, A_PREFIX)).astype(np.int32)
        a_last, a_cache = jax.jit(am.prefill)(ap, jnp.asarray(a_x))
        a_cache = j_grow_cache(cfg_a, a_cache, A_SLOTS)
        a_tok0 = np.asarray(jnp.argmax(a_last, -1)).astype(np.int32)
        lse = _lse_cases()
        ef_x = np.random.default_rng(5).normal(size=(WORLD, 4096 * 3 + 100)).astype(np.float32)
        prompts = np.random.default_rng(9)
        routing = {name: {"arch": arch, "overrides": ov, "slots": 64,
                          "prompt": prompts.integers(0, 512, (R_B, R_PREFIX)).astype(np.int32)}
                   for name, (arch, ov) in ROUTING.items()}
        g_rng = np.random.default_rng(13)
        gqa = {name: {"q": g_rng.normal(size=(2, 16, hq, 16)).astype(np.float32),
                      "k": g_rng.normal(size=(2, 16, hk, 16)).astype(np.float32),
                      "v": g_rng.normal(size=(2, 16, hk, 16)).astype(np.float32),
                      "window": window}
               for name, (hq, hk, window) in GQA_CASES.items()}
        job = {
            "routing": routing,
            "gqa_local": gqa,
            "train": {"overrides": OVERRIDES, "params": tree, "tokens": tokens,
                      "remat": ("none", "dots"), "dec_cache": _tree_np(cache),
                      "dec_tok": dec_tok, "dec_pos": 16},
            "append": {"params": _tree_np(ap), "cache": _tree_np(a_cache), "tok0": a_tok0,
                       "prefix": A_PREFIX, "steps": A_STEPS, "window": A_WINDOW},
            "lse": lse,
            "ef": {"x": ef_x},
        }
        with open(d / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        with open(d / "lse.pkl", "wb") as f:
            pickle.dump(lse, f)
        sub = _reference_subprocess(d)
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_torch_dist_worker.main, args=(r, WORLD, str(d / "job.pkl")))
                 for r in range(WORLD)]
        for p in procs:
            p.start()
        # ---- single-device references, while the ranks run
        step = j_make_step(jm, JAdamW(total_steps=10))
        p_ref, _, m_ref = jax.jit(step)(jp, j_init_opt(jp), {"tokens": jnp.asarray(tokens)})
        ref["leaves"] = [t.numpy() for t in _leaves(params_from_jax(_tree_np(p_ref),
                                                                    device="cpu"))]
        ref["loss"] = float(m_ref["loss"])
        ref["decode_logits"] = np.asarray(jax.jit(jm.decode_step)(
            jp, jnp.asarray(dec_tok), cache, 16)[0])
        a_step = jax.jit(am.decode_step_append)
        tail, tok, logits, toks = am.init_tail(A_B, A_WINDOW), a_tok0, [], []
        for i in range(A_STEPS):
            lg, tail = a_step(ap, jnp.asarray(tok), a_cache, tail, i, A_PREFIX + i)
            logits.append(np.asarray(lg))
            tok = np.asarray(jnp.argmax(lg, -1)).astype(np.int32)
            toks.append(tok)
        ref["append"] = {"logits": logits, "tokens": toks, "tail": _tree_np(tail)}
        ref["ef"] = [tuple(np.asarray(a) for a in j_compress(jnp.asarray(x))) for x in ef_x]
        for p in procs:
            p.join(timeout=600)
        alive = [p.pid for p in procs if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.kill()
        assert not alive, f"ranks {alive} did not finish"
        out, err = sub.communicate(timeout=600)
        assert sub.returncode == 0, err[-3000:]
        with open(d / "ref.pkl", "rb") as f:
            ref.update(pickle.load(f))
    finally:
        torch.set_num_threads(n)
    ranks = []
    for r in range(WORLD):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    errors = [o["error"] for o in ranks if "error" in o]
    assert not errors, errors[0]
    return ranks, ref


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=0, atol=tol)


def test_backend_is_gloo(run):
    assert [o["backend"] for o in run[0]] == ["gloo"] * WORLD


@pytest.mark.parametrize("remat", ["none", "dots"])
def test_sharded_train_step_matches_single_device(run, remat):
    """Every leaf within 2e-4 and the loss within 1e-4 of the reference's
    single-device step, on every rank."""
    ranks, ref = run
    for o in ranks:
        got = o["train"][f"train_{remat}"]
        assert len(got["leaves"]) == len(ref["leaves"])
        for a, b in zip(got["leaves"], ref["leaves"]):
            _close(a, b, 2e-4)
        assert abs(got["loss"] - ref["loss"]) < 1e-4


def test_sharded_decode_step_matches_single_device(run):
    ranks, ref = run
    for o in ranks:
        assert o["train"]["k_spec"] == (None, "data", None, "model", None)
        _close(o["train"]["decode_logits"], ref["decode_logits"], 2e-3)


def test_sequence_sharded_append_decode_matches_reference(run):
    """The LSE branch over a cache sharded along its sequence: logits every
    step, greedy tokens, the tail."""
    ranks, ref = run
    want = ref["append"]
    for o in ranks:
        got = o["append"]
        assert got["k_spec"] == (None, "data", "model", None, None)
        assert got["lse_calls"] == A_STEPS * j_get_config("qwen3-8b").reduced().num_layers
        for i in range(A_STEPS):
            _close(got["logits"][i], want["logits"][i], APPEND_TOL)
            assert np.array_equal(got["tokens"][i], want["tokens"][i]), i
        for f in ("k", "v"):
            _close(got["tail"][f], want["tail"][f], APPEND_TOL)
        assert np.array_equal(got["tail"]["kpos"], np.asarray(want["tail"]["kpos"]))


@pytest.mark.parametrize("case", sorted(_lse_cases()))
def test_lse_decode_attention_matches_reference_sharded_run(run, case):
    ranks, ref = run
    want = ref["lse"][case]
    assert np.isfinite(want).all()
    for o in ranks:
        _close(o["lse"][case], want, LSE_TOL)


@pytest.mark.parametrize("case", sorted(ROUTING))
def test_sharded_decode_step_routes_local_shards(run, case):
    """decode_step on (1, 4) DTensors: the kernels' wrappers get each rank's
    local shards (kv-heads, the cache's sequence with the LSE combine, the
    RG-LRU width, the wkv heads), and the logits, the greedy token and the
    updated cache equal one process's step within ROUTING_TOL."""
    want_spec = {"heads": (None, "data", None, "model", None),
                 "sequence": (None, "data", "model", None, None)}
    for o in run[0]:
        got = o["routing"][case]
        if case in want_spec:
            assert got["specs"]["k"] == want_spec[case]
        calls = got["calls"]
        assert set(calls) == ROUTING_KERNELS[case], calls
        assert all(n > 0 for n in map(len, calls.values()))
        assert not any(dt for c in calls.values() for dt in c), calls
        _close(got["logits"], got["one"], ROUTING_TOL * max(1.0, np.abs(got["one"]).max()))
        assert np.array_equal(got["logits"].argmax(-1), got["one"].argmax(-1))
        for f, a in got["one_cache"].items():
            if f in ROUTING_EXACT[case]:
                assert np.array_equal(got["cache"][f], a), f
            else:
                _close(got["cache"][f], a, ROUTING_TOL * max(1.0, np.abs(a).max()))


@pytest.mark.parametrize("case", sorted(GQA_CASES))
def test_blocked_attention_runs_on_local_heads_or_rows(run, case):
    """``gqa_flash`` on DTensors runs each rank's block loop on its own
    query heads (with the KV heads they group with) or rows: equal to the
    plain run within GQA_TOL, the output sharded as q was."""
    want_pl = "Shard(dim=1)" if case == "rows" else "Shard(dim=2)"
    for o in run[0]:
        got = o["gqa_local"][case]
        assert want_pl in got["placements"], got["placements"]
        _close(got["got"], got["want"], GQA_TOL)


def test_error_feedback_psum_matches_reference(run):
    """The mean equals the mean over ranks of the reference's round trips
    (1e-6) on every rank; each rank's residual equals the reference's."""
    ranks, ref = run
    want = np.mean([xh for xh, _ in ref["ef"]], axis=0)
    for r, o in enumerate(ranks):
        _close(o["ef"]["mean"], want, 1e-6)
        assert np.array_equal(o["ef"]["residual"], ref["ef"][r][1])


def test_elastic_reshard_roundtrip(run):
    """Placed on (2, 2), saved, restored as host tensors, re-placed on
    (1, 4): bit-equal, no divisibility violation."""
    for o in run[0]:
        e = o["elastic"]
        assert e["equal"] and e["restored_plain"] and e["bad"] == []
        assert any("Shard(dim=0)" in p or "Shard(dim=1)" in p for p in e["placements_b"])


def test_io_channel_ranks_match_reference_devices(run):
    ranks, ref = run
    for o in ranks:
        assert o["io"] == ref["io"]


@pytest.mark.parametrize("window", [0, 20])
def test_partials_plain_matches_reference_partial_decode(window):
    """flash_decode_partials_plain = the reference's _partial_decode, rows
    with and without visible slots (f32, 1e-6)."""
    rng = np.random.default_rng(11)
    b, hq, hkv, dh, s = 2, 8, 2, 32, 48
    q = rng.normal(size=(b, 1, hq, dh)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, dh)).astype(np.float32)
    for kpos, q_pos in ((np.arange(s), 30), (np.arange(100, 100 + s), 5)):
        kpos = kpos.astype(np.int32)
        jq = jnp.full((b, 1), q_pos, jnp.int32)
        ja, jm_, jl = _partial_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(kpos), jq, 0.17, window)
        ta, tm_, tl = flash_decode_partials_plain(
            torch.from_numpy(q[:, 0]), torch.from_numpy(k), torch.from_numpy(v),
            torch.from_numpy(kpos), q_pos, scale=0.17, window=window)
        _close(ta, np.asarray(ja)[:, 0], 1e-5 * max(1.0, float(np.abs(ja).max())))
        _close(tm_, np.asarray(jm_)[:, 0], 1e-6 * max(1.0, float(np.abs(jm_).max())))
        _close(tl, np.asarray(jl)[:, 0], 1e-5)


def test_compress_decompress_bit_equal_to_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(3, 1000)).astype(np.float32)
    x[0, :7] = 0.0
    x[1, 3] = 1e4
    res = rng.normal(size=x.shape).astype(np.float32) * 1e-3
    for r in (None, res):
        jx, jr = j_compress(jnp.asarray(x), None if r is None else jnp.asarray(r))
        tx, tr = compress_decompress(torch.from_numpy(x),
                                     None if r is None else torch.from_numpy(r))
        assert np.array_equal(tx.numpy(), np.asarray(jx))
        assert np.array_equal(tr.numpy(), np.asarray(jr))


def test_compression_error_feedback_converges():
    """Residual carry-over keeps the accumulated compression error bounded
    (``tests/test_training.py``'s test on the port)."""
    rng = np.random.default_rng(0)
    g_true = torch.from_numpy(rng.normal(size=(4096,)).astype(np.float32))
    residual = None
    acc_hat = torch.zeros_like(g_true)
    acc_true = torch.zeros_like(g_true)
    for _ in range(20):
        xh, residual = compress_decompress(g_true, residual)
        acc_hat += xh
        acc_true += g_true
    rel = float(torch.linalg.norm(acc_hat - acc_true) / torch.linalg.norm(acc_true))
    assert rel < 0.01, rel
