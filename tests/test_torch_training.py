"""The port's training path held to the JAX reference on the CPU, f32:
gradients of ``lm_loss`` leaf by leaf (``jax.grad`` against
``torch.autograd``) and one ``make_train_step`` (loss, ``grad_norm``) for
all 13 reduced archs (recurrentgemma-2b also at S = 200, past its window of
64), AdamW and its schedule fed identical gradients, grad
accumulation, the remat policies, the RG-LRU scan's gradient Function,
and ``wkv6``'s route through its own (``Wkv6Scan``) under gradients.

Weights: the reference's ``Model.init`` as numpy through
``params_from_jax``; batches: numpy from a seed, fed to both packages.  The
reference's loss and step run under ``jax.jit`` as its own tests run them
(its training path reaches no Pallas kernel).  deepseek-moe-16b builds both
models with ``moe_dropless=False`` (the capacity path, as the reference's
train-step smoke test does); rwkv6-7b trains at S = 128, where the
reference's time mix takes its chunked scan.

Tolerances: GRAD_TOL = 1e-4 of each leaf's largest reference gradient
(measured 3e-6 to 8e-6: two libraries' f32 reductions); rwkv6-7b 1e-3
(measured 2.3e-4: the reference's chunked scan against the port's
sequential one, through exp(-exp(decay))); the loss within 1e-5 of its
value, ``grad_norm`` within 1e-5 relative (rwkv6-7b 1e-4).  The optimizer
is compared apart from the step (OPT_TOL = 1e-6 relative): on a first step
every element moves by about ±lr whatever its gradient's size, so a
whole-step comparison would be decided by gradients near zero.  The RG-LRU
Function's gradients equal autograd of the plain loop bit for bit
(``torch.equal``), and are within 1e-6 relative of ``jax.grad`` of the
reference's ``lru_scan`` (an associative scan: another summation order).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.models.rglru import lru_scan  # noqa: E402
from repro.training import AdamWConfig as JAdamWConfig  # noqa: E402
from repro.training import init_opt_state as j_init_opt  # noqa: E402
from repro.training import lm_loss as j_lm_loss  # noqa: E402
from repro.training import make_train_step as j_make_train_step  # noqa: E402
from repro.training.optimizer import adamw_update as j_adamw_update  # noqa: E402
from repro.training.optimizer import OptState as JOptState  # noqa: E402
from repro.training.optimizer import schedule as j_schedule  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.rglru_scan import (RglruScan, rglru_scan_grad,  # noqa: E402
                                            rglru_scan_plain)
from repro_torch.kernels.rwkv6_scan import wkv6  # noqa: E402
from repro_torch.models import build_model, params_from_jax  # noqa: E402
from repro_torch.models.model import _leaves  # noqa: E402
from repro_torch.training import (AdamWConfig, DataConfig, OptState,  # noqa: E402
                                  adamw_update, batch_at, init_opt_state, lm_loss,
                                  make_train_step, schedule, value_and_grad)

GRAD_TOL = 1e-4
OPT_TOL = 1e-6
B = 2
# case -> (arch, S, grad tol, grad_norm tol, moe_dropless); a case is named
# by its arch, or by arch@S where one arch runs at a second length
ARCHS = {
    "qwen1.5-0.5b": ("qwen1.5-0.5b", 16, GRAD_TOL, 1e-5, True),
    "qwen3-8b": ("qwen3-8b", 16, GRAD_TOL, 1e-5, True),
    "deepseek-moe-16b": ("deepseek-moe-16b", 16, GRAD_TOL, 1e-5, False),
    "deepseek-v2-236b": ("deepseek-v2-236b", 16, GRAD_TOL, 1e-5, True),
    "recurrentgemma-2b": ("recurrentgemma-2b", 16, GRAD_TOL, 1e-5, True),
    "rwkv6-7b": ("rwkv6-7b", 128, 1e-3, 1e-4, True),
    "musicgen-large": ("musicgen-large", 16, GRAD_TOL, 1e-5, True),
    "qwen3-30b-a3b": ("qwen3-30b-a3b", 16, GRAD_TOL, 1e-5, True),
    "pixtral-12b": ("pixtral-12b", 16, GRAD_TOL, 1e-5, True),
    "llama3.1-8b": ("llama3.1-8b", 16, GRAD_TOL, 1e-5, True),
    "phi4-mini-3.8b": ("phi4-mini-3.8b", 16, GRAD_TOL, 1e-5, True),
    "mistral-large-123b": ("mistral-large-123b", 16, GRAD_TOL, 1e-5, True),
    "qwen1.5-110b": ("qwen1.5-110b", 16, GRAD_TOL, 1e-5, True),
    # past the reduced model's attention window of 64
    "recurrentgemma-2b@200": ("recurrentgemma-2b", 200, GRAD_TOL, 1e-5, True),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes on the
    machine's cores, and small CPU ops slow down many times over when each
    process's thread pool spans them all."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch(cfg, s, seed=2):
    rng = np.random.default_rng(seed)
    if cfg.input_mode == "tokens":
        return {"tokens": rng.integers(0, cfg.vocab_size, (B, s + 1)).astype(np.int32)}
    return {"embeddings": (rng.normal(size=(B, s, cfg.d_model)) * 0.1).astype(np.float32),
            "labels": rng.integers(0, cfg.vocab_size, (B, s)).astype(np.int32)}


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def trained(request):
    """Both packages' gradients of one batch and one train step from the
    same weights."""
    arch, s, gtol, ntol, dropless = ARCHS[request.param]
    cfg_j, cfg_t = j_get_config(arch).reduced(), get_config(arch).reduced()
    jm = j_build(cfg_j, remat_policy="dots", moe_dropless=dropless)
    tree = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0)))
    batch = _batch(cfg_t, s)
    j_step = j_make_train_step(jm, JAdamWConfig(total_steps=10))

    @jax.jit
    def j_run(p, b):
        (loss, _), grads = jax.value_and_grad(lambda q: j_lm_loss(jm, q, b),
                                              has_aux=True)(p)
        _, opt, metrics = j_step(p, j_init_opt(p), b)
        return loss, grads, metrics, opt.step

    jp = jax.tree.map(jnp.asarray, tree)
    jloss, jgrads, jmetrics, jstep = j_run(jp, jax.tree.map(jnp.asarray, batch))
    tm = build_model(cfg_t, device="cpu", remat_policy="dots", moe_dropless=dropless)
    tp = params_from_jax(tree, device="cpu")
    (tloss, _), tgrads = value_and_grad(lm_loss, tm, tp, _t(batch))
    before = [p.detach().clone() for p in _leaves(tp)]
    t_step = make_train_step(tm, AdamWConfig(total_steps=10))
    tp, topt, tmetrics = t_step(tp, init_opt_state(tp), _t(batch))
    return dict(arch=arch, gtol=gtol, ntol=ntol, jloss=float(jloss), tloss=float(tloss),
                jgrads=params_from_jax(jax.tree.map(np.asarray, jgrads), device="cpu"),
                tgrads=tgrads, jmetrics=jmetrics, jstep=int(jstep), tmetrics=tmetrics,
                topt=topt, before=before, after=list(_leaves(tp)))


def test_gradients_match_reference_leaf_by_leaf(trained):
    t_leaves, j_leaves = list(_leaves(trained["tgrads"])), list(_leaves(trained["jgrads"]))
    assert len(t_leaves) == len(j_leaves)
    for i, (got, want) in enumerate(zip(t_leaves, j_leaves)):
        assert got.shape == want.shape, i
        bound = trained["gtol"] * float(want.abs().max())
        assert float((got - want).abs().max()) <= bound, (trained["arch"], i)


def test_every_parameter_gets_a_finite_nonzero_gradient(trained):
    for i, g in enumerate(_leaves(trained["tgrads"])):
        assert g is not None and bool(torch.isfinite(g).all()), i
        assert float(g.abs().max()) > 0, (trained["arch"], i)


def test_train_step_matches_reference(trained):
    jm, tm = trained["jmetrics"], trained["tmetrics"]
    assert abs(trained["tloss"] - trained["jloss"]) <= 1e-5 * abs(trained["jloss"])
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(float(jm["loss"]))
    assert abs(float(tm["grad_norm"]) - float(jm["grad_norm"])) \
        <= trained["ntol"] * float(jm["grad_norm"])
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
    assert int(trained["topt"].step) == trained["jstep"] == 1
    assert any(not torch.equal(a, b) for a, b in zip(trained["before"], trained["after"]))


# ---------------------------------------------------------------------------
# AdamW and its schedule
# ---------------------------------------------------------------------------


def _rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max()) / max(float(np.abs(want).max()), 1e-30)


@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference_on_identical_gradients(clip):
    """Three updates of a two-leaf tree from the same gradients in both
    packages (clipped at 1.0, not at 100): params, m, v, grad_norm and lr
    within OPT_TOL."""
    rng = np.random.default_rng(11)
    params = {"a": rng.normal(size=(8, 5)).astype(np.float32),
              "b": {"c": rng.normal(size=(7,)).astype(np.float32)}}
    kw = dict(peak_lr=3e-3, warmup_steps=2, total_steps=6, clip_norm=clip)
    jcfg, tcfg = JAdamWConfig(**kw), AdamWConfig(**kw)
    jp = jax.tree.map(jnp.asarray, params)
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), params)
    js, ts = j_init_opt(jp), init_opt_state(tp)
    for step in range(3):
        grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(np.float32) * 3,
                             params)
        jp, js, jm = j_adamw_update(jcfg, jp, jax.tree.map(jnp.asarray, grads), js)
        tp, ts, tm = adamw_update(tcfg, tp, jax.tree.map(torch.from_numpy, grads), ts)
        assert int(ts.step) == int(js.step) == step + 1
        for name in ("grad_norm", "lr"):
            assert _rel(tm[name].numpy(), jm[name]) <= OPT_TOL, name
        for got, want in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
            for g, w in zip(_leaves(got), jax.tree.leaves(want)):
                assert _rel(g.numpy(), w) <= OPT_TOL
    assert isinstance(ts, OptState) and isinstance(js, JOptState)


def test_schedule_matches_reference():
    cfg_kw = dict(peak_lr=3e-3, warmup_steps=5, total_steps=40, min_lr_ratio=0.1)
    steps = np.arange(0, 46, dtype=np.int32)
    want = np.asarray(j_schedule(JAdamWConfig(**cfg_kw), jnp.asarray(steps)))
    got = schedule(AdamWConfig(**cfg_kw), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    assert float(got[5]) == pytest.approx(3e-3) and float(got[-1]) == pytest.approx(3e-4)


# ---------------------------------------------------------------------------
# grad accumulation and remat
# ---------------------------------------------------------------------------


def _qwen_setup(grad_accum=1, remat="dots", arch="qwen1.5-0.5b"):
    cfg = get_config(arch).reduced()
    m = build_model(cfg, device="cpu", remat_policy=remat)
    params = m.init(torch.Generator().manual_seed(0))
    step = make_train_step(m, AdamWConfig(peak_lr=3e-3, warmup_steps=5, total_steps=50),
                           grad_accum=grad_accum)
    return cfg, m, params, step


def test_grad_accum_matches_full_batch():
    """grad_accum=4 gives (nearly) the update one big batch gives, as the
    reference's test holds its own: loss within 1e-5, the first leaf 1e-4."""
    cfg, _, p1, step1 = _qwen_setup(1)
    _, _, p4, step4 = _qwen_setup(4)
    batch = batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=8), 0)
    p1, _, m1 = step1(p1, init_opt_state(p1), batch)
    p4, _, m4 = step4(p4, init_opt_state(p4), batch)
    assert float(m4["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert float(m4["nll"]) == pytest.approx(float(m1["nll"]), rel=1e-5)
    np.testing.assert_allclose(next(_leaves(p4)).detach().numpy(),
                               next(_leaves(p1)).detach().numpy(), atol=1e-4)


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "recurrentgemma-2b", "deepseek-moe-16b"])
def test_remat_policies_give_equal_gradients(arch):
    """"none", "full", "nothing" and "dots" recompute the same functions on
    the same inputs: the gradients are equal bit for bit."""
    cfg = get_config(arch).reduced()
    batch = batch_at(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2), 3)
    grads = {}
    for policy in ("none", "full", "nothing", "dots"):
        m = build_model(cfg, device="cpu", remat_policy=policy)
        params = m.init(torch.Generator().manual_seed(0))
        grads[policy] = list(_leaves(value_and_grad(lm_loss, m, params, batch)[1]))
    for policy in ("full", "nothing", "dots"):
        assert all(torch.equal(a, b) for a, b in zip(grads[policy], grads["none"])), policy


def test_unknown_remat_policy_is_refused():
    with pytest.raises(ValueError, match="remat_policy"):
        build_model(get_config("qwen1.5-0.5b").reduced(), device="cpu", remat_policy="some")


# ---------------------------------------------------------------------------
# the RG-LRU scan's gradient Function; wkv6 under gradients
# ---------------------------------------------------------------------------


def _scan_inputs(bsz, s, w, seed):
    rng = np.random.default_rng(seed)
    return ((-0.5 * rng.random((bsz, s, w))).astype(np.float32),
            rng.normal(size=(bsz, s, w)).astype(np.float32),
            rng.normal(size=(bsz, w)).astype(np.float32),
            rng.normal(size=(bsz, s, w)).astype(np.float32),
            rng.normal(size=(bsz, w)).astype(np.float32))


def _grads(fn, la, b, h0, gh, gl):
    ts = [torch.tensor(a, requires_grad=True) for a in (la, b, h0)]
    h, hl = fn(*ts)
    loss = (h * torch.from_numpy(gh)).sum() + (hl * torch.from_numpy(gl)).sum()
    return (h.detach(), hl.detach()), torch.autograd.grad(loss, ts)


@pytest.mark.parametrize("bsz,s,w", [(1, 1, 16), (2, 7, 16), (2, 64, 40), (1, 300, 8)])
def test_rglru_function_equals_autograd_of_the_plain_loop(bsz, s, w):
    la, b, h0, gh, gl = _scan_inputs(bsz, s, w, s)
    (h, hl), g = _grads(rglru_scan_grad, la, b, h0, gh, gl)
    (hp, hlp), gp = _grads(rglru_scan_plain, la, b, h0, gh, gl)
    assert torch.equal(h, hp) and torch.equal(hl, hlp)
    for name, got, want in zip(("log_a", "b", "h0"), g, gp):
        assert torch.equal(got, want), name
    want = jax.jit(jax.grad(lambda a, bb, c: (lambda o: (o[0] * gh).sum() + (o[1] * gl).sum())(
        lru_scan(a, bb, c)), argnums=(0, 1, 2)))(la, b, h0)
    for got, w_ in zip(g, want):
        assert _rel(got.numpy(), w_) <= 1e-6


def test_rglru_function_with_one_output_unused():
    """Only h_last reaches the loss (gh materialises as zeros) or only h."""
    la, b, h0, gh, gl = _scan_inputs(2, 9, 8, 3)
    for keep in (0, 1):
        ts = [torch.tensor(a, requires_grad=True) for a in (la, b, h0)]
        tp = [torch.tensor(a, requires_grad=True) for a in (la, b, h0)]
        g = torch.autograd.grad(RglruScan.apply(*ts)[keep].sum(), ts)
        gp = torch.autograd.grad(rglru_scan_plain(*tp)[keep].sum(), tp)
        assert all(torch.equal(x, y) for x, y in zip(g, gp))


def test_wkv6_under_gradients_goes_through_its_function_on_a_device_tensor():
    """The device branch (a meta tensor stands in for CUDA here) under
    gradients runs Wkv6Scan's forward, which takes the kernels' checks (a
    meta tensor beside a host one fails the device check there, past where
    the wrapper once refused; all on meta take the meta route, y carrying
    Wkv6Scan's backward); under no_grad the same checks run outside the
    Function."""
    shapes = [(1, 3, 2, 64)] * 4 + [(2, 64), (1, 2, 64, 64)]
    metas = [torch.zeros(s, device="meta", requires_grad=i == 0) for i, s in enumerate(shapes)]
    mixed = metas[:5] + [torch.zeros(shapes[5])]
    with pytest.raises(ValueError, match="CUDA device") as err:
        wkv6(*mixed)
    frames = [(e.name, e.frame.f_globals.get("__name__")) for e in err.traceback]
    assert ("forward", "repro_torch.kernels.rwkv6_scan") in frames
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA device") as err:
        wkv6(*mixed)
    assert all(e.name != "forward" for e in err.traceback)
    y, s_last = wkv6(*metas)
    assert "Wkv6Scan" in type(y.grad_fn).__name__ and y.device.type == "meta"
    with torch.no_grad():
        assert wkv6(*metas)[0].grad_fn is None


def test_adamw_constants_are_the_references():
    assert AdamWConfig() == AdamWConfig(**{f: getattr(JAdamWConfig(), f)
                                           for f in JAdamWConfig.__dataclass_fields__})
    assert math.isclose(float(schedule(AdamWConfig(), torch.tensor(100))), 3e-4, rel_tol=1e-6)
