"""The port's runtime sanitizer (``repro_torch.analysis.sanitizer``) against
the reference's.

* Mutation: every invariant class of ``tests/test_sanitizer.py`` fires on
  the same deliberately broken hook sequence in both packages (the bodies
  are package-neutral, so each case runs on each package).
* Copy-on-write: the port's check wraps the port's real ``BlockPool``, whose
  blocks are torch tensors: a copy that mutates its parent raises
  ``cow-parent-mutated``, one whose bytes diverge ``cow-copy-diverged``, and
  an honest pool passes, counts the check and unwraps at run end.
* Fuzz: randomized preempt + evict + prefetch + channel-failure schedules
  sanitize silently in the port, and its counters equal the reference's on
  the same schedule (the engines are copies; so must their observers be).
* The ``CACHEFLOW_SANITIZE`` opt-in and the serving report's counters.
"""
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hypothesis_compat import given, settings, st  # noqa: E402

import repro.analysis.sanitizer as j_san  # noqa: E402
import repro.core as j_core  # noqa: E402
import repro.core.baselines as j_baselines  # noqa: E402
import repro.core.trace as j_trace  # noqa: E402
import repro.serving as j_serving  # noqa: E402
import repro_torch.analysis.sanitizer as t_san  # noqa: E402
import repro_torch.core as t_core  # noqa: E402
import repro_torch.core.baselines as t_baselines  # noqa: E402
import repro_torch.core.trace as t_trace  # noqa: E402
import repro_torch.serving as t_serving  # noqa: E402
from repro_torch.config import HARDWARE, IO_BANDWIDTHS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.kvcache import BlockPool  # noqa: E402

PKGS = {
    "jax": types.SimpleNamespace(
        san=j_san, core=j_core, plans=j_baselines.make_baseline_plans,
        TraceEvent=j_trace.TraceEvent, TraceRecorder=j_trace.TraceRecorder,
        TieredKVStore=j_serving.TieredKVStore),
    "torch": types.SimpleNamespace(
        san=t_san, core=t_core, plans=t_baselines.make_baseline_plans,
        TraceEvent=t_trace.TraceEvent, TraceRecorder=t_trace.TraceRecorder,
        TieredKVStore=t_serving.TieredKVStore),
}


@pytest.fixture(params=sorted(PKGS))
def pkg(request):
    return PKGS[request.param]


class _Op:
    """Minimal op stub: the sanitizer hooks only read these fields."""

    def __init__(self, kind, rid, stage=0, unit=0):
        self.kind = kind
        self.request_id = rid
        self.stage = stage
        self.unit = unit


class _Core:
    def __init__(self, max_active=0, kvstore=None):
        self.max_active = max_active
        self.kvstore = kvstore


def _san(pkg, max_active=0, kvstore=None):
    san = pkg.san.EngineSanitizer(_Core(max_active=max_active, kvstore=kvstore))
    san.bind(ops_log=[], busy_comp={0: 0.0}, busy_io={0: 0.0})
    return san


def _mk_req(pkg, rid, n=32, **kw):
    plans = pkg.plans("cacheflow", rid, n, chunk_size=8, l_delta=0, num_layers=4)
    return pkg.core.EngineRequest(rid, n, 0.0, plans, **kw)


# ---------------------------------------------------------------------------
# Mutation: one broken hook sequence per invariant class, in both packages
# ---------------------------------------------------------------------------


def _double_claim(pkg, san):
    san.on_admit(0.0, _mk_req(pkg, "r0"))
    san.on_dispatch(0.0, "comp0", _Op("compute", "r0", 0, 2), 1.0)
    san.on_dispatch(0.0, "io0", _Op("load", "r0", 0, 2), 1.0)


def _channel_occupancy(pkg, san):
    san.on_admit(0.0, _mk_req(pkg, "r0"))
    san.on_dispatch(0.0, "comp0", _Op("compute", "r0", 0, 0), 1.0)
    san.on_dispatch(0.0, "comp0", _Op("compute", "r0", 0, 1), 1.0)


def _double_restore(pkg, san):
    san.on_admit(0.0, _mk_req(pkg, "r0"))
    op = _Op("load", "r0", 0, 3)
    san.on_dispatch(0.0, "io0", op, 1.0)
    san.on_complete(1.0, "io0", op)
    san.on_dispatch(1.0, "io0", _Op("load", "r0", 0, 3), 1.0)


def _completion_time(pkg, san):
    san.on_admit(0.0, _mk_req(pkg, "r0"))
    op = _Op("load", "r0", 0, 3)
    san.on_dispatch(0.0, "io0", op, 1.0)
    san.on_complete(1.0 + 1e-12, "io0", op)


def _time_monotonic(pkg, san):
    san.on_event(2.0, "comp_done")
    san.on_event(1.5, "io_done")


def _negative_duration(pkg, san):
    san.on_admit(0.0, _mk_req(pkg, "r0"))
    san.on_dispatch(0.0, "io0", _Op("load", "r0", 0, 3), -0.5)


def _inactive_dispatch(pkg, san):
    san.on_dispatch(0.0, "io0", _Op("load", "ghost", 0, 3), 0.5)


def _slot_overflow(pkg, san):
    san.core.max_active = 1
    san.on_admit(0.0, _mk_req(pkg, "r0"))
    san.on_admit(0.0, _mk_req(pkg, "r1"))


def _double_admit(pkg, san):
    san.on_admit(0.0, _mk_req(pkg, "r0"))
    san.on_admit(0.0, _mk_req(pkg, "r0"))


def _finish_inactive(pkg, san):
    san.on_finish(0.0, "never-admitted")


def _resume_unsuspended(pkg, san):
    san.on_resume(0.0, "never-suspended")


def _restore_incomplete(pkg, san):
    san.on_admit(0.0, _mk_req(pkg, "r0", n=32))      # 4 units of 8 tokens
    op = _Op("load", "r0", 0, 3)
    san.on_dispatch(0.0, "io0", op, 1.0)
    san.on_complete(1.0, "io0", op)
    san.on_restore_done(1.0, "r0")                   # 3 units never completed


def _rollback_drift(pkg, san):
    san.on_admit(0.0, _mk_req(pkg, "r0"))
    op = _Op("load", "r0", 0, 3)
    san.on_dispatch(0.0, "io0", op, 1.0)
    san.on_complete(1.0, "io0", op)
    san._engine_busy[1][0] += 0.25      # engine accounting drifts off the mirror
    san.on_run_end(active=set(), pending=[], suspended=set())


class _BadStore:
    def audit(self):
        raise AssertionError("host: used 512 != sum 256")


def _store_audit(pkg, san):
    san.core.kvstore = _BadStore()
    san.on_run_end(active=set(), pending=[], suspended=set())


def _trace_schema(pkg, san):
    san.on_trace_event(pkg.TraceEvent(kind="warp_core_breach", t=0.0))


MUTANTS = {
    "double-claim": _double_claim,
    "channel-occupancy": _channel_occupancy,
    "double-restore": _double_restore,
    "completion-time": _completion_time,
    "time-monotonic": _time_monotonic,
    "negative-duration": _negative_duration,
    "inactive-dispatch": _inactive_dispatch,
    "slot-overflow": _slot_overflow,
    "slot-conservation:double-admit": _double_admit,
    "slot-conservation:finish": _finish_inactive,
    "slot-conservation:resume": _resume_unsuspended,
    "restore-incomplete": _restore_incomplete,
    "rollback-exact": _rollback_drift,
    "store-audit": _store_audit,
    "trace-schema": _trace_schema,
}


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_mutation_fires_its_check(pkg, mutant):
    check = mutant.split(":")[0]
    san = _san(pkg, max_active=4)
    with pytest.raises(pkg.san.SanitizerViolation, match=check) as err:
        MUTANTS[mutant](pkg, san)
    assert err.value.check == check


@pytest.mark.parametrize("mutant", sorted(MUTANTS))
def test_violation_messages_equal_across_packages(mutant):
    """The port's violation carries the reference's check, time and text."""
    msgs = {}
    for side, pkg in PKGS.items():
        with pytest.raises(pkg.san.SanitizerViolation) as err:
            MUTANTS[mutant](pkg, _san(pkg, max_active=4))
        msgs[side] = (err.value.check, err.value.t, str(err.value))
    assert msgs["torch"] == msgs["jax"]


# ---------------------------------------------------------------------------
# Copy-on-write on the port's BlockPool (torch tensors)
# ---------------------------------------------------------------------------


def _block(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"k": torch.randn(2, 1, 8, 2, 4, generator=g),
            "v": torch.randn(2, 1, 8, 2, 4, generator=g),
            "kpos": torch.arange(8, dtype=torch.int32).expand(2, 8)}


class _MutatingPool(BlockPool):
    """A BlockPool whose copy is broken one of two ways."""

    def __init__(self, *, mutate_parent=False, diverge_copy=False):
        super().__init__(8)
        self.mutate_parent = mutate_parent
        self.diverge_copy = diverge_copy

    def copy(self, bid):
        new = super().copy(bid)
        if self.mutate_parent:
            self.read(bid)["k"][0, 0, 0, 0, 0] += 1.0
        if self.diverge_copy:
            self.read(new)["v"][1, 0, 3, 1, 2] = -999.0
        return new


class _PoolStore:
    def __init__(self, pool):
        self.pool = pool

    def audit(self):
        self.pool.audit()


@pytest.mark.parametrize("how,check", [("mutate_parent", "cow-parent-mutated"),
                                       ("diverge_copy", "cow-copy-diverged")])
def test_cow_check_on_torch_block_pool_fires(how, check):
    pool = _MutatingPool(**{how: True})
    bid = pool.alloc(_block())
    san = _san(PKGS["torch"], kvstore=_PoolStore(pool))
    with pytest.raises(t_san.SanitizerViolation, match=check):
        pool.copy(bid)


def test_cow_check_passes_on_honest_pool_and_unwraps_at_run_end():
    pool = BlockPool(8)
    bid = pool.alloc(_block())
    pool.incref(bid)
    original = pool.copy
    san = _san(PKGS["torch"], kvstore=_PoolStore(pool))
    assert pool.copy != original                 # wrapped while sanitizing
    new = pool.copy(bid)
    for f, t in pool.read(bid).items():
        assert torch.equal(t, pool.read(new)[f])
    assert san.counters.cow_checks == 1
    assert san.counters.pool_refcount_hw == 2
    san.on_run_end(active=set(), pending=[], suspended=set())
    assert pool.copy == original                 # unwrapped at run end
    assert san.counters.audits == 1


# ---------------------------------------------------------------------------
# Fuzz: silent on correct schedules, counters equal to the reference's
# ---------------------------------------------------------------------------


def _rng_backend(pkg, seed):
    """The reference tests' random-duration backend over ``pkg``'s engine,
    with prefetch on (every draw in the same order in both packages)."""
    class Backend(pkg.core.EngineBackend):
        def __init__(self):
            self.rng = np.random.default_rng(seed)

        def compute_secs(self, op, req):
            return float(self.rng.uniform(0.05, 1.0))

        def io_secs(self, op, req, bandwidth):
            return float(self.rng.uniform(0.05, 1.0))

        def prefill_secs(self, op, req):
            return float(self.rng.uniform(0.05, 1.0))

        def decode_secs(self, reqs):
            return float(self.rng.uniform(0.01, 0.3))

        def prefetch_secs(self, op, req, bandwidth):
            return float(self.rng.uniform(0.05, 1.0))

        def prefetch_gate(self, req):
            return True
    return Backend()


def _fuzz_run(pkg, seed):
    rng = np.random.default_rng(seed)
    stages = int(rng.integers(1, 3))
    bounds = [(0, 2), (2, 4)] if stages == 2 else None
    policy = ["none", "priority", "deadline"][int(rng.integers(0, 3))]
    evict = policy != "none" and bool(rng.integers(0, 2))
    prefetch = bool(rng.integers(0, 2))
    io_channels = int(rng.integers(1, 3))
    kvstore = pkg.TieredKVStore() if (prefetch or rng.integers(0, 2)) else None
    fail = ({int(rng.integers(0, io_channels)): float(rng.uniform(0.5, 3.0))}
            if int(rng.integers(0, 3)) == 0 else None)
    reqs = []
    for i in range(int(rng.integers(3, 8))):
        n = int(rng.integers(16, 160))
        plans = pkg.plans("cacheflow", f"r{i}", n, chunk_size=8, l_delta=0,
                          num_layers=4, stage_bounds=bounds)
        reqs.append(pkg.core.EngineRequest(
            f"r{i}", n, arrival=float(rng.uniform(0, 3.0)), plans=plans,
            new_len=int(rng.integers(0, 3)) * 16,
            decode_len=int(rng.integers(0, 5)),
            priority=int(rng.integers(0, 3)),
            deadline=float(rng.uniform(0.5, 20.0))))
        if kvstore is not None:
            kvstore.put(f"r{i}", n * 1024, tier="remote")
    rec = pkg.TraceRecorder()
    core = pkg.core.EngineCore(
        _rng_backend(pkg, seed), stages=stages, io_channels=io_channels,
        max_active=int(rng.integers(1, 4)), preempt=policy, evict=evict,
        prefetch=prefetch, kvstore=kvstore, channel_fail_at=fail,
        sanitize=True, strict=True)
    res = core.run(reqs, trace=rec)
    return res, core.last_sanitizer, len(reqs)


@pytest.mark.property
@settings(max_examples=20, deadline=None)
@given(seed=st.integers(0, 2**31 - 1))
def test_fuzz_sanitizer_silent_and_counters_equal_reference(seed):
    res, san, n = _fuzz_run(PKGS["torch"], seed)
    assert san is not None and san.counters.finishes == n
    assert san.counters.admits >= n
    j_res, j_sanitizer, _ = _fuzz_run(PKGS["jax"], seed)
    assert res.ops_log == j_res.ops_log
    assert san.counters.as_dict() == j_sanitizer.counters.as_dict()


# ---------------------------------------------------------------------------
# Opt-in and the serving report
# ---------------------------------------------------------------------------


def test_engine_env_var_opt_in(monkeypatch):
    pkg = PKGS["torch"]
    monkeypatch.setenv("CACHEFLOW_SANITIZE", "1")
    core = pkg.core.EngineCore(_rng_backend(pkg, 3), stages=1, io_channels=1)
    assert core.sanitize
    core.run([_mk_req(pkg, "r0")])
    assert isinstance(core.last_sanitizer, t_san.EngineSanitizer)
    assert core.last_sanitizer.counters.finishes == 1
    monkeypatch.setenv("CACHEFLOW_SANITIZE", "0")
    core = pkg.core.EngineCore(_rng_backend(pkg, 3), stages=1, io_channels=1)
    assert not core.sanitize
    core.run([_mk_req(pkg, "r0")])
    assert core.last_sanitizer is None


def test_serving_report_carries_sanitizer_counters(monkeypatch):
    monkeypatch.delenv("CACHEFLOW_SANITIZE", raising=False)
    cfg = get_config("qwen3-8b")
    reqs = [t_serving.Request(f"r{i}", 0.2 * i, prefix_len=4096, new_len=128,
                              decode_len=2) for i in range(3)]
    eng = t_serving.SimServingEngine(cfg, HARDWARE["h100"],
                                     io_bandwidth=IO_BANDWIDTHS["10Gbps"],
                                     stages=2, max_batch=2, sanitize=True)
    rep = eng.run(reqs)
    assert rep.sanitizer is not None
    assert (rep.sanitizer["admits"], rep.sanitizer["finishes"]) == (3, 3)
    assert rep.sanitizer["max_active"] <= 2
    rep2 = t_serving.SimServingEngine(cfg, HARDWARE["h100"],
                                      io_bandwidth=IO_BANDWIDTHS["10Gbps"],
                                      stages=2, max_batch=2).run(
        [t_serving.Request("s0", 0.0, prefix_len=4096, new_len=128, decode_len=2)])
    assert rep2.sanitizer is None
