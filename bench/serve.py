"""The system under test, driven through its public API: a
``RealServingEngine`` over a ``ChunkStore`` whose host tier holds a pool of
remembered sessions, and the closed loop that serves new turns of them.

Every time here is the wall clock (``time.perf_counter``).  The engine's
own times are its engine clock, which lays measured op durations out as if
compute, I/O and decode overlapped; they are read only for
``engine.clock_ratio``.  ``Stamps`` is the engine's telemetry hook with a
wall-clock stamp at admission, first token, finish and each dispatch.
``RealBackend`` synchronises the device after every op, so each stamp
comes after the work it marks.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.obs.telemetry import Telemetry
from repro_torch.serving import ChunkStore, RealServingEngine, Request

from bench import inputs, weights

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file: the registry's
    entry named by ``port_arch`` with the file's published sizes, each set
    on the field that the file's ``port_fields`` names (``group.field``
    for a field of a nested group, as ``moe.top_k``)."""
    hf = cfg["hf"]
    base = get_config(cfg["port_arch"])
    top: Dict[str, object] = {}
    nested: Dict[str, Dict[str, object]] = {}
    for key, field in cfg["port_fields"].items():
        group, _, name = field.rpartition(".")
        if group:
            nested.setdefault(group, {})[name] = hf[key]
        else:
            top[name] = hf[key]
    for group, kw in nested.items():
        top[group] = dataclasses.replace(getattr(base, group), **kw)
    return dataclasses.replace(base, **top)


class WindowClosed(Exception):
    """Raised from the hook to end a ``serve`` call once the run is over."""


class Stamps(Telemetry):
    """Wall-clock stamps of every request of a run and of the dispatched
    work, across its ``serve`` calls.

    ``sizes`` maps each request id to (prefix_len, new_len) so that a
    decode dispatch knows every participant's position.  ``tick(self)``,
    when given, is called after every dispatch; it may raise
    ``WindowClosed``.  ``engine_now`` is the engine clock at the latest
    dispatch, continued across calls."""

    def __init__(self, tick: Optional[Callable] = None):
        super().__init__()
        self.sizes: Dict[str, tuple] = {}
        self.tick = tick
        self.admit: Dict[str, float] = {}
        self.first: Dict[str, float] = {}
        self.finish: Dict[str, float] = {}
        self.decodes: List[tuple] = []      # (wall, [(rid, position)])
        self.ops: List[tuple] = []          # (wall, kind, tokens, layers)
        self.engine_now = 0.0
        self._offset = 0.0                  # engine clock of earlier calls
        self._end = 0.0
        self._pos: Dict[str, int] = {}

    def begin(self, core):
        self._offset = self._end
        super().begin(core)

    def _engine(self, now, dur):
        self.engine_now = self._offset + now
        self._end = max(self._end, self._offset + now + dur)

    def on_admit(self, now, rid, *, queued, active):
        self.admit[rid] = time.perf_counter()
        super().on_admit(now, rid, queued=queued, active=active)

    def on_first_token(self, now, rid):
        self.first[rid] = time.perf_counter()
        prefix, new = self.sizes[rid]
        self._pos[rid] = prefix + new
        super().on_first_token(now, rid)

    def on_finish(self, now, rid, *, queued, active):
        self.finish[rid] = time.perf_counter()
        super().on_finish(now, rid, queued=queued, active=active)

    def on_dispatch(self, now, resource, op, dur):
        self.ops.append((time.perf_counter(), op.kind, op.tokens, op.layers))
        self._engine(now, dur)
        super().on_dispatch(now, resource, op, dur)
        if self.tick is not None:
            self.tick(self)

    def on_decode_dispatch(self, now, dur, rids):
        step = []
        for rid in rids:
            step.append((rid, self._pos[rid]))
            self._pos[rid] += 1
        self.decodes.append((time.perf_counter(), step))
        self._engine(now, dur)
        super().on_decode_dispatch(now, dur, rids)
        if self.tick is not None:
            self.tick(self)


def build(cfg: dict, clients: int, seed: int, device) -> dict:
    """Model, weights, store and engine of a configuration file, with
    ``clients`` requests in flight at most."""
    pcfg = port_config(cfg)
    dtype = _DTYPES[cfg["hf"]["torch_dtype"]]
    model = Model(pcfg, param_dtype=dtype, compute_dtype=dtype, device=device)
    params = weights.make(model.param_specs(), seed, device)
    e = cfg["engine"]
    store = ChunkStore(chunk_size=e["store_chunk"], quant=e["quant"],
                       default_tier="host", hbm_cap=e["hbm_tier_bytes"],
                       host_cap=e["host_tier_bytes"], device=device)
    engine = RealServingEngine(
        model, params, system=e["system"], stages=e["stages"],
        chunk_size=e["chunk_size"], l_delta=e["l_delta"], seed=seed,
        io_channels=e["io_channels"], max_batch=clients,
        kvstore=store, preempt=e["preempt"], admission=e["admission"],
        datapath=e["datapath"], device=device)
    return {"cfg": pcfg, "model": model, "params": params, "store": store,
            "engine": engine}


def remember_pool(sys_: dict, plan, seed: int, vocab: int) -> Dict[int, torch.Tensor]:
    """Set-up: every pool session's prefix prefilled once (the previous
    turn) through ``executor.remember``, its KV stored as int8 chunks on
    the host tier.  Returns the sessions' token ids."""
    ex = sys_["engine"].executor
    ids = {}
    for s, n in enumerate(plan.prefix_lens):
        ids[s] = torch.from_numpy(inputs.token_ids(seed, n, vocab, s))
        ex.remember(session_id(s), ids[s][None])
    return ids


def session_id(s: int) -> str:
    return f"session-{s}"


def requests_of(turns, tag: str) -> List[Request]:
    """Each turn a request forked from its session (``meta["fork_of"]``):
    no prefix prefill runs in the window, only restoration."""
    return [Request(f"{tag}-{t.index}", 0.0, t.prefix_len, t.new_len,
                    decode_len=t.decode_len,
                    meta={"fork_of": session_id(t.session)}) for t in turns]


def serve_call(engine: RealServingEngine, reqs: List[Request], stamps: Stamps) -> dict:
    """One ``serve`` call under ``stamps``; all requests arrive at once and
    the engine keeps ``max_batch`` of them in flight, so it is a closed
    loop of that many clients.  Returns whether the hook ended the call,
    and the served tokens and logits (first token, then each decode step;
    moved to the host) of every request that finished; every request's
    live state is then released."""
    stamps.sizes.update({r.request_id: (r.prefix_len, r.new_len) for r in reqs})
    engine.telemetry = stamps
    closed = False
    try:
        engine.serve(reqs, verify=False)
    except WindowClosed:
        closed = True
    finally:
        engine.telemetry = None
        stamps.core = None          # the stamps outlive the call, its engine core not
    ex = engine.executor
    ex.sync()
    tokens, logits = {}, {}
    for r in reqs:
        if r.request_id in stamps.finish:
            out = ex.outputs(r.request_id)
            tokens[r.request_id] = out["tokens"]
            logits[r.request_id] = torch.cat([out["first_logits"]]
                                             + out["step_logits"]).to("cpu")
        ex.release(r.request_id)
    return {"closed": closed, "tokens": tokens, "logits": logits}
