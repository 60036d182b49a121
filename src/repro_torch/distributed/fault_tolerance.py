"""Fault tolerance: heartbeats, failure detection, restart coordination
(a copy of ``repro.distributed.fault_tolerance``, which holds no framework
code; the port imports nothing of the reference).

Scope of this module on a real fleet:
  * every host runs a ``Heartbeat`` reporter; the coordinator declares a host
    dead after ``timeout`` missed beats,
  * on failure during TRAINING: all hosts restart from the latest complete
    checkpoint manifest (atomic — see training/checkpoint.py) and the data
    pipeline resumes at the exact step (stateless addressing),
  * on failure during SERVING: in-flight restorations owned by the dead
    stage are re-queued — restoration ops are idempotent (content-addressed
    chunks), so re-execution is safe; the simulator's channel-failure
    injection exercises the same path,
  * stragglers: per-resource progress rates are tracked; resources slower
    than ``straggler_factor`` × median are flagged and (for I/O) deprioritised
    by the batch scheduler via a bandwidth override.

Here the coordinator is exercised in-process (tests and
``launch/train.py``); the interfaces are what a cluster supervisor would
call.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class HostState:
    host_id: int
    last_beat: float
    alive: bool = True


class FailureDetector:
    def __init__(self, num_hosts: int, timeout: float = 30.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout
        self.clock = clock
        now = clock()
        self.hosts: Dict[int, HostState] = {
            h: HostState(h, now) for h in range(num_hosts)}

    def beat(self, host_id: int):
        st = self.hosts[host_id]
        st.last_beat = self.clock()
        st.alive = True

    def scan(self) -> List[int]:
        """Returns newly-dead host ids."""
        now = self.clock()
        dead = []
        for st in self.hosts.values():
            if st.alive and now - st.last_beat > self.timeout:
                st.alive = False
                dead.append(st.host_id)
        return dead

    def alive_hosts(self) -> List[int]:
        return [h for h, st in self.hosts.items() if st.alive]


@dataclass
class StragglerMonitor:
    """Flags resources whose measured rate falls below factor × median."""
    straggler_factor: float = 0.5
    rates: Dict[str, List[float]] = field(default_factory=dict)

    def report(self, resource: str, units_per_sec: float):
        self.rates.setdefault(resource, []).append(units_per_sec)

    def stragglers(self) -> List[str]:
        import statistics
        recent = {r: statistics.fmean(v[-5:]) for r, v in self.rates.items() if v}
        if len(recent) < 2:
            return []
        med = statistics.median(recent.values())
        return [r for r, v in recent.items() if v < self.straggler_factor * med]


class TrainingSupervisor:
    """Restart-from-checkpoint supervisor: run_fn(start_step) -> last_step.
    run_fn raises HostFailure to simulate a node loss; the supervisor
    restores and resumes. Used by tests and launch/train.py."""

    def __init__(self, ckpt_manager, max_restarts: int = 10):
        self.ckpt = ckpt_manager
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, run_fn: Callable[[Optional[int]], int]) -> int:
        while True:
            start = self.ckpt.latest_step()
            try:
                return run_fn(start)
            except HostFailure:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                continue


class HostFailure(RuntimeError):
    pass
