"""Serving request lifecycle."""
from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field
from typing import Optional


class Phase(enum.Enum):
    QUEUED = "queued"
    RESTORING = "restoring"
    PREFILL = "prefill"
    DECODE = "decode"
    DONE = "done"
    FAILED = "failed"


@dataclass
class Request:
    request_id: str
    arrival: float
    prefix_len: int                # N_c — cached tokens to restore
    new_len: int                   # fresh suffix tokens to prefill
    decode_len: int = 32           # output tokens to generate
    prefix_id: Optional[str] = None  # shared-prefix key (agentic reuse)
    priority: int = 0              # SLO class; higher preempts lower
                                   # restorations under admission pressure
    deadline: float = math.inf     # wall-clock first-token SLO (EDF mode)
    phase: Phase = Phase.QUEUED
    # timestamps (filled by the engine)
    t_restore_start: Optional[float] = None
    t_restore_end: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    meta: dict = field(default_factory=dict)

    @property
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival

    @property
    def restore_secs(self) -> Optional[float]:
        if self.t_restore_end is None or self.t_restore_start is None:
            return None
        return self.t_restore_end - self.t_restore_start
