"""Serving request surface: sampling params, lifecycle, streamed outputs.

One request = one generation job.  Its lifecycle is an explicit state
machine driven by the engine's scheduler:

    QUEUED -> PREFILLING -> DECODING -> FINISHED
       ^                       |            \
       +----- (preemption) ----+             CANCELLED (any live state)

Preemption (page pressure admitting a higher-priority request) sends a
DECODING request back to QUEUED with its generated tokens intact; on
re-admission the engine re-prefills prompt+generated (recompute-style
resume, pages were released at eviction).  ``cancel()`` is terminal and
frees pages immediately.

Streamed outputs: every generated token produces a ``RequestOutput``
record, delivered through ``engine.stream()`` (iterator) and/or the
request's ``on_token`` callback.  The final record of a request carries
``finished=True`` plus a ``finish_reason``:

    ``"length"``     max_new tokens generated
    ``"stop"``       a stop token id was generated (kept in the output)
    ``"cancelled"``  caller cancelled (or the client disconnected)
    ``"timeout"``    deadline_ms / queue_timeout_ms expired host-side
    ``"rejected"``   admission control refused the request
    ``"error"``      a device-step failure consumed the request's tick
                     (crash containment; the engine keeps serving)

The last three carry the human-readable cause in ``error``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Tuple

__all__ = ["SamplingParams", "RequestState", "Request", "RequestOutput"]


class RequestState(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"
    DECODING = "decoding"
    FINISHED = "finished"
    CANCELLED = "cancelled"

    @property
    def is_terminal(self) -> bool:
        return self in (RequestState.FINISHED, RequestState.CANCELLED)


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request decoding policy, carried by the request (no more
    engine-global temperature).

    temperature <= 0 is greedy; top_k == 0 and top_p >= 1.0 disable the
    respective truncations.  ``stop`` token ids end the request the step
    they are generated (the stop token is kept in the output).

    Deadlines (both optional, milliseconds, enforced host-side in
    ``Scheduler.plan_tick`` — no device work is interrupted):
    ``deadline_ms`` bounds the request's total lifetime from submit;
    ``queue_timeout_ms`` bounds only the wait for FIRST admission (a
    preempted-and-requeued request has already been served, so only the
    deadline applies to it).  Expiry finishes the request with
    ``finish_reason="timeout"``.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    stop: Tuple[int, ...] = ()
    max_new: int = 32
    deadline_ms: Optional[float] = None
    queue_timeout_ms: Optional[float] = None

    def __post_init__(self):
        for name in ("deadline_ms", "queue_timeout_ms"):
            v = getattr(self, name)
            if v is not None and v <= 0:
                raise ValueError(f"{name} must be > 0, got {v}")
        if self.temperature < 0.0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0 (0 = off), got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.max_new < 1:
            raise ValueError(f"max_new must be >= 1, got {self.max_new}")
        if not isinstance(self.stop, tuple):
            object.__setattr__(self, "stop", tuple(self.stop))


@dataclasses.dataclass
class Request:
    """One generation job.  ``tokens`` accumulates generated ids; on
    preemption they are kept and the engine resumes by re-prefilling
    ``prompt + tokens``."""

    prompt: List[int]
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    rid: Optional[int] = None  # auto-assigned by the engine when None
    priority: int = 0  # higher preempts lower under page pressure
    on_token: Optional[Callable[["RequestOutput"], None]] = None

    # engine-managed state
    state: RequestState = RequestState.QUEUED
    tokens: List[int] = dataclasses.field(default_factory=list)
    finish_reason: Optional[str] = None
    error: Optional[str] = None  # cause for timeout/rejected/error finishes
    prefix_matched: int = 0  # tokens served from shared prefix pages at
    #                          the last admission (0 = no sharing)

    @property
    def total_tokens(self) -> int:
        return len(self.prompt) + len(self.tokens)


@dataclasses.dataclass(frozen=True)
class RequestOutput:
    """One streamed step of one request (engine.stream() / on_token)."""

    rid: int
    token: Optional[int]  # newest generated id (None for token-less
    #                       terminal events, e.g. cancellation)
    index: int  # number of generated tokens so far
    state: RequestState
    finished: bool
    finish_reason: Optional[str]
    tokens: Tuple[int, ...]  # snapshot of all generated ids
    error: Optional[str] = None  # cause for timeout/rejected/error finishes
