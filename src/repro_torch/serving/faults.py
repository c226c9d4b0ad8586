"""Deterministic fault injection for the serving stack (chaos harness).

A :class:`FaultPlan` is a seeded schedule of named fault points threaded
through :class:`~repro_torch.serving.engine.ServeEngine`,
:class:`~repro_torch.serving.kv_cache.PagedKVCache` and the gateway as
no-op-by-default hooks.  The plan owns a logical clock (`now`, one tick
per engine poll) and every probabilistic draw is a pure function of
``(seed, point, consultation-counter)``, so a chaos run is exactly
reproducible: same plan, same workload, same faults, same token streams.

Named fault points
------------------

``kv.exhaust``
    Level-triggered: while armed, the page allocator reports zero free
    pages (``_avail_for`` -> 0, ``_alloc_page`` -> None).  Admission
    stalls and speculative re-grow preempts, exactly as if the pool
    were full.  Level (not edge) semantics matter: the allocator's
    accounting check (`can_reserve`) and the subsequent allocation must
    see the *same* pool state within one tick.

``step.error``
    Edge-triggered: the fused device step raises
    :class:`InjectedFault` at dispatch, exercising crash containment
    (that tick's in-flight requests finish with
    ``finish_reason="error"``; the engine keeps serving).

``tick.delay``
    Edge-triggered: the engine sleeps ``delay_s`` before the tick,
    modelling a slow device / straggler shard.

``gateway.disconnect``
    Edge-triggered, consulted once per SSE event written: the gateway
    drops the client connection mid-stream (a disconnect storm),
    cancelling the request server-side.

Faults are described by :class:`FaultSpec` windows or the
:func:`parse_faults` mini-grammar used by the launch CLIs::

    parse_faults("step.error@3,kv.exhaust@1:4,tick.delay@0:20:p0.5:d0.01")

Engines built without a plan share the :data:`NO_FAULTS` singleton,
whose hooks all answer "no fault" without any bookkeeping.
"""

from __future__ import annotations

import collections
import dataclasses
import zlib
from typing import Dict, List, Optional, Sequence, Tuple


class InjectedFault(RuntimeError):
    """Raised from an armed ``step.error`` fault point."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One armed window for a named fault point.

    The spec is armed on ticks ``start <= now < stop`` (``stop=None``
    means open-ended).  Within the window, edge-triggered points fire
    with probability ``prob`` per consultation (deterministic seeded
    draw), at most ``times`` times total (``None`` = unbounded);
    ``delay_s`` is the sleep injected by ``tick.delay``.
    """

    point: str
    start: int = 0
    stop: Optional[int] = None
    prob: float = 1.0
    times: Optional[int] = None
    delay_s: float = 0.01

    def armed(self, now: int) -> bool:
        return self.start <= now and (self.stop is None or now < self.stop)


class FaultPlan:
    """A seeded, deterministic schedule over named fault points.

    ``advance()`` is called once per engine tick; ``active`` /
    ``fires`` / ``raise_if`` / ``delay`` are the hooks consulted at the
    fault points.  All randomness derives from ``(seed, point,
    consultation-counter)`` via crc32, so replays are bit-exact and
    independent of wall clock, thread timing, or any framework PRNG state.
    """

    def __init__(self, specs: Sequence[FaultSpec] = (), *, seed: int = 0):
        self.specs: Tuple[FaultSpec, ...] = tuple(specs)
        self.seed = seed
        self.now = -1  # advance() runs before the first tick -> tick 0
        self.fired: collections.Counter = collections.Counter()
        self._calls: collections.Counter = collections.Counter()
        self._by_point: Dict[str, List[FaultSpec]] = {}
        for s in self.specs:
            self._by_point.setdefault(s.point, []).append(s)

    def __bool__(self) -> bool:
        return bool(self.specs)

    def __repr__(self) -> str:
        return f"FaultPlan({list(self.specs)!r}, seed={self.seed})"

    # -- clock ---------------------------------------------------------

    def advance(self) -> None:
        """Move the logical clock one tick (engine poll / step)."""
        self.now += 1

    # -- hooks ---------------------------------------------------------

    def active(self, point: str) -> bool:
        """Level-triggered query: is any window for `point` armed now?"""
        return any(s.armed(self.now) for s in self._by_point.get(point, ()))

    def _fire(self, point: str) -> Optional[FaultSpec]:
        specs = self._by_point.get(point)
        if not specs:
            return None
        call = self._calls[point]
        self._calls[point] += 1
        for s in specs:
            if not s.armed(self.now):
                continue
            if s.times is not None and self.fired[point] >= s.times:
                continue
            if s.prob < 1.0:
                draw = zlib.crc32(f"{self.seed}:{point}:{call}".encode())
                if draw / 0xFFFFFFFF >= s.prob:
                    continue
            self.fired[point] += 1
            return s
        return None

    def fires(self, point: str) -> bool:
        """Edge-triggered draw: does `point` fire on this consultation?"""
        return self._fire(point) is not None

    def raise_if(self, point: str) -> None:
        if self._fire(point) is not None:
            raise InjectedFault(f"injected fault {point!r} (tick {self.now})")

    def delay(self, point: str) -> float:
        """Seconds to sleep if `point` fires on this consultation."""
        s = self._fire(point)
        return s.delay_s if s is not None else 0.0


#: Shared empty plan: every hook answers "no fault".
NO_FAULTS = FaultPlan()


def parse_faults(text: Optional[str], *, seed: int = 0) -> FaultPlan:
    """Build a :class:`FaultPlan` from the CLI mini-grammar.

    Comma-separated entries ``point[@start[:stop][:pP][:xN][:dS]]``:
    ``@3`` arms tick 3 only, ``@1:4`` arms ticks [1, 4), a bare point
    is armed forever; ``:p0.5`` fires with probability 0.5 per
    consultation, ``:x2`` caps total firings at 2, ``:d0.05`` sets the
    ``tick.delay`` sleep to 50 ms.  Empty / None input returns
    :data:`NO_FAULTS`.
    """
    if not text:
        return NO_FAULTS
    specs = []
    for entry in text.split(","):
        entry = entry.strip()
        if not entry:
            continue
        point, _, rest = entry.partition("@")
        kw: dict = {"point": point, "start": 0, "stop": None}
        if rest:
            parts = rest.split(":")
            kw["start"] = int(parts[0])
            kw["stop"] = kw["start"] + 1
            for part in parts[1:]:
                if part.startswith("p"):
                    kw["prob"] = float(part[1:])
                elif part.startswith("x"):
                    kw["times"] = int(part[1:])
                elif part.startswith("d"):
                    kw["delay_s"] = float(part[1:])
                else:
                    kw["stop"] = None if part == "" else int(part)
        specs.append(FaultSpec(**kw))
    return FaultPlan(specs, seed=seed)
