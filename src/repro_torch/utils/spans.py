"""In-memory spans and per-request stamps of the serving path, off by
default.

    from repro_torch.utils import spans

    spans.enable()
    ...                       # run the engine
    spans.disable()
    got = spans.drain()       # {"spans": [...], "stamps": {...}}

``span(name, **attrs)`` is a context manager that records
``(name, start_ns, end_ns, parent_index, attrs)``: the clock is
``time.perf_counter_ns()``, the parent the span open when it began (-1
for none), and a span inherits its parent's ``tick`` attribute, so the
spans of one engine tick carry the tick's index.  ``stamp(rid, event)``
keeps the first time each event of a request happened.  ``drain()``
returns what was recorded and clears it; nothing is exported or written.

With tracing off, ``span()`` tests one flag and returns a shared no-op
object: it allocates nothing, records no CUDA event and never
synchronises.  The spans are host times: a span around device work
bounds its enqueueing, not its execution.  One tracer serves the
process, and it is meant for the one thread that drives the engine.
"""

from __future__ import annotations

import time

__all__ = ["enable", "disable", "enabled", "span", "record", "stamp",
           "drain"]

_now = time.perf_counter_ns


class _Off:
    """The span returned while tracing is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        pass


_OFF = _Off()


class _Span:
    __slots__ = ("tracer", "rec")

    def __init__(self, tracer, rec):
        self.tracer, self.rec = tracer, rec

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.rec[2] = _now()
        stack = self.tracer.stack
        if stack and stack[-1] is self.rec:
            stack.pop()
        return False

    def set(self, **attrs):
        """Add attributes known only once the span has begun."""
        self.rec[4].update(attrs)


class _Tracer:
    def __init__(self):
        self.on = False
        self.spans = []  # [name, start, end, parent index, attrs]
        self.stack = []  # the open spans' records, outermost first
        self.stamps = {}  # rid -> {event: ns}

    def open(self, name, attrs, start=None):
        parent = self.stack[-1] if self.stack else None
        if parent is not None and "tick" not in attrs \
                and "tick" in parent[4]:
            attrs["tick"] = parent[4]["tick"]
        rec = [name, _now() if start is None else start, None,
               -1 if parent is None else parent[5], attrs,
               len(self.spans)]
        self.spans.append(rec)
        return rec


_tracer = _Tracer()


def enable() -> None:
    _tracer.on = True


def disable() -> None:
    _tracer.on = False


def enabled() -> bool:
    return _tracer.on


def span(name: str, **attrs):
    """A context manager bounding one piece of work (see the module's
    docstring); its ``set(**attrs)`` adds attributes later."""
    if not _tracer.on:
        return _OFF
    rec = _tracer.open(name, attrs)
    _tracer.stack.append(rec)
    return _Span(_tracer, rec)


def record(name: str, start_ns: int, end_ns: int, **attrs) -> None:
    """A closed span timed by the caller's own two clock reads
    (``time.perf_counter_ns``); its parent is the span open now."""
    if _tracer.on:
        _tracer.open(name, attrs, start_ns)[2] = end_ns


def stamp(rid, event: str) -> None:
    """The first time ``event`` happened to request ``rid``."""
    if _tracer.on:
        _tracer.stamps.setdefault(rid, {}).setdefault(event, _now())


def drain() -> dict:
    """Everything recorded since the last drain, then cleared: spans in
    the order they were opened (``record``'s when it was called),
    ``end_ns`` None for one still open."""
    t = _tracer
    out = {"spans": [(n, s, e, p, a) for n, s, e, p, a, _ in t.spans],
           "stamps": t.stamps}
    t.spans, t.stack, t.stamps = [], [], {}
    return out
