"""The program's own spans, stamps and counters in a window, and the
device time of a traced window put down to the program's spans.

The program (``repro_torch.utils.spans``) records host spans on the
``time.perf_counter_ns`` clock: ``engine.poll`` (one a tick),
``engine.plan``, ``engine.dispatch``, ``model.prefill`` /
``model.decode`` / ``model.spec``, the CAM attention backend's
``attn.cam.*``, ``engine.readback`` and ``engine.ingest``, and stamps
each request's ``submit``, ``admit``, ``prefill_enqueued`` and
``first_token``.  ``Scheduler.prefill_positions`` counts the positions
the prefill steps compute, padding included.

Device time by span: every kernel, copy or memset record of the
device-only profile carries the CUPTI correlation id of the CUDA runtime
call that launched it; the runtime call's start, moved to
``perf_counter`` by the offset ``trace.device_record`` chooses, falls in
the innermost program span open at the launch.  Each record counts with
its interval clipped to the window, as in ``device_record``'s
``by_name``, so ``device_by_span`` and ``unattributed_s`` add up to the
sum of ``by_name``.  An idle gap of the device goes to the innermost
program span open at its middle.

``Window`` gathers all of it around ``cell.run`` without a change to
``cell.py`` or ``trace.py``: it wraps ``cell._counters`` (called once
at the window's start and once at its end), ``trace.Tracer`` and
``trace.device_record`` while installed.  ``program_trace.py`` runs it.
Where the program has no spans module or no ``prefill_positions``, as
before they existed, the record lacks those keys and the metrics that
read them return None.
"""

from __future__ import annotations

import contextlib
import time
from collections import Counter, defaultdict

from yardstick import trace as T

NO_SPAN = "no program span"


def clock_offset(device_starts, clock0: dict) -> int:
    """kineto clock minus ``perf_counter``: ``device_record``'s choice
    (wall or monotonic, whichever lies nearer the device records)."""
    first = min(device_starts)
    offs = {k: clock0[k] - clock0["perf"] for k in ("wall", "mono")}
    return min(offs.values(), key=lambda o: abs(first - (clock0["perf"] + o)))


def innermost(spans, points) -> list:
    """For each point (perf ns), the name of the innermost span open at
    it, or None.  ``spans``: (name, start, end, ...) that nest, as the
    program's do; a span with no end is left out."""
    sp = sorted((s, -e, n) for n, s, e, *_ in spans if e is not None)
    out = [None] * len(points)
    stack = []  # (start, end, name), each inside the one below
    j = 0
    for i in sorted(range(len(points)), key=points.__getitem__):
        t = points[i]
        while j < len(sp) and sp[j][0] <= t:
            s, neg_e, name = sp[j]
            while stack and stack[-1][1] < s:
                stack.pop()
            stack.append((s, -neg_e, name))
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def attribute(device, launches: dict, t0_ns: int, t1_ns: int, spans,
              clock0: dict):
    """Device seconds and idle gaps of a traced window by program span.

    device: (name, start, end, correlation id) device records, kineto
    clock; launches: correlation id -> start of the runtime call, kineto
    clock; t0_ns, t1_ns: the window in ``perf_counter_ns``; spans: the
    program's (name, start, end, parent, attrs) in ``perf_counter_ns``;
    clock0 as ``device_record``'s.  Returns ``device_by_span`` (device
    s by the innermost span open at the launch), ``idle_by_span``
    ({span: {"seconds", "gaps"}}, by the innermost span open at the
    gap's middle), ``unattributed_s`` (device s launched in no span or
    with no launch record) and ``unpaired_s`` (its part with no launch
    record)."""
    if not device:
        return None
    off = clock_offset([s for _, s, _, _ in device], clock0)
    w0, w1 = t0_ns + off, t1_ns + off
    clipped, at = [], []
    unpaired = 0
    for _, s, e, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        launch = launches.get(corr)
        if launch is None:
            unpaired += e - s
        else:
            clipped.append((s, e))
            at.append(launch - off)
    by_span = defaultdict(float)
    unattributed = unpaired
    for (s, e), lab in zip(clipped, innermost(spans, at)):
        if lab is None:
            unattributed += e - s
        else:
            by_span[lab] += (e - s) / 1e9
    busy = T._merge([(max(s, w0), min(e, w1)) for _, s, e, _ in device
                     if min(e, w1) > max(s, w0)])
    gaps, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    idle = defaultdict(lambda: {"seconds": 0.0, "gaps": 0})
    mids = [(gs + ge) // 2 - off for gs, ge in gaps]
    for (gs, ge), lab in zip(gaps, innermost(spans, mids)):
        slot = idle[lab or NO_SPAN]
        slot["seconds"] += (ge - gs) / 1e9
        slot["gaps"] += 1
    return dict(device_by_span=dict(by_span), idle_by_span=dict(idle),
                unattributed_s=unattributed / 1e9, unpaired_s=unpaired / 1e9)


def host_by_span(spans) -> dict:
    """{name: [count, seconds, self seconds]} of the program's spans;
    self time leaves out the part its child spans cover."""
    out = defaultdict(lambda: [0, 0.0, 0.0])
    child = defaultdict(int)
    for _, s, e, parent, _ in spans:
        if e is not None and parent >= 0:
            child[parent] += e - s
    for i, (name, s, e, _, _) in enumerate(spans):
        if e is None:
            continue
        row = out[name]
        row[0] += 1
        row[1] += (e - s) / 1e9
        row[2] += (e - s - child[i]) / 1e9
    return dict(out)


def request_waits(prog: dict) -> dict:
    """Per request submitted in the window, from the program's stamps:
    ``queue`` (admit - submit), ``prefill`` (prefill_enqueued - admit)
    and ``lag`` (first_token - prefill_enqueued), in s.  A stage not
    reached by the window's end counts with its wait so far, as
    ``ttft_p90_s`` counts a missing first token; a later stage of such a
    request is left out."""
    end = prog["t1_ns"]
    out = {"queue": [], "prefill": [], "lag": []}
    for st in prog["stamps"].values():
        if "submit" not in st:
            continue  # submitted before the window
        t = st["submit"]
        for stage, ev in (("queue", "admit"), ("prefill", "prefill_enqueued"),
                          ("lag", "first_token")):
            nxt = st.get(ev)
            out[stage].append(((end if nxt is None else nxt) - t) / 1e9)
            if nxt is None:
                break
            t = nxt
    return out


def program_breakdown(rec: dict) -> dict:
    """Device seconds and idle gaps by program span, the device seconds
    no span launched, host seconds by span, and the split of the wait
    for the first token (p50 / p90 of each stage)."""
    from yardstick.stats import percentile

    out = {}
    tr = rec.get("trace") or {}
    if "device_by_span" in tr:
        out["device_by_span"] = sorted(
            ([k, v] for k, v in tr["device_by_span"].items()),
            key=lambda kv: -kv[1])
        out["idle_by_span"] = sorted(
            ([f"{k} ({v['gaps']} gaps)", v["seconds"]]
             for k, v in tr["idle_by_span"].items()), key=lambda kv: -kv[1])
        out["unattributed_s"] = tr["unattributed_s"]
        out["unpaired_s"] = tr["unpaired_s"]
        out["pairing"] = tr.get("pairing")
    prog = rec.get("program")
    if prog:
        out["host_by_span"] = {k: v for k, v in sorted(
            host_by_span(prog["spans"]).items(), key=lambda kv: -kv[1][1])}
        out["ttft_split_p50_p90_s"] = {
            k: [percentile(v, 50), percentile(v, 90), len(v)]
            for k, v in request_waits(prog).items()}
    return out


class _KinetoTracer(T.Tracer):
    """``trace.Tracer`` that also keeps, from the same kineto records,
    each device record's correlation id and each runtime call's start."""

    window = None  # the Window the records go to

    def device_intervals(self):
        from torch.autograd import DeviceType

        device, launches, linked, calls = [], {}, [], Counter()
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                device.append((e.name(), s, s + e.duration_ns(),
                               e.correlation_id()))
                linked.append(e.linked_correlation_id())
            else:
                corr = e.correlation_id()
                calls[e.name()] += 1
                if corr:
                    launches.setdefault(corr, e.start_ns())
        self.window.kineto = (device, launches)
        # which field pairs a device record with its launch
        self.window.pairing = dict(
            device_records=len(device), host_records=sum(calls.values()),
            by_correlation_id=sum(c in launches for *_, c in device),
            by_linked_correlation_id=sum(c in launches for c in linked),
            host_calls=calls.most_common(6))
        return [(n, s, e) for n, s, e, _ in device]


class Window:
    """The program's spans, stamps and ``prefill_positions`` over one
    ``cell.run`` window, and in a traced run on the card the device time
    by span.  ``spans_on=False`` records no span (the counter still
    reads)."""

    def __init__(self, spans_on: bool = True):
        self.spans_on = spans_on
        self.calls = 0
        self.drained = None
        self.t0_ns = self.t1_ns = None
        self.kineto = None
        self.pairing = None  # the kineto records' counts, traced runs
        self.window_args = None

    def _counters(self, orig):
        try:
            from repro_torch.utils import spans
        except ImportError:  # a program without spans
            spans = None

        def counters(eng):
            c = orig(eng)
            if hasattr(eng, "prefill_positions"):
                c["prefill_positions"] = eng.prefill_positions
            self.calls += 1
            if spans is not None and self.spans_on:
                if self.calls == 1:  # the window starts
                    spans.drain()
                    spans.enable()
                    self.t0_ns = time.perf_counter_ns()
                else:
                    self.t1_ns = time.perf_counter_ns()
                    spans.disable()
                    self.drained = spans.drain()
            return c
        return counters

    @contextlib.contextmanager
    def installed(self, cell):
        orig = (cell._counters, T.Tracer, T.device_record)

        def device_record(events, t0_ns, t1_ns, spans, clock0):
            self.window_args = (t0_ns, t1_ns, clock0)
            return orig[2](events, t0_ns, t1_ns, spans, clock0)

        tracer = type("Tracer", (_KinetoTracer,), {"window": self})
        cell._counters = self._counters(orig[0])
        T.Tracer, T.device_record = tracer, device_record
        try:
            yield self
        finally:
            cell._counters, T.Tracer, T.device_record = orig

    def finish(self, rec: dict) -> dict:
        """Put the window's program record into ``rec``: ``program``
        (spans, stamps, the window in ``perf_counter_ns``), and in a
        traced run on the card ``device_by_span``, ``idle_by_span``,
        ``unattributed_s`` and ``unpaired_s`` beside ``rec["trace"]``'s
        own keys."""
        if self.drained is not None:
            rec["program"] = dict(self.drained, t0_ns=self.t0_ns,
                                  t1_ns=self.t1_ns)
        if self.kineto is not None and self.window_args is not None \
                and rec.get("trace") and self.drained is not None:
            t0_ns, t1_ns, clock0 = self.window_args
            got = attribute(*self.kineto, t0_ns, t1_ns,
                            self.drained["spans"], clock0)
            if got is not None:
                rec["trace"].update(got, pairing=self.pairing)
        self.kineto = None
        return rec
