"""The profiler arithmetic of a traced run.

A frozen copy of ``chip_smoke.profiled``'s method: ``torch.profiler``
traces the device's activity alone (CUDA runtime calls and kernels, no
operator events) and the raw kineto records are read
(``prof.profiler.kineto_results.events()``), never exported to disk.
Added here: the busy time is the union of the device records' intervals
(so records that overlap count once), clipped to the window, and each
idle gap of the device is labelled by the host span the harness was in
at the gap's middle.

Clocks: the harness times its spans with ``time.perf_counter_ns``; the
kineto records carry their own clock, which is the wall clock on some
builds and the monotonic one on others.  ``Tracer.start`` reads both host
clocks beside the profiler's start, and ``device_record`` takes the one
whose reading lies nearer the records.
"""

from __future__ import annotations

import time
from collections import defaultdict


class Tracer:
    """Device-only profiling of the measured window."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])

    def start(self):
        import torch

        torch.cuda.synchronize()
        self.prof.start()
        torch.cuda.synchronize()
        self.perf0 = time.perf_counter_ns()
        self.wall0 = time.time_ns()
        self.mono0 = time.monotonic_ns()

    def stop(self):
        import torch

        torch.cuda.synchronize()
        self.prof.stop()

    def device_intervals(self):
        """(name, start ns, end ns) of every device record, kineto clock."""
        from torch.autograd import DeviceType

        out = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                out.append((e.name(), s, s + e.duration_ns()))
        return out


def _merge(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return merged


def device_record(events, t0_ns: int, t1_ns: int, spans, clock0: dict):
    """Busy seconds, device time by name, and idle gaps by host span.

    events: (name, start, end) in the kineto clock; t0_ns, t1_ns: the
    window in ``perf_counter_ns``; spans: (label, start, end) host spans
    in ``perf_counter_ns``; clock0: {"perf", "wall", "mono"} readings
    taken together at the profiler's start."""
    if not events:
        return None
    first = min(s for _, s, _ in events)
    # the kineto clock's offset from perf_counter: wall or monotonic,
    # whichever lies nearer the records
    offs = {k: clock0[k] - clock0["perf"] for k in ("wall", "mono")}
    off = min(offs.values(), key=lambda o: abs(first - (clock0["perf"] + o)))
    w0, w1 = t0_ns + off, t1_ns + off
    by_name = defaultdict(float)
    clipped = []
    for name, s, e in events:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            by_name[name] += (e - s) / 1e9
            clipped.append((s, e))
    merged = _merge(clipped)
    busy = sum(e - s for s, e in merged) / 1e9
    gaps = []
    prev = w0
    for s, e in merged + [[w1, w1]]:
        if s > prev:
            gaps.append((prev, s))
        prev = max(prev, e)
    label_idle = defaultdict(float)
    label_n = defaultdict(int)
    label_max = defaultdict(float)
    host = sorted((s + off, e + off, lab) for lab, s, e in spans)
    j = 0
    for gs, ge in gaps:
        mid = (gs + ge) // 2
        while j < len(host) and host[j][1] < mid:
            j += 1
        lab = (host[j][2] if j < len(host) and host[j][0] <= mid
               else "harness bookkeeping")
        sec = (ge - gs) / 1e9
        label_idle[lab] += sec
        label_n[lab] += 1
        label_max[lab] = max(label_max[lab], sec)
    return dict(
        busy_s=busy,
        by_name=dict(by_name),
        idle_by_label={k: dict(seconds=label_idle[k], gaps=label_n[k],
                               longest_s=label_max[k]) for k in label_idle})


def breakdown(rec: dict) -> dict:
    """The result line's ``breakdown``: the ten device operations that
    took most time, and the device's idle seconds by host span."""
    ops = sorted(rec["by_name"].items(), key=lambda kv: -kv[1])[:10]
    idle = sorted(rec["idle_by_label"].items(),
                  key=lambda kv: -kv[1]["seconds"])[:10]
    return {"device_ops": [[n[:120], s] for n, s in ops],
            "idle_gaps": [[f"{k} ({v['gaps']} gaps, longest "
                           f"{v['longest_s']} s)", v["seconds"]]
                          for k, v in idle]}
