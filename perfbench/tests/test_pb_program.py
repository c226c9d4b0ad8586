"""The program record of a window (``yardstick/program.py``): device
time and idle gaps put down to program spans on synthetic records with a
known clock offset, and ``program_trace.py`` end to end on the CPU at
smoke size."""

import sys

import pytest

from yardstick import program, trace
from yardstick.registry import metric_reader

import program_trace

OFF = 10**6  # the kineto clock (wall) minus perf_counter
CLOCK0 = {"perf": 0, "wall": OFF, "mono": 5 * 10**9}
SPANS = [  # (name, start, end, parent, attrs), perf ns, as drain() gives
    ("engine.poll", 100, 1000, -1, {"tick": 1}),
    ("engine.dispatch", 150, 800, 0, {"tick": 1}),
    ("attn.cam.score", 200, 300, 1, {"tick": 1}),
    ("attn.cam.stage1", 300, 400, 1, {"tick": 1}),
    ("engine.readback", 1600, 1700, -1, {}),
]
# (name, device start, device end (perf ns), launch (perf ns) or None)
KERNELS = [
    ("and", -50, 100, 210),  # clipped at the window's start; score
    ("sort", 400, 500, 350),  # stage1
    ("copy", 950, 1000, 900),  # engine.poll after its dispatch ended
    ("add", 1200, 1300, 1100),  # launched in no span
    ("memset", 1400, 1450, None),  # no launch record
    ("and", 1900, 2100, 220),  # clipped at the window's end; score
]


def _records():
    device = [(n, s + OFF, e + OFF, i + 1)
              for i, (n, s, e, _) in enumerate(KERNELS)]
    launches = {i + 1: at + OFF for i, (_, _, _, at) in enumerate(KERNELS)
                if at is not None}
    return device, launches


def test_attribution_by_launch_and_gap_middle():
    device, launches = _records()
    got = program.attribute(device, launches, 0, 2000, SPANS, CLOCK0)
    assert got["device_by_span"] == pytest.approx(
        {"attn.cam.score": 200e-9, "attn.cam.stage1": 100e-9,
         "engine.poll": 50e-9})
    assert got["unattributed_s"] == pytest.approx(150e-9)
    assert got["unpaired_s"] == pytest.approx(50e-9)
    # gaps: [100, 400] mid 250 in score; [500, 950] mid 725 in dispatch;
    # [1000, 1200], [1300, 1400] in none; [1450, 1900] mid 1675 in readback
    idle = {k: (v["gaps"], v["seconds"]) for k, v in
            got["idle_by_span"].items()}
    assert idle == {"attn.cam.score": (1, pytest.approx(300e-9)),
                    "engine.dispatch": (1, pytest.approx(450e-9)),
                    program.NO_SPAN: (2, pytest.approx(300e-9)),
                    "engine.readback": (1, pytest.approx(450e-9))}
    # the same records through device_record: by_name adds up, and the
    # idle seconds are its idle seconds
    rec = trace.device_record([(n, s, e) for n, s, e, _ in device], 0, 2000,
                              [], CLOCK0)
    assert sum(got["device_by_span"].values()) + got["unattributed_s"] == \
        pytest.approx(sum(rec["by_name"].values()))
    assert sum(v[1] for v in idle.values()) == pytest.approx(
        sum(v["seconds"] for v in rec["idle_by_label"].values()))


@pytest.mark.parametrize("points,want", [
    ((99, 100, 150, 250, 299, 350, 850, 1000, 1001),
     (None, "engine.poll", "engine.dispatch", "attn.cam.score",
      "attn.cam.score", "attn.cam.stage1", "engine.poll", "engine.poll",
      None)),
    ((1650, 120, 1650), ("engine.readback", "engine.poll",
                         "engine.readback")),
])
def test_innermost_span(points, want):
    """Points in any order; a span that starts where its parent starts
    is still the inner one; an open span (no end) is left out."""
    spans = SPANS + [("engine.plan", 100, 140, 0, {}),
                     ("engine.ingest", 5000, None, -1, {})]
    got = program.innermost(spans, list(points))
    want = ["engine.plan" if w == "engine.poll" and 100 <= p <= 140 else w
            for p, w in zip(points, want)]
    assert got == want


def test_program_without_spans(monkeypatch):
    """A program with no spans module and no ``prefill_positions`` (the
    parent of the commit that added them): the counters are the
    harness's own and the five metrics have nothing to read."""
    import types

    import repro_torch.utils

    monkeypatch.delattr(repro_torch.utils, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.utils.spans", None)
    win = program.Window()
    counters = win._counters(lambda eng: {"prefill_tokens": 4})
    eng = types.SimpleNamespace()
    assert counters(eng) == counters(eng) == {"prefill_tokens": 4}
    rec = win.finish({"counters": {"prefill_tokens": 0}, "trace": None,
                      "loop_s": 1.0})
    assert "program" not in rec
    for name in program_trace.METRICS:
        assert metric_reader(name)(rec) is None, name


def test_three_modes_on_cpu(smoke_root):
    """Off, spans and traced on one seed: the counter's metric in every
    run, the spans' and stamps' from the spans on, and no device metric
    on the CPU.  (``correct`` is not asserted: at smoke size a prompt
    can hit a one-token prefix tail of an earlier prompt, and the
    check's recording then misses position 0 in any mode; PERF.md §7.)"""
    rows = program_trace.main(
        ["--workload", "nemo12b-cam.rag", "--seeds", str(2**31 + 17),
         "--seconds", "1.5"], root=smoke_root, device="cpu")
    assert [r["mode"] for r in rows] == ["off", "spans", "traced"]
    counted = {"sched.prefill_live_share"}
    stamped = {"engine.dispatch_share", "sched.queue_wait_p90_s",
               "engine.first_token_lag_p90_s"}
    for r in rows:
        want = counted if r["mode"] == "off" else counted | stamped
        assert set(r["metrics"]) == want, r["mode"]
        for name, v in r["metrics"].items():
            assert isinstance(v, float) and v >= 0, name
        assert 0 < r["metrics"]["sched.prefill_live_share"] <= 1
    assert rows[1]["tokens"] > 0 and rows[1]["spans"] > 0
    split = rows[1]["program_breakdown"]["ttft_split_p50_p90_s"]
    assert set(split) == {"queue", "prefill", "lag"}

