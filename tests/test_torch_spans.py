"""The port's spans, stamps and ``prefill_positions`` (``utils/spans``,
``serving/engine.py``, ``serving/scheduler.py``, ``core/attention.py``)
on a tiny CPU engine: f32 smoke ``mistral-nemo-12b`` on ``camformer``
with ``paged_impl="fused"``, so prefill chunks take the gather route and
decode rows the fused one; 3 slots and 5 requests, so some queue.  Each
case runs the same requests with tracing off and on."""

import numpy as np
import pytest
import torch

from repro_torch.configs import smoke_config
from repro_torch.kernels import (bacam_decode, bacam_mvm, bacam_topk,
                                 bitslice_vmm, flash_attention,
                                 paged_flash_decode)
from repro_torch.models.module import init_params
from repro_torch.serving import Request, SamplingParams, ServeEngine
from repro_torch.utils import spans

CASES = {  # engine flags
    "overlap": dict(mode="overlap"),
    "sync": dict(mode="sync"),
    "overlap-sliced": dict(mode="overlap", prefill_slice=8),
}
KERNELS = (bacam_decode, bacam_mvm, bacam_topk, bitslice_vmm,
           flash_attention, paged_flash_decode)
CAM_SPANS = {"attn.cam.kernel1", "attn.cam.gather", "attn.cam.score",
             "attn.cam.stage1", "attn.cam.stage2", "attn.cam.context"}

_RUNS = {}


def _run(case, traced):
    """(engine, requests, drained, prefill plans' token block sizes,
    blocked_s before the loop, kernel launches) of one run."""
    key = (case, traced)
    if key in _RUNS:
        return _RUNS[key]
    cfg = smoke_config("mistral-nemo-12b", attn_backend="camformer",
                       paged_impl="fused")
    params = init_params(cfg, device="cpu", seed=3)
    eng = ServeEngine(cfg, params, max_batch=3, max_len=48, page_size=8,
                      device="cpu", **CASES[case])
    rng = np.random.default_rng(5)
    reqs = [Request(prompt=[int(t) for t in rng.integers(0, cfg.vocab, n)],
                    sampling=SamplingParams(max_new=m))
            for n, m in ((5, 4), (19, 3), (9, 6), (3, 5), (12, 2))]
    blocks = []
    plan_tick = eng.sched.plan_tick

    def planned(**kw):
        plan = plan_tick(**kw)
        if plan.prefill is not None:
            blocks.append(plan.prefill.tokens.size)
        return plan

    eng.sched.plan_tick = planned
    launches0 = [m.launches for m in KERNELS]
    blocked0 = eng.blocked_s
    spans.drain()
    if traced:
        spans.enable()
    try:
        for r in reqs:
            eng.submit(r)
        eng.run()
    finally:
        spans.disable()
    got = spans.drain()
    launches = [m.launches - a for m, a in zip(KERNELS, launches0)]
    _RUNS[key] = (eng, reqs, got, blocks, blocked0, launches)
    return _RUNS[key]


@pytest.mark.parametrize("case", CASES)
def test_off_records_nothing(case):
    _, _, got, _, _, _ = _run(case, False)
    assert got == {"spans": [], "stamps": {}}


@pytest.mark.parametrize("case", CASES)
def test_tracing_changes_no_result(case):
    off, on = _run(case, False), _run(case, True)
    assert [r.tokens for r in on[1]] == [r.tokens for r in off[1]]
    assert [r.finish_reason for r in on[1]] == ["length"] * len(on[1])
    for attr in ("readbacks", "ticks", "prefill_ticks", "prefill_tokens",
                 "prefill_positions", "tick_errors"):
        assert getattr(on[0], attr) == getattr(off[0], attr), attr
    assert on[5] == off[5]


@pytest.mark.parametrize("case", CASES)
def test_spans_nest(case):
    """engine.poll > engine.dispatch > model.* > attn.cam.*, every span
    inside its parent and carrying its tick's index."""
    _, _, got, _, _, _ = _run(case, True)
    recs = got["spans"]
    names = {r[0] for r in recs}
    assert CAM_SPANS <= names
    assert {"engine.poll", "engine.plan", "engine.dispatch",
            "engine.readback", "engine.ingest", "model.prefill",
            "model.decode"} <= names
    want_parent = {"engine.plan": "engine.poll",
                   "engine.dispatch": "engine.poll",
                   "engine.readback": "engine.poll",
                   "engine.ingest": "engine.poll",
                   "model.prefill": "engine.dispatch",
                   "model.decode": "engine.dispatch"}
    ticks, rows = set(), np.zeros(2, int)
    for name, s, e, parent, attrs in recs:
        assert e is not None and s <= e, name
        if name == "engine.poll":
            assert parent == -1
            assert attrs["tick"] not in ticks
            ticks.add(attrs["tick"])
            rows += [attrs.get("prefill_rows", 0),
                     attrs.get("decode_rows", 0)]
            continue
        pname, ps, pe, _, pattrs = recs[parent]
        assert ps <= s and e <= pe, (name, pname)
        assert attrs["tick"] == pattrs["tick"]
        if name.startswith("attn.cam."):
            assert pname in ("model.prefill", "model.decode"), name
        else:
            assert pname == want_parent[name], name
    assert rows.min() > 0
    # the fused route on decode rows, the gather route on prefill chunks
    route = {(recs[p][0], n) for n, _, _, p, _ in recs
             if n in ("attn.cam.kernel1", "attn.cam.gather")}
    assert route == {("model.decode", "attn.cam.kernel1"),
                     ("model.prefill", "attn.cam.gather")}


@pytest.mark.parametrize("case", CASES)
def test_readback_spans_are_blocked_s(case):
    eng, _, got, _, blocked0, _ = _run(case, True)
    reads = [e - s for n, s, e, _, _ in got["spans"]
             if n == "engine.readback"]
    assert len(reads) == eng.readbacks
    assert sum(reads) / 1e9 == pytest.approx(eng.blocked_s - blocked0,
                                             rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("case", CASES)
def test_prefill_positions_count_the_block(case):
    eng, _, _, blocks, _, _ = _run(case, False)
    assert len(blocks) == eng.prefill_ticks
    assert eng.prefill_positions == sum(blocks)
    assert 0 < eng.prefill_tokens < eng.prefill_positions


@pytest.mark.parametrize("case", CASES)
def test_stamps_ordered(case):
    _, reqs, got, _, _, _ = _run(case, True)
    stamps = got["stamps"]
    assert set(stamps) == {r.rid for r in reqs}
    for r in reqs:
        st = stamps[r.rid]
        order = [st[k] for k in ("submit", "admit", "prefill_enqueued",
                                 "first_token")]
        assert order == sorted(order), (r.rid, st)
    # 5 requests over 3 slots: some wait in the queue
    assert max(s["admit"] - s["submit"] for s in stamps.values()) > \
        min(s["admit"] - s["submit"] for s in stamps.values())


def test_off_span_is_shared():
    """Off: ``span`` hands back one shared object and records nothing;
    ``record`` and ``stamp`` record nothing."""
    spans.disable()
    spans.drain()
    a, b = spans.span("x", tick=1), spans.span("y")
    assert a is b
    with a as s:
        s.set(rows=1)
    spans.record("z", 1, 2)
    spans.stamp(0, "submit")
    assert spans.drain() == {"spans": [], "stamps": {}}


def test_no_cuda_event_when_on(monkeypatch):
    """On: a span records host clock readings only."""
    made = []
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: made.append(1))
    spans.enable()
    try:
        with spans.span("engine.poll", tick=7):
            with spans.span("engine.plan") as inner:
                inner.set(rows=2)
            spans.record("engine.readback", 10, 20)
        spans.stamp(4, "submit")
        spans.stamp(4, "submit")
    finally:
        spans.disable()
    got = spans.drain()
    assert not made
    assert [(n, p, a) for n, _, _, p, a in got["spans"]] == [
        ("engine.poll", -1, {"tick": 7}),
        ("engine.plan", 0, {"tick": 7, "rows": 2}),
        ("engine.readback", 0, {"tick": 7})]
    assert got["spans"][2][1:3] == (10, 20)
    assert list(got["stamps"]) == [4] and list(got["stamps"][4]) == \
        ["submit"]
