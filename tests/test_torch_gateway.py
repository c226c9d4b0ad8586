"""The port's network gateway against the reference's.

Real sockets against ``serve_background`` on the port's ``ServeEngine``
on the CPU, at the f32 smoke width of ``codeqwen1.5-7b`` (3 slots,
64-token slots, 8-token pages) with the reference's weights carried
through ``from_jax_params``:

  * the SSE stream of a keyed request (temperature 0.8, top-k 8) equals
    the JAX engine's in-process ``stream()`` of the same request, token
    for token, on ``dense`` and ``camformer``;
  * ``/healthz`` and ``/metrics`` carry the reference gateway's keys
    for the same engine configuration (the port adds ``device`` to
    ``/healthz``), with equal counters;
  * ``request_from_json`` raises the reference's ``ValueError`` message
    for each malformed body;
  * concurrent clients interleave, a disconnect cancels and frees pages,
    429 / 503 vetoes never reach the engine, a timed-out ``stop`` says
    so, and the runner thread runs the engine without autograd."""

import http.client
import json
import socket
import threading
import time

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import get_model_def
from repro.models.module import init_params as j_init
from repro import serving as J
from repro.serving import gateway as jgw

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import from_jax_params
from repro_torch import serving as T
from repro_torch.serving import gateway as tgw

ARCH = "codeqwen1.5-7b"
ENGINE_KW = dict(max_batch=3, max_len=64, page_size=8)
SAMPLING = dict(temperature=0.8, top_k=8, max_new=6)
PROMPT = [3, 5, 8, 1, 4]

_PARAMS = {}


def _params_np(backend):
    """The reference's smoke weights for ``backend``, as numpy."""
    if backend not in _PARAMS:
        cfg = j_smoke(ARCH, attn_backend=backend)
        params = j_init(get_model_def(cfg).specs(cfg), jax.random.PRNGKey(0))
        _PARAMS[backend] = jax.tree.map(np.asarray, params)
    return _PARAMS[backend]


def _j_engine(backend, **kw):
    cfg = j_smoke(ARCH, attn_backend=backend)
    params = jax.tree.map(jax.numpy.asarray, _params_np(backend))
    return J.ServeEngine(get_model_def(cfg), cfg, params,
                         **dict(ENGINE_KW, **kw))


def _t_engine(backend="dense", **kw):
    cfg = t_smoke(ARCH, attn_backend=backend)
    params = from_jax_params(_params_np(backend), cfg, device="cpu")
    return T.ServeEngine(cfg, params, device="cpu", **dict(ENGINE_KW, **kw))


def _sse_post(port, spec, timeout=120):
    """POST /v1/generate; (status, events or the error body, headers)."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/generate", body=json.dumps(spec),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    events, status = [], resp.status
    headers = dict(resp.getheaders())
    if status == 200:
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.strip()
            if not line.startswith(b"data: "):
                continue
            evt = json.loads(line[6:])
            events.append(evt)
            if evt.get("finished"):
                break
    else:
        events.append(json.loads(resp.read()))
    conn.close()
    return status, events, headers


def _get(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    out = json.loads(conn.getresponse().read())
    conn.close()
    return out


def _wait_for(cond, timeout=60.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def _keys(tree):
    """The key paths of a nested JSON object (list items by index)."""
    if isinstance(tree, dict):
        return {(k,) + p for k, v in tree.items() for p in _keys(v)} | {
            (k,) for k in tree}
    if isinstance(tree, list):
        return {(i,) + p for i, v in enumerate(tree) for p in _keys(v)}
    return set()


# ---------------------------------------------------------------------------
# SSE == the JAX engine's stream()


@pytest.mark.parametrize("backend", ["dense", "camformer"])
def test_sse_matches_jax_engine_stream(backend):
    # the gateway assigns rid 0 on a fresh engine; sampling is keyed by
    # (seed, rid, index), so the tokens must agree exactly
    want = [out.token for out in _j_engine(backend).stream(
        J.Request(prompt=list(PROMPT), rid=0, sampling=J.SamplingParams(**SAMPLING)))]
    assert len(want) == SAMPLING["max_new"]

    handle = tgw.serve_background(_t_engine(backend))
    try:
        status, events, _ = _sse_post(handle.port,
                                      dict(SAMPLING, prompt=PROMPT))
        assert handle.runner.engine.tick_errors == 0
    finally:
        assert handle.stop()
    assert status == 200
    assert [e["rid"] for e in events] == [0] * len(want)
    assert [e["token"] for e in events] == want
    assert [e["index"] for e in events] == list(range(1, len(want) + 1))
    final = events[-1]
    assert final["finished"] and final["finish_reason"] == "length"
    assert final["tokens"] == want


def test_healthz_and_metrics_match_reference_gateway():
    """The same engine configuration behind each package's gateway, one
    request each: the same JSON keys, and equal counters."""
    spec = dict(SAMPLING, prompt=PROMPT)
    got = {}
    for name, mod, eng in (("jax", jgw, _j_engine("dense")),
                           ("torch", tgw, _t_engine("dense"))):
        handle = mod.serve_background(eng)
        try:
            status, events, _ = _sse_post(handle.port, spec)
            assert status == 200 and events[-1]["finished"], name
            assert _wait_for(lambda: not (eng.has_work or eng.has_pending))
            got[name] = (_get(handle.port, "/healthz"),
                         _get(handle.port, "/metrics"), events)
        finally:
            assert handle.stop()
    (jh, jm, jev), (th, tm, tev) = got["jax"], got["torch"]
    assert [e["token"] for e in tev] == [e["token"] for e in jev]
    assert th.pop("device") == "cpu"
    assert th == jh
    assert _keys(tm) == _keys(jm)
    timed = ("blocked_s",)
    assert {k: v for k, v in tm["engine"].items() if k not in timed} == {
        k: v for k, v in jm["engine"].items() if k not in timed}
    assert tm["requests"] == jm["requests"]
    for hist in ("ttft_ms", "tpot_ms"):
        assert tm[hist]["count"] == jm[hist]["count"]
    assert tm["engine"]["readbacks"] == tm["engine"]["ticks"] + tm[
        "engine"]["prefill_ticks"]


# ---------------------------------------------------------------------------
# the engine surface the gateway reads


@pytest.mark.parametrize("prefill_slice", [None, 8])
def test_engine_surface_matches_reference(prefill_slice):
    """``schedule()`` / ``prefill(admitted)`` / ``queue`` / ``active`` /
    ``prefill_tokens`` / ``tp`` on each package's engine: a drained
    request leaves its 20-token prefix retained, a second request
    revives it through ``schedule()`` (a COW fork of the boundary page),
    ``prefill`` drives it to its first token, and the states and streams
    agree."""
    system = list(range(40, 60))  # 2 full 8-token pages + a 4-row tail

    def run(eng, mod):
        sp = mod.SamplingParams(max_new=4)
        eng.submit(mod.Request(prompt=system + [1, 2], sampling=sp, rid=0))
        eng.run()
        late = mod.Request(prompt=system + [9, 9], sampling=sp, rid=1)
        queued = mod.Request(prompt=[7, 7, 7], sampling=sp, rid=2)
        for r in (late, queued):
            eng.submit(r)
        queue0 = [r.rid for r in eng.queue]
        adm = eng.schedule()
        states = [(a.slot, a.req.rid, a.resume_from, a.matched,
                   [tuple(map(int, f)) for f in a.forks]) for a in adm]
        active = [None if r is None else (r.rid, r.state.value)
                  for r in eng.active]
        events = [(e.rid, e.token, e.index) for e in eng.prefill(adm)]
        after = (eng.prefill_tokens, eng.prefill_ticks, eng.tp,
                 [r.rid for r in eng.queue],
                 [None if r is None else r.state.value for r in eng.active])
        eng.run()
        return (queue0, states, active, events, after, late.tokens,
                queued.tokens, eng.kv.free_pages)

    got = run(_t_engine(max_batch=2, prefill_slice=prefill_slice), T)
    want = run(_j_engine("dense", max_batch=2, prefill_slice=prefill_slice),
               J)
    assert got == want
    queue0, states, _, events, after, _, _, _ = got
    assert queue0 == [1, 2]
    assert states[0][3] == 20 and states[0][4]  # matched, one COW fork
    assert [e[0] for e in events] == [1, 2] and after[2] == 1
    assert after[0] > 0 and after[3] == []


# ---------------------------------------------------------------------------
# request_from_json: the reference's messages

BODIES = [
    {"prompt": [1, 2], "max_new": 4, "temperature": 0.5, "top_k": 3,
     "top_p": 0.9, "stop": [7], "priority": 2, "deadline_ms": 100,
     "queue_timeout_ms": 50},  # valid
    [1, 2],
    "hi",
    {"prompt": []},
    {"prompt": "hi"},
    {"prompt": [True, 2], "max_new": 1},
    {"prompt": [1.5], "max_new": 1},
    {"prompt": [1], "stop": 7, "max_new": 1},
    {"prompt": [1], "max_new": 0},
    {"prompt": [1]},  # default max_new 32 exceeds max_len 16
    {"prompt": [1], "max_new": 1, "temperature": -1},
    {"prompt": [1], "max_new": 1, "top_k": -2},
    {"prompt": [1], "max_new": 1, "top_p": 0},
    {"prompt": [1], "max_new": 1, "deadline_ms": -5},
    {"prompt": [1], "max_new": 1, "queue_timeout_ms": 0},
]


def _parse(mod, body):
    try:
        req = mod.request_from_json(body, max_len=16)
    except ValueError as e:
        return "ValueError", str(e)
    return "ok", (req.prompt, req.priority, req.sampling.temperature,
                  req.sampling.top_k, req.sampling.top_p, req.sampling.stop,
                  req.sampling.max_new, req.sampling.deadline_ms,
                  req.sampling.queue_timeout_ms)


@pytest.mark.parametrize("body", BODIES, ids=lambda b: json.dumps(b)[:40])
def test_request_from_json_matches_reference(body):
    want = _parse(jgw, body)
    assert _parse(tgw, body) == want
    assert want[0] == ("ok" if body is BODIES[0] else "ValueError")


def test_malformed_bodies_get_400():
    handle = tgw.serve_background(_t_engine(max_len=16))
    try:
        for body in BODIES[1:]:
            status, events, _ = _sse_post(handle.port, body)
            assert status == 400, body
            assert "error" in events[0]
        assert handle.runner.metrics.snapshot()["requests"]["submitted"] == 0
    finally:
        assert handle.stop()


# ---------------------------------------------------------------------------
# continuous batching, disconnects, backpressure


def test_concurrent_clients_interleave():
    handle = tgw.serve_background(_t_engine())
    n_clients, results = 3, {}
    barrier = threading.Barrier(n_clients)

    def client(i):
        barrier.wait()
        results[i] = _sse_post(handle.port, {
            "prompt": [10 + i, 3, 5], "max_new": 10, "temperature": 0.8,
            "top_k": 8})

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(n_clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert all(not t.is_alive() for t in threads)
        assert all(results[i][0] == 200 for i in range(n_clients))
        assert all(results[i][1][-1]["finished"] for i in range(n_clients))
        assert len({results[i][1][0]["rid"] for i in range(n_clients)}) == 3
        # one token per live request per decode tick: resident requests
        # alternate in the routed order instead of finishing in turn
        log = list(handle.runner.metrics.event_log)
        changes = sum(a[0] != b[0] for a, b in zip(log, log[1:]))
        assert changes > n_clients, log
    finally:
        assert handle.stop()


def test_disconnect_cancels_and_frees_pages():
    eng = _t_engine()
    handle = tgw.serve_background(eng)
    try:
        body = json.dumps({"prompt": [3, 5, 8, 1], "max_new": 50,
                           "temperature": 0.8, "top_k": 8}).encode()
        s = socket.create_connection(("127.0.0.1", handle.port), timeout=60)
        s.sendall(b"POST /v1/generate HTTP/1.1\r\n"
                  b"Host: x\r\nContent-Type: application/json\r\n"
                  + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        buf = b""
        while buf.count(b"data: ") < 2:  # two streamed tokens, mid-flight
            chunk = s.recv(4096)
            assert chunk, f"stream ended early: {buf!r}"
            buf += chunk
        rid = json.loads(buf.split(b"data: ", 1)[1].split(b"\n", 1)[0])["rid"]
        s.close()  # abrupt client disconnect

        assert _wait_for(lambda: any(
            r.rid == rid and r.finish_reason == "cancelled"
            for r in eng.done)), "disconnect did not cancel the request"
        assert _wait_for(lambda: eng.kv.free_pages == eng.kv.n_pages - 1), (
            eng.kv.free_pages, eng.kv.n_pages - 1)
        assert _wait_for(lambda: eng.sched._inflight_total == 0)
        assert handle.runner.is_alive()
        eng.kv.check()

        status, events, _ = _sse_post(handle.port,
                                      {"prompt": [9, 1, 4], "max_new": 2})
        assert status == 200 and events[-1]["finish_reason"] == "length"
    finally:
        assert handle.stop()


def test_backpressure_429_and_503_match_reference():
    """A request the engine can never serve is 503, a full bounded queue
    429 + Retry-After; neither reaches the engine thread.  Each package's
    gateway gives the same status, body and header."""
    got = {}
    for name, mod, eng in (
            ("jax", jgw, _j_engine("dense", n_pages=3, max_queue=0)),
            ("torch", tgw, _t_engine("dense", n_pages=3, max_queue=0))):
        handle = mod.serve_background(eng)
        try:
            never = _sse_post(handle.port, {"prompt": [1, 2, 3],
                                            "max_new": 30})
            full = _sse_post(handle.port, {"prompt": [1, 2, 3],
                                           "max_new": 1})
            snap = handle.runner.metrics.snapshot()["requests"]
            got[name] = (never[:2], full[:2], full[2].get("Retry-After"),
                         snap["rejected"], snap["submitted"], eng.ticks,
                         len(eng.queue))
        finally:
            assert handle.stop()
    (st, evts), (st2, evts2), retry, rejected, submitted, ticks, queued = (
        got["torch"])
    assert got["torch"] == got["jax"]
    assert st == 503 and evts[0]["finish_reason"] == "rejected"
    assert "pool has 2" in evts[0]["error"]
    assert st2 == 429 and retry == "1" and evts2[0]["retry_after_s"] == 1
    assert "queue full" in evts2[0]["error"]
    assert (rejected, submitted, ticks, queued) == (2, 0, 0, 0)


def test_runner_stop_timeout_reports_failure(caplog):
    """A stop() whose join times out returns False and logs, instead of
    reporting a clean shutdown while the thread still runs."""

    class Stuck(tgw.EngineRunner):
        def run(self):  # ignores _stopping long enough to miss the join
            time.sleep(0.5)

    runner = Stuck(_t_engine())
    runner.start()
    with caplog.at_level("ERROR", logger="repro_torch.serving.gateway"):
        assert runner.stop(timeout=0.05) is False
    assert any("failed to stop" in r.message for r in caplog.records)
    runner.join(5)
    assert runner.stop(timeout=5) is True  # once dead, stop reports clean


def test_background_stop_reports_a_stuck_runner(monkeypatch, caplog):
    """``serve_background``'s handle reports False while its engine
    thread still runs, though the gateway thread itself has ended."""
    release = threading.Event()

    class Stuck(tgw.EngineRunner):
        def run(self):  # ignores _stopping until released
            release.wait(10)

    monkeypatch.setattr(tgw, "EngineRunner", Stuck)
    handle = tgw.serve_background(_t_engine())
    try:
        with caplog.at_level("ERROR", logger="repro_torch.serving.gateway"):
            assert handle.stop(timeout=0.05) is False
        assert handle.runner.is_alive()
        assert any("failed to stop" in r.message for r in caplog.records)
    finally:
        release.set()
        handle.runner.join(5)
    assert not handle.runner.is_alive()


# ---------------------------------------------------------------------------
# grad mode is per thread


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree] if torch.is_tensor(tree) else []


@pytest.mark.parametrize("via_runner", [False, True],
                         ids=["poll", "runner"])
def test_engine_thread_runs_without_autograd(via_runner):
    """Weights that require grad, polled from a fresh thread with grad
    mode on (a new thread does not inherit its creator's no_grad): no
    pool leaf and no sampled-token tensor may carry a graph."""
    eng = _t_engine("dense", spec_k=2)
    for leaf in _leaves(eng.params):
        if leaf.is_floating_point():
            leaf.requires_grad_(True)
    sampled = []
    collect = eng._collect

    def spy(inflight):  # the tick's device tensors, before they are read
        for rb in (inflight.prefill_tok, inflight.decode_tok):
            if rb is not None:
                sampled.append(rb.device)
        return collect(inflight)

    eng._collect = spy
    reqs = [T.Request(prompt=[3, 5, 8, 1, 4, 4, 4, 4, 2 + i], rid=i,
                     sampling=T.SamplingParams(**SAMPLING)) for i in range(2)]
    if via_runner:
        handle = tgw.serve_background(eng)
        try:
            for r in reqs:
                status, events, _ = _sse_post(handle.port, {
                    "prompt": r.prompt, **SAMPLING})
                assert status == 200 and events[-1]["finished"]
        finally:
            assert handle.stop()
    else:
        errors = []

        def poll():
            try:
                with torch.enable_grad():
                    for r in reqs:
                        eng.submit(r)
                    while eng.has_work or eng.has_pending:
                        eng.poll()
            except Exception as e:  # surfaced on the test thread below
                errors.append(e)

        th = threading.Thread(target=poll)
        th.start()
        th.join(120)
        assert not th.is_alive() and not errors, errors
        assert [r.finish_reason for r in reqs] == ["length"] * 2
    assert eng.tick_errors == 0, eng.last_error
    assert sampled, "no tick was read"
    pools = _leaves(eng.caches) + _leaves(eng.draft_caches)
    for t in pools + sampled + [eng._tok_buf]:
        assert t.grad_fn is None and not t.requires_grad


def test_stopped_gateway_frees_its_engine_without_the_collector():
    """With the cycle collector off, 4 clients through
    ``serve_background``, then ``stop()`` and ``del``: the engine is
    freed by reference counting alone (no cycle through a finished
    request's ``on_token`` closure or the asyncio server's protocol
    factory keeps it)."""
    import gc
    import weakref

    eng = _t_engine()
    ref = weakref.ref(eng)
    gc.collect()
    gc.disable()
    try:
        handle = tgw.serve_background(eng)
        results = [None] * 4

        def client(i):
            results[i] = _sse_post(handle.port, {"prompt": [3, 5, 8, i + 1],
                                                 **SAMPLING})

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert all(r is not None and r[0] == 200 and r[1][-1]["finished"]
                   for r in results)
        assert handle.stop()
        del handle, eng, threads, client
        assert ref() is None, [type(r).__name__
                               for r in gc.get_referrers(ref())]
    finally:
        gc.enable()
