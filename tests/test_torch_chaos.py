"""Chaos legs of the port's engine against the JAX engine.

Each leg drives the same requests through the reference ``ServeEngine``
and the port's (CPU, f32 smoke ``codeqwen1.5-7b`` with the reference's
weights, 2 slots, 64-token slots, 8-token pages, ``dense``) under the
same :class:`FaultPlan` and, where deadlines matter, the same injected
scheduler ``_clock``.  The two must agree on every streamed event, the
pool audit after every poll (``PagedKVCache.check()`` plus the page and
in-flight counts), each request's terminal ``finish_reason``, ``error``
and tokens, and ``tick_errors`` / ``sched.timeouts`` /
``sched.rejections``; the port must also keep the reference's own
robustness contract (the assertions of ``tests/test_chaos.py``).

The gateway disconnect storm runs on the port's gateway; its survivors'
streams are held against the JAX engine's in-process streams.  The
gateway's 429 / 503 and stop legs are in ``test_torch_gateway.py``.
Chunked prefill against the reference is covered by
``test_torch_contig_model.py`` (``prefill_chunk`` 0 and 4)."""

import http.client
import json
import threading
import time

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as j_smoke
from repro.models import get_model_def
from repro.models.module import init_params as j_init
from repro import serving as J

import repro_torch.serving as T
from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import from_jax_params
from repro_torch.serving.gateway import serve_background

ARCH = "codeqwen1.5-7b"
SAMPLING = dict(temperature=0.8, top_k=8, max_new=6)
PROMPTS = [[3, 5, 8, 1], [4, 9, 2], [7, 7, 1, 3, 8], [11, 4, 6],
           [1, 2, 3, 4, 5], [9, 8, 7]]
PKGS = {"jax": J, "torch": T}

_PARAMS = {}


def _params_np():
    if not _PARAMS:
        cfg = j_smoke(ARCH, attn_backend="dense")
        params = j_init(get_model_def(cfg).specs(cfg), jax.random.PRNGKey(0))
        _PARAMS["dense"] = jax.tree.map(np.asarray, params)
    return _PARAMS["dense"]


def _engine(pkg, faults=None, **kw):
    kw = dict(dict(max_batch=2, max_len=64, page_size=8), **kw)
    if pkg == "jax":
        cfg = j_smoke(ARCH, attn_backend="dense")
        params = jax.tree.map(jax.numpy.asarray, _params_np())
        return J.ServeEngine(get_model_def(cfg), cfg, params, faults=faults,
                             **kw)
    cfg = t_smoke(ARCH, attn_backend="dense")
    return T.ServeEngine(cfg, from_jax_params(_params_np(), cfg, device="cpu"),
                         faults=faults, device="cpu", **kw)


def _plan(pkg, specs, seed=0):
    mod = PKGS[pkg]
    return mod.FaultPlan([mod.FaultSpec(**s) for s in specs], seed=seed)


def _requests(pkg, n=6, **sampling_kw):
    mod = PKGS[pkg]
    kw = dict(SAMPLING, **sampling_kw)
    return [mod.Request(prompt=list(PROMPTS[i % len(PROMPTS)]),
                        sampling=mod.SamplingParams(**kw), rid=i)
            for i in range(n)]


def _audit(eng):
    eng.kv.check()
    return (eng.kv.free_pages, eng.kv.used_pages, eng.kv.retained_pages,
            eng.kv.shared_pages, eng.sched._inflight_total,
            len(eng.queue), sum(r is not None for r in eng.active))


def _drive(eng, max_polls=2000):
    """Drain the engine: (events, the pool audit after every poll)."""
    events, audits = [], []
    while eng.has_work or eng.has_pending:
        events.extend((e.rid, e.token, e.index, e.finished, e.finish_reason,
                       e.error) for e in eng.poll())
        audits.append(_audit(eng))
        assert len(audits) < max_polls, "engine stalled under fault injection"
    return events, audits


def _outcome(eng, reqs):
    return dict(
        requests={r.rid: (r.finish_reason, tuple(r.tokens), r.error)
                  for r in reqs},
        counters=(eng.tick_errors, eng.last_error, eng.sched.timeouts,
                  eng.sched.rejections, eng.ticks, eng.readbacks,
                  eng.sched._inflight_total))


def _both(run):
    """``run(pkg)`` on each package; asserts the two results are equal and
    returns the port's."""
    want, got = run("jax"), run("torch")
    assert got == want
    return got


def _leg(specs=(), n=6, seed=0, mode="overlap", **engine_kw):
    """Submit ``n`` requests up front and drain under ``specs``."""

    def run(pkg):
        eng = _engine(pkg, _plan(pkg, specs, seed) if specs else None,
                      mode=mode, **engine_kw)
        reqs = _requests(pkg, n)
        for r in reqs:
            eng.submit(r)
        events, audits = _drive(eng)
        fired = dict(eng.faults.fired) if specs else {}
        return dict(_outcome(eng, reqs), events=events, audits=audits,
                    fired=fired)

    return _both(run)


def _clean_streams(n=6, **engine_kw):
    return {rid: tok for rid, (_, tok, _) in
            _leg(n=n, **engine_kw)["requests"].items()}


# ---------------------------------------------------------------------------
# step.error: crash containment


@pytest.mark.parametrize("mode", ["sync", "overlap"])
def test_step_error_contained_and_survivors_bit_identical(mode):
    """A step exception at tick 2 fails only that tick's in-flight
    requests; the queued ones run as on a fault-free engine, and a
    request submitted after the fault matches a fresh engine's."""
    want = _clean_streams(mode=mode)

    def run(pkg):
        mod = PKGS[pkg]
        eng = _engine(pkg, _plan(pkg, [dict(point="step.error", start=2,
                                            stop=3)]), mode=mode)
        reqs = _requests(pkg)
        for r in reqs:
            eng.submit(r)
        events, audits = _drive(eng)
        out = dict(_outcome(eng, reqs), events=events, audits=audits)
        late, fresh = (mod.Request(prompt=[2, 4, 6, 8], rid=100,
                                   sampling=mod.SamplingParams(**SAMPLING))
                       for _ in range(2))
        eng.submit(late)
        _drive(eng)
        ctrl = _engine(pkg, mode=mode)
        ctrl.submit(fresh)
        _drive(ctrl)
        assert late.finish_reason == "length"
        assert late.tokens == fresh.tokens
        return dict(out, late=tuple(late.tokens))

    got = _both(run)
    reqs = got["requests"]
    # max_batch=2, max_new=6: rids 0/1 are the residents at tick 2
    assert reqs[0][0] == reqs[1][0] == "error"
    assert all("InjectedFault" in reqs[i][2] for i in (0, 1))
    tick_errors, last_error = got["counters"][:2]
    assert tick_errors == 1 and "InjectedFault" in last_error
    for i in range(2, 6):
        assert reqs[i][0] == "length" and reqs[i][1] == want[i], i
    assert got["counters"][-1] == 0  # lost samples were settled


def test_repeated_step_errors_never_wedge():
    def run(pkg):
        eng = _engine(pkg, PKGS[pkg].parse_faults(
            "step.error@2,step.error@5,step.error@9"))
        reqs = _requests(pkg, 8)
        for r in reqs:
            eng.submit(r)
        events, audits = _drive(eng)
        return dict(_outcome(eng, reqs), events=events, audits=audits)

    got = _both(run)
    assert all(r[0] is not None for r in got["requests"].values())
    assert got["counters"][0] >= 1
    assert got["counters"][-1] == 0


# ---------------------------------------------------------------------------
# kv.exhaust, tick.delay


@pytest.mark.parametrize("start", [1, 0])
def test_kv_exhaust_window_stalls_admission_then_completes(start):
    """Ticks 1-3 (the reference's leg) or 0-2, where the window holds the
    first admission back."""
    want = _clean_streams()
    got = _leg([dict(point="kv.exhaust", start=start, stop=start + 3)])
    assert {rid: r[1] for rid, r in got["requests"].items()} == want
    assert all(r[0] == "length" for r in got["requests"].values())
    assert got["counters"][0] == 0  # exhaustion is backpressure, not a crash
    stalled = [bool(queued and not live) for *_, queued, live in got["audits"]]
    assert stalled[:3] == [start == 0] * 3


def test_tick_delay_streams_identical():
    want = _clean_streams(n=4)
    got = _leg([dict(point="tick.delay", prob=0.5, delay_s=0.002)], n=4,
               seed=3)
    assert got["fired"]["tick.delay"] > 0  # the storm happened
    assert {rid: r[1] for rid, r in got["requests"].items()} == want


# ---------------------------------------------------------------------------
# deadlines and queue timeouts (one injected clock for both engines)


def test_deadline_expires_running_request():
    def run(pkg):
        mod = PKGS[pkg]
        t = {"now": 0.0}
        eng = _engine(pkg)
        eng.sched._clock = lambda: t["now"]
        doomed = mod.Request(prompt=[3, 5, 8, 1], rid=0, sampling=(
            mod.SamplingParams(max_new=6, deadline_ms=50.0)))
        steady = mod.Request(prompt=[4, 9, 2], rid=1,
                             sampling=mod.SamplingParams(max_new=6))
        eng.submit(doomed)
        eng.submit(steady)
        first = [(e.rid, e.token, e.finished) for e in eng.poll()
                 + eng.poll()]  # both admitted and decoding at t = 0
        t["now"] = 1.0  # doomed is 950 ms past its deadline
        events, audits = _drive(eng)
        return dict(_outcome(eng, [doomed, steady]), first=first,
                    events=events, audits=audits)

    got = _both(run)
    (r0, _, err0), (r1, tok1, _) = got["requests"][0], got["requests"][1]
    assert r0 == "timeout" and "deadline_ms" in err0
    assert r1 == "length" and len(tok1) == 6
    assert got["counters"][2] == 1  # sched.timeouts
    assert got["counters"][-1] == 0  # the in-flight sample was settled
    terminal = [e for e in got["events"] if e[3] and e[0] == 0]
    assert len(terminal) == 1 and terminal[0][4] == "timeout"


def test_queue_timeout_applies_only_before_first_admission():
    def run(pkg):
        mod = PKGS[pkg]
        t = {"now": 0.0}
        eng = _engine(pkg, max_batch=1)
        eng.sched._clock = lambda: t["now"]
        reqs = [mod.Request(prompt=p, rid=i, sampling=mod.SamplingParams(
                    max_new=6, queue_timeout_ms=50.0))
                for i, p in enumerate(([3, 5, 8, 1], [4, 9, 2]))]
        for r in reqs:
            eng.submit(r)
        eng.poll()  # rid 0 admits (max_batch=1); rid 1 stays queued
        t["now"] = 0.2  # rid 1 waited past 50 ms; rid 0 is admitted
        events, audits = _drive(eng)
        return dict(_outcome(eng, reqs), events=events, audits=audits)

    got = _both(run)
    (r0, tok0, _), (r1, _, err1) = got["requests"][0], got["requests"][1]
    assert r1 == "timeout" and "queue" in err1
    assert r0 == "length" and len(tok0) == 6
    assert got["counters"][2] == 1


# ---------------------------------------------------------------------------
# admission control: bounded queue, reject(), never-fit


def test_bounded_queue_and_public_reject():
    def run(pkg):
        mod = PKGS[pkg]
        eng = _engine(pkg, max_batch=1, max_queue=2)
        a, b, c = _requests(pkg, 3, temperature=0.0)
        eng.submit(a)
        eng.submit(b)
        with pytest.raises(mod.QueueFullError, match="queue full") as exc:
            eng.submit(c)
        assert c.finish_reason is None and c not in eng.queue
        rejections = [eng.sched.rejections]
        out = eng.sched.reject(b.rid, "load shed by operator")
        assert eng.sched.reject(999, "no such rid") is None
        rejections.append(eng.sched.rejections)
        events, audits = _drive(eng)
        return dict(_outcome(eng, [a, b, c]), raised=str(exc.value),
                    rejected=(out.rid, out.finish_reason, out.finished),
                    rejections=rejections, events=events, audits=audits)

    got = _both(run)
    assert got["rejections"] == [1, 2]
    assert got["rejected"] == (1, "rejected", True)
    assert got["requests"][1][0] == "rejected"
    assert got["requests"][1][2] == "load shed by operator"
    assert got["requests"][0][0] == "length"


def test_never_fit_rejected_at_submit_with_reason():
    def run(pkg):
        mod = PKGS[pkg]
        eng = _engine(pkg, max_len=16)
        req = mod.Request(prompt=[1] * 12, rid=0,
                          sampling=mod.SamplingParams(max_new=8))
        with pytest.raises(mod.RejectionError, match="max_len 16") as exc:
            eng.submit(req)
        assert not eng.queue
        ok = mod.Request(prompt=[1, 2], rid=1,
                         sampling=mod.SamplingParams(max_new=4))
        return (str(exc.value), eng.sched.never_fit(req),
                eng.sched.never_fit(ok), eng.sched.rejections)

    got = _both(run)
    assert got[1] is not None and got[2] is None


# ---------------------------------------------------------------------------
# fault-plan semantics (pure host)


def test_fault_plan_windows_probability_and_parse():
    def run(pkg):
        mod = PKGS[pkg]
        plan = mod.parse_faults(
            "step.error@3,kv.exhaust@1:4,tick.delay@0::p0.5:d0.05", seed=7)
        specs = [(s.point, s.start, s.stop, s.prob, s.delay_s, s.times)
                 for s in plan.specs]
        trace = []
        for _ in range(5):
            plan.advance()
            trace.append((plan.active("kv.exhaust"),
                          plan.fires("step.error")))
        draws = [plan.delay("tick.delay") > 0 for _ in range(32)]
        with pytest.raises(ValueError) as exc:
            mod.parse_faults("step.error@x")
        assert mod.parse_faults(None) is mod.NO_FAULTS
        assert not mod.NO_FAULTS and not mod.NO_FAULTS.active("kv.exhaust")
        return specs, trace, draws, dict(plan.fired), str(exc.value)

    specs, trace, draws, _, _ = _both(run)
    by_point = {s[0]: s for s in specs}
    assert by_point["step.error"][1:3] == (3, 4)  # @3 arms tick 3 only
    assert by_point["kv.exhaust"][1:3] == (1, 4)
    assert by_point["tick.delay"][2:5] == (None, 0.5, 0.05)
    assert trace == [(False, False), (True, False), (True, False),
                     (True, True), (False, False)]
    assert 0 < sum(draws) < 32  # p = 0.5 actually splits


# ---------------------------------------------------------------------------
# the gateway under a disconnect storm


def _sse_post(port, spec, timeout=120):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    conn.request("POST", "/v1/generate", body=json.dumps(spec),
                 headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    events, status = [], resp.status
    if status == 200:
        while True:
            line = resp.readline()
            if not line:
                break  # the server dropped the connection (the storm)
            line = line.strip()
            if line.startswith(b"data: "):
                events.append(json.loads(line[6:]))
                if events[-1].get("finished"):
                    break
    else:
        events.append(json.loads(resp.read()))
    conn.close()
    return status, events


def _wait_for(cond, timeout=60.0, interval=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(interval)
    return cond()


def test_gateway_disconnect_storm_contained():
    """The gateway drops 4 client connections mid-stream; the dropped
    requests cancel server-side and free their pages, the survivors
    finish with the JAX engine's streams for their rids, and the engine
    serves fresh traffic afterwards with a balanced pool."""
    eng = _engine("torch", T.FaultPlan(
        [T.FaultSpec("gateway.disconnect", prob=1.0, times=4)]), max_batch=3)
    handle = serve_background(eng)
    spec = {"prompt": [3, 5, 8, 1], "max_new": 6, "temperature": 0.8,
            "top_k": 8}
    try:
        results = [None] * 6

        def client(i):
            try:
                results[i] = _sse_post(handle.port, dict(spec))
            except OSError:  # reset mid-read: the same as a drop
                results[i] = (200, [])

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(6)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(120)
        assert not any(th.is_alive() for th in threads)
        done = [evts for st, evts in results
                if st == 200 and evts and evts[-1].get("finished")]
        assert len(done) == 2 and len(results) - len(done) == 4, results
        assert _wait_for(lambda: not (eng.has_work or eng.has_pending))
        eng.kv.check()

        def counts():
            snap = handle.runner.metrics.snapshot()["requests"]
            return snap["cancelled"], snap["completed"]

        assert _wait_for(lambda: counts() == (4, 2)), counts()
        assert eng.tick_errors == 0 and handle.runner.is_alive()

        # the storm is spent (times=4): fresh traffic completes
        st, evts = _sse_post(handle.port, dict(spec))
        assert st == 200 and evts[-1]["finish_reason"] == "length"
        assert _wait_for(lambda: not (eng.has_work or eng.has_pending))
        eng.kv.check()
    finally:
        assert handle.stop()
    # survivors: the JAX engine's in-process streams for the same rids
    ref = _engine("jax", max_batch=3)
    for evts in done:
        rid = evts[-1]["rid"]
        want = [o.token for o in ref.stream(J.Request(
            prompt=spec["prompt"], rid=rid,
            sampling=J.SamplingParams(**SAMPLING)))]
        assert evts[-1]["tokens"] == want, rid


# ---------------------------------------------------------------------------
# the serving launcher's robustness flags


def test_serve_launcher_takes_the_robustness_flags():
    """``--faults``, ``--deadline-ms`` and ``--max-queue`` reach the
    engine as the reference launcher's do: the fault fires and is
    contained, every request carries the deadline, and a queue bound
    below the submitted count refuses the surplus at submit."""
    from repro_torch.launch import serve

    argv = ["--arch", "camformer-bert", "--smoke", "--device", "cpu",
            "--requests", "3", "--max-new", "3", "--max-batch", "2",
            "--no-stream"]
    eng = serve.main(argv + ["--faults", "step.error@1", "--deadline-ms",
                             "60000", "--max-queue", "3"])
    assert eng.tick_errors == 1 and "InjectedFault" in eng.last_error
    assert eng.sched.max_queue == 3
    assert {r.sampling.deadline_ms for r in eng.done} == {60000.0}
    assert sorted(r.finish_reason for r in eng.done) == [
        "error", "error", "length"]
    with pytest.raises(T.QueueFullError, match="queue full"):
        serve.main(argv + ["--max-queue", "2"])
