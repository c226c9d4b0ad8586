"""The port's serving layer against the JAX reference.

  * the copied scheduler emits the same ``TickPlan`` as the reference's
    on a scripted trace (admission, a COW prefix hit, priority preemption
    under a small pool, ``prefill_slice`` chunks and a cancel), and its
    allocator audit passes after every tick;
  * ``ServeEngine.run()`` gives the reference engine's greedy token
    streams for ``dense`` and ``camformer``, in sync and overlap mode,
    with a shared prompt prefix, and one readback per tick."""

import jax
import numpy as np
import pytest

from repro.configs import smoke_config as j_smoke
from repro.models import get_model_def
from repro.models.module import init_params as j_init
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSampling
from repro.serving import ServeEngine as JEngine
from repro.serving.kv_cache import PagedKVCache as JKV
from repro.serving.scheduler import Scheduler as JScheduler

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import from_jax_params
from repro_torch.serving import Request as TRequest
from repro_torch.serving import SamplingParams as TSampling
from repro_torch.serving import ServeEngine as TEngine
from repro_torch.serving.kv_cache import PagedKVCache as TKV
from repro_torch.serving.scheduler import Scheduler as TScheduler


def _arr(x):
    return None if x is None else np.asarray(x).tolist()


def _emits(es):
    return [(e.slot, e.req.rid, e.index) for e in es]


def _plan(plan):
    pf, dc = plan.prefill, plan.decode
    return (
        [tuple(map(int, f)) for f in plan.forks],
        None if pf is None else (
            _arr(pf.tokens), _arr(pf.lens), _arr(pf.offsets),
            _arr(pf.scale_base), _arr(pf.table), _arr(pf.sample_index),
            pf.hot, _emits(pf.emit)),
        None if dc is None else (
            _arr(dc.pos), _arr(dc.kv_len), _arr(dc.base), _arr(dc.table),
            _arr(dc.sample_index), _arr(dc.live), _arr(dc.fresh), dc.hot,
            _emits(dc.emit), _arr(dc.n_tok)),
        _arr(plan.keys), _arr(plan.temps), _arr(plan.top_ks),
        _arr(plan.top_ps))


def _events(evs):
    return [(e.rid, e.token, e.index, e.finished, e.finish_reason)
            for e in evs]


def test_scheduler_plans_equal_reference():
    shared = list(range(3, 15))  # a 12-token system prompt
    specs = [  # (prompt, max_new, priority)
        (shared + [40, 41, 42], 6, 0),
        (shared + [50, 51], 5, 0),
        (list(range(60, 78)), 4, 1),  # high priority: preempts
        (shared + [70], 3, 0),
    ]
    scheds = []
    for kv_cls, sched_cls, req_cls, sp_cls in (
            (JKV, JScheduler, JRequest, JSampling),
            (TKV, TScheduler, TRequest, TSampling)):
        kv = kv_cls(n_pages=12, page_size=4, max_batch=3, max_pages_per_seq=8)
        sched = sched_cls(kv, max_batch=3, max_len=32, seed=5,
                          prefix_sharing=True, prefill_slice=8,
                          prefill_bucket=8, clock=lambda: 0.0)
        reqs = [req_cls(prompt=list(p), sampling=sp_cls(max_new=n),
                        rid=i, priority=pr)
                for i, (p, n, pr) in enumerate(specs)]
        scheds.append((sched, reqs))

    for tick in range(80):
        plans, events = [], []
        for sched, reqs in scheds:
            if tick == 0:
                for r in reqs[:2]:
                    sched.submit(r)
            if tick == 3:
                sched.submit(reqs[2])
            if tick == 5:
                sched.submit(reqs[3])
            evs = []
            if tick == 9:
                out = sched.cancel(1)
                evs.extend([] if out is None else [out])
            if not sched.has_work:
                plans.append(None)
                events.append(_events(evs))
                continue
            plan = sched.plan_tick()
            evs.extend(sched.take_events())
            for part in (plan.prefill, plan.decode):
                for e in (part.emit if part is not None else ()):
                    out = sched.ingest(e, (e.req.rid * 7 + e.index) % 50)
                    evs.extend([] if out is None else [out])
            assert sched.kv.check()
            plans.append(_plan(plan))
            events.append(_events(evs))
        assert plans[1] == plans[0], f"tick {tick}"
        assert events[1] == events[0], f"tick {tick}"
        if plans[0] is None and tick > 5:
            break
    (jsched, jreqs), (tsched, treqs) = scheds
    assert not tsched.has_work
    assert tsched.preemptions == jsched.preemptions > 0
    assert [r.prefix_matched for r in treqs] == \
        [r.prefix_matched for r in jreqs]
    assert any(r.prefix_matched for r in treqs)
    assert tsched.prefill_ticks == jsched.prefill_ticks
    assert [(r.tokens, r.finish_reason) for r in treqs] == \
        [(r.tokens, r.finish_reason) for r in jreqs]
    assert treqs[1].finish_reason == "cancelled"


def _requests(req_cls, sp_cls, vocab, late):
    """Four requests sharing a 12-token prefix; with ``late`` the last one
    has priority 1 (it preempts under a small pool)."""
    rng = np.random.default_rng(1)
    shared = [int(t) for t in rng.integers(0, vocab, 12)]
    out = []
    for i, (n, m) in enumerate(((3, 6), (9, 4), (1, 7), (5, 5))):
        prompt = shared + [int(t) for t in rng.integers(0, vocab, n)]
        out.append(req_cls(prompt=prompt, sampling=sp_cls(max_new=m), rid=i,
                           priority=int(bool(late) and i == 3)))
    return out


def _drive(eng, reqs, late):
    """Submit the first three requests, run ``late`` engine polls, submit
    the fourth, drain."""
    for r in reqs[:3]:
        eng.submit(r)
    for _ in range(late):
        eng.poll()
    eng.submit(reqs[3])
    return eng.run()


_JAX_RUNS = {}


def _backend_kw(backend):
    if "," in backend:
        return {"layer_backends": tuple(backend.split(","))}
    return {"attn_backend": backend}


def _jax_run(arch, backend, prefill_slice=None, n_pages=None):
    """The reference engine's streams (sync mode; its own tests pin
    overlap == sync), once per engine configuration.  A small pool
    (``n_pages``) gets a late high-priority request."""
    late = 3 if n_pages else 0
    key = (arch, backend, prefill_slice, n_pages)
    if key not in _JAX_RUNS:
        cfg = j_smoke(arch, **_backend_kw(backend))
        md = get_model_def(cfg)
        params = j_init(md.specs(cfg), jax.random.PRNGKey(0))
        eng = JEngine(md, cfg, params, max_batch=3, max_len=48, page_size=8,
                      mode="sync", prefill_slice=prefill_slice,
                      n_pages=n_pages)
        reqs = _requests(JRequest, JSampling, cfg.vocab, late)
        _drive(eng, reqs, late)
        _JAX_RUNS[key] = (jax.tree.map(np.asarray, params), reqs,
                          eng.ticks, eng.readbacks, eng.preemptions)
    return _JAX_RUNS[key]


STREAM_CASES = [(arch, backend, mode, None, None)
                for arch in ("camformer-bert", "mistral-nemo-12b")
                for backend in ("dense", "camformer")
                for mode in ("sync", "overlap")]
STREAM_CASES += [
    # continuous batching: prompts prefill in 8-token slices across ticks
    ("camformer-bert", "dense", "overlap", 8, None),
    ("camformer-bert", "camformer", "overlap", 8, None),
    # the mixed per-layer stack
    ("mistral-nemo-12b", "dense,camformer", "overlap", None, None),
    # a pool of 7 usable pages: preemption and resume
    ("camformer-bert", "camformer", "overlap", None, 8),
    ("mistral-nemo-12b", "dense", "sync", None, 8),
]


@pytest.mark.parametrize("arch,backend,mode,prefill_slice,n_pages",
                         STREAM_CASES)
def test_engine_streams_equal_reference(arch, backend, mode, prefill_slice,
                                        n_pages):
    params_np, jreqs, jticks, jreadbacks, jpreempt = _jax_run(
        arch, backend, prefill_slice, n_pages)
    cfg = t_smoke(arch, **_backend_kw(backend))
    eng = TEngine(cfg, from_jax_params(params_np, cfg, device="cpu"),
                  max_batch=3, max_len=48, page_size=8, mode=mode,
                  prefill_slice=prefill_slice, n_pages=n_pages,
                  device="cpu")
    late = 3 if n_pages else 0
    treqs = _requests(TRequest, TSampling, cfg.vocab, late)
    done = _drive(eng, treqs, late)
    assert len(done) == len(treqs)
    assert [r.tokens for r in treqs] == [r.tokens for r in jreqs]
    assert [r.finish_reason for r in treqs] == ["length"] * len(treqs)
    assert [r.prefix_matched for r in treqs] == \
        [r.prefix_matched for r in jreqs]
    if n_pages is None:
        assert any(r.prefix_matched for r in treqs)
    assert eng.tick_errors == 0
    assert eng.ticks == jticks
    assert eng.sched.preemptions == jpreempt
    if n_pages is not None:
        assert jpreempt > 0
    # one readback per tick (each decode tick, plus each tick whose
    # prefill completes a prompt: its first-token samples), as the
    # reference engine counts them
    assert eng.readbacks == jreadbacks
    if prefill_slice is None:
        assert eng.readbacks == eng.ticks + eng.prefill_ticks


def test_single_readback_per_decode_tick():
    """The reference's invariant (tests/test_overlap.py): one
    prefill-completion read plus one read per decode tick."""
    cfg = t_smoke("camformer-bert", attn_backend="dense")
    from repro_torch.models import init_params

    eng = TEngine(cfg, init_params(cfg, device="cpu"), max_batch=3,
                  max_len=64, page_size=8, mode="overlap", device="cpu")
    eng.submit(TRequest(prompt=[5, 9, 2, 4],
                        sampling=TSampling(max_new=6)))
    for _ in eng.stream():
        pass
    assert eng.ticks == 5
    assert eng.readbacks == 1 + eng.ticks


def test_tensor_parallel_raises_at_construction():
    """The constructor validates ``tp`` as the reference's does: tp < 1
    raises naming tp, and tp = 2 without an initialised group of at least
    two processes raises naming the devices it needs; tp = 1 builds the
    single-process engine (no mesh, no pool spec tree).  The tp > 1
    engine itself is held on gloo processes in tests/test_torch_tp.py."""
    cfg = t_smoke("camformer-bert", attn_backend="camformer")
    from repro_torch.models import init_params

    params = init_params(cfg, device="cpu")
    with pytest.raises(ValueError, match="tp"):
        TEngine(cfg, params, tp=0, device="cpu")
    with pytest.raises(ValueError, match="devices"):
        TEngine(cfg, params, tp=2, device="cpu")
    eng = TEngine(cfg, params, tp=1, device="cpu")
    assert eng.mesh is None and eng._pool_pspecs is None


@pytest.mark.parametrize("k,p", [(0, 1.0), (5, 1.0), (0, 0.5), (3, 0.9),
                                 (60, 0.999)])
def test_sampler_filters_match_reference(k, p):
    import jax.numpy as jnp
    import torch

    from repro.serving import sampler as JS
    from repro_torch.serving import sampler as TS

    rng = np.random.default_rng(k)
    logits = (rng.standard_normal((6, 53)) * 2).astype(np.float32)
    logits[0, :4] = logits[0, 10]  # ties at the cut
    ks = np.array([k, 0, k, 1, k, 2], np.int32)
    tl = torch.from_numpy(logits)
    np.testing.assert_array_equal(
        TS.apply_top_k(tl, torch.from_numpy(ks)).numpy(),
        np.asarray(JS.apply_top_k(jnp.asarray(logits), jnp.asarray(ks))))
    np.testing.assert_allclose(
        TS.apply_top_p(tl, p).numpy(),
        np.asarray(JS.apply_top_p(jnp.asarray(logits), p)), rtol=1e-6)
    np.testing.assert_array_equal(TS.greedy(tl).numpy(),
                                  np.asarray(JS.greedy(jnp.asarray(logits))))
    np.testing.assert_array_equal(TS.request_key(3, 7), JS.request_key(3, 7))
