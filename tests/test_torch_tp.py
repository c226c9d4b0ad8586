"""Tensor-parallel serving over 4 gloo processes, against the port's
tp = 1 and the JAX package (the port's counterpart of the reference's
``tests/test_sharded.py`` identity matrix and ``tests/test_chaos.py``'s
tp = 2 containment case; the camformer speculative case and the
``model``-split train step are in ``tests/test_torch_tp_train.py``).

One module-scoped run starts 4 processes of ``tests/torch_tp_worker.py``
(part ``serve``; a file rendezvous under tmp_path, no TCP port; killed
after 300 s); each writes what it saw, and the tests below hold it, in
this process, against the port's tp = 1 runs (made by ranks 2 and 3
meanwhile) and the JAX package on one device:

  * on the codeqwen smoke weights drawn by the JAX package: dense at
    tp = 2 (sync and overlap, temperature 0.8, top-k 8), the mixed
    dense/camformer stack with a 12-token shared prefix, hybrid with
    spec_k = 3, prefill_slice = 8 and fused prefill, dense at tp = 4,
    preemption on a 5-page pool: every process's (rid, index,
    token) events, readbacks and ticks equal the port's tp = 1 and the
    JAX tp = 1 run's, the plans were compared every tick, and each
    process's pools hold 1/tp of the bytes;
  * ``step.error`` at tick 2 at tp = 2: one contained tick error on every
    process, requests 0 and 1 in ``error``, 2 and 3 in ``length`` with
    the fault-free tokens;
  * ``launch.serve`` at ``--tp 2`` gives its ``--tp 1`` tokens; the
    gateway at tp = 2 answers two concurrent clients with tp = 1's
    streams.
"""

import concurrent.futures
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke
from repro.models import get_model_def as j_model_def
from repro.models.module import init_params as j_init
from repro.serving import FaultPlan as JFaultPlan
from repro.serving import FaultSpec as JFaultSpec
from repro.serving import Request as JRequest
from repro.serving import SamplingParams as JSampling
from repro.serving import ServeEngine as JEngine

from repro_torch.configs import smoke_config as t_smoke
from repro_torch.models import from_jax_params

from torch_tp_worker import (ARCH, CHAOS_PROMPTS, SAMPLING, SERVE_CASES,
                             SERVE_PART_CASES, run_ranks)


def _jax_params():
    cfg = j_smoke(ARCH)
    return j_init(j_model_def(cfg).specs(cfg), jax.random.PRNGKey(0))


def _jax_identity(params, name):
    """The JAX engine's tp = 1 run of a serving case (sync mode)."""
    over, kw, shared = SERVE_CASES[name]
    cfg = j_smoke(ARCH).replace(**over)
    eng = JEngine(j_model_def(cfg), cfg, params, max_batch=3, max_len=64,
                  page_size=8, mode="sync", **kw)
    pre = list(range(1, shared + 1))
    for i in range(4):
        eng.submit(JRequest(prompt=pre + [3 + i, 5, 8, 1, 9 + i],
                            sampling=JSampling(**SAMPLING), rid=i))
    events = [(o.rid, o.index, o.token) for o in eng.stream()]
    return dict(events=events, readbacks=eng.readbacks, ticks=eng.ticks)


def _jax_preemption(params):
    cfg = j_smoke(ARCH)
    eng = JEngine(j_model_def(cfg), cfg, params, max_batch=2, max_len=32,
                  page_size=8, n_pages=5, prefix_sharing=False, mode="sync")
    eng.submit(JRequest(prompt=[1, 2, 3, 4, 5, 6],
                        sampling=JSampling(max_new=18), rid=0))
    eng.step()
    eng.step()
    eng.submit(JRequest(prompt=[9, 8, 7, 6, 5, 4],
                        sampling=JSampling(max_new=18), rid=1, priority=5))
    done = eng.run()
    return {r.rid: tuple(r.tokens) for r in done}, eng.preemptions


def _jax_chaos(params):
    cfg = j_smoke(ARCH)
    plan = JFaultPlan([JFaultSpec("step.error", start=2, stop=3)])
    eng = JEngine(j_model_def(cfg), cfg, params, max_batch=2, max_len=64,
                  page_size=8, faults=plan)
    reqs = [JRequest(prompt=list(p), sampling=JSampling(
        temperature=0.8, top_k=8, max_new=6), rid=i)
        for i, p in enumerate(CHAOS_PROMPTS)]
    for r in reqs:
        eng.submit(r)
    while eng.has_work or eng.has_pending:
        eng.poll()
    return {r.rid: (tuple(r.tokens), r.finish_reason) for r in reqs}


def jax_runs(runs: dict) -> dict:
    """{name: fn()} of the JAX package's runs, on three threads (each
    run is mostly XLA compiling, which leaves the interpreter free)."""
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        futures = {name: pool.submit(fn) for name, fn in runs.items()}
        return {name: f.result() for name, f in futures.items()}


def write_params(out, params):
    """The JAX package's codeqwen smoke weights as the port's tree."""
    torch.save(from_jax_params(jax.tree.map(np.asarray, params),
                               t_smoke(ARCH), device="cpu"),
               out / "params.pt")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """(every rank's results, the JAX package's runs)."""
    out = tmp_path_factory.mktemp("tp")
    params = _jax_params()
    write_params(out, params)

    def during():  # the JAX package's runs while the processes run
        runs = {name: functools.partial(_jax_identity, params, name)
                for name in SERVE_PART_CASES}
        runs["preemption"] = functools.partial(_jax_preemption, params)
        runs["chaos"] = functools.partial(_jax_chaos, params)
        return jax_runs(runs)

    refs, res = run_ranks(out, "serve", during)
    return res, refs


def tp1(res, key):
    """The port's tp = 1 run of ``key`` (made by rank 2 or 3)."""
    for r in res[2:]:
        if key + "@1" in r["serving"]:
            return r["serving"][key + "@1"]
    raise KeyError(key)


def same_as(got, want, ref, tp, mode):
    """``got`` (tp = ``tp``) against the port's tp = 1 run of its mode
    (the same events, readbacks and ticks) and the JAX package's sync
    run (the same events, readbacks and ticks in sync mode; in overlap
    mode the same tokens, which a speculative tick surfaces in another
    order and over more ticks)."""
    assert got["events"] == want["events"]
    assert (got["readbacks"], got["ticks"]) == (want["readbacks"],
                                                want["ticks"])
    assert sorted(got["events"]) == sorted(ref["events"])
    if mode == "sync":
        assert got["events"] == ref["events"]
        assert (got["readbacks"], got["ticks"]) == (ref["readbacks"],
                                                    ref["ticks"])
    assert got["checks"] >= got["ticks"] > 0  # a plan compared each tick
    assert got["pool_bytes"] * tp == want["pool_bytes"]


@pytest.mark.parametrize("name", SERVE_PART_CASES)
@pytest.mark.parametrize("mode", ["sync", "overlap"])
def test_tp2_streams_equal_tp1_and_the_reference(ranks, name, mode):
    res, refs = ranks
    want = tp1(res, f"{name}/{mode}")
    for r in res[:2]:
        same_as(r["serving"][f"{name}/{mode}"], want, refs[name], 2, mode)


@pytest.mark.parametrize("mode", ["sync", "overlap"])
def test_tp4_streams_equal_tp1_and_the_reference(ranks, mode):
    res, refs = ranks
    want = tp1(res, f"dense/{mode}")
    for r in res:
        same_as(r["serving"][f"dense_tp4/{mode}"], want, refs["dense"], 4,
                mode)


def test_tp2_preemption_equals_tp1_and_the_reference(ranks):
    res, refs = ranks
    want = tp1(res, "preemption")
    ref_tokens, ref_preemptions = refs["preemption"]
    for r in res[:2]:
        got = r["serving"]["preemption"]
        assert got["events"] == want["events"]
        assert got["preemptions"] == want["preemptions"] == ref_preemptions
        assert got["preemptions"] >= 1
        assert {k: v[0] for k, v in got["done"].items()} == ref_tokens
        assert (got["readbacks"], got["ticks"]) == (want["readbacks"],
                                                    want["ticks"])


def test_tp2_step_error_agreed_and_contained(ranks):
    """As the reference's ``test_tp2_step_error_contained``: the tick dies
    on both processes, its requests fail, the others run on with the
    fault-free tokens."""
    res, refs = ranks
    free = tp1(res, "chaos")["done"]  # the port's, fault-free
    assert [free[i] for i in (2, 3)] == [refs["chaos"][i] for i in (2, 3)]
    for r in res[:2]:
        got = r["serving"]["chaos"]
        assert got["tick_errors"] == 1
        assert got["events"] == res[0]["serving"]["chaos"]["events"]
        assert [got["done"][i][1] for i in range(4)] == [
            "error", "error", "length", "length"]
        for i in (2, 3):
            assert got["done"][i] == free[i]
        assert got["done"] == refs["chaos"]


def test_serve_launcher_tp2_gives_tp1_tokens(ranks):
    res, _ = ranks
    want = res[2]["launch"]["serve@1"]
    assert len(want) == 3
    for r in res[:2]:
        assert r["launch"]["serve"] == want


def test_gateway_tp2_answers_two_clients_with_tp1_streams(ranks):
    res, _ = ranks
    base = res[2]["launch"]["gateway@1"]
    got = res[0]["launch"]["gateway"]
    assert sorted(rid for rid, _ in got.values()) == [0, 1]
    for prompt, (rid, tokens) in got.items():
        assert len(tokens) == 4
        assert tokens == base[(prompt, rid)]
    assert res[1]["launch"]["gateway_done"] == res[0]["launch"][
        "gateway_done"]
    # GET /metrics: the degree, and the one page table's occupancy on
    # each of the tp devices
    metrics = res[0]["launch"]["metrics"]["engine"]
    assert metrics["tp"] == 2 and metrics["page_pool"]["tp"] == 2
