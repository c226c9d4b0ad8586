"""One rank of the port's 4-process gloo run of tensor-parallel serving
and the ``model``-split train step (a helper of ``tests/test_torch_tp.py``,
not a test module).

    python tests/torch_tp_worker.py RANK WORLD OUT_DIR PART

Rendezvous through a file under OUT_DIR (no TCP port).  PART ``serve``
(``tests/test_torch_tp.py``): the serving cases of ``SERVE_PART_CASES``
at tp = 2 on ranks 0 and 1 while ranks 2 and 3 run them at tp = 1,
preemption and ``step.error``, dense at tp = 4 on every rank, then the
launchers at tp = 2 on ranks 0 and 1 while rank 2 runs them at tp = 1.
PART ``spec_train`` (``tests/test_torch_tp_train.py``): the case of
``TRAIN_PART_CASES`` the same way, then the train step on
make_mesh_for(4, 2).  PARTs ``families``
(``tests/test_torch_tp_train_families.py``) and ``seq``
(``tests/test_torch_tp_train_seq.py``): the train step of
``FAMILY_CASES`` / ``SEQ_CASES``, each on make_mesh_for(4, its model
size).  Each rank writes
what it saw to OUT_DIR/rank<RANK>.pt; the test compares the ranks with
one another and with the JAX package in the pytest process.
"""

from __future__ import annotations

import http.client
import json
import os
import sys
import threading
import time

import torch
import torch.distributed as dist

ARCH = "codeqwen1.5-7b"
SAMPLING = dict(temperature=0.8, top_k=8, max_new=5)
SERVE_CASES = {  # name: (config overrides, engine keywords, shared prefix)
    "dense": (dict(attn_backend="dense"), {}, 0),
    "camformer_spec_cow": (dict(attn_backend="camformer"),
                           dict(spec_k=4), 12),
    "mixed": (dict(layer_backends=("dense", "camformer")), {}, 12),
    "hybrid_spec_fused": (dict(attn_backend="hybrid"),
                          dict(spec_k=3, prefill_slice=8,
                               prefill_impl="fused"), 12),
}
TRAIN_CASES = (  # (name, arch, smoke overrides, model-axis size, seq_len)
    ("camformer", "camformer-bert", dict(attn_backend="camformer"), 2, 64),
    ("granite", "granite-moe-3b-a800m", dict(n_experts_padded=8), 2, 64),
)
# the model split of the encoder-decoder, Griffin and RWKV-6 families
FAMILY_CASES = (
    ("whisper", "whisper-medium", {}, 2, 64),
    ("recurrentgemma", "recurrentgemma-2b", {}, 2, 64),
    ("rwkv6_4_heads", "rwkv6-3b", dict(rwkv_head_dim=16), 2, 64),
    ("rwkv6", "rwkv6-3b", {}, 2, 64),  # one head: the time mix runs whole
)
# the residual stream's sequence split and its fallbacks
SEQ_CASES = (
    ("res_seq_gelu_layer_norm", "camformer-bert",
     dict(attn_backend="dense", act="gelu", norm="layer"), 2, 64),
    ("kv_seq", "camformer-bert", dict(n_heads=6, n_kv_heads=6), 4, 64),
    # 8 patches + 55 tokens: 63 rows, which 2 does not divide
    ("vlm_odd", "llava-next-mistral-7b", {}, 2, 63),
)
TRAIN_PARTS = {"spec_train": TRAIN_CASES, "families": FAMILY_CASES,
               "seq": SEQ_CASES}
TRAIN_STEPS = 3
CHAOS_PROMPTS = [[3, 5, 8, 1], [4, 9, 2], [7, 7, 1, 3, 8], [11, 4, 6]]
GATEWAY_PROMPTS = [[3, 5, 8, 1], [9, 2, 6]]


def _cfg(over):
    from repro_torch.configs import smoke_config

    return smoke_config(ARCH).replace(**over)


def _engine(cfg, params, tp, **kw):
    from repro_torch.serving import ServeEngine

    kw = dict(dict(max_batch=3, max_len=64, page_size=8), **kw)
    return ServeEngine(cfg, params, tp=tp, device="cpu", **kw)


def _drain(eng, drive):
    """``drive(eng)`` on rank 0 (then ``close``), ``follow`` elsewhere;
    the (rid, index, token) events this process emitted."""
    if eng.tp_rank == 0:
        outs = drive(eng)
        eng.close()
    else:
        outs = eng.follow()
    return [(o.rid, o.index, o.token) for o in outs]


def _summary(eng, events):
    from repro_torch.serving import sharded

    return dict(events=events, readbacks=eng.readbacks, ticks=eng.ticks,
                checks=0 if eng._sync is None else eng._sync.checks,
                pool_bytes=sharded.pool_bytes(eng.caches),
                tick_errors=eng.tick_errors,
                done={r.rid: (tuple(r.tokens), r.finish_reason)
                      for r in eng.done})


def identity_run(params, name, tp, mode):
    """The reference's identity workload: 4 requests at temperature 0.8
    (top-k 8, 5 new tokens), a shared prefix where the case has one."""
    from repro_torch.serving import Request, SamplingParams

    over, kw, shared = SERVE_CASES[name]
    eng = _engine(_cfg(over), params, tp, mode=mode, **kw)
    pre = list(range(1, shared + 1))

    def drive(e):
        for i in range(4):
            e.submit(Request(prompt=pre + [3 + i, 5, 8, 1, 9 + i],
                             sampling=SamplingParams(**SAMPLING), rid=i))
        return list(e.stream())

    return _summary(eng, _drain(eng, drive))


def preemption_run(params, tp):
    """A 5-page pool, a priority submit mid-run (sync mode)."""
    from repro_torch.serving import Request, RequestState, SamplingParams

    eng = _engine(_cfg({}), params, tp, max_batch=2, max_len=32,
                  n_pages=5, prefix_sharing=False, mode="sync")

    def drive(e):
        lo = Request(prompt=[1, 2, 3, 4, 5, 6],
                     sampling=SamplingParams(max_new=18), rid=0, priority=0)
        e.submit(lo)
        outs = e.step() + e.step()
        assert lo.state is RequestState.DECODING and len(lo.tokens) >= 2
        e.submit(Request(prompt=[9, 8, 7, 6, 5, 4],
                         sampling=SamplingParams(max_new=18), rid=1,
                         priority=5))
        outs += list(e.stream())
        return outs

    out = _summary(eng, _drain(eng, drive))
    out["preemptions"] = eng.preemptions
    return out


def chaos_run(params, tp, faults):
    """``step.error`` at tick 2 (overlap mode, 2 slots): the chaos suite's
    workload."""
    from repro_torch.serving import (FaultPlan, FaultSpec, Request,
                                     SamplingParams)

    plan = FaultPlan([FaultSpec("step.error", start=2, stop=3)]
                     if faults else [])
    eng = _engine(_cfg({}), params, tp, max_batch=2, faults=plan)

    def drive(e):
        for i, p in enumerate(CHAOS_PROMPTS):
            e.submit(Request(prompt=list(p), sampling=SamplingParams(
                temperature=0.8, top_k=8, max_new=6), rid=i))
        return list(e.stream())

    return _summary(eng, _drain(eng, drive))


# the serving cases of each part (each part's JAX runs take about as long)
SERVE_PART_CASES = ("dense", "mixed", "hybrid_spec_fused")
TRAIN_PART_CASES = ("camformer_spec_cow",)


def serving_part(params, names, extra):
    """``names`` at tp = 2 on ranks 0 and 1 and at tp = 1 on ranks 2 and
    3 (split between them), each in sync and overlap mode; with
    ``extra`` also the preemption and chaos cases, and dense at tp = 4
    on every rank."""
    res = {}
    rank = dist.get_rank()
    if rank < 2:  # tp = 2 on ranks 0 and 1
        for name in names:
            for mode in ("sync", "overlap"):
                res[f"{name}/{mode}"] = identity_run(params, name, 2, mode)
        if extra:
            res["preemption"] = preemption_run(params, 2)
            res["chaos"] = chaos_run(params, 2, True)
    else:  # tp = 1 on ranks 2 and 3, the cases split between them
        for name in names[rank - 2::2]:
            for mode in ("sync", "overlap"):
                res[f"{name}/{mode}@1"] = identity_run(params, name, 1, mode)
        if extra and rank == 2:
            res["preemption@1"] = preemption_run(params, 1)
        elif extra:
            res["chaos@1"] = chaos_run(params, 1, False)
    if extra:
        for mode in ("sync", "overlap"):  # tp = 4 on every rank
            res[f"dense_tp4/{mode}"] = identity_run(params, "dense", 4,
                                                    mode)
    return res


def _names(tree, name=""):
    """Each leaf's key, in the structure of ``tree``."""
    if isinstance(tree, dict):
        return {k: _names(v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_names(v, name) for v in tree]
    return name


def train_part(out_dir, cases):
    """The ``model``-split step of each case on make_mesh_for(4, its
    model size) (tp profile) from the JAX package's initial state: 3
    steps' metrics, AdamW's m after step 1 gathered ((1 - b1) x the
    clipped gradients), the parameters steps 2 and 3 start from, the
    regions' local extents (``SPLIT_SEEN``) and the step's plan with
    each leaf's storage placement along ``model``."""
    from repro_torch.configs import SHAPES, smoke_config
    from repro_torch.launch.elastic import rescale_state
    from repro_torch.launch.mesh import make_mesh_for, set_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import get_model_def
    from repro_torch.models.module import tree_map
    from repro_torch.sharding import partitioning as P
    from repro_torch.train.checkpoint import host_state
    from repro_torch.train.data import SyntheticLMData

    res = {}
    for name, arch, over, model, seq_len in cases:
        SHAPES["tiny"] = dict(seq_len=seq_len, global_batch=8, kind="train")
        mesh = make_mesh_for(4, model)
        set_mesh(mesh)
        cfg = smoke_config(arch, **over)
        md = get_model_def(cfg)
        data = SyntheticLMData(cfg, "tiny", seed=1, device="cpu", mesh=mesh)
        step, _ = make_train_step(md, cfg, warmup=1, mesh=mesh,
                                  row_axes=data.row_axes)
        state, _ = rescale_state(os.path.join(out_dir, f"jax_{name}"), md,
                                 cfg, mesh)
        P.SPLIT_SEEN.clear()
        metrics, grads1, params_at = [], None, []
        for i in range(TRAIN_STEPS):
            if i:  # the parameters each later step starts from
                params_at.append(host_state(state["params"]))
            state, m = step(state, data.batch(i))
            metrics.append({k: float(v) for k, v in m.items()})
            if i == 0:
                grads1 = host_state(state["opt"]["m"])
        model = mesh.mesh_dim_names.index("model")
        # (leaf name, split along model in storage, the step's plan)
        leaves = []
        tree_map(lambda t, h, k: leaves.append(
            (k, t.placements[model].is_shard(), h)), state["params"],
            step.model_plan, _names(state["params"]))
        res[name] = dict(metrics=metrics, grads1=grads1,
                         seen=dict(P.SPLIT_SEEN), leaves=leaves,
                         params_at=params_at)
        set_mesh(None)
    return res


def _sse_post(port, prompt):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", "/v1/generate", body=json.dumps(
        dict(prompt=prompt, max_new=4, temperature=0.8)),
        headers={"Content-Type": "application/json"})
    resp = conn.getresponse()
    events = []
    while True:
        line = resp.readline()
        if not line:
            break
        if line.startswith(b"data: "):
            events.append(json.loads(line[6:]))
            if events[-1].get("finished"):
                break
    conn.close()
    return events


def launcher_part(params):
    """``launch.serve`` at --tp 2 (ranks 0, 1) and --tp 1 (rank 2); the
    gateway at tp = 2 answering two concurrent clients (ranks 0, 1), and
    rank 2's tp = 1 streams of both prompts under both rid orders."""
    from repro_torch.launch import serve
    from repro_torch.serving import Request, SamplingParams
    from repro_torch.serving.gateway import serve_background

    rank = dist.get_rank()
    argv = ["--arch", "camformer-bert", "--smoke", "--backend", "camformer",
            "--device", "cpu", "--requests", "3", "--max-new", "4",
            "--temperature", "0.8", "--no-stream"]
    res = {}
    if rank < 2:
        eng = serve.main(argv + ["--tp", "2"])
        res["serve"] = {r.rid: tuple(r.tokens) for r in eng.done}
        eng = _engine(_cfg(dict(attn_backend="dense")), params, 2)
        if rank == 0:
            gw = serve_background(eng, port=0)
            got = {}
            clients = [threading.Thread(target=lambda p=p: got.__setitem__(
                tuple(p), _sse_post(gw.port, p))) for p in GATEWAY_PROMPTS]
            for c in clients:
                c.start()
            for c in clients:
                c.join()
            conn = http.client.HTTPConnection("127.0.0.1", gw.port,
                                              timeout=60)
            conn.request("GET", "/metrics")
            res["metrics"] = json.loads(conn.getresponse().read())
            conn.close()
            gw.stop()
            eng.close()
            res["gateway"] = {p: (ev[-1]["rid"], tuple(ev[-1]["tokens"]))
                              for p, ev in got.items()}
        else:
            eng.follow()
        res["gateway_done"] = {r.rid: tuple(r.tokens) for r in eng.done}
    elif rank == 2:
        eng = serve.main(argv + ["--tp", "1"])
        res["serve@1"] = {r.rid: tuple(r.tokens) for r in eng.done}
        base = {}
        for order in (GATEWAY_PROMPTS, GATEWAY_PROMPTS[::-1]):
            eng = _engine(_cfg(dict(attn_backend="dense")), params, 1)
            reqs = [Request(prompt=list(p), sampling=SamplingParams(
                max_new=4, temperature=0.8), rid=i)
                for i, p in enumerate(order)]
            for r in reqs:
                eng.submit(r)
            eng.run()
            base.update({(tuple(r.prompt), r.rid): tuple(r.tokens)
                         for r in reqs})
        res["gateway@1"] = base
    return res


def run_ranks(out_dir, part, during, timeout_s=300):
    """Start ``WORLD`` = 4 processes of this file on ``part`` (a file
    rendezvous under ``out_dir``), call ``during()`` while they run, and
    return (its value, every rank's results); processes still alive
    after ``timeout_s`` are killed."""
    import signal
    import subprocess
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(root / "src")] + [e for e in [os.environ.get("PYTHONPATH")]
                               if e]), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), "4", str(out_dir), part],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True, start_new_session=True) for r in range(4)]
    try:
        value = during()
        logs = [p.communicate(timeout=timeout_s)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-6000:]}"
    return value, [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                              weights_only=False) for r in range(4)]


def main():
    rank, world, out_dir = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    part = sys.argv[4]
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + os.path.join(out_dir, "rendezvous"),
        rank=rank, world_size=world)
    from repro_torch.launch.mesh import make_tp_mesh

    res, took = {}, {}
    try:
        if part in ("serve", "spec_train"):
            for tp in (2, 4):  # every process makes the groups together
                make_tp_mesh(tp)
            params = torch.load(os.path.join(out_dir, "params.pt"))
        parts = ((("serving", lambda: serving_part(params, SERVE_PART_CASES,
                                                   True)),
                  ("launch", lambda: launcher_part(params)))
                 if part == "serve" else
                 (("serving", lambda: serving_part(params, TRAIN_PART_CASES,
                                                   False)),
                  ("train", lambda: train_part(out_dir, TRAIN_CASES)))
                 if part == "spec_train" else
                 (("train", lambda: train_part(out_dir, TRAIN_PARTS[part])),))
        for name, fn in parts:
            t0 = time.perf_counter()
            res[name] = fn()
            took[name] = time.perf_counter() - t0
        res["seconds"] = took
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
