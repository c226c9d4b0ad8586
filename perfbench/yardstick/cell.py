"""One run of one cell: set-up, the measured window, the record.

The entry the window drives is the program's ``ServeEngine`` (paged,
the flags ``launch/cli.build_engine`` passes), built from the cell's
configuration file with weights the benchmark draws from the seed.  The
harness's closed-loop clients drive ``submit`` / ``poll``; every event
is stamped with the host clock when ``poll`` hands it back.

Set-up: import, CUDA init, the weight draw, the engine, one warm-up
request (it builds the CUDA kernels on a checkout's first run and
launches every kernel the window runs), and the first wave of requests
admitted and prefilled.  The window then
runs for ``seconds``; nothing is built or compiled inside it.
"""

from __future__ import annotations

import gc
import sys
import time

import torch

from yardstick import loadgen, registry
from yardstick import weights as W
from yardstick.capture import Capture

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is the JAX
    stack's or the JAX package's."""
    return sorted({n.split(".")[0] for n in sys.modules}
                  & set(FORBIDDEN))


def model_numbers(cfg) -> dict:
    """The configuration's numbers the yardstick and the reference read."""
    keys = ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
            "d_ff", "vocab", "rope_theta", "k_top", "group_size",
            "stage1_k")
    return {k: getattr(cfg, k) for k in keys}


class _Req:
    __slots__ = ("client", "prompt", "t_submit", "times", "served",
                 "t_finish", "reason")

    def __init__(self, client, prompt, t_submit):
        self.client, self.prompt, self.t_submit = client, prompt, t_submit
        self.times = []
        self.served = ()
        self.t_finish = None
        self.reason = None


class Clients:
    """The closed loop: each client submits its next request when its
    last one finishes."""

    def __init__(self, eng, plan: loadgen.Plan, sampling: dict):
        from repro_torch.serving import Request, SamplingParams

        self.eng, self.plan = eng, plan
        self._Request, self._Sampling = Request, SamplingParams
        self.temperature = float(sampling.get("temperature", 0.0))
        self.reqs = {}
        self.rounds = [0] * plan.clients
        self.rejected = 0
        self.open = True  # clients send new requests
        self.capture = None  # records the checked requests' rows

    def submit(self, client: int):
        prompt, out = self.plan.request(client, self.rounds[client])
        self.rounds[client] += 1
        req = self._Request(prompt=prompt, sampling=self._Sampling(
            max_new=out, temperature=self.temperature))
        t = time.perf_counter()
        try:
            rid = self.eng.submit(req)
        except ValueError:
            self.rejected += 1
            return
        self.reqs[rid] = _Req(client, prompt, t)
        cap = self.capture
        if cap is not None and client in self.plan.watched and \
                cap.held + len(prompt) + out <= self.plan.check_positions:
            cap.watch.add(rid)
            cap.held += len(prompt) + out

    def take(self, events, t: float):
        for ev in events:
            rec = self.reqs.get(ev.rid)
            if rec is None:
                continue
            if ev.token is not None:
                rec.times.append(t)
                rec.served = tuple(ev.tokens)
            if ev.finished:
                rec.t_finish, rec.reason = t, ev.finish_reason
                if self.open:
                    self.submit(rec.client)


def _mark(phases: dict, name: str, dev, t_proc0: float):
    """Seconds from process start to the end of set-up phase ``name``."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    phases[name] = time.perf_counter() - t_proc0


def _counters(eng) -> dict:
    return dict(ticks=eng.ticks, prefill_ticks=eng.prefill_ticks,
                prefill_tokens=eng.prefill_tokens, blocked_s=eng.blocked_s,
                tick_errors=eng.tick_errors)


class Stage1Recorder:
    """Traced runs only: the shapes of every launch of kernel 1, taken
    by a wrapper around ``repro_torch.kernels.ops.bacam_paged_scores_topk``
    while ``on``."""

    def __init__(self):
        from repro_torch.kernels import ops

        self.ops, self.orig = ops, ops.bacam_paged_scores_topk
        self.launches = []
        self.on = False

        def wrapped(qp, kp_pages, page_table, kv_len, q_pos=None, **kw):
            if self.on:
                self.launches.append((tuple(qp.shape), tuple(kp_pages.shape),
                                      tuple(page_table.shape), kv_len,
                                      kw.get("group", 16),
                                      kw.get("stage1_k", 2)))
            return self.orig(qp, kp_pages, page_table, kv_len, q_pos, **kw)

        ops.bacam_paged_scores_topk = wrapped

    def close(self):
        self.ops.bacam_paged_scores_topk = self.orig

    def bytes_per_launch(self) -> list:
        from yardstick.counts import stage1_bytes

        live = {}
        out = []
        for qs, ks, ts, kv_len, group, s1 in self.launches:
            key = id(kv_len)
            if key not in live:  # one (B,) tensor a tick, every layer's
                live[key] = int(kv_len.to(torch.int64).sum().item())
            b, hkv, rows, words = qs
            out.append(stage1_bytes(b, hkv, rows, words, ts[1], ks[2],
                                    group, s1, live[key]))
        return out


def _power_limit() -> str:
    import subprocess

    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return res.stdout.strip().splitlines()[0] if res.stdout else \
            "not measured"
    except (OSError, subprocess.SubprocessError):
        return "not measured"


def run(workload_name: str, seed: int, seconds: float, trace: bool, *,
        t_proc0: float, device: str = "cuda", root=registry.ROOT,
        bench: dict | None = None, record: bool = True) -> dict:
    """Run the cell; returns the record (see ``metrics/*.py``) and the
    objects the correctness check needs.  ``record=False`` leaves the
    check's recording out (``calibrate.py`` measures what it costs)."""
    from repro_torch.configs import get_config
    from repro_torch.models.module import param_shapes
    from repro_torch.models.transformer import dtype_of
    from repro_torch.serving import ServeEngine

    bench = registry.load_benchmark(root) if bench is None else bench
    wl = registry.workload(bench, workload_name)
    conf = registry.config(bench, wl["config"], root)
    traffic = registry.traffic(wl["traffic"], root / "perfbench")
    cfg = get_config(conf["arch"]).replace(**conf["model"])
    dev = torch.device(device)
    phases = {"import": time.perf_counter() - t_proc0}
    params = W.draw(param_shapes(cfg), seed, dev, dtype_of(cfg))
    _mark(phases, "draw", dev, t_proc0)
    eflags = conf["engine"]
    eng = ServeEngine(
        cfg, params, max_batch=traffic["clients"], max_len=traffic["max_len"],
        page_size=eflags["page_size"], n_pages=eflags.get("n_pages"),
        mode=eflags["mode"], prefill_slice=eflags.get("prefill_slice"),
        paged_impl=eflags["paged_impl"],
        prefill_impl=eflags.get("prefill_impl"), spec_k=eflags.get("spec_k"),
        spec_backend=eflags.get("spec_backend"), device=dev)
    cuda = dev.type == "cuda"
    _mark(phases, "engine", dev, t_proc0)

    # warm-up: one request of the mix's shortest lengths through prefill
    # and decode (builds and launches every kernel the window runs)
    from repro_torch.serving import Request, SamplingParams

    warm = Request(prompt=[1] * traffic["prompt_len"]["min"],
                   sampling=SamplingParams(max_new=4, temperature=0.0))
    for _ in eng.stream(warm):
        pass
    _mark(phases, "warm_up", dev, t_proc0)
    plan = loadgen.Plan(traffic, seed, cfg.vocab)
    clients = Clients(eng, plan, traffic.get("sampling", {}))
    capture = Capture(eng) if record else None
    if capture is not None:
        clients.capture = capture
        capture.on = True
    for c in range(plan.clients):
        clients.submit(c)
    wave = list(clients.reqs.values())
    # until every request of the wave has its first token; a client
    # whose request is already done sends its next one meanwhile
    while any(not r.times for r in wave):
        clients.take(eng.poll(), time.perf_counter())
    _mark(phases, "first_wave", dev, t_proc0)
    stage1 = Stage1Recorder() if trace else None
    tracer = None
    if trace and cuda:
        from yardstick.trace import Tracer

        tracer = Tracer()
        tracer.start()
    if cuda:
        torch.cuda.synchronize()
    c0 = _counters(eng)
    t_start = time.perf_counter()
    setup_s = t_start - t_proc0
    t_end = t_start + seconds
    if stage1 is not None:
        stage1.on = True
    spans = []
    while True:
        t0 = time.perf_counter()
        if t0 >= t_end:
            break
        p0 = eng.prefill_ticks
        events = eng.poll()
        t1 = time.perf_counter()
        spans.append(("prefill poll" if eng.prefill_ticks > p0
                      else "decode poll", t0, t1))
        clients.take(events, t1)
    t_stop = time.perf_counter()
    clients.open = False
    if capture is not None:
        capture.on = False
    if stage1 is not None:
        stage1.on = False
    if tracer is not None:
        tracer.stop()
    c1 = _counters(eng)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None

    rec = _record(clients, t_start, t_end, t_stop, c0, c1, spans,
                  model_numbers(cfg), setup_s)
    if tracer is not None:
        from yardstick.trace import device_record

        ns = lambda t: int(t * 1e9)  # noqa: E731
        rec["trace"] = device_record(
            tracer.device_intervals(), ns(t_start), ns(t_stop),
            [(lab, ns(a), ns(b)) for lab, a, b in spans],
            {"perf": tracer.perf0, "wall": tracer.wall0,
             "mono": tracer.mono0})
    if stage1 is not None:
        rec["stage1_bytes"] = stage1.bytes_per_launch()
        stage1.close()
    rec["tick_errors"] = c1["tick_errors"] - c0["tick_errors"]
    rec["setup_phases"] = phases
    if capture is not None:
        capture.close()
    # the requests the check can judge: finished, and recorded
    finished = [(rid, r.prompt, r.served, r.reason)
                for rid, r in clients.reqs.items() if r.t_finish is not None
                and capture is not None and rid in capture.watch]
    out = dict(record=rec, peak=peak, params=params, finished=finished,
               capture=capture,
               cfg_numbers=model_numbers(cfg), traffic=traffic,
               attempted=len(clients.reqs) + clients.rejected,
               failed=clients.rejected + sum(
                   1 for r in clients.reqs.values()
                   if r.reason not in (None, "length", "stop")))
    del eng, clients
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        out["device"] = dict(platform="gpu",
                             kind=torch.cuda.get_device_name(dev),
                             count=1, memory_peak_bytes=peak,
                             power_limit=_power_limit())
    else:
        out["device"] = dict(platform="cpu", kind="cpu", count=1,
                             memory_peak_bytes=peak)
    return out


def _record(clients, t_start, t_end, t_stop, c0, c1, spans, m, setup_s):
    """The window's numbers from the requests' host stamps and the
    engine's counters."""
    in_win = lambda t: t_start <= t <= t_end  # noqa: E731
    tokens = 0
    gaps, ttft = [], []
    loop_tokens = loop_first = 0
    for r in clients.reqs.values():
        tokens += sum(1 for t in r.times if in_win(t))
        for a, b in zip(r.times, r.times[1:]):
            if in_win(a) and in_win(b):
                gaps.append(b - a)
        in_loop = [t for t in r.times if t_start <= t <= t_stop]
        loop_tokens += len(in_loop)
        if r.times and t_start <= r.times[0] <= t_stop:
            loop_first += 1
        if in_win(r.t_submit):
            first = r.times[0] if r.times else None
            ttft.append((first if first is not None and first <= t_end
                         else t_end) - r.t_submit)
    d = {k: c1[k] - c0[k] for k in c0}
    return dict(
        setup_s=setup_s, window_s=t_end - t_start, loop_s=t_stop - t_start,
        tokens=tokens, tpot_s=gaps, ttft_s=ttft, counters=d,
        loop_tokens=loop_tokens, loop_first_tokens=loop_first,
        spans=[(lab, a - t_start, b - t_start) for lab, a, b in spans],
        model=m, trace=None, stage1_bytes=None)
