"""Serving engine: host-plan / device-step split with dispatch-ahead
decode and continuous chunked-prefill batching.

The engine mirrors the reference package's ``serving/engine.py``:

  1. ``Scheduler`` (serving/scheduler.py) — host-pure admission,
     preemption, finish detection and page planning; ``plan_tick()``
     emits a ``TickPlan``.
  2. the device step — one plain PyTorch function per tick
     (``_prefill_step`` / ``_decode_step``, or the speculative step of
     serving/speculate.py) over the family's paged interface
     (``models.get_model_def``: dense, MoE, text-only VLM): the model
     forward through every layer's
     ``backend.paged_decode`` (paged CUDA kernels on the card), the
     in-place pool writes, and keyed sampling (``sample_step_keyed``;
     ticks whose rows are all greedy take the argmax).  The sampled ids,
     one (B,) int32 tensor — or the (B, spec_k + 2) speculative pack of
     samples and accepted counts — are the only per-tick readback; the
     decode step's input tokens come from the on-device token buffer of
     the previous tick.
  3. the loop — ``mode="sync"`` reads each tick's tokens right away;
     ``mode="overlap"`` enqueues tick t+1 on the current stream before
     it waits for tick t's ids.  Each step queues the device-to-host copy
     of its ids (into pinned memory) behind its own kernels and records
     an event, so reading tick t waits for tick t only.  Host visibility
     of token values is deferred one tick; everything value-independent
     is planned as in sync mode, and sampling is keyed by
     ``(seed, rid, index)``, so both modes give the same tokens.

Self-speculative decoding (``spec_k > 0``): a drafter stack (the same
weights, every layer on ``spec_backend``) keeps its own pools on the same
page ids, forked with the target's on every COW fork; each decode tick
drafts ``spec_k`` tokens per slot and verifies them in one target pass
(serving/speculate.py), and ``Scheduler.resolve_spec`` settles the
accepted prefix.

Tensor parallelism (``tp > 1``, serving/sharded.py): one engine a
process on the first ``tp`` processes of an initialised
``torch.distributed`` world (NCCL on the card, gloo on the CPU; one
process a device), each holding ``1 / tp`` of the kv heads of every
page and gathering the heads' attention outputs every layer
(models/attention.py).  Rank 0 leads: it takes the submissions and
cancellations and serves the caller; every other process calls
``follow()``, which replays rank 0's control operations and runs each
of its ticks with rank 0's clock reading, until rank 0 calls
``close()``.  Every process plans its own tick, and the plans are
compared every tick (``PlanMismatchError``); a failed tick is agreed
across the processes before it is contained, so every process fails
the same tick.  The streams, ``readbacks`` and ``ticks`` are the tp = 1
engine's.  ``tp == 1`` takes none of this: ``mesh`` is None.

Crash containment is the reference's: a failed tick finishes its
in-flight requests with ``finish_reason="error"`` and counts in
``tick_errors``, and the engine keeps serving.  A caller that needs a
clean run must check ``tick_errors`` and the finish reasons.
"""

from __future__ import annotations

import logging
import time
from typing import Iterator, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models.module import cast_params
from repro_torch.models.registry import get_model_def
from repro_torch.models.transformer import dtype_of, init_pools
from repro_torch.serving import sampler as S
from repro_torch.serving import sharded, speculate
from repro_torch.serving.faults import NO_FAULTS, FaultPlan
from repro_torch.serving.kv_cache import PagedKVCache, pages_for
from repro_torch.serving.request import (Request, RequestOutput, RequestState,
                                         SamplingParams)
from repro_torch.serving.scheduler import Admission, Emit, Scheduler, TickPlan
from repro_torch.utils import spans

__all__ = ["Request", "SamplingParams", "RequestState", "RequestOutput",
           "Admission", "Scheduler", "ServeEngine"]

log = logging.getLogger("repro_torch.serving.engine")

# Right-pad prompt batches to a multiple of this.
PREFILL_BUCKET = 16


def _copy_pool_page(caches, src: int, dst: int):
    """Copy physical page ``src`` -> ``dst`` in every layer's page pools
    (the device half of a COW fork), in place.  Page leaves are the
    ``*_pages`` entries of ``page_spec``; per-slot leaves (``k_scale``)
    are untouched."""
    for layer in caches:
        for name, arr in layer.items():
            if name.endswith("_pages"):
                arr[dst] = arr[src]
    return caches


class _Readback(NamedTuple):
    """One tick's sampled ids: the device tensor, and on the card a
    pinned host copy queued behind the tick plus its completion event."""

    device: torch.Tensor
    host: Optional[torch.Tensor]
    event: Optional["torch.cuda.Event"]


class _InFlight(NamedTuple):
    """Handles of one dispatched tick, read one tick later (overlap) or
    immediately (sync)."""

    prefill_tok: Optional[_Readback]  # (B,) sampled first tokens
    prefill_emit: Tuple[Emit, ...]
    decode_tok: Optional[_Readback]  # (B,) sampled decode tokens, or the
    #                                  (B, m + 1) spec pack (samples ++ n_valid)
    decode_emit: Tuple[Emit, ...]
    spec: bool = False  # decode_tok is a speculative multi-token pack

    @property
    def empty(self) -> bool:
        return not (self.prefill_emit or self.decode_emit)


class ServeEngine:
    def __init__(self, cfg, params, *, max_batch: int = 8,
                 max_len: int = 512, seed: int = 0, page_size: int = 64,
                 n_pages: Optional[int] = None, prefix_sharing: bool = True,
                 mode: str = "overlap", prefill_slice: Optional[int] = None,
                 paged_impl: Optional[str] = None,
                 prefill_impl: Optional[str] = None,
                 spec_k: Optional[int] = None,
                 spec_backend: Optional[str] = None, tp: int = 1,
                 max_queue: Optional[int] = None,
                 faults: Optional[FaultPlan] = None, device="cuda"):
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        self.tp = tp
        self.mesh = None
        self._pool_pspecs = self._draft_pspecs = None
        self._sync: Optional[sharded.TickSync] = None
        self._now: Optional[float] = None  # the tick's clock (tp > 1)
        self.tp_rank = 0  # this process's rank in the tp mesh
        if paged_impl is not None:
            cfg = cfg.replace(paged_impl=paged_impl)
        if prefill_impl is not None:
            cfg = cfg.replace(prefill_impl=prefill_impl)
        if spec_k is not None or spec_backend is not None:
            cfg = cfg.replace(
                spec_k=cfg.spec_k if spec_k is None else spec_k,
                spec_backend=(cfg.spec_backend if spec_backend is None
                              else spec_backend))
        md = get_model_def(cfg)
        if md.page_specs is None:
            raise ValueError(
                f"{cfg.name!r} (family {cfg.family!r}) does not expose the "
                "paged serving interface (page_specs / prefill_paged / "
                "decode_paged) required by ServeEngine")
        if cfg.spec_k and md.verify_paged is None:
            raise ValueError(
                f"{cfg.name!r} does not expose verify_paged "
                "(all-position logits), required for spec_k > 0")
        if mode not in ("sync", "overlap"):
            raise ValueError(f"mode must be 'sync' or 'overlap', got {mode!r}")
        self.device = resolve_device(device)
        if tp > 1:
            self.device = self._join_tp_mesh(tp, self.device)
        self.md, self.cfg = md, cfg
        self.params = cast_params(params, dtype_of(cfg), self.device)
        self.max_batch, self.max_len = max_batch, max_len
        self.mode = mode

        chunk = cfg.prefill_chunk
        if chunk and max_len % chunk != 0:
            raise ValueError(
                f"max_len={max_len} must be a multiple of "
                f"prefill_chunk={chunk} for paged serving")
        per_seq = pages_for(max_len, page_size)
        if n_pages is None:
            n_pages = 1 + max_batch * per_seq  # +1: trash page
        self.faults = NO_FAULTS if faults is None else faults
        self.kv = PagedKVCache(n_pages, page_size, max_batch, per_seq,
                               faults=self.faults)
        self.spec_k = cfg.spec_k
        self.sched = Scheduler(
            self.kv, max_batch=max_batch, max_len=max_len, seed=seed,
            prefix_sharing=prefix_sharing, prefill_slice=prefill_slice,
            prefill_bucket=chunk or PREFILL_BUCKET, spec_k=self.spec_k,
            max_queue=max_queue,
            **({} if tp == 1 else {"clock": self._clock}))
        specs = md.page_specs(cfg, n_pages, page_size, max_batch)
        # speculative decoding: the drafter stack keeps its OWN pools on
        # the SAME page ids, so admission, COW forks and rollback are
        # planned once for both
        self.draft_caches = None
        self._draft_cfg = None
        dspecs = None
        if self.spec_k:
            self._draft_cfg = speculate.draft_config(cfg)
            dspecs = md.page_specs(self._draft_cfg, n_pages, page_size,
                                   max_batch)
        if tp == 1:
            self.caches = init_pools(specs, self.device)
            if dspecs is not None:
                self.draft_caches = init_pools(dspecs, self.device)
        else:
            # head divisibility is checked BEFORE any pool is allocated;
            # every page holds 1/tp of its kv heads on this process
            self._pool_pspecs = sharded.pool_partition_specs(specs, tp)
            if dspecs is not None:
                self._draft_pspecs = sharded.pool_partition_specs(dspecs,
                                                                  tp)
            self.caches = sharded.init_local_pools(specs, tp, self.device)
            if dspecs is not None:
                self.draft_caches = sharded.init_local_pools(dspecs, tp,
                                                             self.device)
            self._sync = sharded.TickSync(self.mesh)
            self.tp_rank = self._sync.rank
            self._sync.check_params(self.params)
        # on-device token state: the decode step's input tokens are the
        # previous step's output, never a host round-trip
        self._zero_tok = torch.zeros((max_batch,), dtype=torch.int32,
                                     device=self.device)
        self._tok_buf = self._zero_tok
        self._pending: Optional[_InFlight] = None
        self._settling: List[Emit] = []

        self.readbacks = 0  # device->host transfers (token id arrays)
        self.blocked_s = 0.0  # host time spent blocked on readbacks
        self.ticks = 0  # decode steps dispatched
        self.tick_errors = 0  # device ticks that failed and were contained
        self.last_error: Optional[str] = None
        self._tick_index = 0  # ticks started: the spans' ``tick``

    # ------------------------------------------------------------------
    # scheduler delegation
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> int:
        if self._sync is not None:  # rank 0 records it for the followers
            self._leader_only("submit")
            self._now = time.monotonic()
            self._sync.ops.append(("submit", list(req.prompt), req.sampling,
                                   req.rid, req.priority, self._now))
        return self.sched.submit(req)

    def cancel(self, rid: int) -> Optional[RequestOutput]:
        if self._sync is not None:
            self._leader_only("cancel")
            self._sync.ops.append(("cancel", rid))
        return self.sched.cancel(rid)

    def schedule(self) -> List[Admission]:
        """Admission policy alone (no model computation) — see
        ``Scheduler.admit``."""
        return self.sched.admit()

    @property
    def queue(self) -> List[Request]:
        return self.sched.queue

    @property
    def active(self) -> List[Optional[Request]]:
        return self.sched.active

    @property
    def done(self) -> List[Request]:
        return self.sched.done

    @property
    def peak_pages(self) -> int:
        return self.sched.peak_pages

    @property
    def has_work(self) -> bool:
        return self.sched.has_work

    @property
    def has_pending(self) -> bool:
        return self._pending is not None

    @property
    def prefill_tokens(self) -> int:
        """Prompt tokens materialized through chunked-prefill steps."""
        return self.sched.prefill_tokens

    @property
    def prefill_positions(self) -> int:
        """Positions the prefill steps computed, padding included."""
        return self.sched.prefill_positions

    @property
    def prefill_ticks(self) -> int:
        """Engine ticks that carried a prefill chunk."""
        return self.sched.prefill_ticks

    @property
    def preemptions(self) -> int:
        return self.sched.preemptions

    @property
    def spec_proposed(self) -> int:
        """Draft tokens proposed by the speculative drafter stack."""
        return self.sched.spec_proposed

    @property
    def spec_accepted(self) -> int:
        """Proposed draft tokens the target stack verified and kept."""
        return self.sched.spec_accepted

    @property
    def spec_acceptance(self) -> float:
        """spec_accepted / spec_proposed (0.0 before any speculation)."""
        return self.sched.spec_acceptance

    # ------------------------------------------------------------------
    # tensor parallelism: the mesh, and one plan on every process
    # ------------------------------------------------------------------
    def _join_tp_mesh(self, tp: int, device: torch.device) -> torch.device:
        """Join the ``("tp",)`` mesh of the world's first ``tp`` processes;
        returns this process's device."""
        import torch.distributed as dist

        from repro_torch.launch.mesh import make_tp_mesh

        world = dist.get_world_size() if dist.is_initialized() else 1
        if world < tp:
            raise ValueError(
                f"tp={tp} needs at least {tp} devices, one process each in "
                f"an initialised torch.distributed group; the world has "
                f"{world} (start the processes with torchrun)")
        want = "nccl" if device.type == "cuda" else "gloo"
        if dist.get_backend() != want:
            raise ValueError(f"the process group runs {dist.get_backend()}, "
                             f"device {device} needs {want}")
        self.mesh = make_tp_mesh(tp)
        if self.mesh is None:
            raise ValueError(f"tp={tp}: process {dist.get_rank()} is outside "
                             f"the mesh of the world's first {tp} processes")
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        return device

    def _clock(self) -> float:
        """The scheduler's clock under tp > 1: the reading rank 0 took for
        this tick or submission."""
        return time.monotonic() if self._now is None else self._now

    def _leader_only(self, what: str) -> None:
        if not self._sync.leader:
            raise RuntimeError(
                f"{what}: a tensor-parallel engine takes its requests on "
                f"rank 0; tp rank {self._sync.rank} runs follow()")

    def _tick_start(self, call: str) -> None:
        """Advance the fault plan's clock and, but for a prefill tick,
        consult ``tick.delay``.  Under tp > 1 rank 0 then reads the clock
        and broadcasts the tick's inputs; the followers, which received
        them in ``follow()``, draw nothing."""
        self._tick_index += 1
        self.faults.advance()
        if self._sync is not None and not self._sync.leader:
            return
        delay = self._fault_delay() if call != "prefill" else 0.0
        if self._sync is not None:
            self._now = time.monotonic()
            self._sync.send(call, self._now, delay)

    def _check_plan(self, plan: TickPlan) -> None:
        if self._sync is not None:
            self._sync.check_plan(plan)

    def _agree(self, err: Optional[BaseException]):
        """The tick's failure, agreed across the tp processes (this
        process's own at tp = 1)."""
        return err if self._sync is None else self._sync.agree(err)

    def _replay(self, ops) -> None:
        """A follower: rank 0's submissions and cancellations, in order,
        each at rank 0's clock reading."""
        for op in ops:
            if op[0] == "cancel":
                self.sched.cancel(op[1])
                continue
            _, prompt, sampling, rid, priority, self._now = op
            try:
                self.sched.submit(Request(prompt=prompt, sampling=sampling,
                                          rid=rid, priority=priority))
            except ValueError:  # rank 0's submit raised the same
                pass

    def follow(self) -> List[RequestOutput]:
        """Processes of tp rank > 0: run rank 0's ticks, each after its
        control operations and at its clock, until rank 0 calls
        ``close()``.  Returns the outputs of those ticks (rank 0's, event
        for event)."""
        if self._sync is None or self._sync.leader:
            raise RuntimeError("follow() runs on tp ranks > 0 of a "
                               "tensor-parallel engine")
        calls = {"poll": self.poll, "step": self.step,
                 "prefill": self._prefill_tick}
        events: List[RequestOutput] = []
        while True:
            msg = self._sync.receive()
            if msg.call == "stop":
                return events
            self._replay(msg.ops)
            self._now = msg.clock
            events.extend(calls[msg.call]())

    def close(self) -> None:
        """Rank 0 of a tensor-parallel engine: end the followers'
        ``follow()``.  A no-op otherwise."""
        if self._sync is not None and self._sync.leader:
            self._sync.send("stop")

    # ------------------------------------------------------------------
    # the device step: one plain function per tick
    # ------------------------------------------------------------------
    def _h2d(self, arr: np.ndarray) -> torch.Tensor:
        """A host plan array on the device.  On the card the copy goes
        through pinned memory and does not wait for queued work."""
        t = torch.from_numpy(np.array(arr, copy=True))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    @staticmethod
    def _sample(logits, hot, samp):
        """The tick's samples: keyed draws when any row is hot (``samp`` =
        keys, index, temps, top_ks, top_ps on the device), else the
        argmax."""
        return S.sample_step_keyed(logits, *samp) if hot else S.greedy(logits)

    def _prefill_step(self, tokens, lens, offsets, scale_base, pt, hot,
                      samp):
        batch = {"tokens": tokens, "lens": lens, "offsets": offsets,
                 "scale_base": scale_base}
        with spans.span("model.prefill"):
            if self.spec_k:
                fn = speculate.build_spec_prefill(self.md, self.cfg,
                                                   self._draft_cfg, hot)
                first, self.caches, self.draft_caches = fn(
                    self.params, batch, self.caches, self.draft_caches, pt,
                    *samp)
                return first
            logits, self.caches = self.md.prefill_paged(
                self.params, batch, self.caches, pt, self.cfg)
            return self._sample(logits, hot, samp)

    def _decode_step(self, tok_prev, fresh, fresh_mask, live_mask, pos,
                     kv_len, pt, base, hot, samp):
        # merge the token state on the device: rows that finished prefill
        # THIS tick take their fresh first token, continuing rows the
        # previous step's output, inert rows 0
        with spans.span("model.decode"):
            tokens = torch.where(live_mask,
                                 torch.where(fresh_mask, fresh, tok_prev),
                                 torch.zeros_like(tok_prev))
            logits, self.caches = self.md.decode_paged(
                self.params, tokens, pos, kv_len, self.caches, pt, self.cfg,
                base=base)
            return self._sample(logits, hot, samp)

    def _spec_step(self, fresh, fresh_mask, live_mask, pos, n_tok, pt, base,
                   hot, samp):
        """One speculative tick; returns the (B, m + 1) pack and updates
        the token buffer and both pools."""
        with spans.span("model.spec"):
            fn = speculate.build_spec_step(self.md, self.cfg,
                                           self._draft_cfg, self.spec_k + 1,
                                           hot)
            packed, self._tok_buf, self.caches, self.draft_caches = fn(
                self.params, self._tok_buf, fresh, fresh_mask, live_mask,
                pos, n_tok, self.caches, self.draft_caches, pt, base, *samp)
            return packed

    def _start_readback(self, tok: torch.Tensor) -> _Readback:
        if tok.is_cuda:
            host = torch.empty(tok.shape, dtype=tok.dtype, pin_memory=True)
            host.copy_(tok, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
            return _Readback(tok, host, event)
        return _Readback(tok, None, None)

    @torch.no_grad()
    def _dispatch(self, plan: TickPlan) -> _InFlight:
        """Enqueue one tick's device work; returns unread token handles.
        The ``engine.dispatch`` span includes any wait on a full launch
        queue; the requests whose last prefill chunk it carried are
        stamped ``prefill_enqueued`` at its end."""
        with spans.span("engine.dispatch"):
            self.faults.raise_if("step.error")  # chaos: the step dies
            if self.mesh is None:
                inflight = self._dispatch_step(plan)
            else:
                from repro_torch.launch.mesh import tp_scope

                with tp_scope(self.mesh):  # attention gathers its heads
                    inflight = self._dispatch_step(plan)
        for e in inflight.prefill_emit:
            spans.stamp(e.req.rid, "prefill_enqueued")
        return inflight

    def _dispatch_step(self, plan: TickPlan) -> _InFlight:
        for src, dst in plan.forks:  # COW copies BEFORE any write
            self.caches = _copy_pool_page(self.caches, int(src), int(dst))
            if self.draft_caches is not None:  # same page ids: fork both
                self.draft_caches = _copy_pool_page(self.draft_caches,
                                                    int(src), int(dst))
        pf, dc = plan.prefill, plan.decode
        # the per-slot sampling rows, on the device only when some row
        # samples at temperature
        keys = temps = top_ks = top_ps = None
        if (pf is not None and pf.hot) or (dc is not None and dc.hot):
            keys, temps, top_ks, top_ps = (self._h2d(x) for x in (
                plan.keys.astype(np.int64), plan.temps, plan.top_ks,
                plan.top_ps))

        def samp(index, need=True):  # sample_step_keyed's row arguments
            return (keys, self._h2d(index) if need else None, temps, top_ks,
                    top_ps)

        prefill_tok = None
        fresh = self._zero_tok
        if pf is not None:
            first = self._prefill_step(
                self._h2d(pf.tokens), self._h2d(pf.lens),
                self._h2d(pf.offsets), self._h2d(pf.scale_base),
                self._h2d(pf.table), pf.hot, samp(pf.sample_index, pf.hot))
            if pf.emit:
                fresh = first
                prefill_tok = self._start_readback(first)
        decode_tok = None
        if dc is not None:
            args = (self._h2d(dc.fresh), self._h2d(dc.live),
                    self._h2d(dc.pos))
            if self.spec_k:
                # the spec step offsets the index per draft step even
                # when greedy, so it always takes it
                packed = self._spec_step(
                    fresh, *args, self._h2d(dc.n_tok), self._h2d(dc.table),
                    self._h2d(dc.base), dc.hot, samp(dc.sample_index))
                decode_tok = self._start_readback(packed)
            else:
                nxt = self._decode_step(
                    self._tok_buf, fresh, *args, self._h2d(dc.kv_len),
                    self._h2d(dc.table), self._h2d(dc.base), dc.hot,
                    samp(dc.sample_index, dc.hot))
                self._tok_buf = nxt
                decode_tok = self._start_readback(nxt)
            self.ticks += 1
        elif pf is not None and pf.emit:
            # prefill completed with no decode tick in the same plan: fold
            # the first-token samples into the on-device buffer
            mask = np.zeros(self.max_batch, bool)
            mask[[e.slot for e in pf.emit]] = True
            self._tok_buf = torch.where(self._h2d(mask), fresh,
                                        self._tok_buf)
        return _InFlight(prefill_tok, pf.emit if pf else (),
                         decode_tok, dc.emit if dc else (),
                         bool(self.spec_k and dc is not None))

    def _read(self, rb: _Readback) -> np.ndarray:
        """THE host<->device readback (token ids only); instrumented so
        benchmarks report the host-idle fraction and tests can assert one
        readback per tick.  The two clock reads of ``blocked_s`` are the
        ``engine.readback`` span's."""
        t0 = time.perf_counter_ns()
        if rb.event is not None:
            rb.event.synchronize()
            out = rb.host.numpy().copy()
        else:
            out = rb.device.cpu().numpy().copy()
        t1 = time.perf_counter_ns()
        self.blocked_s += (t1 - t0) / 1e9
        spans.record("engine.readback", t0, t1)
        self.readbacks += 1
        return out

    def _collect(self, inflight: _InFlight) -> List[RequestOutput]:
        """Read a dispatched tick's sampled ids and surface them (first
        prefill samples, then decode samples).

        A speculative tick reads ONE packed (B, m + 1) array — per-slot
        target samples plus the accepted count — and settles each slot's
        emits through ``Scheduler.resolve_spec`` (accepted prefix
        ingested, rejected suffix dropped and rolled back)."""
        events: List[RequestOutput] = []
        self._settling = list(inflight.prefill_emit + inflight.decode_emit)
        if inflight.prefill_emit:
            vals = self._read(inflight.prefill_tok)
            with spans.span("engine.ingest"):
                for e in inflight.prefill_emit:
                    out = self.sched.ingest(e, int(vals[e.slot]))
                    self._settling.pop(0)
                    if out is not None:
                        events.append(out)
        if not inflight.decode_emit:
            return events
        vals = self._read(inflight.decode_tok)
        with spans.span("engine.ingest"):
            if inflight.spec:
                groups: "dict[int, List[Emit]]" = {}
                for e in inflight.decode_emit:  # slot-major, consecutive
                    groups.setdefault(e.slot, []).append(e)
                for slot, ems in groups.items():  # insertion == settle order
                    events.extend(self.sched.resolve_spec(
                        slot, tuple(ems), vals[slot], int(vals[slot, -1])))
                    del self._settling[:len(ems)]
                return events
            for e in inflight.decode_emit:
                out = self.sched.ingest(e, int(vals[e.slot]))
                self._settling.pop(0)
                if out is not None:
                    events.append(out)
        return events

    # ------------------------------------------------------------------
    # crash containment
    # ------------------------------------------------------------------
    def _fail_tick(self, exc: BaseException,
                   unsettled: List[Emit]) -> List[RequestOutput]:
        """Contain one failed device tick: settle the in-flight accounting
        for every sample that will never be read, reset the on-device
        token buffer, and fail the ACTIVE requests with
        ``finish_reason="error"``.  QUEUED requests are untouched."""
        for e in unsettled:
            self.sched.drop(e)
        if self._pending is not None:  # the dispatched-ahead tick is lost
            for e in self._pending.prefill_emit + self._pending.decode_emit:
                self.sched.drop(e)
            self._pending = None
        self._settling = []
        self._tok_buf = self._zero_tok  # device token state is suspect
        self.tick_errors += 1
        self.last_error = f"{type(exc).__name__}: {exc}"
        log.warning("device tick failed (%s); failing in-flight requests "
                    "and continuing", self.last_error, exc_info=exc)
        return self.sched.fail_active(self.last_error)

    def _plan(self, sp, **kw) -> TickPlan:
        """``sched.plan_tick`` inside the ``engine.plan`` span; the tick's
        live prefill and decode rows go on ``sp``, its ``engine.poll``
        span."""
        with spans.span("engine.plan"):
            plan = self.sched.plan_tick(**kw)
        if spans.enabled():
            pf, dc = plan.prefill, plan.decode
            sp.set(prefill_rows=0 if pf is None
                   else int(np.count_nonzero(pf.lens)),
                   decode_rows=0 if dc is None
                   else int(np.count_nonzero(dc.live)))
        return plan

    @staticmethod
    def _plan_emits(plan: TickPlan) -> List[Emit]:
        ems: List[Emit] = []
        if plan.prefill is not None:
            ems.extend(plan.prefill.emit)
        if plan.decode is not None:
            ems.extend(plan.decode.emit)
        return ems

    def _run_plan(self, plan: TickPlan) -> List[RequestOutput]:
        """Dispatch + read one plan, containing device failures."""
        self._check_plan(plan)
        err = inflight = None
        try:
            inflight = self._dispatch(plan)
        except Exception as e:
            err = e
        err = self._agree(err)
        if err is not None:
            return self._fail_tick(err, self._plan_emits(plan))
        try:
            events = self._collect(inflight)
        except Exception as e:
            err = e
        err = self._agree(err)
        if err is not None:
            return self._fail_tick(err, list(self._settling))
        return events

    # ------------------------------------------------------------------
    # the engine loops
    # ------------------------------------------------------------------
    def step(self) -> List[RequestOutput]:
        """One SYNCHRONOUS engine tick: plan, dispatch, read."""
        self._tick_start("step")
        with spans.span("engine.poll", tick=self._tick_index) as sp:
            plan = self._plan(sp)
            events = self.sched.take_events()
            events.extend(self._run_plan(plan))
        return events

    def prefill(self, admitted: Optional[List[Admission]] = None
                ) -> List[RequestOutput]:
        """Drive the PREFILLING slots to completion (no admissions, no
        decode ticks) and return their first-token outputs.  ``admitted``
        is accepted for API compatibility with ``prefill(schedule())``;
        the scheduler already tracks the slots."""
        del admitted
        events: List[RequestOutput] = []
        while self.sched.has_prefilling:
            events.extend(self._prefill_tick())
        return events

    def _prefill_tick(self) -> List[RequestOutput]:
        self._tick_start("prefill")
        with spans.span("engine.poll", tick=self._tick_index) as sp:
            plan = self._plan(sp, admit=False, decode=False)
            events = self.sched.take_events()
            events.extend(self._run_plan(plan))
        return events

    def _fault_delay(self) -> float:
        d = self.faults.delay("tick.delay")
        if d > 0:
            time.sleep(d)
        return d

    def poll(self) -> List[RequestOutput]:
        """ONE engine iteration honoring ``mode``.  In overlap mode the
        returned outputs are those of the PREVIOUS poll's tick; keep
        polling until ``has_pending`` clears to drain."""
        if self.mode == "sync":
            return self.step() if self.has_work else []
        self._tick_start("poll")
        with spans.span("engine.poll", tick=self._tick_index) as sp:
            inflight = None
            events: List[RequestOutput] = []
            if self.has_work:
                plan = self._plan(sp)
                events.extend(self.sched.take_events())
                self._check_plan(plan)
                err = None
                try:
                    inflight = self._dispatch(plan)
                except Exception as e:
                    err = e
                err = self._agree(err)
                if err is not None:
                    events.extend(self._fail_tick(err,
                                                  self._plan_emits(plan)))
                    return events
            pending, self._pending = self._pending, None
            if pending is not None:
                err = None
                try:
                    read = self._collect(pending)
                except Exception as e:
                    err = e
                err = self._agree(err)
                if err is not None:
                    unsettled = list(self._settling)
                    if inflight is not None:  # the new tick dies with it
                        unsettled.extend(inflight.prefill_emit
                                         + inflight.decode_emit)
                    events.extend(self._fail_tick(err, unsettled))
                    return events
                events.extend(read)
            self._pending = (None if inflight is None or inflight.empty
                             else inflight)
        return events

    def stream(self, *requests: Request) -> Iterator[RequestOutput]:
        """Submit `requests` (if given) and drive the engine, yielding
        each generated token as a RequestOutput until the pool drains."""
        for r in requests:
            self.submit(r)
        while self.has_work or self.has_pending:
            yield from self.poll()

    def run(self) -> List[Request]:
        """Drain the engine; returns completed requests in finish order."""
        for _ in self.stream():
            pass
        return self.sched.done
