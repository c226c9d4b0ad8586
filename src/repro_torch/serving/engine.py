"""Serving engine: host-plan / device-step split with dispatch-ahead
decode and continuous chunked-prefill batching.

The engine mirrors the reference package's ``serving/engine.py``:

  1. ``Scheduler`` (serving/scheduler.py) — host-pure admission,
     preemption, finish detection and page planning; ``plan_tick()``
     emits a ``TickPlan``.
  2. the device step — one plain PyTorch function per tick
     (``_prefill_step`` / ``_decode_step``): the model forward through
     every layer's ``backend.paged_decode`` (paged CUDA kernels on the
     card), the in-place pool writes, and greedy sampling.  The sampled
     ids, one (B,) int32 tensor, are the only per-tick readback; the
     decode step's input tokens come from the on-device token buffer of
     the previous tick.
  3. the loop — ``mode="sync"`` reads each tick's tokens right away;
     ``mode="overlap"`` enqueues tick t+1 on the current stream before
     it waits for tick t's ids.  Each step queues the device-to-host copy
     of its ids (into pinned memory) behind its own kernels and records
     an event, so reading tick t waits for tick t only.  Host visibility
     of token values is deferred one tick; everything value-independent
     is planned as in sync mode, so both modes give the same tokens.

Only greedy decoding is ported: a request with ``temperature > 0`` is
refused at ``submit`` (the keyed sampler is later work), and
``spec_k > 0`` / ``tp > 1`` are refused by the constructor.

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
from repro_torch.models.transformer import (dtype_of, init_pools,
                                            lm_decode_paged, lm_page_specs,
                                            lm_prefill_paged)
from repro_torch.serving import sampler as S
from repro_torch.serving.faults import NO_FAULTS, FaultPlan
from repro_torch.serving.kv_cache import PagedKVCache, pages_for
from repro_torch.serving.request import (Request, RequestOutput, RequestState,
                                         SamplingParams)
from repro_torch.serving.scheduler import Admission, Emit, Scheduler, TickPlan

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
    decode_tok: Optional[_Readback]  # (B,) sampled decode tokens
    decode_emit: Tuple[Emit, ...]

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
                 spec_k: Optional[int] = None, tp: int = 1,
                 max_queue: Optional[int] = None,
                 faults: Optional[FaultPlan] = None, device="cuda"):
        if spec_k:
            raise NotImplementedError(
                "speculative decoding (spec_k > 0) is not ported")
        if tp != 1:
            raise NotImplementedError("tensor parallelism (tp > 1) is not "
                                      "ported")
        if paged_impl is not None:
            cfg = cfg.replace(paged_impl=paged_impl)
        if prefill_impl is not None:
            cfg = cfg.replace(prefill_impl=prefill_impl)
        if cfg.spec_k:
            raise NotImplementedError(
                "speculative decoding (cfg.spec_k > 0) is not ported")
        if mode not in ("sync", "overlap"):
            raise ValueError(f"mode must be 'sync' or 'overlap', got {mode!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
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
        self.sched = Scheduler(
            self.kv, max_batch=max_batch, max_len=max_len, seed=seed,
            prefix_sharing=prefix_sharing, prefill_slice=prefill_slice,
            prefill_bucket=chunk or PREFILL_BUCKET, max_queue=max_queue)
        self.caches = init_pools(
            lm_page_specs(cfg, n_pages, page_size, max_batch), self.device)
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

    # ------------------------------------------------------------------
    # scheduler delegation
    # ------------------------------------------------------------------
    def submit(self, req: Request) -> int:
        if req.sampling.temperature > 0:
            raise NotImplementedError(
                "temperature > 0 needs the keyed sampler, which is not "
                "ported; only greedy requests are served")
        return self.sched.submit(req)

    def cancel(self, rid: int) -> Optional[RequestOutput]:
        return self.sched.cancel(rid)

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
    def prefill_ticks(self) -> int:
        return self.sched.prefill_ticks

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

    def _prefill_step(self, tokens, lens, offsets, scale_base, pt):
        batch = {"tokens": tokens, "lens": lens, "offsets": offsets,
                 "scale_base": scale_base}
        logits, self.caches = lm_prefill_paged(self.params, batch,
                                               self.caches, pt, self.cfg)
        return S.greedy(logits)

    def _decode_step(self, tok_prev, fresh, fresh_mask, live_mask, pos,
                     kv_len, pt, base):
        # merge the token state on the device: rows that finished prefill
        # THIS tick take their fresh first token, continuing rows the
        # previous step's output, inert rows 0
        tokens = torch.where(live_mask,
                             torch.where(fresh_mask, fresh, tok_prev),
                             torch.zeros_like(tok_prev))
        logits, self.caches = lm_decode_paged(
            self.params, tokens, pos, kv_len, self.caches, pt, self.cfg,
            base=base)
        return S.greedy(logits)

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
        """Enqueue one tick's device work; returns unread token handles."""
        self.faults.raise_if("step.error")  # chaos: the step dies
        for src, dst in plan.forks:  # COW copies BEFORE any write
            self.caches = _copy_pool_page(self.caches, int(src), int(dst))
        prefill_tok = None
        fresh = self._zero_tok
        pf = plan.prefill
        if pf is not None:
            if pf.hot:
                raise NotImplementedError("temperature > 0 is not ported")
            first = self._prefill_step(
                self._h2d(pf.tokens), self._h2d(pf.lens),
                self._h2d(pf.offsets), self._h2d(pf.scale_base),
                self._h2d(pf.table))
            if pf.emit:
                fresh = first
                prefill_tok = self._start_readback(first)
        dc = plan.decode
        decode_tok = None
        if dc is not None:
            if dc.hot:
                raise NotImplementedError("temperature > 0 is not ported")
            nxt = self._decode_step(
                self._tok_buf, fresh, self._h2d(dc.fresh),
                self._h2d(dc.live), self._h2d(dc.pos), self._h2d(dc.kv_len),
                self._h2d(dc.table), self._h2d(dc.base))
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
                         decode_tok, dc.emit if dc else ())

    def _read(self, rb: _Readback) -> np.ndarray:
        """THE host<->device readback (token ids only); instrumented so
        benchmarks report the host-idle fraction and tests can assert one
        readback per tick."""
        t0 = time.perf_counter()
        if rb.event is not None:
            rb.event.synchronize()
            out = rb.host.numpy().copy()
        else:
            out = rb.device.cpu().numpy().copy()
        self.blocked_s += time.perf_counter() - t0
        self.readbacks += 1
        return out

    def _collect(self, inflight: _InFlight) -> List[RequestOutput]:
        """Read a dispatched tick's sampled ids and surface them (first
        prefill samples, then decode samples)."""
        events: List[RequestOutput] = []
        self._settling = list(inflight.prefill_emit + inflight.decode_emit)
        for tok, emits in ((inflight.prefill_tok, inflight.prefill_emit),
                           (inflight.decode_tok, inflight.decode_emit)):
            if not emits:
                continue
            vals = self._read(tok)
            for e in emits:
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
        try:
            inflight = self._dispatch(plan)
        except Exception as e:
            return self._fail_tick(e, self._plan_emits(plan))
        try:
            return self._collect(inflight)
        except Exception as e:
            return self._fail_tick(e, list(self._settling))

    # ------------------------------------------------------------------
    # the engine loops
    # ------------------------------------------------------------------
    def step(self) -> List[RequestOutput]:
        """One SYNCHRONOUS engine tick: plan, dispatch, read."""
        self.faults.advance()
        self._fault_delay()
        plan = self.sched.plan_tick()
        events = self.sched.take_events()
        events.extend(self._run_plan(plan))
        return events

    def _fault_delay(self) -> None:
        d = self.faults.delay("tick.delay")
        if d > 0:
            time.sleep(d)

    def poll(self) -> List[RequestOutput]:
        """ONE engine iteration honoring ``mode``.  In overlap mode the
        returned outputs are those of the PREVIOUS poll's tick; keep
        polling until ``has_pending`` clears to drain."""
        if self.mode == "sync":
            return self.step() if self.has_work else []
        self.faults.advance()
        self._fault_delay()
        inflight = None
        events: List[RequestOutput] = []
        if self.has_work:
            plan = self.sched.plan_tick()
            events.extend(self.sched.take_events())
            try:
                inflight = self._dispatch(plan)
            except Exception as e:
                events.extend(self._fail_tick(e, self._plan_emits(plan)))
                return events
        pending, self._pending = self._pending, None
        if pending is not None:
            try:
                events.extend(self._collect(pending))
            except Exception as e:
                unsettled = list(self._settling)
                if inflight is not None:  # the new tick dies with the device
                    unsettled.extend(inflight.prefill_emit
                                     + inflight.decode_emit)
                events.extend(self._fail_tick(e, unsettled))
                return events
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
