"""Host-side serving scheduler: admission, preemption, finish detection,
and page planning — NO device work.

The serving core is split into three parts ("async /
overlapped engine loop"):

  * ``Scheduler`` (this module) — pure host state machine.  It owns the
    request queue, the slot table, the ``PagedKVCache`` allocator, and
    every per-slot numpy array the device step consumes.  One call to
    ``plan_tick()`` produces a ``TickPlan``: which requests admit (and
    which COW pages fork), the chunk of prompt each PREFILLING slot
    advances by this tick, and the decode batch (positions, page-table
    snapshot, sampling-parameter rows, per-request rng keys).  Planning
    NEVER reads a device value — everything it needs (positions, page
    counts, token budgets) is host-derivable, which is exactly what lets
    the engine dispatch tick ``t+1`` before reading tick ``t``.

  * the fused device step (``engine.py``) — consumes a ``TickPlan``,
    runs per-layer ``backend.paged_decode`` + cache write + vectorized
    keyed sampling inside ONE step function, and returns sampled token ids: the
    only per-tick readback.

  * the loop (``engine.py``) — sync (read every tick) or overlapped
    (dispatch-ahead: host visibility of token VALUES is deferred one
    tick; value-dependent events — stop tokens — are detected on
    ``ingest`` and at most one extra "zombie" tick runs for a stopped
    slot, writing only into pages that slot still owns).

Continuous chunked-prefill batching: a PREFILLING slot advances by
``prefill_slice`` tokens per tick (page-sized chunks) while DECODING
slots keep ticking — admission is no longer a stop-the-world batched
prefill.  ``prefill_slice=None`` prefills the whole suffix in the
admission tick (the classic regime).

Token attribution is positional, not slot-based: every dispatched sample
carries an ``Emit(slot, req, index)`` record, so tokens read back later
still reach the right request even if the slot was preempted, drained,
or reassigned in the meantime — and per-request ``(rid, index)`` rng
keys (``sampler.request_key``) make the sampled values independent of
tick scheduling entirely.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np

from repro_torch.serving import sampler as S
from repro_torch.serving.kv_cache import (NO_MATCH, TRASH_PAGE, PagedKVCache,
                                    pages_for)
from repro_torch.serving.request import Request, RequestOutput, RequestState
from repro_torch.utils import spans

__all__ = ["Admission", "Emit", "PrefillChunk", "DecodeTick", "TickPlan",
           "Scheduler", "RejectionError", "QueueFullError"]


class RejectionError(ValueError):
    """Admission control refused a request at submit: it can NEVER run
    (empty prompt, exceeds max_len, needs more pages than the pool has).
    A ValueError subclass so seed-era callers catching ValueError keep
    working."""


class QueueFullError(RejectionError):
    """Admission control refused a request because the bounded queue is
    at capacity — a RETRYABLE condition (the gateway maps it to HTTP 429
    + Retry-After, unlike never-fit rejections' 503)."""


class Admission(NamedTuple):
    """One scheduling decision: where a request lands and what it shares."""

    slot: int
    req: Request
    resume_from: int  # generated tokens carried across a preemption
    matched: int  # prefix tokens served from shared pages (0 = none)
    forks: Tuple[Tuple[int, int], ...]  # (src, dst) COW page copies


class Emit(NamedTuple):
    """Attribution of one dispatched sample: generated-token ``index`` of
    ``req``, computed in batch row ``slot`` at dispatch time."""

    slot: int
    req: Request
    index: int


class PrefillChunk(NamedTuple):
    """One tick's prefill work: each PREFILLING row advances by one chunk
    of its (suffix of) prompt; rows with ``lens == 0`` are inactive and
    write to the trash page."""

    tokens: np.ndarray  # (B, S) right-padded chunk batch
    lens: np.ndarray  # (B,) TOTAL valid tokens after this chunk (0 = idle)
    offsets: np.ndarray  # (B,) first position written this chunk
    scale_base: np.ndarray  # (B,) k_scale origin (prefix-sharing offset)
    table: np.ndarray  # (B, P) page-table snapshot, idle rows trashed
    sample_index: np.ndarray  # (B,) generated-token index sampled per row
    hot: bool  # any completing row samples with temperature > 0
    emit: Tuple[Emit, ...]  # completing rows: first-token attribution


class DecodeTick(NamedTuple):
    """One tick's decode work over every DECODING row.

    Multi-token ticks (speculative decoding, future Medusa-style heads):
    ``n_tok[i] > 1`` means row ``i`` dispatches ``n_tok[i]`` consecutive
    generated-token indices this tick — its ``emit`` records are
    slot-major consecutive — and ``pos[i]`` is the FIRST position
    written.  Plain decode is the ``n_tok == 1`` degenerate case.
    """

    pos: np.ndarray  # (B,) first position written this tick
    kv_len: np.ndarray  # (B,) pos+1 for live rows, 0 for inert rows
    base: np.ndarray  # (B,) prefix-sharing offset
    table: np.ndarray  # (B, P) page-table snapshot, inert rows trashed
    sample_index: np.ndarray  # (B,) FIRST generated-token index per row
    live: np.ndarray  # (B,) bool — rows decoding this tick
    fresh: np.ndarray  # (B,) bool — input token comes from THIS tick's
    #                     prefill sample (first decode after admission)
    hot: bool  # any live row samples with temperature > 0
    emit: Tuple[Emit, ...]
    n_tok: Optional[np.ndarray] = None  # (B,) tokens dispatched per row
    #                     (None <=> all-ones: the plain single-token tick)


class TickPlan(NamedTuple):
    """Everything the device step needs for one tick, host-computed."""

    forks: Tuple[Tuple[int, int], ...]  # COW copies, dispatched first
    prefill: Optional[PrefillChunk]
    decode: Optional[DecodeTick]
    keys: np.ndarray  # (B, 2) uint32 per-request raw rng key data
    temps: np.ndarray  # (B,) float32 per-slot sampling params
    top_ks: np.ndarray  # (B,) int32
    top_ps: np.ndarray  # (B,) float32


class Scheduler:
    """Admission policy + per-tick work planning, host-pure.

    Mutates allocator state (reservations, refcounts, fork page ids) and
    per-slot numpy arrays, but runs NO model computation and reads NO
    device values.  The engine feeds sampled tokens back through
    ``ingest`` (token values are the ONLY device-derived input), which
    appends them to their requests, detects stop/length finishes, and
    retires slots.
    """

    def __init__(self, kv: PagedKVCache, *, max_batch: int, max_len: int,
                 seed: int = 0, prefix_sharing: bool = True,
                 prefill_slice: Optional[int] = None,
                 prefill_bucket: int = 16, spec_k: int = 0,
                 max_queue: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.kv = kv
        self.max_batch, self.max_len = max_batch, max_len
        self.seed = seed
        self.prefix_sharing = prefix_sharing
        if prefill_slice is not None and prefill_slice < 1:
            raise ValueError(f"prefill_slice must be >= 1, got {prefill_slice}")
        if spec_k < 0:
            raise ValueError(f"spec_k must be >= 0, got {spec_k}")
        if max_queue is not None and max_queue < 0:
            raise ValueError(f"max_queue must be >= 0, got {max_queue}")
        self.prefill_slice = prefill_slice
        self.prefill_bucket = prefill_bucket
        self.spec_k = spec_k
        self.max_queue = max_queue  # bounded admission (None = unbounded)
        self._clock = clock  # injectable for deterministic deadline tests

        self.queue: List[Request] = []
        self.active: List[Optional[Request]] = [None] * max_batch
        self.done: List[Request] = []
        self.peak_pages = 0  # high-water mark of actively-owned pages
        self.preemptions = 0  # page-pressure evictions (gateway /metrics
        #                       and the traffic-SLO benchmark report this)
        self.spec_proposed = 0  # draft tokens proposed (spec_k > 0)
        self.spec_accepted = 0  # draft tokens the target verified
        self.timeouts = 0  # deadline/queue-timeout expiries (host-side)
        self.rejections = 0  # admission-control refusals (submit + reject)
        self.prefill_tokens = 0  # prompt tokens materialized via chunks
        self.prefill_positions = 0  # positions the prefill steps compute:
        #  max_batch x the chunk's padded length a tick, so
        #  prefill_tokens / prefill_positions is the live share of them
        self.prefill_ticks = 0  # ticks that carried a prefill chunk
        #  (gateway /metrics + serve_slo: TTFT attribution — a TTFT
        #   regression with flat chunk counters is a decode/queue problem,
        #   not a prefill-path one)
        # slots whose multi-token tick is dispatched but not yet resolved
        # (rollback may rewind their pos/dispatched/pages): excluded from
        # planning and drain until resolve_spec runs.  Keyed by slot,
        # valued by the Request identity so a preempt-then-reassign of
        # the slot never blocks (or rolls back) the new occupant.
        self._spec_unread: dict = {}

        b = max_batch
        self.pos = np.zeros(b, np.int32)  # next decode position per slot
        self.base = np.zeros(b, np.int32)  # prefix-sharing offset per slot
        self.progress = np.zeros(b, np.int32)  # prompt tokens materialized
        self.dispatched = np.zeros(b, np.int32)  # generated tokens dispatched
        self.max_toks = np.zeros(b, np.int32)  # generation budget per slot
        self.temps = np.zeros(b, np.float32)
        self.top_ks = np.zeros(b, np.int32)
        self.top_ps = np.ones(b, np.float32)
        self.keys = np.zeros((b, 2), np.uint32)

        self._next_rid = 0
        self._arrival = 0  # FIFO tiebreak within a priority class
        self._admissions = 0  # preemption tiebreak (evict newest first)
        self._inflight_total = 0  # dispatched samples not yet ingested
        self._pending_forks: List[Tuple[int, int]] = []  # COW copies due
        # drain-released requests (slot freed at plan time) whose final
        # token is still in flight: not queued, not active, but LIVE —
        # cancel() must still reach them
        self._retiring: List[Request] = []
        # terminal outputs produced DURING planning (timeouts, containment
        # failures): the engine drains these into its poll() return so
        # stream()/run() callers see them without an on_token callback
        self._events: List[RequestOutput] = []

    # ------------------------------------------------------------------
    # submission / cancellation
    # ------------------------------------------------------------------
    def never_fit(self, req: Request) -> Optional[str]:
        """Admission-control policy: reason this request can NEVER be
        served (no amount of waiting helps), or None if it could fit.
        Public so the gateway can veto before the request ever crosses
        onto the engine thread (-> HTTP 503)."""
        if not req.prompt:
            return "empty prompt"
        need = len(req.prompt) + req.sampling.max_new
        if need > self.max_len:
            return f"prompt+max_new {need} > max_len {self.max_len}"
        pages = pages_for(need, self.kv.page_size)
        if pages > self.kv.max_pages_per_seq:
            return (f"needs {pages} pages > max_pages_per_seq "
                    f"{self.kv.max_pages_per_seq}")
        if pages > self.kv.n_pages - 1:
            return f"needs {pages} pages; pool has {self.kv.n_pages - 1}"
        return None

    def queue_full(self, extra: int = 0) -> bool:
        """Bounded-admission check: would `extra` more submissions (e.g.
        a gateway's not-yet-drained backlog) overflow ``max_queue``?"""
        return (self.max_queue is not None
                and len(self.queue) + extra >= self.max_queue)

    def submit(self, req: Request) -> int:
        """Queue a request; returns its rid (auto-assigned when None).

        Raises :class:`RejectionError` for never-fit requests and
        :class:`QueueFullError` when the bounded queue is at capacity
        (both ValueError subclasses); the request is left untouched.
        """
        if getattr(req, "_inflight", 0):
            raise ValueError(
                f"request {req.rid} still has in-flight dispatched work")
        if req.rid is None:
            req.rid = self._next_rid
        self._next_rid = max(self._next_rid, req.rid + 1)
        reason = self.never_fit(req)
        if reason is not None:
            self.rejections += 1
            raise RejectionError(f"request {req.rid}: {reason}")
        if self.queue_full():
            self.rejections += 1
            raise QueueFullError(
                f"request {req.rid}: queue full "
                f"({len(self.queue)} >= max_queue {self.max_queue})")
        req.state = RequestState.QUEUED
        req.tokens = []
        req.finish_reason = None
        req.error = None
        req._seq = self._arrival  # FIFO order, kept across preemption
        req._inflight = 0
        req._t_submit = self._clock()  # deadline_ms / queue_timeout_ms base
        req._admitted_once = False
        self._arrival += 1
        self.queue.append(req)
        spans.stamp(req.rid, "submit")
        return req.rid

    def cancel(self, rid: int) -> Optional[RequestOutput]:
        """Terminate a queued or running request NOW; running requests
        free their pages immediately (in-flight dispatched samples for it
        are discarded at ingest).  Returns the final output record, or
        None if rid is not live."""
        for qi, r in enumerate(self.queue):
            if r.rid == rid:
                self.queue.pop(qi)
                return self._finish_now(r, "cancelled")
        for slot, r in enumerate(self.active):
            if r is not None and r.rid == rid:
                self.kv.release(slot)
                self.active[slot] = None
                return self._finish_now(r, "cancelled")
        for r in self._retiring:  # slot drained, final token in flight
            if r.rid == rid:
                self._retiring.remove(r)
                return self._finish_now(r, "cancelled")
        return None

    def reject(self, rid: int, reason: str) -> Optional[RequestOutput]:
        """Admission-control eviction seam: terminally reject a QUEUED
        request with ``finish_reason="rejected"`` and the human-readable
        `reason` in ``error``.  The public replacement for reaching into
        the queue's private ordering: load-shedding policies (gateway
        overload, operator action) name the rid and the scheduler does
        the bookkeeping.  Returns None if rid is not queued (running
        requests are past admission — use ``cancel``)."""
        for qi, r in enumerate(self.queue):
            if r.rid == rid:
                self.queue.pop(qi)
                self.rejections += 1
                return self._finish_now(r, "rejected", error=reason)
        return None

    def _finish_now(self, req: Request, reason: str,
                    error: Optional[str] = None) -> RequestOutput:
        req.state = (RequestState.CANCELLED if reason == "cancelled"
                     else RequestState.FINISHED)
        req.finish_reason = reason
        req.error = error
        self.done.append(req)
        out = RequestOutput(
            rid=req.rid, token=None, index=len(req.tokens), state=req.state,
            finished=True, finish_reason=reason, tokens=tuple(req.tokens),
            error=error)
        if req.on_token:
            req.on_token(out)
        return out

    def take_events(self) -> List[RequestOutput]:
        """Drain terminal outputs produced during planning (timeouts,
        crash containment) for the engine's poll() return."""
        events, self._events = self._events, []
        return events

    # ------------------------------------------------------------------
    # admission policy
    # ------------------------------------------------------------------
    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.active)

    @property
    def has_prefilling(self) -> bool:
        return any(r is not None and r.state is RequestState.PREFILLING
                   for r in self.active)

    def _max_tokens_of(self, req: Request) -> int:
        return min(req.sampling.max_new, self.max_len - len(req.prompt))

    def _next_queued_index(self) -> int:
        return min(range(len(self.queue)),
                   key=lambda i: (-self.queue[i].priority,
                                  self.queue[i]._seq))

    def _pick_victim(self, priority: int) -> Optional[int]:
        """Lowest-priority DECODING slot strictly below `priority`; among
        equals, the most recently admitted (least prefill to redo)."""
        best = None
        for slot, r in enumerate(self.active):
            # only DECODING slots are evictable: preempting a PREFILLING
            # slot would discard partially-materialized chunks for no gain
            if (r is None or r.state is not RequestState.DECODING
                    or r.priority >= priority):
                continue
            key = (r.priority, -r._admit_seq)
            if best is None or key < best[0]:
                best = (key, slot)
        return None if best is None else best[1]

    def _preempt(self, slot: int) -> None:
        req = self.active[slot]
        self.kv.release(slot)  # sharers keep refcounted pages alive
        self.active[slot] = None
        req.state = RequestState.QUEUED  # tokens kept: resume re-prefills
        self.queue.append(req)  # _seq unchanged: keeps its FIFO standing
        self.preemptions += 1

    def admit(self) -> List[Admission]:
        """Fill free slots from the queue, matching shared prefixes and
        preempting lower-priority decoders under page pressure.  Mutates
        allocator state but runs NO model computation — the tick's
        prefill chunks consume the resulting PREFILLING slots."""
        admitted: List[Admission] = []
        while self.queue:
            qi = self._next_queued_index()
            req = self.queue[qi]
            if req._inflight:
                # a preempted request's last dispatched token has not been
                # ingested yet (overlapped loop): re-admitting now would
                # both replay it via re-prefill AND append it at ingest
                break
            effective = req.prompt + req.tokens  # resume covers generated
            need = len(req.prompt) + req.sampling.max_new
            match = (self.kv.match_prefix(effective)
                     if self.prefix_sharing else NO_MATCH)
            if match.defer:
                break  # prefix pages materialize soon; retry next tick
            slot = next(
                (i for i, r in enumerate(self.active) if r is None), None)
            if slot is None or not self.kv.can_reserve(
                    need, slot, n_shared=len(match.shared), match=match):
                victim = self._pick_victim(req.priority)
                if victim is None:
                    break  # page pressure: wait for retirements
                self._preempt(victim)
                continue  # re-match: the release may have dropped pages
            self.queue.pop(qi)
            forks = self.kv.reserve_shared(slot, match, need)
            if self.prefix_sharing:
                self.kv.register_prefix(slot, effective)
            req.state = RequestState.PREFILLING
            req.prefix_matched = match.matched
            req._admitted_once = True  # queue_timeout_ms no longer applies
            req._admit_seq = self._admissions
            self._admissions += 1
            self.active[slot] = req  # slot is taken from this point on
            self.base[slot] = match.matched
            self.progress[slot] = match.matched
            self.dispatched[slot] = len(req.tokens)
            self.max_toks[slot] = self._max_tokens_of(req)
            sp = req.sampling
            self.temps[slot] = sp.temperature
            self.top_ks[slot] = sp.top_k
            self.top_ps[slot] = sp.top_p
            self.keys[slot] = S.request_key(self.seed, req.rid)
            self._pending_forks.extend(forks)  # drained by plan_tick
            spans.stamp(req.rid, "admit")
            admitted.append(Admission(
                slot, req, len(req.tokens), match.matched, tuple(forks)))
        # never-fit requests are rejected at submit() now, so a queue that
        # cannot admit here is only ever WAITING (page pressure, deferred
        # prefix, in-flight preempted sample) — no MemoryError escape hatch
        self.peak_pages = max(self.peak_pages, self.kv.used_pages)
        return admitted

    # legacy spelling (the seed-era engine API)
    schedule = admit

    # ------------------------------------------------------------------
    # per-tick work planning
    # ------------------------------------------------------------------
    def _drain_dispatched(self) -> None:
        """Release slots whose requests have dispatched their full token
        budget (a length finish is host-plannable): the pages free for
        this tick's admissions even though the final token value has not
        been read yet.  Ingest finishes the request when it arrives."""
        for slot, r in enumerate(self.active):
            if (r is not None and r.state is RequestState.DECODING
                    and self.dispatched[slot] >= self.max_toks[slot]
                    and self._spec_unread.get(slot) is not r):
                # a spec-unread slot may roll dispatched back below the
                # budget at resolve time — never drain it early
                self.kv.release(slot)
                self.active[slot] = None
                self._retiring.append(r)

    def _plan_prefill(self) -> Optional[PrefillChunk]:
        slots = [i for i, r in enumerate(self.active)
                 if r is not None and r.state is RequestState.PREFILLING]
        if not slots:
            return None
        b = self.max_batch
        chunks = {}
        for i in slots:
            r = self.active[i]
            eff = r.prompt + r.tokens
            remaining = len(eff) - int(self.progress[i])
            take = (remaining if self.prefill_slice is None
                    else min(remaining, self.prefill_slice))
            chunks[i] = eff[self.progress[i]:self.progress[i] + take]
        if self.prefill_slice is None:
            maxs = max(len(c) for c in chunks.values())
            s = min(-(-maxs // self.prefill_bucket) * self.prefill_bucket,
                    self.max_len)
        else:
            s = min(self.prefill_slice, self.max_len)
        tokens = np.zeros((b, s), np.int32)
        lens = np.zeros(b, np.int32)
        offsets = np.zeros(b, np.int32)
        scale_base = np.zeros(b, np.int32)
        sample_index = np.zeros(b, np.int32)
        emit: List[Emit] = []
        hot = False
        for i in slots:
            r = self.active[i]
            chunk = chunks[i]
            tokens[i, :len(chunk)] = chunk
            offsets[i] = self.progress[i]
            scale_base[i] = self.base[i]
            lens[i] = self.progress[i] + len(chunk)
            self.progress[i] += len(chunk)
            if self.progress[i] == len(r.prompt) + len(r.tokens):
                # last chunk: this row samples its first generated token
                r.state = RequestState.DECODING
                self.pos[i] = self.progress[i]
                sample_index[i] = self.dispatched[i]
                emit.append(Emit(i, r, int(self.dispatched[i])))
                r._inflight += 1
                self._inflight_total += 1
                self.dispatched[i] += 1
                hot = hot or self.temps[i] > 0
                self.kv.commit_pages(self.kv.owned(i))
        self.prefill_tokens += sum(len(c) for c in chunks.values())
        self.prefill_positions += b * s
        self.prefill_ticks += 1
        table = np.where(lens[:, None] > 0, self.kv.table, TRASH_PAGE)
        return PrefillChunk(tokens, lens, offsets, scale_base, table,
                            sample_index, bool(hot), tuple(emit))

    def _plan_decode(self, fresh_slots: Tuple[int, ...]) -> Optional[DecodeTick]:
        live = [i for i, r in enumerate(self.active)
                if (r is not None and r.state is RequestState.DECODING
                    and self.dispatched[i] < self.max_toks[i]
                    and self._spec_unread.get(i) is not r)]
        if not live:
            return None
        b = self.max_batch
        live_mask = np.zeros(b, bool)
        live_mask[live] = True
        fresh = np.zeros(b, bool)
        fresh[[i for i in fresh_slots if live_mask[i]]] = True
        pos = self.pos.copy()
        kv_len = np.where(live_mask, self.pos + 1, 0).astype(np.int32)
        table = np.where(live_mask[:, None], self.kv.table, TRASH_PAGE)
        sample_index = self.dispatched.copy()
        n_tok = np.where(live_mask, 1, 0).astype(np.int32)
        emit = []
        hot = False
        for i in live:
            r = self.active[i]
            # multi-token tick: dispatch up to spec_k drafts + 1 sample,
            # capped at the slot's remaining generation budget; the
            # resolve step rolls back whatever the target rejects
            m = (1 if self.spec_k == 0 else
                 min(self.spec_k + 1,
                     int(self.max_toks[i] - self.dispatched[i])))
            n_tok[i] = m
            for j in range(m):
                emit.append(Emit(i, r, int(self.dispatched[i]) + j))
            r._inflight += m
            self._inflight_total += m
            self.dispatched[i] += m
            self.pos[i] += m
            if self.spec_k > 0:
                self._spec_unread[i] = r
            hot = hot or self.temps[i] > 0
        return DecodeTick(pos, kv_len, self.base.copy(), table, sample_index,
                          live_mask, fresh, bool(hot), tuple(emit),
                          n_tok if self.spec_k else None)

    def _expire(self) -> None:
        """Enforce per-request deadlines host-side (start of every
        plan_tick): queued requests past ``queue_timeout_ms`` (first
        admission only) or ``deadline_ms``, and running requests past
        ``deadline_ms``, finish NOW with ``finish_reason="timeout"``.
        No device work is interrupted — an expired running slot releases
        its pages and any still-in-flight sample for it is discarded at
        ingest, exactly like cancellation."""
        now = self._clock()
        for r in list(self.queue):
            sp = r.sampling
            if sp.deadline_ms is None and sp.queue_timeout_ms is None:
                continue
            waited_ms = (now - r._t_submit) * 1e3
            qto = None if r._admitted_once else sp.queue_timeout_ms
            bounds = [b for b in (qto, sp.deadline_ms) if b is not None]
            bound = min(bounds) if bounds else None
            if bound is not None and waited_ms > bound:
                self.queue.remove(r)
                self.timeouts += 1
                self._events.append(self._finish_now(
                    r, "timeout",
                    error=f"expired after {waited_ms:.0f}ms in queue "
                          f"(bound {bound:g}ms)"))
        for slot, r in enumerate(self.active):
            if r is None or r.sampling.deadline_ms is None:
                continue
            age_ms = (now - r._t_submit) * 1e3
            if age_ms > r.sampling.deadline_ms:
                self.kv.release(slot)
                self.active[slot] = None
                self.timeouts += 1
                self._events.append(self._finish_now(
                    r, "timeout",
                    error=f"deadline_ms {r.sampling.deadline_ms:g} "
                          f"exceeded ({age_ms:.0f}ms)"))

    def fail_active(self, error: str) -> List[RequestOutput]:
        """Crash containment: a device tick died before its samples could
        be read, so every ACTIVE and RETIRING request — whose in-flight
        work and (for actives) cache writes are lost — finishes with
        ``finish_reason="error"``.  Suspect exclusively-owned pages are
        invalidated (registry claims dropped; they free rather than
        retain) before release.  QUEUED requests survive untouched: a
        preempted request's lost sample regenerates bit-identically on
        resume (keyed sampling).  The ENGINE settles the in-flight
        accounting by ``drop``-ing the failed tick's emits; this method
        only retires state.  Pending COW forks and unread speculative
        ticks die with the tick that would have consumed them."""
        events: List[RequestOutput] = []
        for slot, r in enumerate(self.active):
            if r is None:
                continue
            self.kv.invalidate(slot)
            self.kv.release(slot)
            self.active[slot] = None
            events.append(self._finish_now(r, "error", error=error))
        for r in list(self._retiring):
            self._retiring.remove(r)
            events.append(self._finish_now(r, "error", error=error))
        self._spec_unread.clear()
        self._pending_forks = []
        return events

    def plan_tick(self, *, admit: bool = True,
                  decode: bool = True) -> TickPlan:
        """Plan one engine tick: admissions + one prefill chunk per
        PREFILLING slot + one decode step per DECODING slot.  Host-pure;
        the engine dispatches the plan and (eventually) feeds the sampled
        tokens back through ``ingest``."""
        self._expire()
        self._drain_dispatched()
        if admit:
            self.admit()
        # forks accumulate on admission (whether via plan_tick or a
        # direct schedule() call) and dispatch ONCE, before any write
        forks, self._pending_forks = self._pending_forks, []
        prefill = self._plan_prefill()
        dec = (self._plan_decode(tuple(e.slot for e in prefill.emit)
                                 if prefill else ())
               if decode else None)
        return TickPlan(tuple(forks), prefill, dec, self.keys.copy(),
                        self.temps.copy(), self.top_ks.copy(),
                        self.top_ps.copy())

    # ------------------------------------------------------------------
    # host visibility (the only device-derived input)
    # ------------------------------------------------------------------
    def ingest(self, emit: Emit, token: int) -> Optional[RequestOutput]:
        """Record one sampled token read back from the device.  Appends
        it to its request, detects stop/length finishes, retires the slot
        (unless it was already drain-released or preempted), and emits
        the streamed output.  Returns None for discarded samples: the
        request was cancelled, or already finished on an earlier stop
        token (the overlapped loop's zombie tick)."""
        slot, req, idx = emit
        req._inflight -= 1
        self._inflight_total -= 1
        if req.state.is_terminal or idx != len(req.tokens):
            return None  # cancelled / stopped earlier: drop the sample
        req.tokens.append(token)
        if idx == 0:
            spans.stamp(req.rid, "first_token")
        reason = None
        if token in req.sampling.stop:
            reason = "stop"
        elif len(req.tokens) >= self._max_tokens_of(req):
            reason = "length"
        if reason is not None:
            req.state = RequestState.FINISHED
            req.finish_reason = reason
            if self.active[slot] is req:  # not drained / reassigned
                self.kv.release(slot)
                self.active[slot] = None
            elif req in self.queue:  # preempted, finished by its last token
                self.queue.remove(req)
            elif req in self._retiring:  # drain-released at plan time
                self._retiring.remove(req)
            self.done.append(req)
        out = RequestOutput(
            rid=req.rid, token=token, index=len(req.tokens),
            state=req.state, finished=reason is not None,
            finish_reason=reason, tokens=tuple(req.tokens))
        if req.on_token:
            req.on_token(out)
        return out

    def drop(self, emit: Emit) -> None:
        """Discard a dispatched sample without surfacing it (a rejected
        speculative suffix position): balances the in-flight accounting
        that ``ingest`` would otherwise settle."""
        emit.req._inflight -= 1
        self._inflight_total -= 1

    @property
    def spec_acceptance(self) -> float:
        """Fraction of proposed draft tokens the target accepted."""
        return self.spec_accepted / max(self.spec_proposed, 1)

    def resolve_spec(self, slot: int, emits: Tuple[Emit, ...],
                     tokens, n_valid: int) -> List[RequestOutput]:
        """Settle one slot's multi-token tick: ingest the accepted prefix
        (``tokens[:n_valid]`` at the first ``n_valid`` emits), drop the
        rejected suffix, and roll the slot's host state AND paged cache
        back to the last valid position (``truncate_to`` + re-grow to the
        admission reservation; the boundary-fork copies it may produce
        join the next tick's COW dispatch).  A slot that was preempted,
        cancelled, or finished (stop token inside the valid run) in the
        meantime only settles attribution — its pages are no longer ours
        to rewind.  Rollback re-growth that loses the page-pressure race
        preempts the request (it resumes via re-prefill, token-exact)."""
        req = emits[0].req
        n_tok = len(emits)
        if self._spec_unread.get(slot) is req:
            del self._spec_unread[slot]
        if n_tok > 1:
            self.spec_proposed += n_tok - 1
            self.spec_accepted += n_valid - 1
        events: List[RequestOutput] = []
        for j, e in enumerate(emits):
            if j < n_valid:
                out = self.ingest(e, int(tokens[j]))
                if out is not None:
                    events.append(out)
            else:
                self.drop(e)
        excess = n_tok - n_valid
        if excess > 0 and self.active[slot] is req:
            self.dispatched[slot] -= excess
            self.pos[slot] -= excess
            try:
                forks = self.kv.truncate_to(slot, int(self.pos[slot]))
                self.kv.reserve(
                    slot, len(req.prompt) + req.sampling.max_new)
                self._pending_forks.extend(forks)
            except MemoryError:
                self._preempt(slot)
        return events
