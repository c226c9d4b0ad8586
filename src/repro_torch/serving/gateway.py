"""Network serving gateway: asyncio HTTP/SSE frontend over ``ServeEngine``.

This is the layer that points live traffic at the paged serving core.  It
is stdlib asyncio (``asyncio.start_server`` + hand-rolled HTTP/1.1) over
the engine's public surface and ``engine.sched``; the reference package's
``serving/gateway.py`` with the same names, endpoints, JSON keys and
status mapping.

Architecture — one engine thread, many asyncio clients:

  * ``EngineRunner`` (a thread) owns ALL engine interaction.  It drains a
    thread-safe control queue (submissions, cancellations) at the top of
    every iteration and then calls ``engine.poll()`` — one overlapped
    (dispatch-ahead) engine tick.  New requests therefore join the running
    batch at the next tick: continuous-batching admission under live
    traffic, never a stop-the-world drain.  Grad mode is per thread and
    this thread does not inherit its creator's; the engine's
    ``_dispatch`` turns autograd off for every tick's device work.  On
    the card every launch and the tick's readback event are issued from
    this thread, on its current stream.

  * each HTTP handler coroutine builds a ``Request`` from the JSON body,
    installs an ``on_token`` callback that trampolines every
    ``RequestOutput`` onto the event loop (``loop.call_soon_threadsafe``),
    and streams them to the client as server-sent events.  A client
    disconnect mid-stream cancels the request — ``engine.cancel(rid)``
    runs on the engine thread and frees the request's pages immediately.

  * ``GatewayMetrics`` accumulates per-request TTFT (submit -> first
    token) and TPOT (inter-token) histograms on the engine thread, plus
    request/token/prefix-sharing counters.  ``GET /metrics`` surfaces
    them next to the engine's own counters (``readbacks``, ``blocked_s``,
    ``peak_pages``, ``preemptions``, pool residency).

Endpoints:

  * ``POST /v1/generate`` — body ``{"prompt": [ids], "max_new": N,
    "temperature": t, "top_k": k, "top_p": p, "stop": [ids],
    "priority": n, "deadline_ms": D, "queue_timeout_ms": Q}``; responds
    ``text/event-stream``, one ``data: {json}`` event per generated
    token (the final event carries ``"finished": true``, a
    ``finish_reason``, the full token list, and — for
    timeout/rejected/error finishes — the cause under ``"error"``).
  * ``GET /healthz`` — liveness + model/backend identity and the device
    (``cuda`` / ``cpu``) the engine runs on.
  * ``GET /metrics`` — JSON metrics snapshot.

Backpressure (admission control BEFORE the request crosses onto the
engine thread): a request that can never fit the engine gets HTTP 503;
a full bounded queue (``ServeEngine(max_queue=...)``) gets HTTP 429 with
a ``Retry-After`` header.  Requests the engine itself rejects finish
with ``finish_reason="rejected"`` and the reason string in the SSE
error field.

Crash containment covers host-side and injected faults (``step.error``
is raised before any launch; see ``engine._fail_tick``).  A real device
fault such as an illegal address poisons the CUDA context: no tick after
it can succeed, and the gateway does not claim to survive one.
"""

from __future__ import annotations

import asyncio
import bisect
import collections
import json
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.serving.request import (Request, RequestOutput, RequestState,
                                         SamplingParams)

__all__ = [
    "EngineRunner",
    "Gateway",
    "GatewayMetrics",
    "LatencyStats",
    "request_from_json",
    "serve_background",
]

log = logging.getLogger("repro_torch.serving.gateway")

_BUCKETS_MS = (
    1.0,
    2.0,
    5.0,
    10.0,
    20.0,
    50.0,
    100.0,
    200.0,
    500.0,
    1000.0,
    2000.0,
    5000.0,
    10000.0,
    30000.0,
)


class LatencyStats:
    """Streaming latency accumulator: log-spaced histogram buckets plus a
    bounded sample ring for percentile estimates (p50/p99 over the most
    recent ``cap`` observations)."""

    def __init__(self, cap: int = 8192):
        self.count = 0
        self.total_ms = 0.0
        self.buckets = [0] * (len(_BUCKETS_MS) + 1)
        self._cap = cap
        self._samples: List[float] = []

    def observe(self, ms: float) -> None:
        self.count += 1
        self.total_ms += ms
        self.buckets[bisect.bisect_left(_BUCKETS_MS, ms)] += 1
        if len(self._samples) < self._cap:
            self._samples.append(ms)
        else:
            self._samples[self.count % self._cap] = ms

    def percentile(self, q: float) -> float:
        if not self._samples:
            return 0.0
        s = sorted(self._samples)
        idx = min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1))))
        return s[idx]

    def snapshot(self) -> dict:
        hist = {}
        for le, n in zip(_BUCKETS_MS, self.buckets):
            hist[f"le_{le:g}"] = n
        hist["inf"] = self.buckets[-1]
        return {
            "count": self.count,
            "mean_ms": self.total_ms / max(self.count, 1),
            "p50_ms": self.percentile(50.0),
            "p99_ms": self.percentile(99.0),
            "buckets_ms": hist,
        }


class GatewayMetrics:
    """Request-level serving metrics, written from the engine thread."""

    def __init__(self):
        self._lock = threading.Lock()
        self.ttft = LatencyStats()
        self.tpot = LatencyStats()
        self.submitted = 0
        self.completed = 0
        self.cancelled = 0
        self.rejected = 0
        self.timed_out = 0
        self.errored = 0
        self.tokens_out = 0
        self.prompt_tokens = 0
        self.prefix_hit_tokens = 0
        # routed (rid, index) order — the continuous-batching interleave
        # record the gateway tests assert on; bounded for long-lived servers
        self.event_log = collections.deque(maxlen=4096)

    def record_submit(self) -> None:
        with self._lock:
            self.submitted += 1

    def record_rejected(self) -> None:
        """A request vetoed at the gateway (429/503): it never reached
        the engine thread, so no RequestOutput will account for it."""
        with self._lock:
            self.rejected += 1

    def record_output(self, req: Request, rec: dict, out: RequestOutput) -> None:
        now = time.perf_counter()
        with self._lock:
            if out.token is not None:
                self.tokens_out += 1
                self.event_log.append((out.rid, out.index))
                if rec["t_prev"] is None:
                    self.ttft.observe((now - rec["t_submit"]) * 1e3)
                else:
                    self.tpot.observe((now - rec["t_prev"]) * 1e3)
                rec["t_prev"] = now
            if out.finished:
                if out.finish_reason == "cancelled":
                    self.cancelled += 1
                elif out.finish_reason == "rejected":
                    self.rejected += 1
                elif out.finish_reason == "timeout":
                    self.timed_out += 1
                elif out.finish_reason == "error":
                    self.errored += 1
                else:
                    self.completed += 1
                self.prompt_tokens += len(req.prompt)
                self.prefix_hit_tokens += req.prefix_matched

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "requests": {
                    "submitted": self.submitted,
                    "completed": self.completed,
                    "cancelled": self.cancelled,
                    "rejected": self.rejected,
                    "timed_out": self.timed_out,
                    "errored": self.errored,
                    "tokens_out": self.tokens_out,
                    "prompt_tokens": self.prompt_tokens,
                    "prefix_hit_tokens": self.prefix_hit_tokens,
                    "prefix_hit_rate": (
                        self.prefix_hit_tokens / max(self.prompt_tokens, 1)
                    ),
                },
                "ttft_ms": self.ttft.snapshot(),
                "tpot_ms": self.tpot.snapshot(),
            }


class EngineRunner(threading.Thread):
    """The engine thread: the ONLY place ``ServeEngine`` is touched.

    Clients hand in fully-built ``Request``s through ``submit(req, sink)``
    — ``sink`` is called once per ``RequestOutput`` ON THIS THREAD (wrap
    with ``loop.call_soon_threadsafe`` to cross into asyncio) — and
    ``cancel(rid)``.  Both enqueue onto thread-safe deques the run loop
    drains before each ``engine.poll()``, so admission, preemption, COW
    prefix matching, and page accounting all stay single-threaded.
    """

    def __init__(self, engine, *, idle_wait_s: float = 0.02):
        super().__init__(name="engine-runner", daemon=True)
        self.engine = engine
        self.metrics = GatewayMetrics()
        self.idle_wait_s = idle_wait_s
        self._submit_q: collections.deque = collections.deque()
        self._cancel_q: collections.deque = collections.deque()
        self._wake = threading.Event()
        self._stopping = threading.Event()
        self._lock = threading.Lock()
        # start above any rids the engine already assigned (e.g. warmup
        # requests run before the runner thread took over)
        self._next_rid = engine.sched._next_rid
        self._live: set = set()

    # -- client-thread surface ------------------------------------------------
    def submit(self, req: Request, sink: Callable[[RequestOutput], None]) -> int:
        """Queue ``req`` for the engine; returns its rid immediately (the
        engine thread performs the actual admission).  ``sink`` receives
        every streamed output of the request, including the terminal one."""
        with self._lock:
            if req.rid is None:
                req.rid = self._next_rid
            self._next_rid = max(self._next_rid, req.rid + 1)
            self._live.add(req.rid)
        rec = {"t_submit": time.perf_counter(), "t_prev": None}
        metrics = self.metrics
        metrics.record_submit()

        def on_token(out: RequestOutput, _req=req, _rec=rec, _sink=sink) -> None:
            metrics.record_output(_req, _rec, out)
            if out.finished:
                with self._lock:
                    self._live.discard(out.rid)
            _sink(out)
            if out.finished:
                # the request outlives its stream in the engine's records:
                # unhook this closure (it holds the runner and, through the
                # sink, the event loop), so no reference cycle keeps the
                # engine alive after ``stop``
                _req.on_token = None

        req.on_token = on_token
        self._submit_q.append(req)
        self._wake.set()
        return req.rid

    def cancel(self, rid: int) -> None:
        self._cancel_q.append(rid)
        self._wake.set()

    def admission_veto(self, req: Request) -> Optional[Tuple[str, bool]]:
        """Admission control BEFORE ``req`` crosses onto the engine
        thread: ``None`` to admit, else ``(reason, retryable)`` —
        retryable means the bounded queue is full right now (HTTP 429 +
        Retry-After), non-retryable means the request can never be
        served by this engine (HTTP 503).  Reads scheduler state without
        locking: queue length is a monotonic-enough signal for
        backpressure, and the engine-thread submit path re-checks
        authoritatively."""
        sched = self.engine.sched
        reason = sched.never_fit(req)
        if reason is not None:
            return reason, False
        if sched.queue_full(extra=len(self._submit_q)):
            return (
                f"queue full ({len(sched.queue)} queued, "
                f"max_queue {sched.max_queue})",
                True,
            )
        return None

    def stop(self, timeout: float = 30.0) -> bool:
        """Stop the engine thread; returns False (and logs) if the join
        timed out — the thread is still running, NOT cleanly stopped."""
        self._stopping.set()
        self._wake.set()
        self.join(timeout)
        if self.is_alive():
            log.error(
                "engine thread failed to stop within %.1fs; "
                "it is still running (daemon thread, will not block exit)",
                timeout,
            )
            return False
        return True

    # -- engine-thread loop ---------------------------------------------------
    def _drain_control(self) -> None:
        cancels = []
        while self._cancel_q:
            cancels.append(self._cancel_q.popleft())
        pending = []
        while self._submit_q:
            pending.append(self._submit_q.popleft())
        cancelled = set(cancels)
        for req in pending:
            if req.rid in cancelled:
                # cancel raced ahead of the submit drain: never admit, but
                # still surface the terminal event through the sink
                cancelled.discard(req.rid)
                req.state = RequestState.CANCELLED
                req.finish_reason = "cancelled"
                out = RequestOutput(
                    rid=req.rid,
                    token=None,
                    index=0,
                    state=RequestState.CANCELLED,
                    finished=True,
                    finish_reason="cancelled",
                    tokens=(),
                )
                if req.on_token:
                    req.on_token(out)
                continue
            try:
                self.engine.submit(req)
            except ValueError as e:
                # rejected by admission control (RejectionError /
                # QueueFullError / invalid request): the gateway
                # pre-vetoes, this is the engine-thread authority —
                # surface the reason, keep serving
                req.state = RequestState.FINISHED
                req.finish_reason = "rejected"
                req.error = str(e)
                out = RequestOutput(
                    rid=req.rid,
                    token=None,
                    index=0,
                    state=RequestState.FINISHED,
                    finished=True,
                    finish_reason="rejected",
                    tokens=(),
                    error=str(e),
                )
                if req.on_token:
                    req.on_token(out)
        for rid in cancelled:
            self.engine.cancel(rid)  # terminal event routed via on_token

    def run(self) -> None:
        eng = self.engine
        while not self._stopping.is_set():
            self._drain_control()
            try:
                eng.poll()
            except Exception as e:
                # device-step failures are contained INSIDE poll()
                # (engine._fail_tick); anything reaching here is a
                # host-side planning bug.  Fail the requests it touched
                # and keep the thread alive — a serving gateway must not
                # die to one poisoned tick.
                log.exception(
                    "engine poll raised (host-side bug); failing active "
                    "requests and continuing"
                )
                try:
                    eng.sched.fail_active(f"{type(e).__name__}: {e}")
                except Exception:
                    log.exception("containment itself failed")
                self._wake.wait(self.idle_wait_s)
            if not (eng.has_work or eng.has_pending):
                if self._wake.wait(self.idle_wait_s):
                    self._wake.clear()
        with self._lock:
            live = list(self._live)
        for rid in live:
            eng.cancel(rid)


def request_from_json(spec: dict, *, max_len: Optional[int] = None) -> Request:
    """Build a validated ``Request`` from a ``POST /v1/generate`` body.

    Raises ``ValueError`` on malformed input (the gateway maps it to 400)
    so invalid requests never reach the engine thread.
    """
    if not isinstance(spec, dict):
        raise ValueError("request body must be a JSON object")
    prompt = spec.get("prompt")
    if (
        not isinstance(prompt, list)
        or not prompt
        or not all(isinstance(t, int) and not isinstance(t, bool) for t in prompt)
    ):
        raise ValueError("'prompt' must be a non-empty list of token ids")
    stop = spec.get("stop", ())
    if not isinstance(stop, (list, tuple)):
        raise ValueError("'stop' must be a list of token ids")
    deadline = spec.get("deadline_ms")
    queue_timeout = spec.get("queue_timeout_ms")
    sampling = SamplingParams(
        temperature=float(spec.get("temperature", 0.0)),
        top_k=int(spec.get("top_k", 0)),
        top_p=float(spec.get("top_p", 1.0)),
        stop=tuple(int(t) for t in stop),
        max_new=int(spec.get("max_new", 32)),
        deadline_ms=None if deadline is None else float(deadline),
        queue_timeout_ms=None if queue_timeout is None else float(queue_timeout),
    )
    if max_len is not None and len(prompt) + sampling.max_new > max_len:
        raise ValueError(
            f"prompt+max_new {len(prompt) + sampling.max_new} exceeds "
            f"engine max_len {max_len}"
        )
    return Request(
        prompt=list(prompt),
        sampling=sampling,
        priority=int(spec.get("priority", 0)),
    )


def _sse_event(out: RequestOutput) -> bytes:
    payload = {
        "rid": out.rid,
        "token": out.token,
        "index": out.index,
        "state": out.state.value,
        "finished": out.finished,
        "finish_reason": out.finish_reason,
    }
    if out.finished:
        payload["tokens"] = list(out.tokens)
        if out.error is not None:
            payload["error"] = out.error
    return b"data: " + json.dumps(payload).encode() + b"\n\n"


class Gateway:
    """The asyncio HTTP server; owns an ``EngineRunner``.

    ``await Gateway(engine).start()`` binds the socket (``port=0`` picks a
    free one — read it back from ``.port``) and starts the engine thread;
    ``await serve_forever()`` blocks; ``await aclose()`` shuts both down.
    """

    def __init__(
        self,
        engine,
        *,
        host: str = "127.0.0.1",
        port: int = 8000,
    ):
        self.engine = engine
        self.runner = EngineRunner(engine)
        self.host = host
        self.port = port
        # gateway-level fault points (client disconnect storms) read the
        # engine's plan: only engine ticks advance a plan's clock, so one
        # --faults flag arms the whole stack
        self.faults = engine.faults
        self._server: Optional[asyncio.AbstractServer] = None

    async def start(self) -> "Gateway":
        if not self.runner.is_alive():
            self.runner.start()
        self._server = await asyncio.start_server(self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        return self

    async def serve_forever(self) -> None:
        await self._server.serve_forever()

    async def aclose(self, timeout: float = 30.0) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            # the server's protocol factory holds ``self._handle``: drop
            # it, so no reference cycle keeps the gateway (and through
            # it the engine) alive once it is closed
            self._server = None
        if not self.runner.stop(timeout):
            raise RuntimeError(
                "engine thread did not stop cleanly (join timed out)"
            )

    # -- request handling -----------------------------------------------------
    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            try:
                head = await reader.readuntil(b"\r\n\r\n")
            except (asyncio.IncompleteReadError, asyncio.LimitOverrunError):
                return
            line, _, rest = head.partition(b"\r\n")
            parts = line.decode("latin-1").split()
            if len(parts) < 2:
                return
            method, path = parts[0].upper(), parts[1]
            headers: Dict[str, str] = {}
            for raw in rest.decode("latin-1").split("\r\n"):
                name, sep, value = raw.partition(":")
                if sep:
                    headers[name.strip().lower()] = value.strip()
            if method == "POST" and path == "/v1/generate":
                length = int(headers.get("content-length", "0"))
                body = await reader.readexactly(length) if length else b""
                await self._generate(reader, writer, body)
            elif method == "GET" and path == "/healthz":
                await _send_json(writer, 200, self._health())
            elif method == "GET" and path == "/metrics":
                await _send_json(writer, 200, self._metrics())
            else:
                await _send_json(writer, 404, {"error": f"no route {method} {path}"})
        except (ConnectionResetError, BrokenPipeError, asyncio.IncompleteReadError):
            pass
        finally:
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionResetError, BrokenPipeError):
                pass

    async def _generate(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter, body: bytes
    ) -> None:
        try:
            spec = json.loads(body.decode() or "null")
            req = request_from_json(spec, max_len=self.engine.max_len)
        except (ValueError, TypeError) as e:
            await _send_json(writer, 400, {"error": str(e)})
            return
        veto = self.runner.admission_veto(req)
        if veto is not None:
            reason, retryable = veto
            self.runner.metrics.record_rejected()
            if retryable:  # bounded queue full NOW: back off and retry
                await _send_json(
                    writer,
                    429,
                    {"error": reason, "finish_reason": "rejected", "retry_after_s": 1},
                    headers=(("Retry-After", "1"),),
                )
            else:  # can NEVER be served by this engine
                await _send_json(
                    writer, 503, {"error": reason, "finish_reason": "rejected"}
                )
            return
        loop = asyncio.get_running_loop()
        queue: asyncio.Queue = asyncio.Queue()

        def sink(out: RequestOutput) -> None:
            loop.call_soon_threadsafe(queue.put_nowait, out)

        rid = self.runner.submit(req, sink)
        writer.write(
            b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n"
        )
        # half-close watch: a client that goes away mid-stream hits EOF
        # here long before a write fails, so its pages free immediately
        gone = loop.create_task(_watch_disconnect(reader))
        try:
            while True:
                getter = loop.create_task(queue.get())
                done, _ = await asyncio.wait(
                    {getter, gone}, return_when=asyncio.FIRST_COMPLETED
                )
                if getter not in done:
                    getter.cancel()
                    self.runner.cancel(rid)
                    return
                out = getter.result()
                writer.write(_sse_event(out))
                await writer.drain()
                if out.finished:
                    return
                if self.faults.fires("gateway.disconnect"):
                    # chaos: simulate the client vanishing mid-stream —
                    # drop the connection and cancel server-side, exactly
                    # the disconnect path a real storm exercises
                    self.runner.cancel(rid)
                    return
        except (ConnectionResetError, BrokenPipeError):
            self.runner.cancel(rid)
        finally:
            gone.cancel()

    def _health(self) -> dict:
        cfg = self.engine.cfg
        layout = cfg.uniform_backend or ",".join(cfg.layer_backends)
        return {
            "status": "ok",
            "model": cfg.name,
            "backend": layout,
            "device": self.engine.device.type,
            "mode": self.engine.mode,
            "max_batch": self.engine.max_batch,
            "max_len": self.engine.max_len,
        }

    def _metrics(self) -> dict:
        eng = self.engine
        snap = self.runner.metrics.snapshot()
        snap["engine"] = {
            "ticks": eng.ticks,
            "readbacks": eng.readbacks,
            "blocked_s": eng.blocked_s,
            "peak_pages": eng.peak_pages,
            # per-device page-pool occupancy (ONE host page table; under
            # tensor parallelism each device holds all pages at 1/tp of
            # the head slice — serving/sharded.py)
            "tp": eng.tp,
            "page_pool": eng.kv.occupancy(eng.tp),
            "preemptions": eng.preemptions,
            # TTFT attribution: chunked-prefill activity next to the
            # spec/preemption counters (flat under a TTFT regression =>
            # decode/queueing problem, rising => prefill path)
            "prefill_tokens": eng.prefill_tokens,
            "prefill_ticks": eng.prefill_ticks,
            "spec_proposed": eng.spec_proposed,
            "spec_accepted": eng.spec_accepted,
            "spec_acceptance": eng.spec_acceptance,
            "free_pages": eng.kv.free_pages,
            "pool_pages": eng.kv.n_pages - 1,
            "queue_depth": len(eng.queue),
            "active": sum(r is not None for r in eng.active),
            # robustness counters: contained device-tick failures plus
            # the scheduler's admission/deadline enforcement tallies
            "tick_errors": eng.tick_errors,
            "timeouts": eng.sched.timeouts,
            "rejections": eng.sched.rejections,
        }
        return snap


async def _watch_disconnect(reader: asyncio.StreamReader) -> None:
    while True:
        try:
            data = await reader.read(1024)
        except (ConnectionResetError, BrokenPipeError, OSError):
            return
        if not data:
            return


async def _send_json(
    writer: asyncio.StreamWriter,
    status: int,
    obj: dict,
    headers: Tuple[Tuple[str, str], ...] = (),
) -> None:
    reason = {
        200: "OK",
        400: "Bad Request",
        404: "Not Found",
        429: "Too Many Requests",
        503: "Service Unavailable",
    }.get(status, "Error")
    body = json.dumps(obj, default=float).encode()
    extra = "".join(f"{name}: {value}\r\n" for name, value in headers)
    writer.write(
        f"HTTP/1.1 {status} {reason}\r\n"
        f"Content-Type: application/json\r\n"
        f"Content-Length: {len(body)}\r\n"
        f"{extra}"
        f"Connection: close\r\n\r\n".encode() + body
    )
    await writer.drain()


class _BackgroundGateway:
    """Handle to a gateway running on its own thread + event loop."""

    def __init__(self, box: dict, thread: threading.Thread):
        self._box = box
        self._thread = thread

    @property
    def gateway(self) -> Gateway:
        return self._box["gateway"]

    @property
    def runner(self) -> EngineRunner:
        return self.gateway.runner

    @property
    def port(self) -> int:
        return self.gateway.port

    @property
    def url(self) -> str:
        return f"http://{self.gateway.host}:{self.gateway.port}"

    def stop(self, timeout: float = 30.0) -> bool:
        """Stop the gateway thread and its engine thread; returns False
        (and logs) when either is still running after ``timeout`` instead
        of pretending a clean shutdown."""
        loop, stop = self._box["loop"], self._box["stop"]
        self._box["timeout"] = timeout
        loop.call_soon_threadsafe(stop.set)
        self._thread.join(timeout + 5.0)  # aclose joins the runner first
        if self._thread.is_alive():
            log.error(
                "gateway thread failed to stop within %.1fs; "
                "it is still running",
                timeout,
            )
            return False
        return "error" not in self._box and not self.runner.is_alive()


def serve_background(
    engine,
    *,
    host: str = "127.0.0.1",
    port: int = 0,
    timeout: float = 60.0,
) -> _BackgroundGateway:
    """Start a gateway on a daemon thread (its own asyncio loop); returns
    once the socket is bound.  Used by the tests and ``chip_smoke.py``."""
    started = threading.Event()
    box: dict = {}

    def _main() -> None:
        async def body() -> None:
            gw = Gateway(engine, host=host, port=port)
            await gw.start()
            box["gateway"] = gw
            box["loop"] = asyncio.get_running_loop()
            box["stop"] = asyncio.Event()
            started.set()
            await box["stop"].wait()
            try:
                await gw.aclose(box["timeout"])
            except RuntimeError as e:  # the runner outlived its join; logged
                box["error"] = e

        asyncio.run(body())

    thread = threading.Thread(target=_main, name="gateway", daemon=True)
    thread.start()
    if not started.wait(timeout):
        raise RuntimeError("gateway failed to start")
    return _BackgroundGateway(box, thread)
