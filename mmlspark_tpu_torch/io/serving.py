"""Serving: turn a pipeline into a web service (Spark Serving equivalent).

The port's copy of ``mmlspark_tpu/io/serving.py``: the same servers,
routes, exchange protocol and reply bodies, so a client cannot tell the
two apart.  mmlspark parks each HTTP request's open socket keyed by request-id,
emits (id, request) rows into a streaming micro-batch, runs the user's
pipeline, and routes replies back via HTTPSink.

This module keeps that exact architecture, minus Spark streaming: an
:class:`HTTPServer` accepts requests into a queue; the driver loop pulls
micro-batches with :func:`HTTPServer.get_batch`, converts them to a table
(:func:`request_table`), runs any pipeline/model, and answers with
:func:`reply_from_table` — replies route to the still-open sockets by id.
``serve_forever`` wires the loop up for the one-liner case.  Batching is
what the card needs: requests accumulate into one batch a device walk
instead of one walk a request.  The multiprocess server's workers only
park sockets and forward over the transport: they never touch CUDA.
"""

from __future__ import annotations


import json
import logging
import queue
import threading
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from ..core.profiling import StageStats
from ..core.schema import DataTable
from ..core.telemetry import (current_fit_span, get_journal,
                              get_registry, merge_snapshots,
                              mirror_journal_from_env, record_flight,
                              render_prometheus)
from . import wire
from .transport import (CH_CONTROL, CH_METRICS, CH_SCORING, CH_STATS,
                        parse_address)

log = logging.getLogger(__name__)


# numpy → JSON-able, for the negotiated JSON fallback reply path (a
# binary-mode engine hands numpy values through; a session without the
# binary capability still gets correct JSON).  One shared definition —
# the engine's transform path uses the same conversion.
from .scoring import _json_value as _jsonable  # noqa: E402


class _QuietThreadingHTTPServer(ThreadingHTTPServer):
    """Serving-wide HTTP server invariants, in ONE place for both the
    in-process and worker-process paths:

    * accept backlog 128 — the default (5) overflows under concurrent-
      client bursts; the kernel drops SYNs and clients stall on 1s/3s
      retransmit timers, a serving p99 disaster;
    * quiet ``handle_error`` — a client that resets or abandons its
      connection is business as usual for a public-facing server (the
      chaos drill injects exactly these); log at debug instead of
      spraying tracebacks to stderr.  Anything else still gets a full
      traceback.
    """

    request_queue_size = 128

    def handle_error(self, request, client_address):
        import sys
        exc = sys.exc_info()[1]
        if isinstance(exc, (ConnectionError, TimeoutError,
                            BrokenPipeError)):
            log.debug("serving: client %s dropped: %r",
                      client_address, exc)
            return
        log.exception("serving: unhandled error for client %s",
                      client_address)


class _ServingHandler(BaseHTTPRequestHandler):
    """Shared plumbing for every serving HTTP handler: quiet logging,
    HTTP/1.1 keep-alive, JSON replies, and the /healthz + /readyz +
    /metrics endpoints.  Subclasses define ``do_POST``, a ``timeout``
    (the slow-client read deadline — http.server applies it as the
    socket timeout and closes the connection on expiry), ``_ready()``,
    and optionally ``_metrics()`` (defaults to rendering this process's
    global :class:`~mmlspark_tpu_torch.core.telemetry.MetricsRegistry`)."""

    disable_nagle_algorithm = True   # ms-latency serving contract
    # HTTP/1.1 keep-alive: a closed-loop client reuses its connection
    # instead of paying a TCP connect per request (every reply carries
    # Content-Length, so this is safe)
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):  # quiet
        pass

    def _send_json(self, status, obj):
        body = json.dumps(obj).encode("utf-8")
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _ready(self) -> bool:
        return False

    def _model_info(self) -> Optional[dict]:
        """The active model version/digest block ``/readyz`` carries
        when a rollout controller is installed;
        ``None`` keeps the legacy ready-only body."""
        return None

    def _metrics(self) -> Optional[str]:
        """Prometheus text for /metrics; ``None`` -> 503.  Default:
        this process's global registry (scoring engine, train stats,
        whatever else registered).  Instantiating the SLO monitor here
        means the ``mmlspark_tpu_slo_*`` families ride every serving
        scrape from the first one — not only after someone probes
        ``/slo``."""
        from ..core.slo import get_monitor
        get_monitor()
        return get_registry().render_prometheus()

    def _slo(self) -> dict:
        """JSON report for /slo: the process-global SLO monitor's
        burn-rate evaluation (sampling on demand, so two scrapes a few
        seconds apart yield meaningful windowed rates)."""
        from ..core.slo import get_monitor
        return get_monitor().report()

    def _statusz(self) -> str:
        """Plain text for /statusz: the one-page operational summary
        (model version, SLO burn, capacity headroom, top phases,
        worker liveness) assembled from the registries that already
        exist — no new state."""
        from ..core.capacity import render_statusz
        try:
            info = self._model_info()
        except Exception:  # noqa: BLE001 - advisory block
            info = None
        return render_statusz(model_info=info)

    def do_GET(self):
        if self.path == "/healthz":
            # liveness: the accept loop is running
            self._send_json(200, {"status": "ok"})
        elif self.path == "/readyz":
            try:
                ready = bool(self._ready())
            except Exception:  # noqa: BLE001
                ready = False
            body = {"ready": ready}
            try:
                info = self._model_info()
            except Exception:  # noqa: BLE001 - the model block is
                info = None    # advisory; readiness must still answer
            if info:
                body["model"] = info
            self._send_json(200 if ready else 503, body)
        elif self.path == "/slo":
            try:
                report = self._slo()
            except Exception:  # noqa: BLE001 - the route must degrade
                log.exception("serving: /slo evaluation failed")
                self.send_error(503, "slo monitor unavailable")
                return
            self._send_json(200, report)
        elif self.path == "/metrics":
            try:
                text = self._metrics()
            except Exception:  # noqa: BLE001 - a scrape must degrade,
                log.exception("serving: /metrics render failed")
                text = None
            if text is None:
                self.send_error(503, "metrics unavailable")
                return
            body = text.encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/statusz":
            try:
                text = self._statusz()
            except Exception:  # noqa: BLE001 - a status page must
                log.exception("serving: /statusz render failed")
                self.send_error(503, "statusz unavailable")
                return
            body = text.encode("utf-8")
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        else:
            self.send_error(404)


class _Pending:
    __slots__ = ("event", "response", "status", "t_park")

    def __init__(self):
        self.event = threading.Event()
        self.response: Any = None
        self.status = 200
        self.t_park = time.monotonic()


class _TrackedQueue(queue.Queue):
    """A Queue that tracks the request ids currently aboard, so a
    reconnecting worker's re-park can restore the reply route WITHOUT
    double-enqueueing a request whose first copy is still queued
    (scoring it twice would burn batch slots and, in transform mode,
    run user code twice).  ``_put``/``_get`` are Queue's documented
    under-mutex extension hooks."""

    def __init__(self):
        super().__init__()
        self.rids = set()

    def _put(self, item):
        self.rids.add(item[0])
        super()._put(item)

    def _get(self):
        item = super()._get()
        self.rids.discard(item[0])
        return item

    def put_unique(self, item) -> bool:
        """Enqueue unless this rid is already aboard; returns whether
        the item was enqueued."""
        with self.not_full:
            if item[0] in self.rids:
                return False
            self._put(item)
            self.unfinished_tasks += 1
            self.not_empty.notify()
            return True


class _Exchange:
    """Shared request queue + parked-reply table.

    One exchange can back many worker servers: requests from every worker
    land in ONE micro-batch queue, and a reply routes to the parked socket
    by request-id regardless of which worker accepted it — the
    cross-worker reply routing of the reference's DistributedHTTPSource /
    HTTPSink pair (expected path io/http/DistributedHTTPSource.scala,
    UNVERIFIED; SURVEY.md §3.4).

    Lifecycle of a ``pending`` entry: the handler that parked it always
    pops it via :meth:`unpark` (reply, timeout, or client error alike),
    and request ids are uuid4 — never recycled, so a late reply can
    never deliver into a reused id.  As a backstop against a handler
    thread dying between park and unpark (daemon teardown, a killed
    worker thread), :meth:`park` amortizes a sweep that drops entries
    older than ``2 * reply_timeout + sweep_grace`` — a leaked entry
    outlives its client by a bounded margin instead of forever.
    """

    _SWEEP_EVERY = 256

    def __init__(self, reply_timeout: float = 30.0,
                 sweep_grace: float = 10.0):
        self.queue: "queue.Queue[Tuple[str, Any, float]]" = queue.Queue()
        self.pending: Dict[str, _Pending] = {}
        self.lock = threading.Lock()
        self.reply_timeout = reply_timeout
        self.sweep_grace = sweep_grace
        self._parks = 0

    def park(self, payload: Any) -> Tuple[str, _Pending]:
        rid = uuid.uuid4().hex
        pending = _Pending()
        with self.lock:
            self.pending[rid] = pending
            self._parks += 1
            if self._parks % self._SWEEP_EVERY == 0:
                self._sweep_locked()
        # queue items carry the enqueue stamp so the scoring engine's
        # wait-shedding and per-request deadlines see true queue age
        self.queue.put((rid, payload, time.perf_counter()))
        return rid, pending

    def _sweep_locked(self) -> None:
        """Drop pending entries whose handler must be gone (no event is
        set — a live handler unparks within ``reply_timeout``).  Called
        under ``self.lock``."""
        horizon = time.monotonic() - (2 * self.reply_timeout
                                      + self.sweep_grace)
        stale = [r for r, p in self.pending.items()
                 if p.t_park < horizon]
        for r in stale:
            del self.pending[r]
        if stale:
            log.warning("serving: swept %d orphaned pending replies "
                        "(handler died between park and unpark)",
                        len(stale))

    def unpark(self, rid: str) -> bool:
        """Remove a parked request after its wait ended.  Returns whether a
        reply landed — re-checked under the lock: once the entry is popped
        here, any later reply() sees no entry and reports undelivered, so
        a reply racing the timeout either fully delivers or fully fails,
        never both."""
        with self.lock:
            pending = self.pending.pop(rid, None)
            return pending is not None and pending.event.is_set()

    def get_batch(self, max_rows: int = 64, timeout: float = 0.05
                  ) -> List[Tuple[str, Any]]:
        """Pull a micro-batch as legacy ``(rid, payload)`` 2-tuples (the
        enqueue stamps ride the raw queue only — direct-queue readers
        like the scoring engine use them; batch pullers keep the
        pre-resilience contract)."""
        batch: List[Tuple[str, Any]] = []
        try:
            batch.append(self.queue.get(timeout=timeout)[:2])
            while len(batch) < max_rows:
                batch.append(self.queue.get_nowait()[:2])
        except queue.Empty:
            pass
        return batch

    def reply(self, request_id: str, response: Any,
              status: int = 200) -> bool:
        with self.lock:
            pending = self.pending.get(request_id)
            if pending is None:
                return False  # socket gone (timeout/disconnect)
            pending.response = response
            pending.status = status
            pending.event.set()
            return True

    def reply_many(self, entries: List[Tuple[str, Any, int]]) -> int:
        """Batched reply delivery: one lock acquisition for the whole
        micro-batch instead of one per row — the scoring engine's reply
        hot path.  Returns the number delivered."""
        delivered = 0
        with self.lock:
            for rid, response, status in entries:
                pending = self.pending.get(rid)
                if pending is None:
                    continue
                pending.response = response
                pending.status = status
                pending.event.set()
                delivered += 1
        return delivered


class HTTPServer:
    """Accepts JSON POSTs, parks the socket, exposes micro-batches.

    Analog of ``DistributedHTTPSource`` for one process; a mesh deployment
    runs one server per host exactly like the reference runs one per
    executor (SURVEY.md §3.4).
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 api_path: str = "/", reply_timeout: float = 30.0,
                 exchange: Optional[_Exchange] = None,
                 request_read_timeout: float = 30.0):
        self._exchange = exchange or _Exchange(reply_timeout)
        # /readyz hook: the scoring engine installs its liveness check
        # here at start(); None means "no engine attached yet" → 503
        self.ready_check: Optional[Callable[[], bool]] = None
        # /metrics hook: None -> the process-global MetricsRegistry;
        # a custom provider returns the full exposition text itself
        self.metrics_provider: Optional[Callable[[], str]] = None
        # /readyz model block: RolloutController.install() points this
        # at its model_info() so operators can read the active
        # version/digest off the readiness probe
        self.model_info_provider: Optional[Callable[[], dict]] = None
        # /statusz hook: None -> the default one-page summary built
        # from the process-global registries; the multiprocess driver
        # points every worker's route at its fleet-wide render
        self.statusz_provider: Optional[Callable[[], str]] = None
        outer = self

        class Handler(_ServingHandler):
            # slow-client read deadline: a peer that opens a connection
            # and trickles (or never sends) its request body gets cut
            # off instead of parking a handler thread forever
            timeout = request_read_timeout

            def _ready(self):
                check = outer.ready_check
                return check is not None and bool(check())

            def _model_info(self):
                provider = outer.model_info_provider
                return provider() if provider is not None else None

            def _metrics(self):
                provider = outer.metrics_provider
                if provider is not None:
                    return provider()
                return super()._metrics()

            def _statusz(self):
                provider = outer.statusz_provider
                if provider is not None:
                    return provider()
                return super()._statusz()

            def do_POST(self):
                if api_path not in ("/", self.path):
                    self.send_error(404)
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(
                        self.rfile.read(length).decode("utf-8"))
                except (ValueError, UnicodeDecodeError):
                    self.send_error(400, "invalid JSON")
                    return
                rid, pending = outer._exchange.park(payload)
                ok = pending.event.wait(outer._exchange.reply_timeout)
                # unpark re-checks under the lock: a reply racing the
                # timeout is either fully delivered or fully refused
                if not outer._exchange.unpark(rid) and not ok:
                    self.send_error(504, "pipeline timeout")
                    return
                body = json.dumps(pending.response).encode("utf-8")
                self.send_response(pending.status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._server = _QuietThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._server.server_address
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)

    def start(self) -> "HTTPServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    @property
    def request_queue(self) -> "queue.Queue[Tuple[str, Any, float]]":
        """The raw parked-request queue (enqueue-stamped 3-tuples) — the
        scoring engine's batcher reads it directly for deadline-aware
        batch forming and queue-age shedding."""
        return self._exchange.queue

    def get_batch(self, max_rows: int = 64, timeout: float = 0.05
                  ) -> List[Tuple[str, Any]]:
        """Pull up to ``max_rows`` parked requests (micro-batch trigger)."""
        return self._exchange.get_batch(max_rows, timeout)

    def reply(self, request_id: str, response: Any,
              status: int = 200) -> bool:
        """HTTPSink: route a reply to the parked socket by request-id."""
        return self._exchange.reply(request_id, response, status)

    def reply_many(self, entries: List[Tuple[str, Any, int]]) -> int:
        """Batched reply routing (one lock for the whole micro-batch)."""
        return self._exchange.reply_many(entries)


class DistributedHTTPServer:
    """N worker HTTP servers over ONE shared exchange.

    The reference's DistributedHTTPSource runs one server per executor
    and routes each reply back to whichever executor parked the socket
    (SURVEY.md §3.4).  Here: every worker pushes into the shared micro-
    batch queue, the driver loop pulls interleaved batches, and
    ``reply``/``reply_from_table`` deliver by request-id across workers.
    """

    def __init__(self, num_workers: int = 2, host: str = "127.0.0.1",
                 api_path: str = "/", reply_timeout: float = 30.0,
                 request_read_timeout: float = 30.0):
        self._exchange = _Exchange(reply_timeout)
        self.workers = [
            HTTPServer(host, 0, api_path, reply_timeout,
                       exchange=self._exchange,
                       request_read_timeout=request_read_timeout)
            for _ in range(num_workers)]

    @property
    def addresses(self) -> List[str]:
        return [w.address for w in self.workers]

    @property
    def ready_check(self) -> Optional[Callable[[], bool]]:
        """/readyz hook, fanned out to every worker server."""
        return self.workers[0].ready_check if self.workers else None

    @ready_check.setter
    def ready_check(self, check: Optional[Callable[[], bool]]) -> None:
        for w in self.workers:
            w.ready_check = check

    @property
    def metrics_provider(self) -> Optional[Callable[[], str]]:
        """/metrics hook, fanned out to every worker server."""
        return self.workers[0].metrics_provider if self.workers else None

    @metrics_provider.setter
    def metrics_provider(self,
                         provider: Optional[Callable[[], str]]) -> None:
        for w in self.workers:
            w.metrics_provider = provider

    @property
    def model_info_provider(self) -> Optional[Callable[[], dict]]:
        """/readyz model-block hook, fanned out to every worker."""
        return self.workers[0].model_info_provider if self.workers \
            else None

    @model_info_provider.setter
    def model_info_provider(
            self, provider: Optional[Callable[[], dict]]) -> None:
        for w in self.workers:
            w.model_info_provider = provider

    @property
    def statusz_provider(self) -> Optional[Callable[[], str]]:
        """/statusz hook, fanned out to every worker server."""
        return self.workers[0].statusz_provider if self.workers \
            else None

    @statusz_provider.setter
    def statusz_provider(
            self, provider: Optional[Callable[[], str]]) -> None:
        for w in self.workers:
            w.statusz_provider = provider

    @property
    def request_queue(self) -> "queue.Queue[Tuple[str, Any, float]]":
        return self._exchange.queue

    def start(self) -> "DistributedHTTPServer":
        for w in self.workers:
            w.start()
        return self

    def stop(self) -> None:
        for w in self.workers:
            w.stop()

    def get_batch(self, max_rows: int = 64, timeout: float = 0.05
                  ) -> List[Tuple[str, Any]]:
        return self._exchange.get_batch(max_rows, timeout)

    def reply(self, request_id: str, response: Any,
              status: int = 200) -> bool:
        return self._exchange.reply(request_id, response, status)

    def reply_many(self, entries: List[Tuple[str, Any, int]]) -> int:
        return self._exchange.reply_many(entries)


def join_exchange(exchange: str, worker_id: int,
                  http_host: str = "0.0.0.0", api_path: str = "/",
                  reply_timeout: float = 30.0, token: str = "",
                  request_read_timeout: float = 30.0,
                  reconnect_tries: int = 5,
                  reconnect_backoff: Tuple[float, float] = (0.1, 2.0)
                  ) -> None:
    """Run ONE serving worker against a remote exchange — the multi-host
    entrypoint (each machine runs this next to its accelerator; the
    reference's per-executor DistributedHTTPSource server,
    SURVEY.md §3.4).  Blocks until the exchange sends ``stop`` or the
    transport session drops beyond repair: the exchange link is an
    :mod:`mmlspark_tpu_torch.io.transport` resumable session, so a link blip
    is re-dialed with bounded, jittered exponential backoff
    (``reconnect_tries`` attempts, delays from
    ``reconnect_backoff=(base, cap)`` seconds), unacked frames are
    replayed, and this worker's still-parked requests survive.
    ``exchange`` is the driver's
    ``MultiprocessHTTPServer(spawn_workers=False).exchange_address``
    (``host:port``, or ``[v6]:port`` for IPv6 — validated up front with
    a clear error instead of failing deep in ``create_connection``);
    ``worker_id`` must be the unique slot index in [0, num_workers);
    ``token`` is the driver's ``MultiprocessHTTPServer.token`` shared
    secret, checked by the transport handshake.  Security posture
    (what the token does and does NOT protect): docs/transport.md
    §Security."""
    host, port = parse_address(exchange)
    _mp_worker_main(host, port, int(worker_id), http_host, api_path,
                    reply_timeout, token, request_read_timeout,
                    reconnect_tries, reconnect_backoff)


def _mp_worker_main(driver_host: str, driver_port: int, worker_id: int,
                    http_host: str, api_path: str,
                    reply_timeout: float, token: str = "",
                    request_read_timeout: float = 30.0,
                    reconnect_tries: int = 5,
                    reconnect_backoff: Tuple[float, float] = (0.1, 2.0)
                    ) -> None:
    """Worker-process entrypoint (module-level for spawn-pickling).

    Owns REAL client sockets in its own process: parks each HTTP request
    locally, forwards (rid, payload) to the driver over ONE
    :class:`~mmlspark_tpu_torch.io.transport.TransportClient` session, and
    delivers driver replies to the parked socket.  Delivery is decided
    ATOMICALLY here (the process that holds the socket), and reported
    back as an app-level ack — that keeps ``reply()``'s delivered/
    undelivered contract exact across process boundaries, matching the
    reference where HTTPSink's reply lands on whichever executor parked
    the socket (SURVEY.md §3.4).

    Resilience now lives in the transport: a link blip reconnects with
    bounded, jittered backoff, resumes the session and replays unacked
    frames in both directions — no park or reply is lost to the blip
    and none is duplicated (sequence dedup).  On every (re)connect the
    worker re-hellos and re-parks its still-pending requests: a no-op
    on a clean resume (the driver's ``put_unique`` dedups), and exactly
    the rebuild required after a session RESET (driver restarted or
    resume grace expired).  ``/healthz`` reports process liveness;
    ``/readyz`` reports whether the exchange session is up.
    """
    from .transport import TransportClient, TransportConfig

    # cross-process tracing: when the driver-side tool set
    # MMLSPARK_TPU_JOURNAL_DIR, this worker's journal (request_recv /
    # request_reply app events + hop_* transport spans) is mirrored to
    # a per-pid JSONL the trace reader can merge with the driver's
    mirror_journal_from_env(f"w{worker_id}")
    journal = get_journal()

    # "engine_ready" mirrors the driver's ready beacon (None until the
    # first beacon arrives — treated as ready so a beacon-less driver
    # degrades to link-up readiness, the pre-beacon contract);
    # "model_info" mirrors the beacon's rollout model block so this
    # worker's /readyz names the active version/digest
    link: Dict[str, Any] = {"engine_ready": None, "model_info": None}
    stop_evt = threading.Event()
    pending: Dict[str, _Pending] = {}
    payloads: Dict[str, Any] = {}   # rid -> payload, kept for re-park
    plock = threading.Lock()
    # worker-local telemetry: what THIS process did with its sockets.
    # Reported to the driver (periodically + on every scrape) so the
    # driver's exposition shows the whole multiprocess topology.
    wstats = StageStats()
    wstats.incr("parked", 0)
    wstats.incr("replied", 0)
    wstats.set_gauge("exchange_link_up", 1.0)
    # /metrics scrape waiters: nonce -> _Pending holding the driver's
    # rendered exposition text
    mwaiters: Dict[str, _Pending] = {}

    def _deliver_binary_replies(buf):
        """One raw-float32 reply block: the driver batched a
        whole micro-batch of margins into one frame; unpack, deliver to
        the parked sockets, and answer with ONE batched delivery ack
        instead of a JSON ack per row."""
        try:
            entries = wire.unpack_replies(buf)
        except wire.WireError as e:
            log.warning("worker %d: malformed binary reply block "
                        "dropped: %s", worker_id, e)
            return
        rids, flags = [], []
        for rid, vals in entries:
            # the HTTP egress is JSON regardless — the one conversion
            # happens HERE at the socket owner, not in the driver loop
            v = vals.item() if vals.size == 1 else vals.tolist()
            with plock:
                p = pending.get(rid)
                if p is not None:
                    p.response = v
                    p.status = 200
                    p.event.set()
                pl = payloads.get(rid)
            if p is not None:
                wstats.incr("replied")
            journal.emit("request_reply", rid=rid,
                         tid=_payload_tid(rid, pl), status=200,
                         delivered=p is not None)
            rids.append(rid)
            flags.append(p is not None)
        try:
            # short timeout: this runs ON the read pump (see the JSON
            # ack send below for the rationale)
            client.send(CH_SCORING, {"op": "ack_many", "rids": rids,
                                     "delivered": flags}, timeout=2.0)
        except OSError:
            pass

    def on_message(session, channel, msg, deadline_ms):
        if isinstance(msg, (bytes, memoryview)):
            if channel == CH_SCORING:
                _deliver_binary_replies(msg)
            return
        op = msg.get("op")
        if channel == CH_CONTROL:
            if op == "stop":
                stop_evt.set()
            elif op == "ready":
                # driver readiness beacon → worker /readyz truth; a
                # None value means "no engine check installed" (the
                # beacon only carried model info) and must not flip
                # readiness
                if msg.get("value") is not None:
                    link["engine_ready"] = bool(msg.get("value"))
                if msg.get("model") is not None:
                    link["model_info"] = msg.get("model")
        elif channel == CH_SCORING and op == "reply":
            rid = msg["rid"]
            with plock:
                p = pending.get(rid)
                if p is not None:
                    p.response = msg["response"]
                    p.status = msg.get("status", 200)
                    p.event.set()
                pl = payloads.get(rid)
            if p is not None:
                wstats.incr("replied")
            journal.emit("request_reply", rid=rid,
                         tid=_payload_tid(rid, pl),
                         status=msg.get("status", 200),
                         delivered=p is not None)
            try:
                # short timeout: this runs ON the read pump — blocking
                # on credits here would also block the inbound CREDIT
                # frames that could unblock it.  A dropped ack degrades
                # to reply() reporting undelivered, which is bounded.
                client.send(CH_SCORING, {"op": "ack", "rid": rid,
                                         "delivered": p is not None},
                            timeout=2.0)
            except OSError:
                pass
        elif channel == CH_METRICS and op in ("metrics_txt",
                                              "slo_json",
                                              "statusz_txt"):
            # driver's answer to a /metrics, /slo or /statusz round-trip
            with plock:
                mw = mwaiters.pop(msg.get("req"), None)
            if mw is not None:
                mw.response = (msg.get("report") if op == "slo_json"
                               else msg.get("text"))
                mw.event.set()

    def _payload_tid(rid, payload):
        """A request's trace id in the worker process: the client's
        ``_trace_id`` payload key, else the rid this worker minted —
        the same contract the engine applies driver-side, so both
        journals speak about one request under one id."""
        if isinstance(payload, dict) and payload.get("_trace_id"):
            return str(payload["_trace_id"])
        return str(rid)

    adv = {"host": ""}

    def on_connect(resumed):
        # app hello on EVERY (re)connect: the driver keys the slot on
        # the session, so a duplicate hello is idempotent — and after a
        # session reset it is the required re-introduction.  Then
        # re-park everything still waiting here: ``put_unique`` on the
        # driver dedups rids already queued, the route-restore half is
        # what un-strands requests whose reply failed during the blip.
        try:
            if adv["host"] in ("0.0.0.0", "", "::"):
                # a wildcard bind must not advertise 0.0.0.0: report
                # the interface this worker reaches the exchange
                # through (multi-host dial-ability contract)
                sock = client.session._sock
                if sock is not None:
                    adv["host"] = sock.getsockname()[0]
            client.send(CH_CONTROL, {
                "op": "hello", "worker": worker_id,
                "host": adv["host"], "port": httpd.server_address[1]})
            # first stats beacon NOW, not a full period later: the
            # driver's per-worker `worker_up` gauge must read fresh
            # from the moment the slot joins (a scrape right after
            # start would otherwise show a healthy worker as dark)
            client.send(CH_STATS, {"op": "stats",
                                   "snapshot": wstats.snapshot(),
                                   "fit": current_fit_span()})
            with plock:
                requeue = [(r, payloads[r]) for r in pending
                           if r in payloads]
            for rid, payload in requeue:
                client.send(CH_SCORING,
                            {"op": "park", "rid": rid,
                             "payload": payload},
                            tc={"tid": _payload_tid(rid, payload)})
        except OSError:
            pass   # link died instantly — the next reconnect retries

    class Handler(_ServingHandler):
        timeout = request_read_timeout   # slow-client read deadline

        def _ready(self):
            # session up AND the driver's engine (if it beacons
            # readiness over the exchange) has not declared itself down
            return (client.connected
                    and link["engine_ready"] is not False)

        def _model_info(self):
            # the driver's rollout model block, as last beaconed
            return link.get("model_info")

        def _metrics(self):
            # the engine (and its StageStats) lives in the DRIVER
            # process — a scrape of this worker asks the driver for the
            # whole-topology exposition over the exchange session,
            # carrying this worker's local stats along so the driver's
            # view is fresh.  Link down / driver silent -> degrade to a
            # worker-local render rather than a 503 (a half-scrape
            # beats none during an exchange blip).
            if not client.connected:
                return _local_metrics()
            nonce = uuid.uuid4().hex
            waiter = _Pending()
            with plock:
                mwaiters[nonce] = waiter
            try:
                client.send(CH_METRICS,
                            {"op": "metrics_req", "req": nonce,
                             "stats": wstats.snapshot()},
                            deadline_ms=5000)
            except OSError:
                with plock:
                    mwaiters.pop(nonce, None)
                return _local_metrics()
            if not waiter.event.wait(5.0):
                with plock:
                    mwaiters.pop(nonce, None)
                return _local_metrics()
            return waiter.response

        def _slo(self):
            # like /metrics: the scoring counters the SLO objectives
            # read live in the DRIVER process, so a worker's /slo does
            # one exchange round-trip; link down / driver silent
            # degrades to the worker-local monitor (its transport
            # objectives still evaluate) instead of a 503
            from ..core.slo import get_monitor
            if not client.connected:
                return get_monitor().report()
            nonce = uuid.uuid4().hex
            waiter = _Pending()
            with plock:
                mwaiters[nonce] = waiter
            try:
                client.send(CH_METRICS,
                            {"op": "slo_req", "req": nonce},
                            deadline_ms=5000)
            except OSError:
                with plock:
                    mwaiters.pop(nonce, None)
                return get_monitor().report()
            if not waiter.event.wait(5.0):
                with plock:
                    mwaiters.pop(nonce, None)
                return get_monitor().report()
            return waiter.response

        def _statusz(self):
            # the fleet-wide status page (SLO burn, headroom, worker
            # liveness) is assembled in the DRIVER process — one
            # exchange round-trip like /slo; link down / driver silent
            # degrades to this worker's local summary
            from ..core.capacity import render_statusz
            local = lambda: render_statusz(  # noqa: E731
                model_info=link.get("model_info"))
            if not client.connected:
                return local()
            nonce = uuid.uuid4().hex
            waiter = _Pending()
            with plock:
                mwaiters[nonce] = waiter
            try:
                client.send(CH_METRICS,
                            {"op": "statusz_req", "req": nonce},
                            deadline_ms=5000)
            except OSError:
                with plock:
                    mwaiters.pop(nonce, None)
                return local()
            if not waiter.event.wait(5.0):
                with plock:
                    mwaiters.pop(nonce, None)
                return local()
            return waiter.response

        def do_POST(self):
            if api_path not in ("/", self.path):
                self.send_error(404)
                return
            length = int(self.headers.get("Content-Length", 0))
            try:
                payload = json.loads(
                    self.rfile.read(length).decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                self.send_error(400, "invalid JSON")
                return
            rid = uuid.uuid4().hex
            p = _Pending()
            with plock:
                pending[rid] = p
                payloads[rid] = payload
            wstats.incr("parked")
            tid = _payload_tid(rid, payload)
            journal.emit("request_recv", rid=rid, tid=tid,
                         worker=worker_id)
            # deadline propagation: a client-declared budget rides the
            # frame header so the driver can 504 dead work unscored
            dl = payload.get("_deadline_ms") \
                if isinstance(payload, dict) else None
            dl = dl if isinstance(dl, (int, float)) and dl > 0 else None
            # raw-float32 park: a plain features-vector
            # request on a binary-negotiated session ships as ONE
            # packed float32 row — no JSON re-encode on this hop.
            # Anything richer (explicit _trace_id, extra keys, ragged
            # vectors) takes the negotiated JSON fallback below.
            sent = False
            # a _deadline_ms the header cannot carry AT ALL (a
            # string-typed or non-positive value the ENGINE would still
            # parse from the payload) keeps the JSON wire.  Note the
            # carried semantics intentionally differ in one way: the
            # header deadline is the REMAINING budget at frame-send
            # time (decremented by worker-side queueing/replay — the
            # transport's propagation contract), while the JSON
            # payload key keeps the original budget; the binary wire
            # is therefore the stricter of the two, never the looser.
            if (client.session.peer_binary and isinstance(payload, dict)
                    and "features" in payload
                    and set(payload) <= {"features", "_deadline_ms"}
                    and ("_deadline_ms" not in payload
                         or dl is not None)):
                try:
                    row = np.asarray(payload["features"],
                                     dtype=np.float32)
                    if row.ndim == 1 and row.size:
                        client.session.send_bytes(
                            CH_SCORING,
                            wire.pack_matrix(rid, row.reshape(1, -1)),
                            deadline_ms=dl)
                        sent = True
                except (TypeError, ValueError):
                    sent = False         # undecodable: JSON carries it
                except OSError:
                    sent = True          # session closed; same exposure
                    #                      bound as the JSON path below
            if not sent:
                try:
                    client.send(CH_SCORING,
                                {"op": "park", "rid": rid,
                                 "payload": payload},
                                deadline_ms=dl,
                                tc={"tid": tid})
                except OSError:
                    # session closed for good; the wait below bounds
                    # the client's exposure (a mere blip queues the
                    # frame for replay instead of landing here)
                    pass
            ok = p.event.wait(reply_timeout)
            with plock:
                # atomic here, where the socket lives: once popped, a
                # racing reply acks delivered=False and the driver
                # reports the timeout truthfully
                p2 = pending.pop(rid, None)
                payloads.pop(rid, None)
            delivered = p2 is not None and p2.event.is_set()
            if not delivered and not ok:
                try:
                    client.send(CH_SCORING, {"op": "expire",
                                             "rid": rid})
                except OSError:
                    pass   # session gone — the route dies with it
                self.send_error(504, "pipeline timeout")
                return
            body = json.dumps(p.response).encode("utf-8")
            self.send_response(p.status)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    def _local_metrics():
        # degraded scrape: this worker's own stats only, flagged so a
        # dashboard can tell a partial exposition from a healthy one
        return (render_prometheus({"worker_local": wstats.snapshot()})
                + "# driver unreachable: worker-local metrics only\n")

    httpd = _QuietThreadingHTTPServer((http_host, 0), Handler)
    adv["host"] = httpd.server_address[0]
    base, cap = reconnect_backoff
    client = TransportClient(
        (driver_host, driver_port), token=token,
        cfg=TransportConfig(reconnect_tries=reconnect_tries,
                            reconnect_backoff=(base, cap)),
        on_message=on_message, on_connect=on_connect,
        on_down=lambda: stop_evt.set(),   # budget exhausted: shut down
        name=f"exchange-worker{worker_id}")
    try:
        client.connect()
    except OSError:
        httpd.server_close()
        raise
    threading.Thread(target=httpd.serve_forever, daemon=True).start()

    def stats_beacon():
        # periodic worker-stats report: keeps the driver's per-worker
        # blocks fresh so a scrape against ANY server (or the driver's
        # own render_metrics()) sees every worker, not just the one
        # being scraped.  Best-effort, and only while the session is
        # up — beacons must not burn replay credits during an outage.
        while not stop_evt.wait(1.0):
            wstats.set_gauge("exchange_link_up",
                             1.0 if client.connected else 0.0)
            if not client.connected:
                continue
            try:
                # the beacon names the fit span this process is inside
                # (None outside training) — the trace reader can tie a
                # worker's stats to the fit they served under
                payload = {"op": "stats",
                           "snapshot": wstats.snapshot(),
                           "fit": current_fit_span()}
                # drift sketches ride the same beacon: the
                # driver key-wise sums the counters across workers —
                # cross-process sketch merging through the metrics
                # scrape, exactly like StageStats
                from ..core.drift import peek_drift_monitor
                dm = peek_drift_monitor()
                if dm is not None:
                    payload["drift"] = dm.snapshot()
                # the saturation block rides the same beacon:
                # per-worker headroom/busy gauges merge into the
                # driver scrape under the gauge merge policy
                from ..core.capacity import peek_capacity_monitor
                cm = peek_capacity_monitor()
                if cm is not None:
                    payload["capacity"] = cm.snapshot()
                client.send(CH_STATS, payload)
            except OSError:
                pass

    threading.Thread(target=stats_beacon, name="worker-stats-beacon",
                     daemon=True).start()

    stop_evt.wait()
    httpd.shutdown()
    httpd.server_close()
    client.close()


class MultiprocessHTTPServer:
    """N worker HTTP servers as SEPARATE OS PROCESSES over one TCP
    exchange — the cross-process topology of the reference's
    DistributedHTTPSource, where each executor process accepts requests
    and replies route back to the process holding the socket
    (SURVEY.md §3.4).  Driver-facing API is identical to
    :class:`DistributedHTTPServer` (start/stop/addresses/get_batch/
    reply), so the same micro-batch loop drives either topology.

    With ``spawn_workers=False`` nothing is forked: the exchange waits
    for ``num_workers`` REMOTE workers to dial in via
    :func:`join_exchange` — the multi-HOST deployment, each machine
    running one worker next to its accelerator (the reference's
    per-executor HTTP server).  Pass ``host="0.0.0.0"`` so remote
    workers can reach the exchange; ``exchange_address`` is the
    ``host:port`` to hand them, along with the ``token`` shared secret
    each ``join_exchange`` must present (auto-generated unless given).

    The exchange runs on :mod:`mmlspark_tpu_torch.io.transport` — ONE framed,
    CRC-checked, flow-controlled, resumable transport multiplexing the
    scoring channel (park/reply/expire/ack), the worker stats beacons,
    the ``/metrics`` scrape round-trips and session control.  The
    transport handshake enforces the token before any state is touched
    (non-protocol and wrong-token peers are dropped at the preamble;
    security posture: docs/transport.md §Security).

    Failure handling (the reference's executor-loss story applied to
    serving): a link BLIP is invisible above the transport — the worker
    reconnects with jittered backoff, the session resumes, and unacked
    frames replay with sequence dedup (no lost, no duplicated
    messages).  A session that dies for good (worker crash, resume
    grace expired, respawn takeover) purges the worker's reply routes
    (so replies report undelivered immediately instead of hanging),
    releases its ack waiters, and reopens its worker slot for a fresh
    hello.  With ``supervise_workers=True`` (spawned topology) a dead
    worker PROCESS is respawned automatically; its parked client
    sockets died with it (those clients see a reset and retry), but
    capacity and readiness recover without operator action.
    ``self.counters`` tracks ``worker_deaths`` / ``worker_respawns``.

    Every timeout is constructor-level config so drills and tests can
    tighten them: ``request_read_timeout`` (worker HTTP slow-client
    deadline), ``preauth_timeout`` (transport handshake deadline),
    ``ack_grace`` (reply-ack wait beyond ``reply_timeout``),
    ``reconnect_tries``/``reconnect_backoff`` (worker session re-dial),
    ``sweep_grace`` (orphaned route sweep slack), and
    ``transport_config`` (frame/flow/keepalive/resume knobs, including
    the chaos ``socket_wrap`` hook).
    """

    _SWEEP_EVERY = 512

    #: the scoring engine reads this: replies may stay numpy (sliced
    #: straight off the margin ndarray) — this exchange serializes them
    #: per session: a raw-float32 block on binary-negotiated sessions,
    #: the JSON fallback otherwise
    binary_wire = True

    def __init__(self, num_workers: int = 2, host: str = "127.0.0.1",
                 api_path: str = "/", reply_timeout: float = 30.0,
                 spawn_workers: bool = True, join_timeout: float = 20.0,
                 token: Optional[str] = None,
                 request_read_timeout: float = 30.0,
                 preauth_timeout: float = 30.0,
                 ack_grace: float = 5.0,
                 reconnect_tries: int = 5,
                 reconnect_backoff: Tuple[float, float] = (0.1, 2.0),
                 supervise_workers: bool = True,
                 sweep_grace: float = 10.0,
                 transport_config: Optional[Any] = None):
        import dataclasses
        import secrets

        from .transport import TransportConfig, TransportServer

        self.token = secrets.token_hex(16) if token is None else token
        tcfg = transport_config or TransportConfig()
        # exchange-level timeouts override the transport defaults so
        # ONE knob set governs the whole topology
        tcfg = dataclasses.replace(
            tcfg, preauth_timeout_s=preauth_timeout,
            reconnect_tries=reconnect_tries,
            reconnect_backoff=reconnect_backoff)
        self._ts = TransportServer(
            host, 0, token=self.token, cfg=tcfg,
            on_message=self._on_transport_msg,
            on_session_lost=self._on_session_lost, name="exchange")
        self.queue: _TrackedQueue = _TrackedQueue()
        # rid -> (session id, monotonic park time, trace id); the stamp
        # bounds how long an orphaned route can leak (_sweep_routes);
        # the trace id lets the reply frame carry the request's trace
        # context back through the worker hop
        self._route: Dict[str, Tuple[str, float, str]] = {}
        self._acks: Dict[str, Tuple[_Pending, str]] = {}  # rid -> waiter
        self._lock = threading.Lock()
        self._slot_sid: Dict[int, str] = {}   # worker slot -> session id
        self.addresses: List[str] = [""] * num_workers
        self.counters = {"worker_deaths": 0, "worker_respawns": 0}
        # telemetry: the exchange's own StageStats mirror of `counters`
        # (registered under "serving_exchange" at start()) plus the
        # per-worker snapshots the worker processes beacon over the
        # link — render_metrics() turns all of it into one exposition
        self.stats = StageStats()
        for _k in ("worker_deaths", "worker_respawns"):
            self.stats.incr(_k, 0)
        self.worker_stats: Dict[int, dict] = {}
        # per-worker drift-sketch snapshots: workers whose
        # scoring engine carries a DriftMonitor piggyback its
        # StageStats-shaped block on the stats beacon; render_metrics
        # merges them (counters SUM = the merged sketch, gauges take
        # the worst arm) into one ns="drift" block
        self.worker_drift: Dict[int, dict] = {}
        # per-worker saturation blocks: capacity monitors
        # piggyback their headroom/busy gauges on the stats beacon;
        # render_metrics merges them (depth gauges SUM, levels take
        # the worst arm) into one ns="capacity" view
        self.worker_capacity: Dict[int, dict] = {}
        # worker slot -> monotonic instant of its last stats beacon (or
        # scrape piggyback): the per-worker `worker_up` gauge ages from
        # here, so a silent worker is visible from ONE scrape
        self._beacon_seen: Dict[int, float] = {}
        #: beacon age beyond which a worker's `worker_up` gauge reads 0
        #: (3x the 1 s beacon period + slack)
        self.beacon_stale_s = 4.0
        # the scoring engine installs its liveness check here; the
        # beacon thread broadcasts it to worker processes so their
        # /readyz reflects ENGINE readiness, not just link liveness
        self.ready_check: Optional[Callable[[], bool]] = None
        # rollout model info: the driver-side controller
        # installs model_info() here; the ready beacon carries it to
        # every worker process so THEIR /readyz names the active
        # model version/digest too
        self.model_info_provider: Optional[Callable[[], dict]] = None
        self._reply_timeout = reply_timeout
        self._join_timeout = join_timeout
        self._request_read_timeout = request_read_timeout
        self._preauth_timeout = preauth_timeout
        self._ack_grace = ack_grace
        self._reconnect_tries = reconnect_tries
        self._reconnect_backoff = reconnect_backoff
        self._supervise_workers = bool(supervise_workers)
        self._sweep_grace = sweep_grace
        self._parks = 0
        self._host = host
        self._api_path = api_path
        self._closing = threading.Event()
        self._proc_supervisor: Optional[threading.Thread] = None
        self._ready_beacon: Optional[threading.Thread] = None

        self._procs = []
        self._spawn_workers = spawn_workers
        if spawn_workers:
            self._procs = [self._make_proc(i)
                           for i in range(num_workers)]

    def _make_proc(self, worker_id: int):
        import multiprocessing as mp
        ctx = mp.get_context("spawn")  # no inherited CUDA/thread state
        dh, dp = self._ts.address
        return ctx.Process(
            target=_mp_worker_main,
            args=(dh, dp, worker_id, self._host, self._api_path,
                  self._reply_timeout, self.token,
                  self._request_read_timeout, self._reconnect_tries,
                  self._reconnect_backoff),
            daemon=True)

    @property
    def exchange_address(self) -> str:
        """``host:port`` remote workers dial via :func:`join_exchange`.
        A wildcard bind advertises this machine's primary outbound
        interface, not ``0.0.0.0`` — the same dial-ability rule the
        workers follow for their own hello addresses."""
        import socket as _socket
        h, p = self._ts.address
        if h in ("0.0.0.0", "", "::"):
            probe = _socket.socket(_socket.AF_INET, _socket.SOCK_DGRAM)
            try:
                # UDP connect sends nothing; it just resolves the route
                probe.connect(("10.255.255.255", 1))
                h = probe.getsockname()[0]
            except OSError:
                try:
                    h = _socket.gethostbyname(_socket.gethostname())
                except OSError:
                    h = "127.0.0.1"
            finally:
                probe.close()
        return f"{h}:{p}"

    def start(self) -> "MultiprocessHTTPServer":
        for p in self._procs:
            p.start()
        import time
        # The transport server authenticates and pumps every
        # connection; this loop only waits for the APP-LEVEL hellos
        # that fill the worker slots.  Garbage, wrong-token and
        # invalid-id peers never consume a slot (the handshake drops
        # them before any exchange state exists).  Budgets: 60 s for
        # spawned workers (a loaded single-core host can take >20 s
        # just to spawn and import N interpreters), join_timeout for
        # external ones.
        self._ts.start()
        budget = 60.0 if self._procs else self._join_timeout
        deadline = time.monotonic() + budget
        while (any(not a for a in self.addresses)
               and time.monotonic() < deadline):
            time.sleep(0.05)
        if any(not a for a in self.addresses):
            missing = [i for i, a in enumerate(self.addresses) if not a]
            xaddr = self.exchange_address  # before stop() closes it
            saw_peer = bool(self._ts.sessions)
            self.stop()
            if self._procs and not saw_peer:
                raise RuntimeError(
                    "worker processes failed to connect; if this is "
                    "a script, MultiprocessHTTPServer must be "
                    "started under `if __name__ == '__main__':` "
                    "(spawn re-imports the main module)")
            raise RuntimeError(
                f"worker slots {missing} never joined {xaddr} within "
                f"{budget}s: start one join_exchange(...) per slot with "
                f"a unique id in [0, {len(self.addresses)}) and this "
                f"server's .token (invalid ids and missing or wrong "
                f"tokens are dropped and land here; a duplicate id "
                f"takes over its slot)")
        if self._procs and self._supervise_workers:
            self._proc_supervisor = threading.Thread(
                target=self._supervise_procs, name="worker-supervisor",
                daemon=True)
            self._proc_supervisor.start()
        self._ready_beacon = threading.Thread(
            target=self._beacon_loop, name="ready-beacon", daemon=True)
        self._ready_beacon.start()
        get_registry().register("serving_exchange", self.stats)
        return self

    def render_metrics(self) -> str:
        """One Prometheus exposition for the whole multiprocess
        topology: the driver's registry (scoring engine, train stats,
        this exchange's own counters) plus each worker's last-reported
        stats under ``ns="worker<N>"`` and their aggregate under
        ``ns="workers"``.  EVERY slot appears, beaconing or not: a
        ``worker_up`` gauge (1 while the slot's beacons are fresh, 0
        for a silent/dead/never-joined worker — ``_up`` suffix, so the
        ``workers`` aggregate takes the MIN and one dark worker shows
        there too) and a ``last_beacon_age_ms`` gauge make a silent
        worker visible from ONE scrape instead of requiring a
        dashboard diff against the slot count."""
        from ..core.slo import get_monitor
        get_monitor()   # slo families ride every topology scrape
        now = time.monotonic()
        with self._lock:
            # copy the gauges level too: the synthetic worker_up /
            # beacon-age gauges are inserted below OUTSIDE the lock,
            # and a shallow dict(s) would mutate the stored snapshot a
            # concurrent scrape (HTTP thread vs transport pump) is
            # iterating
            per_worker = {
                w: {**s, "gauges": dict(s.get("gauges") or {})}
                for w, s in self.worker_stats.items()}
            worker_drift = list(self.worker_drift.values())
            worker_cap = list(self.worker_capacity.values())
            seen = dict(self._beacon_seen)
        for w in range(len(self.addresses)):
            snap = per_worker.setdefault(
                w, {"rows": 0, "rows_per_s": 0.0, "counters": {},
                    "gauges": {}, "stages": {}})
            gauges = snap.setdefault("gauges", {})
            age_s = (now - seen[w]) if w in seen else float("inf")
            gauges["worker_up"] = \
                1.0 if age_s <= self.beacon_stale_s else 0.0
            gauges["last_beacon_age_ms"] = (
                round(age_s * 1e3, 1) if age_s != float("inf")
                else float("inf"))
        extra = {f"worker{w}": snap
                 for w, snap in sorted(per_worker.items())}
        if per_worker:
            extra["workers"] = merge_snapshots(per_worker.values())
        if worker_drift:
            # merged drift sketches for the whole topology: counter
            # sums ARE the concatenated-rows sketch; the
            # driver's own monitor (if any) joins the merge
            from ..core.drift import peek_drift_monitor
            dm = peek_drift_monitor()
            blocks = worker_drift + ([dm.snapshot()]
                                     if dm is not None else [])
            extra["drift"] = merge_snapshots(blocks)
        # merged saturation view: the gauge merge policy (min for
        # *_up, sum for *_depth/*_inflight, max otherwise) makes the
        # fold meaningful — total queued work sums, worst headroom
        # dominates
        from ..core.capacity import peek_capacity_monitor
        cm = peek_capacity_monitor()
        cap_blocks = worker_cap + ([cm.snapshot()]
                                   if cm is not None else [])
        if cap_blocks:
            extra["capacity"] = merge_snapshots(cap_blocks)
        return get_registry().render_prometheus(extra=extra)

    def render_statusz(self) -> str:
        """Topology-wide ``/statusz``: the capacity module's operator
        page plus per-slot worker liveness from the beacon ages — the
        one-glance saturation answer for the whole serving fleet."""
        from ..core.capacity import render_statusz
        now = time.monotonic()
        with self._lock:
            seen = dict(self._beacon_seen)
            n = len(self.addresses)
        workers = {}
        for w in range(n):
            age_s = (now - seen[w]) if w in seen else float("inf")
            workers[f"worker{w}"] = {
                "up": age_s <= self.beacon_stale_s,
                "beacon_age_s": round(age_s, 3)}
        info = None
        if self.model_info_provider is not None:
            try:
                info = self.model_info_provider()
            except Exception:  # noqa: BLE001 - advisory block
                info = None
        return render_statusz(model_info=info, workers=workers)

    def _beacon_loop(self) -> None:
        """Broadcast the installed ``ready_check`` verdict to every
        slotted worker so worker-process ``/readyz`` tells the truth
        about the ENGINE, not just the exchange link.  No check
        installed → no beacons → workers fall back to link-up
        readiness."""
        while not self._closing.wait(0.5):
            check = self.ready_check
            info_provider = self.model_info_provider
            if check is None and info_provider is None:
                continue
            r = None
            if check is not None:
                try:
                    r = bool(check())
                except Exception:  # noqa: BLE001
                    r = False
            msg = {"op": "ready", "value": r}
            if info_provider is not None:
                try:
                    msg["model"] = info_provider()
                except Exception:  # noqa: BLE001 - advisory block
                    pass
            for session in self._worker_sessions():
                try:
                    session.send(CH_CONTROL, msg, timeout=0.5)
                except OSError:
                    pass   # dying link: the transport handles it

    def _worker_sessions(self) -> List[Any]:
        """Connected sessions currently holding a worker slot."""
        with self._lock:
            sids = list(self._slot_sid.values())
        out = []
        for sid in sids:
            s = self._ts.sessions.get(sid)
            if s is not None and s.connected:
                out.append(s)
        return out

    def _supervise_procs(self) -> None:
        """Spawned-worker supervision: a dead worker PROCESS is
        respawned into its slot (the reader-death purge already freed
        the slot and failed its in-flight replies).  The respawn binds
        a fresh HTTP port — ``addresses`` updates on its hello, so
        callers should re-read it rather than cache."""
        while not self._closing.wait(0.5):
            for i, p in enumerate(self._procs):
                if p.is_alive() or self._closing.is_set():
                    continue
                log.warning("serving: worker process %d died "
                            "(exitcode %s); respawning", i, p.exitcode)
                self.counters["worker_respawns"] += 1
                self.stats.incr("worker_respawns")
                # flight record BEFORE the respawn overwrites state:
                # the journal tail + metrics + thread stacks at the
                # moment the death was noticed are the post-mortem
                record_flight("serving_worker_death",
                              {"worker": i, "exitcode": p.exitcode,
                               "pid": p.pid})
                newp = self._make_proc(i)
                self._procs[i] = newp
                newp.start()

    def _on_transport_msg(self, session, channel: int, msg: dict,
                          deadline_ms) -> None:
        """App-protocol dispatch for one authenticated exchange
        session.  The transport already enforced magic/version/token,
        framing, CRC and sequencing — by the time a message lands here
        it is a well-formed JSON object from a tokened peer, or a raw
        binary scoring payload (FLAG_BINARY frame) this method routes
        to the zero-copy park path."""
        if isinstance(msg, (bytes, memoryview)):
            self._on_binary_scoring(session, channel, msg, deadline_ms)
            return
        op = msg.get("op")
        if channel == CH_CONTROL and op == "hello":
            self._on_worker_hello(session, msg)
        elif channel == CH_SCORING:
            if op == "park":
                rid, payload = msg["rid"], msg["payload"]
                # deadline propagation: a frame-header deadline becomes
                # the engine's per-request budget unless the payload
                # already carries an explicit one
                if (deadline_ms and isinstance(payload, dict)
                        and "_deadline_ms" not in payload):
                    payload["_deadline_ms"] = deadline_ms
                tid = str(rid)
                if isinstance(payload, dict) \
                        and payload.get("_trace_id"):
                    tid = str(payload["_trace_id"])
                with self._lock:
                    self._route[rid] = (session.sid, time.monotonic(),
                                        tid)
                    self._parks += 1
                    if self._parks % self._SWEEP_EVERY == 0:
                        self._sweep_routes_locked()
                # put_unique: a reconnect re-park whose first copy is
                # still queued only restores the route (above) — it
                # must not enqueue a second copy to be scored twice
                self.queue.put_unique((rid, payload,
                                       time.perf_counter()))
            elif op == "expire":
                with self._lock:
                    self._route.pop(msg["rid"], None)
            elif op == "ack":
                with self._lock:
                    entry = self._acks.pop(msg["rid"], None)
                if entry is not None:
                    waiter = entry[0]
                    waiter.response = msg["delivered"]
                    waiter.event.set()
            elif op == "ack_many":
                # batched delivery ack answering a binary reply block:
                # one frame resolves the whole micro-batch's waiters
                resolved = []
                with self._lock:
                    for rid, d in zip(msg.get("rids") or (),
                                      msg.get("delivered") or ()):
                        entry = self._acks.pop(rid, None)
                        if entry is not None:
                            resolved.append((entry[0], bool(d)))
                for waiter, d in resolved:
                    waiter.response = d
                    waiter.event.set()
        elif channel == CH_STATS and op == "stats":
            # periodic worker-stats beacon: keep the last-known
            # snapshot per WORKER SLOT (not session) so the
            # whole-topology exposition names stable workers
            with self._lock:
                w = session.meta.get("worker")
                if w is not None and isinstance(msg.get("snapshot"),
                                                dict):
                    self.worker_stats[w] = msg["snapshot"]
                    self._beacon_seen[w] = time.monotonic()
                if w is not None and isinstance(msg.get("drift"),
                                                dict):
                    self.worker_drift[w] = msg["drift"]
                if w is not None and isinstance(msg.get("capacity"),
                                                dict):
                    self.worker_capacity[w] = msg["capacity"]
        elif channel == CH_METRICS and op == "metrics_req":
            # a /metrics scrape hit this worker: fold its piggybacked
            # stats in, render the WHOLE topology (driver registry +
            # every worker's last report + aggregated totals), and
            # answer the round-trip
            with self._lock:
                w = session.meta.get("worker")
                if w is not None and isinstance(msg.get("stats"), dict):
                    self.worker_stats[w] = msg["stats"]
                    self._beacon_seen[w] = time.monotonic()
            try:
                text = self.render_metrics()
            except Exception:  # noqa: BLE001 - scrape must degrade
                log.exception("serving: metrics render failed")
                text = "# metrics render failed\n"
            try:
                # short timeout: this runs ON the read pump (see the
                # worker-side ack send for the rationale); a dropped
                # scrape answer degrades to the worker's local render
                session.send(CH_METRICS, {"op": "metrics_txt",
                                          "req": msg.get("req"),
                                          "text": text}, timeout=2.0)
            except OSError:
                pass   # dying link: the transport handles the purge
        elif channel == CH_METRICS and op == "slo_req":
            # a /slo probe hit a worker: evaluate the driver's monitor
            # (the scoring counters live here) and answer
            from ..core.slo import get_monitor
            try:
                report = get_monitor().report()
            except Exception:  # noqa: BLE001 - probe must degrade
                log.exception("serving: slo evaluation failed")
                report = {"error": "slo evaluation failed"}
            try:
                session.send(CH_METRICS, {"op": "slo_json",
                                          "req": msg.get("req"),
                                          "report": report},
                             timeout=2.0)
            except OSError:
                pass
        elif channel == CH_METRICS and op == "statusz_req":
            # a /statusz probe hit a worker: the authoritative view
            # (burn states, headroom, fleet liveness) lives on the
            # driver — render here and answer
            try:
                text = self.render_statusz()
            except Exception:  # noqa: BLE001 - probe must degrade
                log.exception("serving: statusz render failed")
                text = "statusz render failed\n"
            try:
                session.send(CH_METRICS, {"op": "statusz_txt",
                                          "req": msg.get("req"),
                                          "text": text}, timeout=2.0)
            except OSError:
                pass

    def _on_binary_scoring(self, session, channel: int, buf,
                           deadline_ms) -> None:
        """Zero-copy park: a raw-float32 scoring request
        (io/wire.py preamble + packed row block) lands on the queue as
        a float32 view — no JSON, no per-value Python objects.  A
        malformed preamble costs exactly ONE request (a per-row 400
        when the rid is recoverable), never the connection — the same
        blast-radius contract the JSON decode path gives."""
        def refuse(rid):
            # the per-request 400 of the blast-radius contract: one
            # bad payload costs ONE request, never the connection
            if not rid:
                return
            try:
                session.send(CH_SCORING,
                             {"op": "reply", "rid": rid,
                              "response": {"error": "bad request"},
                              "status": 400}, timeout=2.0)
            except OSError:
                pass

        if channel != CH_SCORING:
            log.warning("serving: unexpected binary payload on "
                        "channel %d dropped", channel)
            return
        try:
            kind, rid, X = wire.unpack_matrix(buf)
        except wire.WireError as e:
            rid = wire.peek_rid(buf)
            log.warning("serving: malformed binary scoring payload "
                        "(%s); %s", e,
                        f"400ing request {rid[:8]}" if rid
                        else "rid unrecoverable, dropping")
            refuse(rid)
            return
        if kind != wire.K_REQ:
            log.warning("serving: unexpected binary payload kind %d "
                        "dropped", kind)
            return
        if X.shape[0] != 1:
            # the exchange park contract is ONE row per request id —
            # the engine maps one decoded row to one batch entry, so a
            # multi-row block under a single rid would misalign scores
            # across co-batched requests.  Multi-row matrices are the
            # FLEET protocol (io/fleet.py).
            log.warning("serving: %d-row binary park %s rejected "
                        "(one row per request)", X.shape[0], rid[:8])
            refuse(rid)
            return
        payload = (wire.BinaryReq(X, deadline_ms) if deadline_ms
                   else X)
        with self._lock:
            self._route[rid] = (session.sid, time.monotonic(),
                                str(rid))
            self._parks += 1
            if self._parks % self._SWEEP_EVERY == 0:
                self._sweep_routes_locked()
        self.queue.put_unique((rid, payload, time.perf_counter()))

    def _on_worker_hello(self, session, msg: dict) -> None:
        w = msg.get("worker")
        if (not isinstance(w, int)
                or not 0 <= w < len(self.addresses)):
            log.warning("serving: ignoring hello with invalid "
                        "worker id %r (need 0..%d)", w,
                        len(self.addresses) - 1)
            return
        # newest-wins slot claim: a hello for an occupied slot from a
        # DIFFERENT session means the worker process was respawned (or
        # re-dialed before its old session's loss was declared).  The
        # new session takes the slot; the old one is dropped and its
        # routes purged WITHOUT counting a worker death twice —
        # clearing its slot claim first means its teardown cannot wipe
        # the live worker's address.  A re-hello on the SAME session
        # (reconnect after a session reset, or the routine re-hello on
        # every resume) is idempotent.
        stale_sid = None
        with self._lock:
            old_sid = self._slot_sid.get(w)
            if old_sid is not None and old_sid != session.sid:
                log.warning("serving: worker slot %d re-helloed on a "
                            "new session; replacing the stale one", w)
                stale_sid = old_sid
                old_sess = self._ts.sessions.get(old_sid)
                if old_sess is not None:
                    old_sess.meta.pop("worker", None)
            self._slot_sid[w] = session.sid
            session.meta["worker"] = w
        self.addresses[w] = f"http://{msg['host']}:{msg['port']}"
        if stale_sid is not None:
            self._ts.drop_session(stale_sid, notify=False)
            self._purge_session(stale_sid)

    def _on_session_lost(self, session) -> None:
        """A session died for good (resume grace expired, peer CLOSEd,
        or an explicit drop): purge its routes so replies report
        undelivered immediately, release its ack waiters, and reopen
        its worker slot for a fresh hello — the surviving workers keep
        serving (the reference's executor-loss story, SURVEY.md §5.3
        applied to serving).  Requests from this worker still in
        ``self.queue`` score normally; their replies find no route and
        report undelivered."""
        held_slot = False
        with self._lock:
            w = session.meta.get("worker")
            if w is not None and self._slot_sid.get(w) == session.sid:
                self._slot_sid.pop(w, None)
                if 0 <= w < len(self.addresses):
                    self.addresses[w] = ""   # slot freed for rejoin
                held_slot = True
        self._purge_session(session.sid)
        if held_slot and not self._closing.is_set():
            # only a session that actually HELD a worker slot counts as
            # a worker death — an authed peer with an invalid or
            # superseded hello never represented capacity
            self.counters["worker_deaths"] += 1
            self.stats.incr("worker_deaths")

    def _purge_session(self, sid: str) -> None:
        """Drop every route and ack waiter still pointing at ``sid``."""
        with self._lock:
            for r in [r for r, entry in self._route.items()
                      if entry[0] == sid]:
                self._route.pop(r, None)
            dead_acks = [r for r, (_, s) in self._acks.items()
                         if s == sid]
            waiters = [self._acks.pop(r)[0] for r in dead_acks]
        for waiter in waiters:
            waiter.response = False
            waiter.event.set()

    def _sweep_routes_locked(self) -> None:
        """Drop routes whose worker-side handler must be gone: a live
        handler expires its rid at ``reply_timeout``; entries older
        than twice that (+ grace) mean the expire never arrived (wedged
        worker handler thread).  Called under ``self._lock``."""
        horizon = time.monotonic() - (2 * self._reply_timeout
                                      + self._sweep_grace)
        stale = [r for r, entry in self._route.items()
                 if entry[1] < horizon]
        for r in stale:
            del self._route[r]
        if stale:
            log.warning("serving: swept %d orphaned reply routes",
                        len(stale))

    @property
    def request_queue(self) -> "queue.Queue[Tuple[str, Any, float]]":
        return self.queue

    def get_batch(self, max_rows: int = 64, timeout: float = 0.05
                  ) -> List[Tuple[str, Any]]:
        """Micro-batch pull as legacy ``(rid, payload)`` 2-tuples; the
        enqueue stamps stay on the raw queue for the scoring engine."""
        batch: List[Tuple[str, Any]] = []
        try:
            batch.append(self.queue.get(timeout=timeout)[:2])
            while len(batch) < max_rows:
                batch.append(self.queue.get_nowait()[:2])
        except queue.Empty:
            pass
        return batch

    def _reply_session(self, rid: str):
        """Pop the route for ``rid`` and return ``(live session, trace
        id)``, or ``(None, None)``.  A session that is down RIGHT NOW
        reports undelivered immediately (the old fail-fast contract):
        if the worker is merely mid-blip it re-parks the request on
        resume and the engine scores it again — at-least-once scoring,
        with exactly-once CLIENT delivery still decided atomically by
        the socket owner."""
        with self._lock:
            entry = self._route.pop(rid, None)
        if entry is None:
            return None, None
        session = self._ts.sessions.get(entry[0])
        if session is None or not session.connected:
            return None, None
        return session, entry[2]

    @staticmethod
    def _binary_value_ok(v) -> bool:
        """Can this reply value ride the raw-float32 block?  Only
        values that are ALREADY float32 (the predictor hot path's
        margin dtype) — anything wider (python floats, float64
        transform columns) or integer would be silently narrowed, so
        those keep the exact JSON path, as do error dicts, strings and
        object columns."""
        if isinstance(v, (np.ndarray, np.generic)):
            a = np.asarray(v)
            # size cap mirrors the wire's u16 n_values field, so the
            # pack cannot fail after classification
            return a.dtype == np.float32 and a.size <= 0xFFFF
        return False

    def reply(self, request_id: str, response: Any,
              status: int = 200) -> bool:
        """Route a reply to the worker PROCESS holding the socket; blocks
        on that worker's delivered/undelivered ack (the socket owner
        decides atomically, so a reply racing the worker-side timeout
        reports exactly what the client saw)."""
        session, tid = self._reply_session(request_id)
        if session is None:
            return False
        waiter = _Pending()
        with self._lock:
            self._acks[request_id] = (waiter, session.sid)
        try:
            sent_binary = False
            if (status == 200 and session.peer_binary
                    and self._binary_value_ok(response)):
                try:
                    session.send_bytes(
                        CH_SCORING,
                        wire.pack_replies([(request_id, response)]))
                    sent_binary = True
                except ValueError:
                    # a value that refuses to pack (e.g. >u16 floats)
                    # falls back to the JSON frame, like reply_many
                    sent_binary = False
            if not sent_binary:
                session.send(CH_SCORING,
                             {"op": "reply", "rid": request_id,
                              "response": _jsonable(response),
                              "status": status},
                             tc={"tid": tid})
        except OSError:
            # worker session closed between park and reply: undelivered
            with self._lock:
                self._acks.pop(request_id, None)
            return False
        if not waiter.event.wait(self._reply_timeout + self._ack_grace):
            with self._lock:
                self._acks.pop(request_id, None)
            return False
        return bool(waiter.response)

    def reply_many(self, entries: List[Tuple[str, Any, int]]) -> int:
        """Pipelined batch reply: send every reply frame first, then
        collect the delivery acks — one exchange round-trip for the
        whole micro-batch instead of a blocking RTT per row.

        Binary-negotiated sessions get their whole micro-batch as ONE
        raw-float32 reply block serialized straight from the margin
        values (no ``tolist()``, no per-row JSON frames) and answer
        with one batched ``ack_many``; error replies and non-binary
        sessions keep the per-row JSON frames (the negotiated
        fallback/error path)."""
        waiting: List[Tuple[str, _Pending]] = []
        #: session.sid -> (session, [(rid, value), ...]) — one binary
        #: block per (session, batch)
        bin_groups: Dict[str, Tuple[Any, List[Tuple[str, Any]]]] = {}
        for rid, response, status in entries:
            session, tid = self._reply_session(rid)
            if session is None:
                continue
            waiter = _Pending()
            with self._lock:
                self._acks[rid] = (waiter, session.sid)
            if (status == 200 and session.peer_binary
                    and self._binary_value_ok(response)):
                bin_groups.setdefault(
                    session.sid, (session, []))[1].append(
                        (rid, response))
                waiting.append((rid, waiter))
                continue
            try:
                session.send(CH_SCORING,
                             {"op": "reply", "rid": rid,
                              "response": _jsonable(response),
                              "status": status},
                             tc={"tid": tid})
            except OSError:
                with self._lock:
                    self._acks.pop(rid, None)
                continue
            waiting.append((rid, waiter))
        dead: set = set()
        for session, items in bin_groups.values():
            try:
                session.send_bytes(CH_SCORING,
                                   wire.pack_replies(items))
            except (OSError, ValueError):
                # session died (or a value refused to pack): those
                # waiters are undelivered NOW, not after the ack wait
                with self._lock:
                    for rid, _v in items:
                        self._acks.pop(rid, None)
                        dead.add(rid)
        delivered = 0
        deadline = time.monotonic() + self._reply_timeout \
            + self._ack_grace
        for rid, waiter in waiting:
            if rid in dead:
                continue
            if waiter.event.wait(max(0.0, deadline - time.monotonic())) \
                    and bool(waiter.response):
                delivered += 1
            else:
                with self._lock:
                    self._acks.pop(rid, None)
        return delivered

    def stop(self) -> None:
        self._closing.set()    # supervisor + beacon wind down
        for session in list(self._ts.sessions.values()):
            try:
                session.send(CH_CONTROL, {"op": "stop"}, timeout=1.0)
            except OSError:
                pass
        for p in self._procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
        self._ts.stop()
        if self._proc_supervisor is not None:
            self._proc_supervisor.join(timeout=5)
            self._proc_supervisor = None
        if self._ready_beacon is not None:
            self._ready_beacon.join(timeout=5)
            self._ready_beacon = None


def request_table(batch: List[Tuple[str, Any]]) -> DataTable:
    """(id, payload) micro-batch → table with ``id`` + payload columns.

    Dict payloads with shared keys become real columns (vector columns for
    list values); anything else lands in a ``value`` object column.
    Entries may be ``(rid, payload)`` or the stamped ``(rid, payload,
    t_enqueue)`` triples the resilience-aware queue carries.

    Binary-wire payloads (float32 row views /
    :class:`~mmlspark_tpu_torch.io.wire.BinaryReq`) are converted
    back to ``{"features": [...]}`` dicts here so a TRANSFORM-mode
    engine behind the binary exchange keeps its column contract — the
    per-value cost lands only on this legacy path, never on the
    predictor hot path (which consumes the views directly).
    """
    ids = np.asarray([e[0] for e in batch], dtype=object)
    payloads = [e[1] for e in batch]
    payloads = [
        {"features": (p.X if isinstance(p, wire.BinaryReq)
                      else p).ravel().tolist()}
        if isinstance(p, (np.ndarray, wire.BinaryReq)) else p
        for p in payloads]
    cols: Dict[str, Any] = {"id": ids}
    if payloads and all(isinstance(p, dict) for p in payloads):
        keys = set(payloads[0])
        for p in payloads[1:]:
            keys &= set(p)
        for k in sorted(keys):
            vals = [p[k] for p in payloads]
            if all(isinstance(v, (list, tuple)) for v in vals):
                try:
                    cols[k] = np.asarray(vals, dtype=np.float64)
                    continue
                except (ValueError, TypeError):
                    pass
            arr = np.empty(len(vals), dtype=object)
            arr[:] = vals
            cols[k] = arr
    else:
        arr = np.empty(len(payloads), dtype=object)
        arr[:] = payloads
        cols["value"] = arr
    return DataTable(cols)


def reply_from_table(server: HTTPServer, table: DataTable,
                     reply_col: str, id_col: str = "id") -> int:
    """Route one reply per row back through the server; returns #delivered."""
    delivered = 0
    ids = table[id_col]
    vals = table[reply_col]
    for rid, v in zip(ids, vals):
        if isinstance(v, np.ndarray):
            v = v.tolist()
        elif isinstance(v, np.generic):
            v = v.item()
        if server.reply(str(rid), v):
            delivered += 1
    return delivered


def serve_forever(server: HTTPServer,
                  transform: Callable[[DataTable], DataTable],
                  reply_col: str, max_rows: int = 64,
                  stop_event: Optional[threading.Event] = None) -> None:
    """Micro-batch loop: accumulate → transform → route replies.

    Thin shim over :class:`~mmlspark_tpu_torch.io.scoring.ScoringEngine` in
    legacy transform mode: one worker with inline replies is exactly the
    old loop's thread shape, and the small 2 ms batch budget
    approximates its drain-what's-queued behavior, so lone requests keep
    their sub-poll latency.  Kept so existing callers and notebooks run
    unchanged; new code should construct a ``ScoringEngine`` directly
    for the pipelined hot path (deadline batching knobs, padded
    buckets, stage stats)."""
    from .scoring import ScoringEngine
    engine = ScoringEngine(server, transform=transform,
                           reply_col=reply_col, max_rows=max_rows,
                           latency_budget_ms=2.0, num_scorers=1,
                           num_repliers=0, on_error="raise")
    engine.serve(stop_event)
