"""Pipelined micro-batch scoring engine — the serving hot path.

The port's copy of ``mmlspark_tpu/io/scoring.py``.  A serial loop (one
thread: blocking ``get_batch`` → JSON/dict decode → predict → reply)
makes socket I/O, Python decode and the scorer wait on each other.  This
module uses the canonical serving-throughput levers (Clipper, Crankshaw
et al. 2017; Spark Serving's micro-batch trigger):

* **Deadline-aware batching** — a batch closes when ``max_rows`` is
  reached OR the oldest parked request exceeds ``latency_budget_ms``,
  instead of a fixed poll.  Bursts fill big batches immediately; a lone
  request waits at most the budget.
* **Power-of-two padded buckets** — feature matrices for a device walk
  are padded to the next power-of-two row count before scoring, as the
  reference pads them to bound its compile cache, so the engine sees the
  reference's batches (results are sliced back before reply).
* **One device→host copy a batch** — the port's predictor returns its
  margins as a tensor on the booster's device (the card's walk on a CUDA
  booster, the native scorer's on a CPU one); the engine brings each
  batch's margins to the host in one explicit copy
  (:func:`_host_margins`), whatever the device.  With the profiler on,
  ``dispatch_host`` is the host time until the walk's launches return
  and ``device_wait`` the wait until that copy completes.
* **Pipelining** — N workers each form (serialized by a lock), decode,
  and score batches: while one worker waits on the card's walk (or is
  inside the GIL-releasing native scorer), another accumulates and
  decodes the next batch, and an optional replier thread routes the
  previous batch's responses (the reply path of the multiprocess
  topology blocks on cross-process acks).
* **Instrumentation** — every stage (batch forming, queue wait, decode,
  score, reply, end-to-end) records into
  :class:`~mmlspark_tpu_torch.core.profiling.StageStats`; ``stats_snapshot()``
  exposes rows/s and p50/p99 counters, the numbers
  ``tools/bench_serving.py`` commits as a BENCH artifact.

On top of the fast path sits the **resilience layer** (the reference's
operational story — executor restarts, socket allreduce recovery —
applied to serving, SURVEY.md §5.3):

* **Admission control / load shedding** — ``max_queue_depth`` bounds
  intake: once the parked-request queue exceeds it, the overflow gets
  an explicit ``503 {"error": "shed"}`` instead of unbounded queueing;
  ``shed_wait_ms`` sheds requests that already waited past the budget.
  Shedding drops from the HEAD of the queue (the oldest requests are
  the ones closest to their deadlines — answering them late helps
  nobody, while the fresh arrivals behind them can still make their
  SLO).
* **Per-request deadlines** — ``deadline_ms`` (overridable per request
  via a ``_deadline_ms`` payload key) rejects expired requests with
  ``504 {"error": "expired"}`` at batch-close time, BEFORE scoring —
  an expired request never burns a batch slot.
* **Worker supervision + per-row salvage** — a scoring worker that
  crashes (anything escaping the per-batch handler, including the
  chaos harness's :class:`WorkerKilled`) is restarted in place, and
  the batch it held is salvaged row by row: rows that score get their
  real answers, so one poison payload fails only its own request.  A
  batch-level predictor exception takes the same per-row salvage path.
  A supervisor thread additionally respawns any thread that truly
  died.
* **Graceful drain** — ``stop(drain=True)`` finishes the queued and
  in-flight work (bounded by a timeout) before the workers exit, so a
  rolling restart answers what it already accepted.

Every degradation is counted: ``stats_snapshot()["counters"]`` always
carries ``shed`` / ``expired`` / ``salvaged`` / ``restarted`` (seeded to
zero), the numbers ``tools/chaos_serving.py`` asserts on.

The fast decode path is :class:`ColumnPlan`: the payload-key → feature-
column mapping is resolved ONCE, so each batch becomes one contiguous
float32 matrix build instead of per-row dict walks through
``request_table``.

Works with any server exposing the exchange contract
(:class:`~mmlspark_tpu_torch.io.serving.HTTPServer`,
:class:`~mmlspark_tpu_torch.io.serving.DistributedHTTPServer`,
:class:`~mmlspark_tpu_torch.io.serving.MultiprocessHTTPServer`).  Queue items
may be ``(rid, payload)`` or ``(rid, payload, t_enqueue)`` — the
in-repo exchanges stamp enqueue time so wait-shedding and deadlines
measure true queue age; unstamped items age from first dequeue.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..core.capacity import capacity_enabled, ensure_capacity_sampler
from ..core.profiler import get_profiler
from ..core.profiling import StageStats
from ..core.schema import DataTable
from ..core.telemetry import get_journal, get_registry, record_flight
from .wire import BinaryReq

log = logging.getLogger(__name__)


class WorkerKilled(BaseException):
    """Chaos/test hook: raised inside a scoring worker to simulate the
    thread dying (a ``BaseException`` so the per-batch ``except
    Exception`` handler does NOT absorb it — it escapes to the worker
    shell exactly like a real crash would)."""


def _host_margins(raw, n: int) -> np.ndarray:
    """The first ``n`` margins of a scorer's result as a host ndarray: a
    tensor (on the card or the CPU) is sliced and brought over in ONE
    explicit device→host copy, which waits for the walk; anything else
    (the native scorer's arrays, a plain callable's lists) goes through
    ``np.asarray`` as in the reference."""
    if isinstance(raw, torch.Tensor):
        return raw[:n].detach().cpu().numpy()
    return np.asarray(raw)[:n]


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (bucket ladder for padded scoring)."""
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


class ColumnPlan:
    """Pre-resolved request → float32 feature-matrix decode plan.

    Two layouts, resolved once at construction instead of per batch:

    * ``features="features"`` — each payload carries one key holding a
      length-``num_features`` list (the reference's vector-column
      serving contract).
    * ``features=["f0", "f1", ...]`` — each payload carries one scalar
      per named key; columns are assembled in the given order.

    ``decode`` builds the contiguous ``(n, f)`` float32 matrix straight
    from the payload list — no intermediate :class:`DataTable`, no
    per-row dict-intersection walk.  ``decode_table`` covers callers
    that already hold a table.

    Binary wire: payloads may also be float32 row views
    (``np.ndarray`` or :class:`~mmlspark_tpu_torch.io.wire.BinaryReq`) — the
    negotiated raw-float32 wire's ``np.frombuffer`` output.  A batch of
    those assembles with one ``np.concatenate`` (a single-row batch is
    ZERO-copy: the view passes straight through), with the same width
    validation the JSON paths get.  Column order on the binary wire is
    the model's canonical feature order — the identical contract the
    JSON ``features`` vector already used.
    """

    def __init__(self, features: Union[str, Sequence[str]] = "features",
                 num_features: Optional[int] = None):
        if isinstance(features, str):
            self.vector_key: Optional[str] = features
            self.scalar_keys: Tuple[str, ...] = ()
        else:
            self.vector_key = None
            self.scalar_keys = tuple(features)
            if num_features is not None \
                    and num_features != len(self.scalar_keys):
                raise ValueError(
                    f"num_features={num_features} but plan names "
                    f"{len(self.scalar_keys)} scalar columns")
            num_features = len(self.scalar_keys)
        self.num_features = num_features

    def decode(self, payloads: List[Any]) -> np.ndarray:
        """Payload dicts (or binary row views) → C-contiguous ``(n, f)``
        float32 matrix.  A mixed JSON/binary batch takes the engine's
        per-row salvage path (each singleton re-enters here and picks
        its own layout)."""
        if payloads and isinstance(payloads[0], (np.ndarray, BinaryReq)):
            return self.decode_binary(payloads)
        if self.vector_key is not None:
            key = self.vector_key
            X = np.asarray([p[key] for p in payloads], dtype=np.float32)
            if X.ndim != 2:
                raise ValueError(
                    f"payload key {key!r} must hold fixed-length "
                    f"vectors; got ragged/scalar values")
        else:
            X = np.empty((len(payloads), len(self.scalar_keys)),
                         dtype=np.float32)
            for j, key in enumerate(self.scalar_keys):
                X[:, j] = [p[key] for p in payloads]
        if self.num_features is not None \
                and X.shape[1] != self.num_features:
            raise ValueError(
                f"decoded {X.shape[1]} features, model expects "
                f"{self.num_features}")
        return np.ascontiguousarray(X)

    def decode_binary(self, payloads: List[Any]) -> np.ndarray:
        """Binary-wire fast path: each payload is already a float32
        ``(r, f)`` view (``np.frombuffer`` output of
        :func:`~mmlspark_tpu_torch.io.wire.unpack_matrix`); a multi-entry
        batch is ONE ``np.concatenate``, a single entry passes through
        zero-copy.  No JSON, no per-value Python objects."""
        rows = [p.X if isinstance(p, BinaryReq) else p for p in payloads]
        X = rows[0] if len(rows) == 1 else np.concatenate(rows, axis=0)
        if not isinstance(X, np.ndarray) or X.ndim != 2 \
                or X.dtype != np.float32:
            raise ValueError(
                "binary payloads must be (r, f) float32 row blocks")
        if self.num_features is not None \
                and X.shape[1] != self.num_features:
            raise ValueError(
                f"decoded {X.shape[1]} features, model expects "
                f"{self.num_features}")
        return X

    def decode_table(self, table: DataTable) -> np.ndarray:
        """Same plan applied to an already-built :class:`DataTable`."""
        if self.vector_key is not None:
            col = table[self.vector_key]
            if col.dtype == object:
                X = np.asarray([np.asarray(v, np.float32) for v in col],
                               dtype=np.float32)
            else:
                X = np.asarray(col, np.float32)
        else:
            X = np.column_stack(
                [np.asarray(table[k], np.float32)
                 for k in self.scalar_keys])
        return np.ascontiguousarray(X.astype(np.float32, copy=False))


def _json_value(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    return v


class ScoringEngine:
    """Deadline-batched, pipelined scoring over a serving exchange.

    Two scoring modes (exactly one of ``predictor``/``transform``):

    * ``predictor`` — the hot path: a callable ``(n, f) float32 ->
      margins`` (typically ``Booster.predictor()``), fed by a
      :class:`ColumnPlan` fast decode, with power-of-two padded buckets.
      Each reply body is the row's score (scalar for single-class, list
      for multiclass), or whatever ``reply_fn(values) -> list`` builds.
    * ``transform`` — legacy-compatible: a ``DataTable -> DataTable``
      callable; the batch goes through
      :func:`~mmlspark_tpu_torch.io.serving.request_table` and replies come
      from ``reply_col``, exactly like the old ``serve_forever`` body.

    Threads: ``num_scorers`` pipeline workers and ``num_repliers``
    repliers.  Each worker forms its own batch (one former at a time,
    serialized by a lock — deadline semantics preserved), then decodes
    and scores it; while one worker is inside the GIL-releasing native
    kernel, another holds the form lock accumulating the next batch.
    Forming in the scorer thread instead of a dedicated batcher saves a
    bounded-queue hop per batch — two thread wakeups that measurably
    cost throughput at saturation on small hosts.  Repliers are
    separate because ``MultiprocessHTTPServer.reply`` blocks on a
    cross-process ack; ``num_repliers=0`` replies inline on the worker
    (the right choice for in-process exchanges with non-blocking
    ``reply_many`` — and what the ``serve_forever`` shim uses to match
    the old loop's shape exactly).  The reply queue is bounded: when
    repliers fall behind, workers stop pulling and requests
    back-pressure into the exchange queue.

    Resilience knobs (all off/None by default except supervision — the
    fast path is unchanged unless asked):

    * ``max_queue_depth`` — shed (503) the oldest queued requests
      whenever the backlog exceeds this after forming a batch.
    * ``shed_wait_ms`` — shed (503) any request that already waited
      longer than this when a batch closes.
    * ``deadline_ms`` — expire (504) any request older than this at
      batch-close time; a ``_deadline_ms`` payload key overrides it per
      request.  Expired rows are rejected BEFORE scoring.
    * ``supervise`` — run the supervisor thread that respawns worker or
      replier threads that died (the in-place restart on a crash
      happens regardless; see :meth:`_worker_shell`).
    """

    RESILIENCE_COUNTERS = ("shed", "expired", "salvaged", "restarted")

    def __init__(self, server, *,
                 predictor: Optional[Callable] = None,
                 plan: Optional[ColumnPlan] = None,
                 transform: Optional[Callable[[DataTable], DataTable]]
                 = None,
                 reply_col: str = "prediction",
                 max_rows: int = 256,
                 latency_budget_ms: float = 5.0,
                 num_scorers: int = 2,
                 num_repliers: int = 1,
                 queue_depth: int = 8,
                 pad_buckets: Optional[bool] = None,
                 reply_fn: Optional[Callable[[np.ndarray], List[Any]]]
                 = None,
                 on_error: str = "reply",
                 max_queue_depth: Optional[int] = None,
                 shed_wait_ms: Optional[float] = None,
                 deadline_ms: Optional[float] = None,
                 supervise: bool = True,
                 stats: Optional[StageStats] = None,
                 drift_monitor=None,
                 ingest_tap: Optional[Callable] = None):
        if (predictor is None) == (transform is None):
            raise ValueError(
                "pass exactly one of predictor= (hot path) or "
                "transform= (DataTable->DataTable legacy path)")
        if on_error not in ("reply", "raise"):
            raise ValueError("on_error must be 'reply' (500 the batch, "
                             "keep serving) or 'raise' (stop and "
                             "re-raise from serve())")
        if predictor is not None and plan is None:
            # wire the predictor's known width into the auto plan so a
            # wrong-width payload fails at decode time as a per-row 400
            # instead of blowing up the whole batch at score time and
            # coming back as salvage-path 500s
            plan = ColumnPlan(
                num_features=getattr(predictor, "num_features", None))
        if pad_buckets is None:
            # the reference pads for a bounded compile cache on its
            # jitted walk; the port pads the device walk alike, so the
            # engine's batches are the reference's.  The native scorer
            # is not padded.  Unknown callables (no .mode) are assumed
            # jit-like and padded.
            pad_buckets = getattr(predictor, "mode", "jit") != "native"
        # rid-routed predictors (the RolloutController's blue/green
        # traffic splitter): the engine hands the batch's
        # request ids alongside the matrix so the split is per-request
        # and retry-stable.  Engine-level padding is disabled — padded
        # phantom rows have no rid to route; the splitter pads each
        # arm's sub-batch itself.
        self._routed = bool(getattr(predictor, "routes_by_rid", False))
        if self._routed:
            pad_buckets = False
        self._server = server
        self._predictor = predictor
        self._plan = plan
        self._transform = transform
        self._reply_col = reply_col
        self._max_rows = int(max_rows)
        self._budget = float(latency_budget_ms) / 1e3
        self._num_scorers = max(1, int(num_scorers))
        self._num_repliers = max(0, int(num_repliers))
        self._pad_buckets = bool(pad_buckets)
        self._reply_fn = reply_fn
        # binary-wire reply mode: when the exchange can ship
        # raw margin blocks (MultiprocessHTTPServer.binary_wire), reply
        # values stay numpy — sliced straight off the margin ndarray —
        # and the per-row tolist()/_json_value builds are skipped; the
        # exchange serializes per session (binary frame or negotiated
        # JSON fallback) at delivery time
        self._ndarray_replies = bool(getattr(server, "binary_wire",
                                             False)) \
            and reply_fn is None
        self._on_error = on_error
        self._max_queue_depth = (None if max_queue_depth is None
                                 else int(max_queue_depth))
        self._shed_wait = (None if shed_wait_ms is None
                           else float(shed_wait_ms) / 1e3)
        self._deadline = (None if deadline_ms is None
                          else float(deadline_ms) / 1e3)
        self._supervise = bool(supervise)
        # streaming data-quality sketches: when a
        # DriftMonitor is attached, every scored batch is offered to it
        # (decoded float32 rows + margins) behind the monitor's own
        # duty-cycle gate; with no monitor the hot path pays ONE
        # attribute check per batch.  start() installs it process-wide
        # (ns="drift" + the mmlspark_tpu_drift_* exposition) so the
        # SLO drift objectives and the worker stats beacon see it.
        self._drift = drift_monitor
        # streaming-ingest tap: called with every scored
        # batch's decoded rows + margins, AFTER the reply-side work is
        # queued conceptually (same placement as the drift observe).
        # The deployment decides what a "label" is at this point —
        # typically enqueue features keyed by rid until ground truth
        # arrives; the drills append with labels they know.  Advisory
        # like the drift tap: a raising tap is counted and dropped,
        # never an answer lost.  Deliberately SYNCHRONOUS, unlike the
        # duty-gated drift sketches: the tap must see 100% of rows (it
        # is the training feed), and on the small hosts this serves
        # from, a handoff queue + drain thread costs more in wakeup
        # churn than the bin+append it would hide (no-op async tap
        # measured 5.6% p50 on 1 core vs 0.04% inline; the spill fsync
        # is amortized over segment_rows).
        self._ingest_tap = ingest_tap
        self._fatal: Optional[BaseException] = None
        self._died = threading.Event()
        self.stats = stats or StageStats()
        for name in self.RESILIENCE_COUNTERS:
            self.stats.incr(name, 0)     # observable zeros
        self._journal = get_journal()
        # continuous-profiler wiring, zero-overhead flavor:
        # the stage histograms this engine ALREADY records are ALIASED
        # into the profile view (shared LatencyStats objects), so the
        # scoring.* phases cost nothing extra per batch; only the
        # dispatch bracketing in _score_matrix adds hot-path work, on
        # pre-resolved timers behind one `enabled` check
        self._prof = get_profiler()
        # pre-resolved stage timers: the pipeline records through these
        # with OUTER windows (decode covers payload extraction, score
        # covers result assembly, reply covers the whole delivery), so
        # the named phases tile the e2e wall time — the perf_report
        # >=90%-attributed acceptance bar depends on this tiling
        self._pt_form = self.stats.timer("batch_form")
        self._pt_decode = self.stats.timer("decode")
        self._pt_score = self.stats.timer("score")
        self._pt_reply = self.stats.timer("reply")
        self._pt_e2e = self.stats.timer("e2e")
        self._pt_queue_wait = self.stats.timer("queue_wait")
        self._prof.alias("scoring.form", self._pt_form)
        self._prof.alias("scoring.decode", self._pt_decode)
        self._prof.alias("scoring.score", self._pt_score)
        self._prof.alias("scoring.reply", self._pt_reply)
        self._prof.alias("scoring.e2e", self._pt_e2e)
        self._prof.alias("scoring.queue_wait", self._pt_queue_wait)
        # saturation taps: the enabled flag is CACHED here —
        # per-batch tap sites pay one attribute check when capacity
        # observability is off (the sentinel A/B constructs a fresh
        # engine per arm, so flipping capacity.configure() between
        # bursts is the whole switch).  queue_age records the batch-max
        # true queue age at admission (stamped exchanges only): the
        # capacity monitor's knee estimator reads its windowed p50 —
        # queueing delay is where saturation shows first, and e2e
        # deliberately excludes it
        self._cap_taps = capacity_enabled()
        self._pt_queue_age = self.stats.timer("queue_age")
        self._prof.alias("scoring.queue_age", self._pt_queue_age)
        # journaling is hot-path work too: attributing it explicitly
        # is what lets perf_report explain >=90% of e2e instead of
        # showing an anonymous gap
        self._pt_trace = self.stats.timer("trace")
        self._prof.alias("scoring.trace", self._pt_trace)
        # engine-owned like every other stage (newest engine wins the
        # profile view) — a process-lifetime accumulator here would mix
        # windows with the per-engine e2e and break the attribution
        self._pt_disp_host = self.stats.timer("dispatch_host")
        self._pt_disp_wait = self.stats.timer("device_wait")
        self._prof.alias("scoring.dispatch_host", self._pt_disp_host)
        self._prof.alias("scoring.device_wait", self._pt_disp_wait)
        self._reply_q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._threads: List[threading.Thread] = []
        self._supervisor_thread: Optional[threading.Thread] = None
        self._form_lock = threading.Lock()   # one batch former at a time
        self._inflight = 0          # batches being decoded/scored
        self._inflight_lock = threading.Lock()
        # worker slot -> (batch, t_first) being scored; the supervisor /
        # worker shell salvages this when the worker crashes mid-batch
        self._current: dict = {}
        self._reply_many = getattr(server, "reply_many", None)
        self._request_q = getattr(server, "request_queue", None)
        if self._request_q is None:  # duck-typed custom servers
            exchange = getattr(server, "_exchange", None)
            self._request_q = getattr(exchange, "queue", None)
        self._get_batch = None
        if self._request_q is None:
            # legacy duck type (pre-engine serve_forever contract): a
            # server exposing only get_batch()/reply() still works —
            # batches form through pulls instead of raw queue reads
            self._get_batch = getattr(server, "get_batch", None)
            if self._get_batch is None:
                raise TypeError(
                    "server must expose request_queue, _exchange.queue, "
                    "or the legacy get_batch() contract")

    # -- tracing -------------------------------------------------------------

    @staticmethod
    def _tid(entry) -> str:
        """A request's trace id: the ``_trace_id`` its client sent in
        the payload, else the request id (minted at admission by the
        exchange) — every request is traceable without client opt-in,
        and a client-chosen id survives the worker hop because it rides
        the payload."""
        payload = entry[1]
        if isinstance(payload, dict):
            tid = payload.get("_trace_id")
            if tid:
                return str(tid)
        return str(entry[0])

    def _trace(self, ev: str, batch, **fields) -> None:
        """Journal one per-batch pipeline event carrying the batch's
        request ids and trace ids — ``tools/trace_report.py`` stitches
        these into per-request form→decode→score→reply timelines.
        The emit cost (id-list builds + ring insert) is itself timed
        into the ``trace`` stage / ``scoring.trace`` phase."""
        t0 = time.perf_counter()
        self._journal.emit(ev, rids=[str(e[0]) for e in batch],
                           trace_ids=[self._tid(e) for e in batch],
                           **fields)
        self._pt_trace.record(time.perf_counter() - t0)

    # -- batch forming -------------------------------------------------------

    @staticmethod
    def _norm(item, now: Optional[float] = None
              ) -> Tuple[str, Any, float]:
        """Queue items are ``(rid, payload)`` or ``(rid, payload,
        t_enqueue)``; unstamped items age from first dequeue."""
        if len(item) >= 3:
            return item[0], item[1], item[2]
        return item[0], item[1],  \
            now if now is not None else time.perf_counter()

    def _form_batch(self) -> Optional[
            Tuple[List[Tuple[str, Any, float]], float,
                  List[Tuple[str, Any, int]]]]:
        """Adaptive, deadline-aware close.  A batch closes when:

        * ``max_rows`` requests are aboard (size cap), or
        * the batch has been open for ``latency_budget`` (deadline), or
        * the queue is dry AND no other worker is scoring a batch
          (work-conserving: holding requests to fill a batch only pays
          while the pipeline couldn't start them anyway — if every
          scorer is idle, shipping now costs nothing and saves the
          wait).

        The budget clock starts when the batch OPENS (first dequeue) —
        for exchanges that stamp enqueue time the shed/deadline checks
        additionally see true queue age; for unstamped items (bare
        2-tuples) age starts at dequeue and the ``e2e`` stat excludes
        queueing delay (the benchmark's client-side percentiles capture
        it).

        Admission control runs at batch close: overflow past
        ``max_queue_depth`` is shed from the queue head, then each
        formed row is checked against its deadline (expired → 504,
        never scored) and the wait budget (over → 503 shed).

        Returns ``(live_batch, t_first, error_replies)``; ``None`` on
        an idle poll tick.  ``error_replies`` are the shed/expired
        ``(rid, body, status)`` entries — delivered by the CALLER after
        the form lock is released, because the multiprocess reply path
        blocks on cross-process acks and must not stall every other
        former."""
        if self._request_q is None:
            return self._form_batch_pulling()
        q = self._request_q
        try:
            first = q.get(timeout=0.05)
        except queue.Empty:
            return None
        t_first = time.perf_counter()
        batch: List[Tuple[str, Any, float]] = []
        shed: List[Tuple[str, Any, float]] = []
        try:
            batch.append(self._norm(first, t_first))
            deadline = t_first + self._budget
            while len(batch) < self._max_rows:
                try:
                    batch.append(self._norm(q.get_nowait()))
                    continue
                except queue.Empty:
                    pass
                now = time.perf_counter()
                if now >= deadline:
                    break
                with self._inflight_lock:
                    busy = self._inflight > 0
                if not busy:
                    break    # scorers idle: ship immediately
                try:
                    batch.append(self._norm(
                        q.get(timeout=min(deadline - now, 1e-3))))
                except queue.Empty:
                    continue
            qsize = getattr(q, "qsize", None)
            if self._max_queue_depth is not None and qsize is not None:
                # bounded intake: the backlog beyond the bound is shed
                # NOW with an explicit reply instead of queueing
                # unboundedly.  Dropping from the head sheds the oldest
                # waiters — the requests closest to their deadlines.
                while qsize() > self._max_queue_depth:
                    try:
                        shed.append(self._norm(q.get_nowait()))
                    except queue.Empty:
                        break
            if self._cap_taps:
                # batch-close saturation taps: the residual
                # backlog after this batch formed, and how full the
                # batch is against its row cap — both per BATCH, not
                # per row
                if qsize is not None:
                    try:
                        self.stats.set_gauge("queue_depth",
                                             float(qsize()))
                    except (NotImplementedError, OSError):
                        pass
                self.stats.set_gauge(
                    "batch_occupancy",
                    round(len(batch) / max(1, self._max_rows), 4))
            live, errors = self._admit(batch, shed)
        except Exception:  # noqa: BLE001 - form-path bug / bad item
            # rows already pulled off the queue MUST still get replies:
            # without this, a forming crash (malformed queue item, a
            # duck-typed queue quirk) silently drops them and their
            # clients hang until the handler timeout
            return [], t_first, self._error_all(batch + shed)
        return live, t_first, errors

    def _form_batch_pulling(self) -> Optional[
            Tuple[List[Tuple[str, Any, float]], float,
                  List[Tuple[str, Any, int]]]]:
        """Same close policy over the legacy ``get_batch()`` contract
        (servers that expose no raw queue; no depth-based shedding —
        the queue is invisible here, but wait/deadline checks apply)."""
        pulled = self._get_batch(self._max_rows, 0.05)
        if not pulled:
            return None
        t_first = time.perf_counter()
        batch: List[Tuple[str, Any, float]] = []
        try:
            batch = [self._norm(it, t_first) for it in pulled]
            deadline = t_first + self._budget
            while len(batch) < self._max_rows:
                now = time.perf_counter()
                if now >= deadline:
                    break
                with self._inflight_lock:
                    busy = self._inflight > 0
                if not busy:
                    break    # scorers idle: ship immediately
                batch += [self._norm(it, now) for it in
                          self._get_batch(self._max_rows - len(batch),
                                          min(deadline - now, 1e-3))]
            live, errors = self._admit(batch, [])
        except Exception:  # noqa: BLE001 - pulled rows must get replies
            return [], t_first, self._error_all(batch)
        return live, t_first, errors

    def _error_all(self, entries) -> List[Tuple[str, Any, int]]:
        """Last-resort 500s for rows stranded by a forming crash; an
        entry too malformed to even yield a request id is logged and
        dropped (nothing to address a reply to)."""
        log.exception("batch forming failed; erroring %d dequeued rows",
                      len(entries))
        errors = []
        for e in entries:
            try:
                errors.append((e[0], {"error": "scoring failed"}, 500))
            except Exception:  # noqa: BLE001 - unaddressable item
                log.warning("dropping unaddressable queue item %r", e)
        return errors

    def _admit(self, batch, shed):
        """Split a formed batch into live rows vs shed/expired ones and
        build the explicit degradation replies (503 shed / 504
        expired).  Runs at batch-close time, BEFORE any scoring — an
        expired request never burns a batch slot.  Returns
        ``(live, error_replies)``; the caller delivers the errors
        outside the form lock."""
        now = time.perf_counter()
        live, expired = [], []
        max_age = 0.0
        for entry in batch:
            rid, payload, t_enq = entry
            age = now - t_enq
            if age > max_age:
                max_age = age
            dl = self._deadline
            if isinstance(payload, dict) and "_deadline_ms" in payload:
                try:
                    dl = float(payload["_deadline_ms"]) / 1e3
                except (TypeError, ValueError):
                    pass
            elif isinstance(payload, BinaryReq) and payload.deadline_ms:
                # binary wire: the deadline rode the frame header (no
                # payload keys exist to carry it)
                try:
                    dl = float(payload.deadline_ms) / 1e3
                except (TypeError, ValueError):
                    pass
            if dl is not None and age > dl:
                expired.append(entry)
            elif self._shed_wait is not None and age > self._shed_wait:
                shed.append(entry)
            else:
                live.append(entry)
        if self._cap_taps and batch:
            # admission tap: one histogram insert per batch
            # with the WORST queue age aboard — true queue age for
            # stamped exchanges, ~0 for unstamped 2-tuples
            self._pt_queue_age.record(max_age)
        errors = []
        if shed:
            self.stats.incr("shed", len(shed))
            self._trace("shed", shed)
            errors += [(e[0], {"error": "shed"}, 503) for e in shed]
        if expired:
            self.stats.incr("expired", len(expired))
            self._trace("expired", expired)
            errors += [(e[0], {"error": "expired"}, 504)
                       for e in expired]
        return live, errors

    def _reply_errors(self, entries) -> None:
        """Deliver explicit degradation replies (shed/expired/crash) —
        no latency timers, these are not scored rows."""
        try:
            if self._reply_many is not None:
                self._reply_many(entries)
            else:
                for rid, body, status in entries:
                    self._server.reply(rid, body, status)
        except Exception:  # noqa: BLE001 - reply path must not kill form
            log.exception("failed delivering %d degradation replies",
                          len(entries))

    def _worker(self, slot: int) -> None:
        """Pipeline worker: form (serialized) → decode → score → reply
        (inline or handed to a replier)."""
        while True:
            with self._form_lock:
                if self._stop.is_set():
                    return
                formed = self._form_batch()
            if formed is None:
                if self._draining.is_set():
                    return   # drain mode: queue dry — exit cleanly
                continue
            batch, t_first, errors = formed
            if errors:
                # shed/expired replies, delivered OUTSIDE the form lock
                # (the multiprocess reply path blocks on acks)
                self._reply_errors(errors)
            if not batch:
                continue     # everything formed was shed/expired
            form_s = time.perf_counter() - t_first
            self._pt_form.record(form_s)
            self._trace("form", batch, rows=len(batch),
                        dur_ms=round(form_s * 1e3, 3))
            self._current[slot] = (batch, t_first)
            with self._inflight_lock:
                self._inflight += 1
                inflight = self._inflight
            if self._cap_taps:
                # scorer utilization at batch start: the fraction of
                # scorer slots busy the moment this batch shipped
                self.stats.set_gauge(
                    "worker_busy",
                    round(inflight / self._num_scorers, 4))
            try:
                if self._predictor is not None:
                    pairs = self._score_predictor(batch)
                else:
                    pairs = self._score_transform(batch)
            except Exception as e:  # noqa: BLE001
                if self._on_error == "raise":
                    # legacy serve_forever semantics: a transform bug
                    # stops the loop and surfaces from serve()
                    self._fatal = e
                    self._died.set()
                    self._stop.set()
                    return
                # hot-path semantics: a bad batch must not kill the
                # worker — salvage it row by row so one poison payload
                # fails only its own request
                log.exception("scoring batch of %d failed; salvaging "
                              "per-row", len(batch))
                pairs = self._salvage_batch(batch)
            finally:
                with self._inflight_lock:
                    self._inflight -= 1
            if self._num_repliers == 0:
                self._deliver(pairs, t_first)
            else:
                self._reply_q.put((pairs, t_first, time.perf_counter()))
            self._current.pop(slot, None)

    def _worker_shell(self, slot: int) -> None:
        """Crash boundary around :meth:`_worker`: anything escaping the
        per-batch handler (a :class:`WorkerKilled` chaos injection, a
        bug in the form/deliver path) restarts the worker in place
        after salvaging the batch it held — the engine's worker-
        supervision contract.  ``KeyboardInterrupt``/``SystemExit``
        still propagate."""
        while True:
            try:
                self._worker(slot)
                return                        # clean stop/drain exit
            except (KeyboardInterrupt, SystemExit):
                raise
            except BaseException as e:  # noqa: BLE001 - crash boundary
                if self._stop.is_set():
                    return
                log.exception("scoring worker %d crashed; restarting",
                              slot)
                self.stats.incr("restarted")
                inflight = self._current.pop(slot, None)
                # the restart erases the crash scene — capture it first
                # (throttled + rotated inside record_flight, so a
                # crash-looping worker cannot flood the disk)
                record_flight(
                    "scoring_worker_crash",
                    {"slot": slot, "error": repr(e),
                     "batch_rows": len(inflight[0]) if inflight else 0})
                if inflight is not None:
                    self._salvage_crashed(*inflight)

    def _salvage_crashed(self, batch, t_first: float) -> None:
        """Recover the batch a crashed worker held: score it row by row
        and deliver; a second crash during salvage fails the remaining
        rows with explicit 500s (bounded — a worker that dies on every
        call must not loop forever on one batch).  A crash after
        partial delivery can re-reply rows the exchange already
        routed; the exchange drops replies to popped ids, and the
        salvage re-scores the same rows so a double reply carries the
        identical value."""
        try:
            pairs = self._salvage_batch(batch)
            self._deliver(pairs, t_first)
        except BaseException:  # noqa: BLE001 - salvage must terminate
            log.exception("salvage of crashed batch failed; erroring "
                          "%d rows", len(batch))
            self._reply_errors([(e[0], {"error": "scoring failed"}, 500)
                                for e in batch])

    def _salvage_batch(self, batch):
        """Batch-level scoring failed: retry each row alone so only the
        poison row(s) fail.  Rows rescued this way count as
        ``salvaged``."""
        score_one = (self._score_predictor if self._predictor is not None
                     else self._score_transform)
        pairs, rescued = [], 0
        for entry in batch:
            try:
                row_pairs = score_one([entry])
            except Exception:  # noqa: BLE001 - this row is the poison
                pairs.append((entry[0], {"error": "scoring failed"},
                              500))
                continue
            # a 2-tuple result row scored; 3-tuples are decode 400s
            rescued += sum(1 for p in row_pairs if len(p) == 2)
            pairs.extend(row_pairs)
        if rescued:
            self.stats.incr("salvaged", rescued)
        self._trace("salvage", batch, rescued=rescued)
        return pairs

    def _supervisor(self) -> None:
        """Belt-and-braces thread supervision: the worker shell restarts
        crashes in place, but a thread that truly died (shell itself
        failed, replier crashed) is respawned here so capacity
        recovers."""
        while not self._stop.wait(0.2):
            if self._draining.is_set():
                continue     # drain exits are legitimate deaths
            for i, t in enumerate(self._threads):
                if t.is_alive() or self._stop.is_set():
                    continue
                scorer = i < self._num_scorers
                log.warning("%s thread %d found dead; respawning",
                            "scoring" if scorer else "replier", i)
                self.stats.incr("restarted")
                if scorer:
                    nt = threading.Thread(target=self._worker_shell,
                                          args=(i,),
                                          name=f"scoring-worker-{i}",
                                          daemon=True)
                else:
                    nt = threading.Thread(
                        target=self._replier,
                        name=f"scoring-replier-{i}", daemon=True)
                self._threads[i] = nt
                nt.start()

    # -- scoring -------------------------------------------------------------

    def _score_matrix(self, X: np.ndarray, n: int,
                      rids: Optional[List[str]] = None) -> List[Any]:
        """Pad to the power-of-two bucket, score, slice, format.
        Callers own the ``score`` stage bracket (their window also
        covers the per-batch result assembly, so the named phases tile
        the e2e wall time instead of leaking glue between brackets).
        For rid-routed predictors (``routes_by_rid``) the rids ride
        along so the splitter pins each row to its arm."""
        X_rows = X          # unpadded view for the drift sketches
        if self._pad_buckets:
            b = next_pow2(n)
            if b > n:
                Xp = np.zeros((b, X.shape[1]), np.float32)
                Xp[:n] = X
                X = Xp
        scorer = self._predictor
        if self._routed and rids is not None:
            def scorer(M, _p=self._predictor, _r=rids):  # noqa: E731
                return _p.score_routed(M, _r)
        if self._prof.enabled:
            # dispatch bracketing: host time until the scorer call
            # returns (the walk's launches are queued) vs the wait until
            # its margins reach the host, with the build-seq delta
            # classifying the dispatch as cache hit/miss
            prof = self._prof
            seq0 = prof._compile_seq
            t0 = time.perf_counter()
            raw = scorer(X)
            t_host = time.perf_counter()
            m = _host_margins(raw, n)
            self._pt_disp_host.record(t_host - t0)
            self._pt_disp_wait.record(time.perf_counter() - t_host)
            prof.count_dispatch("scoring",
                                prof._compile_seq - seq0)
        else:
            m = _host_margins(scorer(X), n)
        if self._drift is not None:
            # live-traffic sketches (duty-cycle gated inside; never
            # raises) — rows as decoded, margins as scored
            self._drift.observe(X_rows[:n], m)
        if self._ingest_tap is not None:
            try:
                self._ingest_tap(X_rows[:n], m)
            except Exception:   # noqa: BLE001 - tap is advisory
                self.stats.incr("ingest_tap_errors")
                log.exception("ingest tap failed; batch not retained")
        if self._reply_fn is not None:
            return self._reply_fn(m)
        if self._ndarray_replies:
            # binary wire: hand the margin ndarray through — indexing
            # yields numpy scalars/row views the exchange serializes
            # straight into a float32 reply block (no tolist())
            return m
        return m.tolist()

    def _score_predictor(self, batch):
        t0 = time.perf_counter()
        try:
            X = self._plan.decode([e[1] for e in batch])
        except Exception:  # noqa: BLE001 - malformed row(s) aboard
            X = None
        dec_s = time.perf_counter() - t0
        self._pt_decode.record(dec_s)
        self._trace("decode", batch, dur_ms=round(dec_s * 1e3, 3),
                    **({"fallback": "per_row"} if X is None else {}))
        if X is None:
            return self._score_predictor_salvage(batch)
        t1 = time.perf_counter()
        vals = self._score_matrix(X, X.shape[0],
                                  rids=[str(e[0]) for e in batch])
        pairs = [(e[0], vals[i]) for i, e in enumerate(batch)]
        score_s = time.perf_counter() - t1
        self._pt_score.record(score_s)
        self._trace("score", batch, rows=X.shape[0],
                    dur_ms=round(score_s * 1e3, 3))
        return pairs

    def _score_predictor_salvage(self, batch):
        """The vectorized decode failed: decode per row so ONE malformed
        payload gets its own 400 instead of failing every co-batched
        request (a single misbehaving client must not error out up to
        ``max_rows`` innocent neighbors)."""
        t_dec = time.perf_counter()
        rows, order, good, bad = [], [], [], []
        width = self._plan.num_features
        for entry in batch:
            rid, p = entry[0], entry[1]
            try:
                r = self._plan.decode([p])
            except Exception:  # noqa: BLE001
                bad.append(rid)
                continue
            if width is None:
                width = r.shape[1]
            if r.shape[1] != width:
                bad.append(rid)
                continue
            rows.append(r[0])
            order.append(rid)
            good.append(entry)
        out = [(rid, {"error": "bad request"}, 400) for rid in bad]
        self._pt_decode.record(time.perf_counter() - t_dec)
        if rows:
            X = np.ascontiguousarray(np.stack(rows))
            t0 = time.perf_counter()
            # salvage keeps each surviving row's rid: a routed
            # predictor re-pins it to the SAME arm the vectorized
            # attempt would have used (retry-stable routing)
            vals = self._score_matrix(X, len(rows),
                                      rids=[str(r) for r in order])
            out += [(rid, vals[i]) for i, rid in enumerate(order)]
            score_s = time.perf_counter() - t0
            self._pt_score.record(score_s)
            self._trace("score", good, rows=len(rows),
                        dur_ms=round(score_s * 1e3, 3))
        return out

    def _score_transform(self, batch):
        from .serving import request_table
        t0 = time.perf_counter()
        table = request_table(batch)
        dec_s = time.perf_counter() - t0
        self._pt_decode.record(dec_s)
        self._trace("decode", batch, dur_ms=round(dec_s * 1e3, 3))
        t1 = time.perf_counter()
        out = self._transform(table)
        ids = out["id"]
        vals = out[self._reply_col]
        if self._ndarray_replies:
            # binary-negotiated exchange: skip the per-row _json_value
            # build — the exchange serializes numpy values from the
            # column directly (float32 block per batch)
            pairs = [(str(rid), v) for rid, v in zip(ids, vals)]
        else:
            pairs = [(str(rid), _json_value(v))
                     for rid, v in zip(ids, vals)]
        score_s = time.perf_counter() - t1
        self._pt_score.record(score_s)
        self._trace("score", batch, rows=len(batch),
                    dur_ms=round(score_s * 1e3, 3))
        return pairs

    # -- replies -------------------------------------------------------------

    def _deliver(self, pairs, t_first: float) -> None:
        t0 = time.perf_counter()
        if self._reply_many is not None:
            self._reply_many(
                [(e[0], e[1], e[2] if len(e) > 2 else 200)
                 for e in pairs])
        else:
            for entry in pairs:
                rid, val = entry[0], entry[1]
                status = entry[2] if len(entry) > 2 else 200
                self._server.reply(rid, val, status)
        reply_s = time.perf_counter() - t0
        self._pt_reply.record(reply_s)
        # reply pairs carry no payload, so only rids ride this event;
        # the reader recovers a client trace id from the form event
        t_tr = time.perf_counter()
        self._journal.emit(
            "reply", rids=[str(e[0]) for e in pairs],
            statuses=[e[2] if len(e) > 2 else 200 for e in pairs],
            dur_ms=round(reply_s * 1e3, 3))
        self._pt_trace.record(time.perf_counter() - t_tr)
        e2e_s = time.perf_counter() - t_first
        self._pt_e2e.record(e2e_s)
        self.stats.add_rows(len(pairs))

    def _replier(self) -> None:
        while True:
            item = self._reply_q.get()
            if item is None:
                return
            pairs, t_first, t_handoff = item
            wait_s = time.perf_counter() - t_handoff
            self._pt_queue_wait.record(wait_s)
            try:
                self._deliver(pairs, t_first)
            except Exception:  # noqa: BLE001 - one bad delivery must
                # not kill the replier (dropping every queued batch and
                # wedging workers on the bounded reply queue); give the
                # batch explicit 500s and keep draining
                log.exception("reply delivery failed; erroring %d rows",
                              len(pairs))
                self._reply_errors(
                    [(e[0], {"error": "scoring failed"}, 500)
                     for e in pairs])

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "ScoringEngine":
        self._stop.clear()
        self._draining.clear()
        self._died.clear()
        self._fatal = None
        self._current.clear()
        self._threads = [
            threading.Thread(target=self._worker_shell, args=(i,),
                             name=f"scoring-worker-{i}", daemon=True)
            for i in range(self._num_scorers)]
        self._threads += [
            threading.Thread(target=self._replier,
                             name=f"scoring-replier-{i}", daemon=True)
            for i in range(self._num_repliers)]
        for t in self._threads:
            t.start()
        if self._supervise:
            self._supervisor_thread = threading.Thread(
                target=self._supervisor, name="scoring-supervisor",
                daemon=True)
            self._supervisor_thread.start()
        # readiness wiring: servers exposing a ready_check slot (the
        # /readyz endpoint) report this engine's liveness
        if hasattr(self._server, "ready_check"):
            try:
                self._server.ready_check = self.is_ready
            except AttributeError:
                pass
        # telemetry wiring: the newest live engine owns the "scoring"
        # namespace — /metrics scrapes (and the multiprocess driver's
        # render_metrics) see its stage latencies and resilience
        # counters without any per-server plumbing
        get_registry().register("scoring", self.stats)
        if self._cap_taps:
            # saturation wiring: observable zeros for the
            # instantaneous gauges, and the process-global capacity
            # sampler (knee estimation, busy fractions, headroom SLO
            # gauges) ticking wherever an engine serves
            self.stats.set_gauge("queue_depth", 0.0)
            self.stats.set_gauge("batch_occupancy", 0.0)
            self.stats.set_gauge("worker_busy", 0.0)
            ensure_capacity_sampler()
        if self._drift is not None:
            # the newest engine's monitor owns ns="drift" (and the
            # mmlspark_tpu_drift_* families), same semantics as above
            from ..core.drift import set_drift_monitor
            set_drift_monitor(self._drift)
        return self

    def is_ready(self) -> bool:
        """Liveness for ``/readyz``: started, not stopping, and at
        least one scoring worker alive."""
        if not self._threads or self._stop.is_set() \
                or self._draining.is_set():
            return False
        return any(t.is_alive()
                   for t in self._threads[:self._num_scorers])

    def stop(self, drain: bool = False, drain_timeout: float = 10.0
             ) -> None:
        """Drain-and-join.  Default: workers stop pulling at their next
        form tick (finishing the batch in hand, replies included), then
        repliers drain on sentinels.  With ``drain=True`` the workers
        first keep forming until the request queue runs dry (bounded by
        ``drain_timeout``), so everything already accepted is answered
        before exit — the graceful-restart path.  Callers should stop
        intake (server accept) first or the drain chases a moving
        queue until the timeout."""
        if drain and not self._stop.is_set():
            self._draining.set()
            deadline = time.monotonic() + drain_timeout
            for t in self._threads[:self._num_scorers]:
                t.join(timeout=max(0.0,
                                   deadline - time.monotonic()))
        self._stop.set()
        self._draining.set()   # unblock any drain-mode check
        for t in self._threads[:self._num_scorers]:
            t.join(timeout=5)
        for _ in range(self._num_repliers):
            self._reply_q.put(None)
        for t in self._threads[self._num_scorers:]:
            t.join(timeout=5)
        if self._supervisor_thread is not None:
            self._supervisor_thread.join(timeout=5)
            self._supervisor_thread = None
        self._threads = []

    def serve(self, stop_event: Optional[threading.Event] = None) -> None:
        """Blocking convenience: start, wait for ``stop_event`` (forever
        when ``None``), then drain and stop — the ``serve_forever``
        calling convention.  With ``on_error="raise"``, a scoring
        exception stops the engine and re-raises here."""
        self.start()
        try:
            while not self._died.is_set() \
                    and (stop_event is None or not stop_event.is_set()):
                if stop_event is not None:
                    stop_event.wait(0.2)
                else:
                    self._died.wait(0.2)
        finally:
            self.stop()
        if self._fatal is not None:
            raise self._fatal

    # -- observability -------------------------------------------------------

    def stats_snapshot(self) -> dict:
        """Rows/s plus per-stage count/mean/p50/p99 and the resilience
        counters (``shed``/``expired``/``salvaged``/``restarted``) —
        the numbers the serving BENCH and chaos artifacts record."""
        return self.stats.snapshot()
