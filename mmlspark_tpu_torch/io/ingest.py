"""Streaming ingest — the training-side feed of the online-learning
loop.  The port's copy of ``mmlspark_tpu/io/ingest.py``: its segments,
snapshots and ``mapper.json`` are the reference's bytes for the same
appends, so either package replays the other's directory.

The refresh pipeline (``io/refresh.py``) can only retrain on data it
still *has* when drift fires, and it must still have that data after a
SIGKILL.  This module is the durable buffer between live traffic and
the incremental fit:

* **Bin-at-append** — every micro-batched ``(X, y)`` append is binned
  immediately to the ACTIVE model's uint8
  :class:`~mmlspark_tpu_torch.gbdt.binning.BinMapper` ladder, on the host
  (the native ``fastbin`` of ``transform_packed``).  Raw float32
  rows never accumulate: retained rows cost 1 byte/feature, and —
  because tree thresholds sit exactly on bin upper bounds — the binned
  rows are *sufficient statistics* for continued training
  (:func:`mmlspark_tpu_torch.gbdt.engine.train_incremental` reconstructs the
  active model's margins bit-exactly from bin representatives).
* **Window + reservoir retention** — the buffer holds the last
  ``window_rows`` rows exactly (recency) plus a uniform reservoir
  sample of every row ever evicted from the window (history), so a
  refresh fit sees both the drifted present and the long tail.  Every
  row is retained at most once: first in the window, then either it
  enters the reservoir or it is dropped forever.  Reservoir decisions
  are counter-keyed hashes of ``(seed, evicted_index)`` — a pure
  function of the row's position in the stream, independent of batch
  boundaries and of process restarts.
* **Crash-safe segment spill** — appended rows accumulate in a tail
  and spill to ``seg_NNNNNNNN.npz`` files in exact ``segment_rows``
  slices, written tmp + fsync + atomic-rename (the training
  checkpoints' discipline).  The in-memory window/reservoir state is
  maintained ONLY over spilled rows, so the durable state is always
  exactly "replay of the segment files": reopening the directory after
  a SIGKILL reproduces the window, the reservoir and every counter
  bit-identically as of the last durable segment (unspilled tail rows
  are the only loss, by contract).  ``compact()`` folds replayed
  segments into one ``state_NNNNNNNN.npz`` snapshot (same atomic
  discipline, snapshot durable before segment unlink) so disk stays
  bounded without ever widening the crash window.

``training_view()`` is the fit input: reservoir + the last
``window_rows`` of (spilled + tail) rows, oldest first.

Telemetry: the buffer federates a StageStats block under
``ns="ingest"`` and renders the ``mmlspark_tpu_ingest_*`` families
(docs/observability.md) into the process scrape.
"""

from __future__ import annotations

import io as _io
import json
import logging
import os
import threading
from typing import List, Optional, Tuple

import numpy as np

from ..core.profiling import StageStats
from ..core.telemetry import PREFIX, _fmt, _labels, get_journal, \
    get_registry
from ..gbdt.binning import BinMapper
from .registry import _atomic_write, _fsync_dir, sha256_hex

log = logging.getLogger(__name__)

__all__ = ["IngestBuffer", "IngestError"]

_META = "meta.json"
_MAPPER = "mapper.json"
_SEG_FMT = "seg_%08d.npz"
_STATE_FMT = "state_%08d.npz"
_FORMAT = 1

INGEST_NS = "ingest"


class IngestError(RuntimeError):
    """Ingest contract violation (shape mismatch, incompatible
    directory, torn configuration)."""


def _hash_u64(seed: int, t: np.ndarray) -> np.ndarray:
    """Counter-keyed 64-bit hash (splitmix64 finalizer over
    ``seed ^ t``): deterministic, platform-independent, vectorized —
    the reservoir's per-row randomness.  uint64 arithmetic wraps
    silently in numpy, which is exactly the mixing we want."""
    x = (np.asarray(t, np.uint64) + np.uint64(0x9E3779B97F4A7C15)) \
        ^ np.uint64(seed & 0xFFFFFFFFFFFFFFFF)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _savez_atomic(path: str, **arrays) -> None:
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    _atomic_write(path, buf.getvalue())


class IngestBuffer:
    """Durable streaming buffer of binned training rows.

    ``root`` is the spill directory.  A fresh directory needs
    ``mapper`` (the active model's bin ladder, persisted alongside);
    reopening an existing one replays its durable state and verifies
    any ``mapper`` passed matches the persisted ladder bit-exactly —
    segments binned under one ladder must never be extended under
    another.
    """

    def __init__(self, root: str, mapper: Optional[BinMapper] = None, *,
                 window_rows: int = 4096, reservoir_rows: int = 2048,
                 segment_rows: int = 512, seed: int = 0,
                 max_segments: int = 64,
                 stats: Optional[StageStats] = None,
                 register: bool = True):
        if segment_rows <= 0 or window_rows <= 0 or reservoir_rows < 0:
            raise IngestError(
                "window_rows/segment_rows must be positive and "
                "reservoir_rows non-negative")
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)
        self.stats = stats or StageStats()
        self._lock = threading.RLock()
        self._journal = get_journal()
        existing = os.path.exists(os.path.join(self.root, _META))
        if existing:
            self._load_meta(mapper)
        else:
            if mapper is None:
                raise IngestError(
                    f"fresh ingest dir {self.root} needs a BinMapper "
                    "(the active model's ladder)")
            self.mapper = mapper
            self.window_rows = int(window_rows)
            self.reservoir_rows = int(reservoir_rows)
            self.segment_rows = int(segment_rows)
            self.seed = int(seed)
            self._write_meta()
        self.max_segments = int(max_segments)
        f = self.mapper.num_features
        if self.mapper.num_total_bins > 256:
            raise IngestError(
                "ingest retains uint8 bins; mapper has "
                f"{self.mapper.num_total_bins} total bins (> 256)")
        # durable state: maintained ONLY over spilled rows
        self._win: List[Tuple[np.ndarray, np.ndarray]] = []
        self._win_rows = 0
        self._res_bins = np.zeros((self.reservoir_rows, f), np.uint8)
        self._res_labels = np.zeros(self.reservoir_rows, np.float64)
        self._res_filled = 0
        self._evicted = 0
        self._rows_durable = 0
        # volatile tail: appended, not yet spilled (lost on SIGKILL)
        self._tail: List[Tuple[np.ndarray, np.ndarray]] = []
        self._tail_rows = 0
        self._seg_next = 0
        for k in ("rows", "batches", "segments_spilled",
                  "segments_replayed", "rows_dropped", "compactions",
                  "spilled_bytes"):
            self.stats.incr(k, 0)
        if existing:
            self._replay()
        if register:
            reg = get_registry()
            reg.register(INGEST_NS, self.stats)
            reg.register_exposition(
                INGEST_NS, self.render_prometheus)
        self._registered = register
        self._update_gauges()

    # -- config persistence --------------------------------------------------

    def _write_meta(self) -> None:
        mtext = self.mapper.to_json()
        _atomic_write(os.path.join(self.root, _MAPPER),
                      mtext.encode("utf-8"))
        meta = {"format": _FORMAT,
                "window_rows": self.window_rows,
                "reservoir_rows": self.reservoir_rows,
                "segment_rows": self.segment_rows,
                "seed": self.seed,
                "num_features": self.mapper.num_features,
                "mapper_digest": f"sha256:{sha256_hex(mtext)}"}
        _atomic_write(os.path.join(self.root, _META),
                      json.dumps(meta, indent=1,
                                 sort_keys=True).encode("utf-8"))

    def _load_meta(self, mapper: Optional[BinMapper]) -> None:
        try:
            with open(os.path.join(self.root, _META), "rb") as fh:
                meta = json.loads(fh.read().decode("utf-8"))
            with open(os.path.join(self.root, _MAPPER), "rb") as fh:
                mtext = fh.read().decode("utf-8")
        except (OSError, ValueError) as e:
            raise IngestError(
                f"unreadable ingest dir {self.root}: {e}") from e
        if meta.get("format") != _FORMAT:
            raise IngestError(
                f"ingest dir format {meta.get('format')!r} not "
                f"supported (want {_FORMAT})")
        want = meta.get("mapper_digest", "").split(":", 1)[-1]
        if sha256_hex(mtext) != want:
            raise IngestError(
                f"ingest dir {self.root}: mapper.json fails its "
                "recorded digest; refusing to replay")
        persisted = BinMapper.from_json(mtext)
        if mapper is not None and mapper.to_json() != mtext:
            raise IngestError(
                "ingest dir was binned under a different ladder than "
                "the mapper passed; refusing to mix bin spaces")
        self.mapper = persisted
        self.window_rows = int(meta["window_rows"])
        self.reservoir_rows = int(meta["reservoir_rows"])
        self.segment_rows = int(meta["segment_rows"])
        self.seed = int(meta["seed"])

    # -- durable-state machinery ---------------------------------------------

    def _push_durable(self, b: np.ndarray, y: np.ndarray) -> None:
        """Feed spilled rows, in stream order, through the window →
        reservoir machinery (also the replay path: replay IS re-push)."""
        self._win.append((b, y))
        self._win_rows += len(b)
        self._rows_durable += len(b)
        while self._win_rows > self.window_rows:
            b0, y0 = self._win[0]
            k = min(self._win_rows - self.window_rows, len(b0))
            self._evict(b0[:k], y0[:k])
            if k == len(b0):
                self._win.pop(0)
            else:
                self._win[0] = (b0[k:], y0[k:])
            self._win_rows -= k

    def _evict(self, b: np.ndarray, y: np.ndarray) -> None:
        m = len(b)
        if m == 0:
            return
        R = self.reservoir_rows
        if R == 0:
            self.stats.incr("rows_dropped", m)
            return
        off = 0
        fill = min(R - self._res_filled, m)
        if fill > 0:
            s = self._res_filled
            self._res_bins[s:s + fill] = b[:fill]
            self._res_labels[s:s + fill] = y[:fill]
            self._res_filled += fill
            off = fill
        self._evicted += fill
        if off >= m:
            return
        # Algorithm R with per-step independent counter-keyed
        # randomness: evicted row t is accepted w.p. R/(t+1) into a
        # uniform slot.  Repeated-index fancy assignment keeps the LAST
        # write per slot — identical to sequential processing.
        t = np.arange(self._evicted, self._evicted + (m - off),
                      dtype=np.uint64)
        self._evicted += m - off
        u = _hash_u64(self.seed, 2 * t).astype(np.float64) / 2.0 ** 64
        acc = u * (t.astype(np.float64) + 1.0) < float(R)
        idx = np.nonzero(acc)[0]
        if len(idx):
            slots = (_hash_u64(self.seed, 2 * t[idx] + np.uint64(1))
                     % np.uint64(R)).astype(np.int64)
            self._res_bins[slots] = b[off:][idx]
            self._res_labels[slots] = y[off:][idx]
        self.stats.incr("rows_dropped", int((~acc).sum()))

    # -- append / spill ------------------------------------------------------

    def append(self, X, y) -> int:
        """Bin and retain one micro-batch; spills full segments.
        Returns the number of rows appended."""
        with self.stats.time("append"):
            X = np.asarray(X)
            if X.ndim == 1:
                X = X[None, :]
            if X.ndim != 2 or X.shape[1] != self.mapper.num_features:
                raise IngestError(
                    f"append shape {X.shape} does not match the "
                    f"ladder's {self.mapper.num_features} features")
            yv = np.asarray(y, np.float64).reshape(-1)
            if len(yv) != X.shape[0]:
                raise IngestError(
                    f"append got {X.shape[0]} rows but {len(yv)} "
                    "labels")
            # transform_packed gives a CPU tensor (the native fastbin)
            b = np.ascontiguousarray(
                self.mapper.transform_packed(X).numpy(), dtype=np.uint8)
            with self._lock:
                self._tail.append((b, yv))
                self._tail_rows += len(b)
                self.stats.incr("rows", len(b))
                self.stats.incr("batches")
                self.stats.add_rows(len(b))
                while self._tail_rows >= self.segment_rows:
                    self._spill_one_locked()
                self._update_gauges()
            return int(len(b))

    def _take_tail_locked(self, k: int) -> Tuple[np.ndarray, np.ndarray]:
        bs, ys, got = [], [], 0
        while got < k:
            b0, y0 = self._tail[0]
            take = min(k - got, len(b0))
            bs.append(b0[:take])
            ys.append(y0[:take])
            if take == len(b0):
                self._tail.pop(0)
            else:
                self._tail[0] = (b0[take:], y0[take:])
            got += take
        self._tail_rows -= k
        return np.concatenate(bs), np.concatenate(ys)

    def _spill_one_locked(self, rows: Optional[int] = None) -> int:
        k = min(rows or self.segment_rows, self._tail_rows)
        b, yv = self._take_tail_locked(k)
        idx = self._seg_next
        path = os.path.join(self.root, _SEG_FMT % idx)
        _savez_atomic(path, bins=b, labels=yv,
                      first_row=np.int64(self._rows_durable),
                      seg=np.int64(idx))
        self._seg_next = idx + 1
        self._push_durable(b, yv)
        self.stats.incr("segments_spilled")
        self.stats.incr("spilled_bytes", os.path.getsize(path))
        self._journal.emit("ingest_segment", seg=idx, rows=int(len(b)),
                           durable_rows=self._rows_durable)
        if self._live_segments_locked() > self.max_segments:
            self._compact_locked()
        return idx

    def flush(self) -> int:
        """Spill any tail rows so the buffer's full contents are
        durable (the refresh controller calls this before snapshotting
        its fit dataset).  Returns the durable row count."""
        with self._lock:
            while self._tail_rows > 0:
                self._spill_one_locked(rows=self._tail_rows)
            self._update_gauges()
            return self._rows_durable

    # -- compaction ----------------------------------------------------------

    def _seg_files_locked(self) -> List[Tuple[int, str]]:
        out = []
        for fn in os.listdir(self.root):
            if fn.startswith("seg_") and fn.endswith(".npz"):
                out.append((int(fn[4:-4]), os.path.join(self.root, fn)))
        return sorted(out)

    def _state_files_locked(self) -> List[Tuple[int, str]]:
        out = []
        for fn in os.listdir(self.root):
            if fn.startswith("state_") and fn.endswith(".npz"):
                out.append((int(fn[6:-4]), os.path.join(self.root, fn)))
        return sorted(out)

    def _live_segments_locked(self) -> int:
        return len(self._seg_files_locked())

    def _compact_locked(self) -> None:
        if self._seg_next == 0:
            return
        idx = self._seg_next - 1
        wb = np.concatenate([b for b, _ in self._win]) if self._win \
            else np.zeros((0, self.mapper.num_features), np.uint8)
        wy = np.concatenate([y for _, y in self._win]) if self._win \
            else np.zeros(0, np.float64)
        path = os.path.join(self.root, _STATE_FMT % idx)
        # snapshot durable BEFORE any unlink: a crash between the two
        # leaves both snapshot and segments (replay prefers the newest
        # snapshot and ignores segments it already covers)
        _savez_atomic(path, win_bins=wb, win_labels=wy,
                      res_bins=self._res_bins[:self._res_filled],
                      res_labels=self._res_labels[:self._res_filled],
                      evicted=np.int64(self._evicted),
                      rows_durable=np.int64(self._rows_durable),
                      seg=np.int64(idx))
        for i, p in self._seg_files_locked():
            if i <= idx:
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass
        for i, p in self._state_files_locked():
            if i < idx:
                try:
                    os.unlink(p)
                except FileNotFoundError:
                    pass
        _fsync_dir(self.root)
        self.stats.incr("compactions")
        self._journal.emit("ingest_compact", seg=idx,
                           durable_rows=self._rows_durable)

    def compact(self) -> None:
        """Fold all spilled segments into one snapshot file."""
        with self._lock:
            self._compact_locked()
            self._update_gauges()

    # -- replay --------------------------------------------------------------

    def _replay(self) -> None:
        with self._lock:
            states = self._state_files_locked()
            base = -1
            if states:
                base, spath = states[-1]
                with np.load(spath) as st:
                    wb = np.ascontiguousarray(st["win_bins"], np.uint8)
                    wy = np.asarray(st["win_labels"], np.float64)
                    rb = np.ascontiguousarray(st["res_bins"], np.uint8)
                    ry = np.asarray(st["res_labels"], np.float64)
                    self._evicted = int(st["evicted"])
                    self._rows_durable = int(st["rows_durable"])
                if len(wb):
                    self._win = [(wb, wy)]
                    self._win_rows = len(wb)
                self._res_filled = len(rb)
                self._res_bins[:len(rb)] = rb
                self._res_labels[:len(ry)] = ry
            replayed = 0
            last = base
            for i, p in self._seg_files_locked():
                if i <= base:
                    continue        # crash between snapshot and unlink
                if i != last + 1:
                    raise IngestError(
                        f"ingest dir {self.root}: segment {last + 1} "
                        f"missing (found {i}); refusing a gapped "
                        "replay")
                with np.load(p) as seg:
                    b = np.ascontiguousarray(seg["bins"], np.uint8)
                    yv = np.asarray(seg["labels"], np.float64)
                    first = int(seg["first_row"])
                if first != self._rows_durable:
                    raise IngestError(
                        f"ingest segment {i} starts at row {first}, "
                        f"expected {self._rows_durable}; refusing a "
                        "torn replay")
                self._push_durable(b, yv)
                replayed += 1
                last = i
            self._seg_next = last + 1
            self.stats.incr("segments_replayed", replayed)
            self.stats.incr("rows", self._rows_durable)
            if replayed or base >= 0:
                self._journal.emit(
                    "ingest_replay", segments=replayed,
                    snapshot=base if base >= 0 else None,
                    durable_rows=self._rows_durable)

    # -- views ---------------------------------------------------------------

    def training_view(self) -> Tuple[np.ndarray, np.ndarray]:
        """The fit input: reservoir sample + the last ``window_rows``
        of all appended rows (spilled + tail), oldest first.  Copies —
        safe to hand to a fit while appends continue."""
        with self._lock:
            chunks = list(self._win) + list(self._tail)
            rows = self._win_rows + self._tail_rows
            drop = max(0, rows - self.window_rows)
            out_b = [self._res_bins[:self._res_filled].copy()]
            out_y = [self._res_labels[:self._res_filled].copy()]
            for b, yv in chunks:
                if drop >= len(b):
                    drop -= len(b)
                    continue
                out_b.append(b[drop:].copy())
                out_y.append(yv[drop:].copy())
                drop = 0
            return (np.concatenate(out_b) if out_b else
                    np.zeros((0, self.mapper.num_features), np.uint8),
                    np.concatenate(out_y))

    @property
    def rows_seen(self) -> int:
        return self.stats.counter("rows")

    @property
    def rows_durable(self) -> int:
        with self._lock:
            return self._rows_durable

    @property
    def rows_retained(self) -> int:
        with self._lock:
            return (self._res_filled + self._win_rows
                    + self._tail_rows)

    def _update_gauges(self) -> None:
        self.stats.set_gauge("window_rows", self._win_rows)
        self.stats.set_gauge("reservoir_rows", self._res_filled)
        self.stats.set_gauge("tail_rows", self._tail_rows)

    def close(self) -> None:
        if self._registered:
            reg = get_registry()
            reg.unregister(INGEST_NS)
            reg.unregister_exposition(INGEST_NS)
            self._registered = False

    # -- exposition ----------------------------------------------------------

    def render_prometheus(self, prefix: str = PREFIX) -> str:
        """The ``mmlspark_tpu_ingest_*`` families
        (docs/observability.md §Metric families)."""
        with self._lock:
            self._update_gauges()
        snap = self.stats.snapshot()
        c, g = snap["counters"], snap["gauges"]
        lines: List[str] = []

        def fam(suffix: str, typ: str, help_: str) -> str:
            name = f"{prefix}_ingest_{suffix}"
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {typ}")
            return name

        n = fam("rows_total", "counter",
                "Rows appended to the streaming ingest buffer "
                "(binned at append time).")
        lines.append(f"{n} {c.get('rows', 0)}")
        n = fam("batches_total", "counter",
                "Micro-batches appended.")
        lines.append(f"{n} {c.get('batches', 0)}")
        n = fam("segments_total", "counter",
                "Durable segment spills / replays after restart / "
                "compactions, by event.")
        for ev, key in (("spilled", "segments_spilled"),
                        ("replayed", "segments_replayed"),
                        ("compacted", "compactions")):
            lines.append(f'{n}{_labels({"event": ev})} '
                         f'{c.get(key, 0)}')
        n = fam("retained_rows", "gauge",
                "Rows currently retained, by store (window = exact "
                "recency, reservoir = uniform history, tail = "
                "not-yet-durable).")
        for store in ("window", "reservoir", "tail"):
            lines.append(f'{n}{_labels({"store": store})} '
                         f'{_fmt(g.get(store + "_rows", 0))}')
        n = fam("rows_dropped_total", "counter",
                "Rows evicted from the window that the reservoir "
                "declined (gone forever, by design).")
        lines.append(f"{n} {c.get('rows_dropped', 0)}")
        n = fam("spilled_bytes_total", "counter",
                "Bytes written to durable segment files.")
        lines.append(f"{n} {c.get('spilled_bytes', 0)}")
        return "\n".join(lines) + "\n"
