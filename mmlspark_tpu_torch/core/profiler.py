"""Continuous performance profiler — always-on cost attribution.

The port's counterpart of ``mmlspark_tpu/core/profiler.py``, with the
card's hooks in place of JAX's.  Three sources, all cheap enough to stay
on:

* **Phase attribution** — hot paths feed :meth:`Profiler.record_phase`
  with durations they measured (the GBDT engine's ``train.host_iter``
  and its ``train.boost_chunk`` dispatch).  Phases accumulate into one
  :class:`~mmlspark_tpu_torch.core.profiling.StageStats` — the same
  log-bucket histograms the rest of telemetry uses, so snapshots merge
  cross-process with :func:`~mmlspark_tpu_torch.core.telemetry.
  merge_snapshots` and ``tools/perf_report.py`` can recompute exact
  percentiles.
* **Kernel builds** — the reference's ``jax.monitoring`` compile ledger
  becomes a ledger of the port's first-use kernel builds and library
  loads (``ops/_build.py``'s ``nvcc`` runs and ``ctypes`` loads, the
  native host kernels' ``g++`` runs and loads; :meth:`Profiler.
  record_build`).  :meth:`Profiler.compile_seq` advances once per build
  or load, so a dispatch bracketed by it is a miss when it built or
  loaded a kernel and a hit otherwise.  :meth:`Profiler.dispatch`
  records the split host-dispatch / device wait (:func:`device_wait`: a
  ``torch.cuda.synchronize`` where the reference calls
  ``block_until_ready``) plus the hit/miss ledger per site.  Card
  watermarks come from ``torch.cuda``'s allocator and the device's total
  memory (:meth:`Profiler.sample_memory`), labelled ``cuda:<i>``.
* **Sampling** — an OPT-IN ~100 Hz thread-stack sampler producing
  collapsed-stack flamegraph lines (``a;b;c 42``), copied from the
  reference as it is.

Exposition: the ``mmlspark_tpu_profile_*`` families join every
``/metrics`` scrape through the registry's exposition-provider hook.
The reference's ``jax_events_total`` / ``jax_seconds_total`` families
and snapshot key ``jax_events`` are replaced by
``mmlspark_tpu_profile_build_events_total`` /
``mmlspark_tpu_profile_build_seconds_total`` and ``build_events``
(events ``nvcc_build``, ``cuda_load``, ``native_build``,
``native_load``); every other family, key and label is the reference's.

Overhead contract: with the profiler DISABLED (``MMLSPARK_TPU_PROFILER=0``
or :meth:`Profiler.configure`) every hook is one attribute check;
ENABLED, a phase record is a dict lookup plus one log-bucket histogram
insert, and a dispatch bracket is one card synchronize.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

from .profiling import LatencyStats, StageStats
from .telemetry import (PREFIX, _fmt, _labels, current_fit_span,
                        get_journal, get_registry)

__all__ = ["Profiler", "get_profiler", "device_wait", "PROFILER_ENV"]

#: set to ``"0"`` to disable the always-on profiler process-wide
PROFILER_ENV = "MMLSPARK_TPU_PROFILER"


def device_wait(devices=None) -> None:
    """Wait until the card has finished the work queued on it — the
    dispatch bracket's second half (the reference's
    ``block_until_ready``).  Synchronizes each CUDA device of
    ``devices`` (every device when None); nothing in a process that has
    not started CUDA, and nothing for CPU devices."""
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return
    if devices is None:
        torch.cuda.synchronize()
        return
    for d in set(torch.device(x) for x in devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)


class Profiler:
    """Process-wide performance attribution.  One instance per process
    (:func:`get_profiler`); every hook is safe from any thread."""

    #: journal profile spans only when they exceed this (keeps the
    #: bounded journal ring from flooding with per-request spans);
    #: callers may force with ``journal=True``
    SPAN_JOURNAL_MS = 50.0

    def __init__(self, enabled: Optional[bool] = None):
        if enabled is None:
            enabled = os.environ.get(PROFILER_ENV, "1") != "0"
        self.enabled = bool(enabled)
        #: phase timers — StageStats so the snapshot merges like every
        #: other telemetry source
        self.stats = StageStats()
        self._timers: Dict[str, LatencyStats] = {}
        self._lock = threading.Lock()
        #: kernel build / load ledger: event name -> [n, total_s]
        self._build_events: Dict[str, List[float]] = {}
        self._compile_seq = 0
        #: per-site dispatch ledger: site -> {"hits": n, "misses": n}
        self._dispatch: Dict[str, Dict[str, int]] = {}
        #: (device, kind) -> bytes, refreshed by sample_memory()
        self._mem: Dict[Tuple[str, str], float] = {}
        self._mem_t = 0.0
        # sampler state
        self._sampler_stop = threading.Event()
        self._sampler_thread: Optional[threading.Thread] = None
        self._samples = 0
        self._stacks: Dict[str, int] = {}
        self._stacks_cap = 4096

    # ---- configuration ----

    def configure(self, enabled: Optional[bool] = None) -> "Profiler":
        if enabled is not None:
            self.enabled = bool(enabled)
        return self

    # ---- phase attribution ----

    def timer(self, phase: str) -> LatencyStats:
        """Resolve the phase's histogram ONCE — per-frame/per-batch
        call sites cache the returned object and record directly
        (``if prof.enabled: t.record(dt)``), skipping the dict lookup
        and call overhead of :meth:`record_phase` on every hit."""
        t = self._timers.get(phase)
        if t is None:
            with self._lock:
                t = self._timers.setdefault(phase,
                                            self.stats.timer(phase))
        return t

    def alias(self, phase: str, timer: LatencyStats) -> None:
        """Expose an EXISTING histogram (one a hot path already
        records into — the scoring engine's stage timers, the
        transport's codec timers) under ``phase`` in the profile view.
        This is the zero-overhead attribution path: the phase shows up
        in ``mmlspark_tpu_profile_phase_seconds`` and the snapshot
        without a single extra record on the hot path.  Replaces any
        previous alias — the newest engine instance wins, matching the
        registry's namespace semantics."""
        with self._lock:
            self._timers[phase] = timer
            self.stats.adopt(phase, timer)

    def record_phase(self, phase: str, seconds: float) -> None:
        """Accumulate an already-measured duration under ``phase``.
        The hot paths call this with timings they measured anyway, so
        an enabled profiler adds one histogram insert per call and a
        disabled one adds a single attribute check."""
        if not self.enabled:
            return
        self.timer(phase).record(seconds)

    @contextmanager
    def phase(self, name: str):
        """Scoped timer for call sites that don't already clock
        themselves."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record_phase(name, time.perf_counter() - t0)

    def span(self, name: str, seconds: float, journal: bool = False,
             record: bool = True, **ids) -> None:
        """Record a phase AND journal a ``profile_span`` event (with
        the current fit span and any caller ids — trace ids ride
        ``tid=``) when the span is slow enough to matter or the caller
        forces it.  This is what puts per-hop costs on the
        ``tools/trace_report.py`` timelines.  ``record=False`` journals
        only — for call sites whose phase is an ALIASED timer they
        already recorded into (a second record would double-count)."""
        if not self.enabled:
            return
        if record:
            self.record_phase(name, seconds)
        dur_ms = seconds * 1e3
        if journal or dur_ms >= self.SPAN_JOURNAL_MS:
            get_journal().emit("profile_span", phase=name,
                               dur_ms=round(dur_ms, 3),
                               fit=current_fit_span(), **ids)

    # ---- kernel builds and loads ----

    def record_build(self, event: str, secs: float) -> None:
        """One first-use kernel build or library load (``ops._build``'s
        ``nvcc_build`` / ``cuda_load``, ``native``'s ``native_build`` /
        ``native_load``) taking ``secs``: counted in the build ledger
        and advancing :meth:`compile_seq`."""
        if not self.enabled:
            return
        with self._lock:
            ent = self._build_events.setdefault(event, [0, 0.0])
            ent[0] += 1
            ent[1] += float(secs)
            self._compile_seq += 1

    def compile_seq(self) -> int:
        """Process-monotonic build counter: bumped once per kernel build
        or library load (:meth:`record_build`).  Bracket a call with it to
        classify the dispatch as a hit (unchanged: every kernel it ran
        was loaded already) or a miss (moved: it built or loaded one)."""
        return self._compile_seq

    def count_dispatch(self, site: str, misses: int = 0) -> None:
        """Ledger-only dispatch accounting (the cheapest hook: one
        lock).  ``misses`` is the :meth:`compile_seq` delta over the
        bracketed call — 0 means every kernel it ran was loaded already.
        ONE dispatch contributes ONE ledger entry (hit or miss), no
        matter how many kernels it built — the raw build count lives in
        the ``build_events`` family.  Caveat: the sequence is
        process-global, so a dispatch whose window overlaps ANOTHER
        site's build is conservatively counted as a miss for this
        site."""
        with self._lock:
            ent = self._dispatch.setdefault(site,
                                            {"hits": 0, "misses": 0})
            if misses > 0:
                ent["misses"] += 1
            else:
                ent["hits"] += 1

    def dispatch(self, site: str, host_s: float, wait_s: float,
                 misses: int = 0) -> None:
        """One bracketed dispatch at ``site``: ``host_s`` is the wall
        time until the call returned (the host's launch glue; on the
        card the launches are asynchronous), ``wait_s`` the further wall
        time until the card finished (:func:`device_wait`, a
        ``torch.cuda.synchronize`` — device compute the host had not
        waited for yet).
        ``misses`` is the :meth:`compile_seq` delta over the call.
        Per-batch call sites pre-resolve the two timers and call
        :meth:`count_dispatch` instead."""
        if not self.enabled:
            return
        self.record_phase(f"{site}.dispatch_host", host_s)
        self.record_phase(f"{site}.device_wait", wait_s)
        self.count_dispatch(site, misses)

    # ---- memory watermarks ----

    def record_memory(self, device: str, kind: str,
                      nbytes: float) -> None:
        with self._lock:
            self._mem[(str(device), str(kind))] = float(nbytes)

    def sample_memory(self, min_interval_s: float = 1.0) -> None:
        """Refresh the card watermarks of every visible card:
        ``torch.cuda.memory_allocated`` / ``max_memory_allocated`` and
        the device's total memory fill the reference's
        ``bytes_in_use`` / ``peak_bytes_in_use`` / ``bytes_limit``,
        labelled ``cuda:<i>``.  Rate-limited; a process without CUDA
        contributes nothing.  Never imports torch, and never starts
        CUDA: a process that has not initialised it (a CPU scorer) is
        skipped, so a metrics scrape cannot take the card."""
        if not self.enabled:
            return
        torch = sys.modules.get("torch")
        if torch is None or not torch.cuda.is_initialized():
            return
        now = time.monotonic()
        with self._lock:
            if now - self._mem_t < min_interval_s:
                return
            self._mem_t = now
        try:
            for i in range(torch.cuda.device_count()):
                label = f"cuda:{i}"
                self.record_memory(label, "bytes_in_use",
                                   torch.cuda.memory_allocated(i))
                self.record_memory(label, "peak_bytes_in_use",
                                   torch.cuda.max_memory_allocated(i))
                self.record_memory(
                    label, "bytes_limit",
                    torch.cuda.get_device_properties(i).total_memory)
        except Exception:  # noqa: BLE001 - a watermark read must never
            pass           # hurt the path it observes

    # ---- stack sampler (opt-in) ----

    def start_sampler(self, hz: float = 100.0,
                      thread_prefixes: Optional[Tuple[str, ...]] = None,
                      max_stacks: int = 4096,
                      duty_cap: float = 0.05) -> "Profiler":
        """Start the opt-in collapsed-stack sampler: ~``hz`` snapshots
        of every (filtered) thread's Python stack per second.
        ``thread_prefixes`` limits sampling to threads whose name
        starts with one of them (default: every thread but the sampler
        itself).  ``duty_cap`` bounds the sampler's own CPU share: if a
        snapshot costs c seconds the next sleep is at least
        ``c * (1/duty_cap - 1)``, so a slow ``sys._current_frames`` on
        a big process degrades the RATE, never the host."""
        if self._sampler_thread is not None:
            return self
        self._sampler_stop.clear()
        interval = 1.0 / max(1e-3, float(hz))
        self._stacks_cap = int(max_stacks)

        def loop():
            me = threading.get_ident()
            while not self._sampler_stop.is_set():
                t0 = time.perf_counter()
                try:
                    names = {t.ident: t.name
                             for t in threading.enumerate()}
                    for ident, frame in sys._current_frames().items():
                        if ident == me:
                            continue
                        name = names.get(ident, "?")
                        if thread_prefixes is not None and not any(
                                name.startswith(p)
                                for p in thread_prefixes):
                            continue
                        parts: List[str] = []
                        f = frame
                        depth = 0
                        while f is not None and depth < 64:
                            code = f.f_code
                            parts.append(
                                f"{os.path.basename(code.co_filename)}"
                                f":{code.co_name}")
                            f = f.f_back
                            depth += 1
                        key = name + ";" + ";".join(reversed(parts))
                        with self._lock:
                            self._samples += 1
                            if key in self._stacks or \
                                    len(self._stacks) < self._stacks_cap:
                                self._stacks[key] = \
                                    self._stacks.get(key, 0) + 1
                            else:
                                self._stacks["<overflow>"] = \
                                    self._stacks.get("<overflow>", 0) + 1
                except Exception:  # noqa: BLE001 - sampling must never
                    pass           # take the process down
                cost = time.perf_counter() - t0
                self._sampler_stop.wait(
                    max(interval - cost, cost * (1.0 / duty_cap - 1.0)))

        self._sampler_thread = threading.Thread(
            target=loop, name="profile-sampler", daemon=True)
        self._sampler_thread.start()
        return self

    def stop_sampler(self) -> None:
        self._sampler_stop.set()
        t = self._sampler_thread
        if t is not None:
            t.join(timeout=5)
        self._sampler_thread = None

    def flamegraph_lines(self, top: Optional[int] = None) -> List[str]:
        """Collapsed-stack lines (``thread;frame;...;leaf count``) in
        descending count order — feed straight to ``flamegraph.pl`` or
        speedscope."""
        with self._lock:
            items = sorted(self._stacks.items(), key=lambda kv: -kv[1])
        if top is not None:
            items = items[:top]
        return [f"{k} {v}" for k, v in items]

    # ---- snapshot / exposition ----

    def snapshot(self, top_stacks: int = 50) -> dict:
        """JSON-able profile block: phases (StageStats shape — merge
        with ``telemetry.merge_snapshots``), the build/dispatch
        ledger, the kernel build accumulations, the card watermarks,
        and the sampler's top collapsed stacks.  Embedded in flight
        records; ``tools/perf_report.py`` consumes it."""
        self.sample_memory()
        with self._lock:
            build_events = {k: {"count": int(v[0]),
                                "total_s": round(v[1], 6)}
                            for k, v in self._build_events.items()}
            dispatch = {k: dict(v) for k, v in self._dispatch.items()}
            mem = {f"{d}/{k}": v for (d, k), v in self._mem.items()}
            samples = self._samples
        return {
            "enabled": self.enabled,
            "phases": self.stats.snapshot(),
            "build_events": build_events,
            "compile_seq": self._compile_seq,
            "dispatch": dispatch,
            "memory_bytes": mem,
            "sampler": {"samples": samples,
                        "stacks": self.flamegraph_lines(top_stacks)},
        }

    def render_prometheus(self, prefix: str = PREFIX) -> str:
        """The ``mmlspark_tpu_profile_*`` families (appended to every
        registry render through ``register_exposition``)."""
        self.sample_memory()
        lines: List[str] = []

        def fam(suffix: str, typ: str, help_: str) -> str:
            name = f"{prefix}_profile_{suffix}"
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {typ}")
            return name

        n = fam("enabled", "gauge",
                "1 while the always-on profiler is recording.")
        lines.append(f"{n} {1 if self.enabled else 0}")

        snap = self.stats.snapshot()
        stages = snap.get("stages") or {}
        if stages:
            n = fam("phase_seconds", "histogram",
                    "Attributed wall time per named hot-path phase "
                    "(log-bucketed, cross-process mergeable).")
            for phase in sorted(stages):
                s = stages[phase]
                lab = {"phase": phase}
                buckets = s.get("buckets") or {}
                cum = 0
                for le, c in sorted(
                        ((le, c) for le, c in buckets.items()
                         if le != "+Inf"),
                        key=lambda kv: float(kv[0])):
                    cum += int(c)
                    lines.append(
                        f"{n}_bucket{_labels({**lab, 'le': le})} {cum}")
                lines.append(
                    f"{n}_bucket{_labels({**lab, 'le': '+Inf'})} "
                    f"{_fmt(s.get('count', 0))}")
                lines.append(
                    f"{n}_sum{_labels(lab)} "
                    f"{_fmt(s.get('total_s', 0.0))}")
                lines.append(
                    f"{n}_count{_labels(lab)} "
                    f"{_fmt(s.get('count', 0))}")

        with self._lock:
            build_events = {k: (int(v[0]), float(v[1]))
                            for k, v in self._build_events.items()}
            dispatch = {k: dict(v) for k, v in self._dispatch.items()}
            mem = dict(self._mem)
            samples = self._samples
        if dispatch:
            n = fam("dispatch_total", "counter",
                    "Bracketed dispatches per site, split hit (no "
                    "kernel built or loaded) vs miss.")
            for site in sorted(dispatch):
                for outcome in ("hit", "miss"):
                    lines.append(
                        f"{n}{_labels({'site': site, 'outcome': outcome})}"
                        f" {dispatch[site].get(outcome + 's', 0)}")
        if build_events:
            n = fam("build_events_total", "counter",
                    "First-use kernel builds and library loads "
                    "(nvcc_build = one nvcc run).")
            for ev in sorted(build_events):
                lines.append(f"{n}{_labels({'event': ev})} "
                             f"{build_events[ev][0]}")
            n = fam("build_seconds_total", "counter",
                    "Cumulative seconds per kernel build or load event "
                    "(the build-time ledger).")
            for ev in sorted(build_events):
                lines.append(f"{n}{_labels({'event': ev})} "
                             f"{_fmt(round(build_events[ev][1], 6))}")
        if mem:
            n = fam("memory_bytes", "gauge",
                    "Card memory watermarks (torch.cuda allocator "
                    "and device total).")
            for (dev, kind) in sorted(mem):
                lines.append(
                    f"{n}{_labels({'device': dev, 'kind': kind})} "
                    f"{_fmt(mem[(dev, kind)])}")
        n = fam("sampler_samples_total", "counter",
                "Thread-stack samples taken by the opt-in sampler.")
        lines.append(f"{n} {samples}")
        return "\n".join(lines) + "\n"


_profiler = Profiler()


def get_profiler() -> Profiler:
    """The process-global profiler every hot-path hook feeds."""
    return _profiler


# the profile families join every /metrics scrape (one failing provider
# is skipped by the registry, never fatal to the scrape)
get_registry().register_exposition(
    "profile", lambda: _profiler.render_prometheus())
