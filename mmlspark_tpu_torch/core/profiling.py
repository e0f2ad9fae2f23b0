"""Device traces of a fit (``profileTraceDir``) and training counters.

The port's counterpart of ``maybe_trace`` in
``mmlspark_tpu/core/profiling.py``, which captures a ``jax.profiler``
trace: here ``torch.profiler`` records the host and, when CUDA is
available, the card's kernels, and writes one Chrome trace
(``chrome://tracing`` / Perfetto) per traced region into the directory.
:class:`StageStats` is the counter and gauge surface of the reference's
``StageStats``.  The rest of that module belongs to the serving plane.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager
from typing import Dict, Optional

import torch


@contextmanager
def maybe_trace(out_dir: Optional[str]):
    """Record the wrapped region with ``torch.profiler`` (CPU activity,
    and CUDA activity when a card is present) and export it as
    ``out_dir/fit_<ns>_<pid>.trace.json``; nothing when ``out_dir`` is
    unset, so a fit has one ``with`` either way."""
    if not out_dir:
        yield
        return
    os.makedirs(out_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        out_dir, f"fit_{time.time_ns()}_{os.getpid()}.trace.json"))


class StageStats:
    """Named event counters and point-in-time gauges, the counter and
    gauge surface of the reference's ``StageStats`` that training and the
    elastic layer use (``engine.train_stats``, the heartbeat watchdog's
    ``stats``).  The reference's per-stage latency histograms belong to
    the serving plane."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, int] = {}
        self._gauges: Dict[str, float] = {}

    def incr(self, name: str, n: int = 1) -> None:
        """Add ``n`` to a counter; ``n=0`` registers the name, so a
        snapshot shows an explicit zero instead of a missing key."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def counter(self, name: str) -> int:
        with self._lock:
            return self._counters.get(name, 0)

    def set_gauge(self, name: str, value: float) -> None:
        """Record a level (the last write wins)."""
        with self._lock:
            self._gauges[name] = float(value)

    def gauge(self, name: str, default: float = 0.0) -> float:
        with self._lock:
            return self._gauges.get(name, default)

    def snapshot(self) -> Dict[str, Dict]:
        """``{"counters": {...}, "gauges": {...}}``, read under one lock."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "gauges": dict(self._gauges)}
