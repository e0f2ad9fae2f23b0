"""Device traces of a fit (``profileTraceDir``).

The port's counterpart of ``maybe_trace`` in
``mmlspark_tpu/core/profiling.py``, which captures a ``jax.profiler``
trace: here ``torch.profiler`` records the host and, when CUDA is
available, the card's kernels, and writes one Chrome trace
(``chrome://tracing`` / Perfetto) per traced region into the directory.
The rest of that module belongs to the serving plane.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from typing import Optional

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
