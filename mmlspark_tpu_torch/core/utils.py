"""Shared runtime utilities.

The port's counterpart of ``mmlspark_tpu/core/utils.py``: the cluster
topology helpers report the cards of this host (``torch.cuda``) and the
processes of the ``torch.distributed`` group where the reference reports
JAX's devices and processes; :func:`block_until_ready` waits for the
card.  None of them starts CUDA in a process without a card.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Optional, TypeVar

import torch

log = logging.getLogger("mmlspark_tpu_torch")

T = TypeVar("T")


def _dist():
    """``torch.distributed`` when a process group is up, else None."""
    dist = torch.distributed
    return dist if dist.is_available() and dist.is_initialized() else None


class ClusterUtil:
    """Device/process topology helpers (executor counting analog)."""

    @staticmethod
    def get_num_devices() -> int:
        """Cards over the whole group: this host's cards times the
        group's processes (one host a process group, as the reference
        counts ``jax.device_count()``); 1 (the CPU) without a card."""
        return ClusterUtil.get_num_local_devices() * \
            ClusterUtil.get_num_processes()

    @staticmethod
    def get_num_local_devices() -> int:
        return max(1, torch.cuda.device_count())

    @staticmethod
    def get_num_processes() -> int:
        dist = _dist()
        return dist.get_world_size() if dist else 1

    @staticmethod
    def get_process_index() -> int:
        dist = _dist()
        return dist.get_rank() if dist else 0

    @staticmethod
    def get_default_platform() -> str:
        """``"gpu"`` with a card, else ``"cpu"`` (the reference's
        platform names)."""
        return "gpu" if torch.cuda.is_available() else "cpu"


class FaultToleranceUtils:
    """Retry helper for flaky IO (model download, HTTP) — reference analog."""

    @staticmethod
    def retry_with_timeout(fn: Callable[[], T], retries: int = 3,
                           backoff_s: float = 0.5,
                           exceptions=(Exception,)) -> T:
        last: Optional[BaseException] = None
        for attempt in range(retries):
            try:
                return fn()
            except exceptions as e:  # noqa: PERF203 - retry loop
                last = e
                if attempt < retries - 1:
                    sleep = backoff_s * (2 ** attempt)
                    log.warning("Attempt %d/%d failed (%s); retrying in %.1fs",
                                attempt + 1, retries, e, sleep)
                    time.sleep(sleep)
        assert last is not None
        raise last


class StopWatch:
    """Minimal wall-clock timer used by the Timer stage and benchmarks."""

    def __init__(self):
        self.start = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self.start

    def restart(self) -> float:
        now = time.perf_counter()
        dt = now - self.start
        self.start = now
        return dt


def block_until_ready(tree: Any) -> Any:
    """Wait until the card has finished every tensor of ``tree`` (the
    reference's ``jax.block_until_ready``): one synchronize of each CUDA
    device its tensors lie on; other leaves pass through.  Returns
    ``tree``."""
    devs = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                devs.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                walk(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                walk(v)

    walk(tree)
    for d in devs:
        torch.cuda.synchronize(d)
    return tree
