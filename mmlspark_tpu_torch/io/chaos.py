"""Deterministic fault injection for training: the training half of the
reference's ``mmlspark_tpu/io/chaos.py``.

Every injector draws its decisions from a :class:`ChaosChannel`, a stream
seeded by ``(seed, channel name)``: channels are independent, and within
one the k-th decision depends only on the seed and the call index, so a
plan with the reference's seed injects at the reference's calls.

* :class:`ChaosBoostStep` wraps the engine's chunk function
  (``gbdt.engine._boost_chunk``) and raises at chosen calls or at a rate:
  the failure ``faultTolerantRetries`` replays.  With ``drop_device`` it
  first makes the fit forget its device buffers, as a lost device does,
  so that only a replay that uploads every input again succeeds.
* :func:`corrupt_file` tears or bit-flips a snapshot file; the engine must
  discard it and start fresh.
* :func:`read_ckpt_boundary` reads the boundary of the durable checkpoint
  meta; :class:`ChaosControllerKill` SIGKILLs the current process once a
  boundary is durable.
* :class:`ChaosHeartbeat` stalls the elastic watchdog's lease writes
  (``gbdt.elastic.HeartbeatWatchdog``'s ``write_hook``).
* :func:`kill_process` SIGKILLs a process.

The reference's serving injectors (predictor, queue, socket, transport,
drift) wait for the port's serving plane.
"""

from __future__ import annotations

import os
import random
import signal
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional

__all__ = [
    "ChaosBoostStep", "ChaosChannel", "ChaosControllerKill",
    "ChaosHeartbeat", "ChaosPlan", "corrupt_file", "kill_process",
    "read_ckpt_boundary",
]


class ChaosChannel:
    """One independently seeded decision stream: ``fire(rate)`` is the
    k-th Bernoulli draw of the channel, a function of ``(seed, name)`` and
    the call index alone."""

    def __init__(self, seed: Any, name: str):
        self.name = name
        self._rng = random.Random(f"{seed}:{name}")
        self._lock = threading.Lock()
        self.calls = 0
        self.fired = 0

    def fire(self, rate: float) -> bool:
        """True with probability ``rate``."""
        with self._lock:
            self.calls += 1
            hit = rate > 0 and self._rng.random() < rate
            if hit:
                self.fired += 1
            return hit

    def uniform(self, lo: float, hi: float) -> float:
        with self._lock:
            self.calls += 1
            return self._rng.uniform(lo, hi)


class ChaosPlan:
    """A seeded fault plan: named :class:`ChaosChannel` streams and the
    ledger of what they injected (:meth:`counts`)."""

    def __init__(self, seed: Any = 0):
        self.seed = seed
        self._channels: Dict[str, ChaosChannel] = {}
        self._lock = threading.Lock()

    def channel(self, name: str) -> ChaosChannel:
        with self._lock:
            ch = self._channels.get(name)
            if ch is None:
                ch = self._channels[name] = ChaosChannel(self.seed, name)
            return ch

    def counts(self) -> Dict[str, Dict[str, int]]:
        """Per channel ``{calls, fired}``."""
        with self._lock:
            chans = list(self._channels.values())
        return {c.name: {"calls": c.calls, "fired": c.fired}
                for c in chans}


def kill_process(proc_or_pid) -> int:
    """SIGKILL a process (a ``Popen``/``multiprocessing.Process`` or a
    pid); returns the pid."""
    pid = getattr(proc_or_pid, "pid", proc_or_pid)
    os.kill(int(pid), signal.SIGKILL)
    return int(pid)


class ChaosBoostStep:
    """Wrap a chunk function with deterministic failures.

    * ``fail_on_calls``: call indices (1-based, replays counted) that
      raise ``RuntimeError`` instead of running.
    * ``exc_rate``: a per-call failure drawn from the plan's channel.
    * ``drop_device``: before raising, call ``drop_device_arrays()`` on
      every argument that has it (the engine's fit state), so that the
      device buffers are gone as after a device loss.

    The failure is an ordinary ``RuntimeError``, which the engine
    replays."""

    def __init__(self, step: Callable, plan: ChaosPlan, *,
                 exc_rate: float = 0.0,
                 fail_on_calls: Iterable[int] = (),
                 name: str = "boost_step", drop_device: bool = False):
        self._inner = step
        self._exc_rate = float(exc_rate)
        self._fail_on = frozenset(int(k) for k in fail_on_calls)
        self._chan = plan.channel(name)
        self._drop = drop_device
        self._lock = threading.Lock()
        self.calls = 0
        self.failures = 0

    def __call__(self, *args, **kwargs):
        with self._lock:
            self.calls += 1
            n = self.calls
        if n in self._fail_on or self._chan.fire(self._exc_rate):
            with self._lock:
                self.failures += 1
            if self._drop:
                for a in list(args) + list(kwargs.values()):
                    drop = getattr(a, "drop_device_arrays", None)
                    if callable(drop):
                        drop()
            raise RuntimeError(
                f"chaos: injected chunk-step failure (call {n})")
        return self._inner(*args, **kwargs)


def corrupt_file(path: str, plan: Optional[ChaosPlan] = None, *,
                 mode: str = "bitflip", name: str = "ckpt") -> str:
    """Corrupt a file in place: ``mode="torn"`` truncates it to half its
    length (a write cut short), ``mode="bitflip"`` flips one byte at an
    offset drawn from the plan's channel (the file's middle without a
    plan).  Returns ``path``."""
    size = os.path.getsize(path)
    if size == 0:
        raise ValueError(f"cannot corrupt empty file {path}")
    if mode == "torn":
        with open(path, "r+b") as fh:
            fh.truncate(max(1, size // 2))
        return path
    if mode == "bitflip":
        if plan is not None:
            off = int(plan.channel(name).uniform(0, max(0, size - 1)))
        else:
            off = size // 2
        with open(path, "r+b") as fh:
            fh.seek(off)
            b = fh.read(1)
            fh.seek(off)
            fh.write(bytes([b[0] ^ 0xFF]))
        return path
    raise ValueError(f"unknown corruption mode {mode!r} "
                     "(use 'torn' or 'bitflip')")


def read_ckpt_boundary(ckpt_dir: str) -> Optional[int]:
    """The boundary iteration the durable checkpoint meta in ``ckpt_dir``
    names, or None (absent, or caught mid-replace)."""
    import json

    import numpy as np

    # the file name lives with the writer
    from ..gbdt.checkpoint import _CKPT_FILE
    try:
        with np.load(os.path.join(ckpt_dir, _CKPT_FILE)) as z:
            return int(json.loads(bytes(z["__meta__"]).decode("utf-8"))
                       ["it"])
    except Exception:  # noqa: BLE001 - absent, or a replace in flight
        return None


class ChaosControllerKill(threading.Thread):
    """SIGKILL the current process once a checkpoint boundary of at least
    ``at_boundary`` is durable in ``ckpt_dir``: a death timed by the
    checkpoint itself, between two boundaries, with no cleanup run."""

    def __init__(self, ckpt_dir: str, at_boundary: int, *,
                 poll_s: float = 0.03):
        super().__init__(daemon=True, name="chaos-controller-kill")
        self._ckpt_dir = ckpt_dir
        self._at = int(at_boundary)
        self._poll_s = float(poll_s)

    def run(self) -> None:
        while True:
            it = read_ckpt_boundary(self._ckpt_dir)
            if it is not None and it >= self._at:
                kill_process(os.getpid())
                return      # reached only where the kill is stubbed out
            time.sleep(self._poll_s)


class ChaosHeartbeat:
    """A ``write_hook`` for the elastic watchdog that delays its lease
    writes, so that peers see a stale heartbeat: one stall of
    ``stall_s`` once ``after_s`` have passed since the first tick, and
    per-tick stalls of ``rate_stall_s`` at ``rate`` (drawn from the plan's
    channel)."""

    def __init__(self, plan: Optional[ChaosPlan] = None, *,
                 after_s: float = 0.0, stall_s: float = 0.0,
                 rate: float = 0.0, rate_stall_s: float = 0.05,
                 name: str = "heartbeat"):
        self._after_s = float(after_s)
        self._stall_s = float(stall_s)
        self._rate = float(rate)
        self._rate_stall_s = float(rate_stall_s)
        if rate > 0 and plan is None:
            # a silently disabled injector would let a drill pass having
            # injected nothing
            raise ValueError("ChaosHeartbeat with rate > 0 needs a "
                             "ChaosPlan to draw from")
        self._chan = plan.channel(name) if rate > 0 else None
        self._t0: Optional[float] = None
        self._fired = False
        self.stalls = 0

    def __call__(self) -> None:
        now = time.monotonic()
        if self._t0 is None:
            self._t0 = now
        if (self._stall_s > 0 and not self._fired
                and now - self._t0 >= self._after_s):
            self._fired = True
            self.stalls += 1
            time.sleep(self._stall_s)
            return
        if self._chan is not None and self._chan.fire(self._rate):
            self.stalls += 1
            time.sleep(self._rate_stall_s)
