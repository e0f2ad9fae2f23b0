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

The serving injectors:

* :class:`ChaosPredictor` wraps a scoring callable and raises batch
  exceptions (the engine's per-row salvage) or
  :class:`~mmlspark_tpu_torch.io.scoring.WorkerKilled` (the engine's
  supervision and restart) at chosen calls or at a rate.
* :class:`ChaosQueue` stalls a queue's ``get``s (a wedged intake).
* :class:`ChaosSocket` wraps a connected socket: resets, partial writes,
  slow reads and writes.
* :class:`ChaosTransport` wraps a transport link's socket
  (``TransportConfig.socket_wrap``): frame bit flips, dropped ACKs,
  mid-frame kills and half-open silence, which the session resume must
  survive with no loss and no duplicate.

* :class:`ChaosDrift` perturbs one feature column of the request
  stream once a number of rows has flowed (a step, or a ramp over
  ``ramp_rows``; NaN storms), the drift the monitor and the refresh
  loop must catch: the reference's stream for the same seed.
"""

from __future__ import annotations

import os
import queue
import random
import signal
import struct
import threading
import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np

from .scoring import WorkerKilled
from .transport import T_ACK as _T_ACK

__all__ = [
    "ChaosBoostStep", "ChaosChannel", "ChaosControllerKill", "ChaosDrift",
    "ChaosHeartbeat", "ChaosPlan", "ChaosPredictor", "ChaosQueue",
    "ChaosSocket", "ChaosTransport", "WorkerKilled", "corrupt_file",
    "kill_process", "read_ckpt_boundary",
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


class ChaosPredictor:
    """Wrap a scoring callable with deterministic failure injection.

    * ``exc_rate`` — per-call probability of an ordinary
      ``RuntimeError`` (the engine treats it as a batch failure and
      salvages per row).
    * ``kill_on_calls`` — exact call indices (1-based) that raise
      :class:`WorkerKilled` instead of scoring — simulates the worker
      thread dying mid-batch (the supervision path).  Call indices
      count every invocation, including the engine's per-row salvage
      retries.

    The wrapper forwards ``mode`` when the inner predictor has one, so
    the engine's pad-buckets auto-detection behaves identically.
    """

    def __init__(self, predictor: Callable, plan: ChaosPlan, *,
                 exc_rate: float = 0.0,
                 kill_on_calls: Iterable[int] = (),
                 name: str = "predictor"):
        self._inner = predictor
        self._exc_rate = float(exc_rate)
        self._kill_on = frozenset(int(k) for k in kill_on_calls)
        self._chan = plan.channel(name)
        self._lock = threading.Lock()
        self.calls = 0
        self.kills = 0
        self.excs = 0
        if hasattr(predictor, "mode"):
            self.mode = predictor.mode

    def __call__(self, X):
        with self._lock:
            self.calls += 1
            n = self.calls
        if n in self._kill_on:
            with self._lock:
                self.kills += 1
            raise WorkerKilled(f"chaos: worker kill at call {n}")
        if self._chan.fire(self._exc_rate):
            with self._lock:
                self.excs += 1
            raise RuntimeError(f"chaos: injected predictor fault "
                               f"(call {n})")
        return self._inner(X)


class ChaosQueue:
    """Wrap a ``queue.Queue`` with deterministic ``get`` stalls (a
    wedged intake / slow upstream).  Puts pass through untouched so no
    request is ever lost — chaos degrades, it must not drop."""

    def __init__(self, inner: "queue.Queue", plan: ChaosPlan, *,
                 stall_rate: float = 0.0, stall_s: float = 0.05,
                 name: str = "queue"):
        self._inner = inner
        self._stall_rate = float(stall_rate)
        self._stall_s = float(stall_s)
        self._chan = plan.channel(name)

    def _maybe_stall(self):
        if self._chan.fire(self._stall_rate):
            time.sleep(self._stall_s)

    def get(self, block: bool = True, timeout: Optional[float] = None):
        self._maybe_stall()
        return self._inner.get(block, timeout)

    def get_nowait(self):
        self._maybe_stall()
        return self._inner.get_nowait()

    def put(self, item, block: bool = True,
            timeout: Optional[float] = None):
        return self._inner.put(item, block, timeout)

    def put_nowait(self, item):
        return self._inner.put_nowait(item)

    def qsize(self) -> int:
        return self._inner.qsize()

    def empty(self) -> bool:
        return self._inner.empty()


class ChaosSocket:
    """Wrap a CONNECTED socket with deterministic network faults:

    * ``reset_rate`` — before a send: hard connection reset (``SO_LINGER
      0`` close emits an RST; the caller sees ``ConnectionResetError``).
    * ``partial_rate`` — before a send: transmit roughly half the bytes,
      then reset — the truncated-request case a server's read path must
      survive.
    * ``slow_rate``/``slow_s`` — before a send or recv: stall — the
      slow-loris case the server's read deadlines must bound.

    Everything else delegates to the wrapped socket.  ``makefile`` is
    delegated raw (buffered readers bypass injection); inject on the
    side that calls ``sendall``/``recv``.
    """

    def __init__(self, sock, plan: ChaosPlan, *,
                 reset_rate: float = 0.0, partial_rate: float = 0.0,
                 slow_rate: float = 0.0, slow_s: float = 0.05,
                 name: str = "socket"):
        self._sock = sock
        self._reset_rate = float(reset_rate)
        self._partial_rate = float(partial_rate)
        self._slow_rate = float(slow_rate)
        self._slow_s = float(slow_s)
        self._chan = plan.channel(name)
        self.resets = 0

    def _reset(self):
        import socket as _socket
        self.resets += 1
        try:
            # linger(on, 0): close() drops the connection with an RST
            # instead of an orderly FIN — the "client yanked the cable"
            # failure servers must shrug off
            self._sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_LINGER,
                                  struct.pack("ii", 1, 0))
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        raise ConnectionResetError("chaos: injected connection reset")

    def sendall(self, data: bytes):
        if self._chan.fire(self._reset_rate):
            self._reset()
        if self._chan.fire(self._partial_rate):
            self._sock.sendall(data[:max(1, len(data) // 2)])
            self._reset()
        if self._chan.fire(self._slow_rate):
            time.sleep(self._slow_s)
        return self._sock.sendall(data)

    def recv(self, bufsize: int, *flags):
        if self._chan.fire(self._slow_rate):
            time.sleep(self._slow_s)
        return self._sock.recv(bufsize, *flags)

    def __getattr__(self, attr):
        return getattr(self._sock, attr)


class ChaosTransport:
    """Frame-aware fault injection for :mod:`mmlspark_tpu_torch.io.transport`
    links — plug an instance factory into ``TransportConfig.socket_wrap``
    (one wrapper per accepted/dialed socket) so the chaos drills
    exercise the transport ITSELF, not just the app on top of it.

    The transport writes exactly one frame per ``sendall``, which is
    what makes frame-level injection possible from a socket wrapper:

    * ``bitflip_rate`` — flip one byte at a deterministic offset past
      the length prefix; the frame-wide CRC32C must catch it, the
      receiver kills the poisoned link, and the session resume must
      replay with zero loss and zero duplication.
    * ``ack_drop_rate`` — silently swallow outbound ACK frames, so the
      peer's replay buffer stays fat and a later resume replays frames
      the receiver already delivered — the sequence-dedup path.
    * ``kill_on_sends`` — exact send indices (1-based) that transmit
      roughly HALF the frame and then hard-reset (``SO_LINGER 0`` →
      RST): the seeded mid-frame link kill the resume contract is
      verified against.
    * ``reset_rate`` — per-send Bernoulli version of the same reset.
    * ``half_open_after`` — after N sends this side goes silent
      WITHOUT closing: writes are swallowed (reads still flow), which
      is exactly what a peer's keepalive timeout must detect as a
      half-open link.

    Counters: ``bitflips`` / ``ack_drops`` / ``resets`` /
    ``blackholed``.  Everything else delegates to the wrapped socket.
    """

    #: byte offset of the frame-type field (after the u32 length)
    _TYPE_OFF = 4

    def __init__(self, sock, plan: ChaosPlan, *,
                 bitflip_rate: float = 0.0, ack_drop_rate: float = 0.0,
                 reset_rate: float = 0.0,
                 kill_on_sends: Iterable[int] = (),
                 half_open_after: int = 0,
                 name: str = "transport"):
        self._sock = sock
        self._bitflip_rate = float(bitflip_rate)
        self._ack_drop_rate = float(ack_drop_rate)
        self._reset_rate = float(reset_rate)
        self._kill_on = frozenset(int(k) for k in kill_on_sends)
        self._half_open_after = int(half_open_after)
        self._chan = plan.channel(name)
        self._lock = threading.Lock()
        self.sends = 0
        self.bitflips = 0
        self.ack_drops = 0
        self.resets = 0
        self.blackholed = 0

    def _reset(self):
        import socket as _socket
        self.resets += 1
        try:
            self._sock.setsockopt(_socket.SOL_SOCKET, _socket.SO_LINGER,
                                  struct.pack("ii", 1, 0))
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        raise ConnectionResetError("chaos: injected transport reset")

    def sendall(self, data: bytes):
        with self._lock:
            self.sends += 1
            n = self.sends
        if self._half_open_after and n > self._half_open_after:
            # half-open: swallow silently, keep the socket "alive"
            self.blackholed += 1
            return None
        if n in self._kill_on:
            # mid-frame kill: the peer reads a torn frame, then RST
            try:
                self._sock.sendall(data[:max(1, len(data) // 2)])
            except OSError:
                pass
            self._reset()
        if self._chan.fire(self._reset_rate):
            self._reset()
        if (self._ack_drop_rate > 0 and len(data) > self._TYPE_OFF
                and data[self._TYPE_OFF] == _T_ACK
                and self._chan.fire(self._ack_drop_rate)):
            self.ack_drops += 1
            return None
        if self._chan.fire(self._bitflip_rate) and len(data) > 5:
            off = int(self._chan.uniform(self._TYPE_OFF,
                                         len(data) - 1))
            off = min(max(off, self._TYPE_OFF), len(data) - 1)
            self.bitflips += 1
            data = (data[:off] + bytes([data[off] ^ 0x40])
                    + data[off + 1:])
        return self._sock.sendall(data)

    def recv(self, bufsize: int, *flags):
        if self._half_open_after and self.sends > self._half_open_after:
            # the silent side also stops answering reads it would have
            # served — but must NOT close (that would be a clean FIN,
            # not a half-open link)
            time.sleep(0.05)
        return self._sock.recv(bufsize, *flags)

    def __getattr__(self, attr):
        return getattr(self._sock, attr)


class ChaosDrift:
    """Seeded mid-traffic data-drift injector: perturb ONE
    feature column of the request stream once a configured number of
    rows has flowed — the upstream-pipeline-change / sensor-failure
    event the drift monitor must detect.

    Wrap the drill's payload generator (or a feature matrix producer):
    ``drift(X)`` returns ``X`` untouched for the first ``after_rows``
    rows of cumulative traffic, then applies, to rows past that
    boundary (the cut can land mid-batch):

    * ``scale``/``shift`` — ``x → x * scale + shift`` (a recalibrated
      or re-unit'd upstream feature);
    * ``nan_rate`` — per-row Bernoulli NaN injection drawn from the
      plan's channel (the "feature went silently null" storm).

    ``ramp_rows > 0`` selects ramp mode: instead of a step
    change at the cut, the injected shift/scale interpolate linearly
    from no-op to full strength over the ``ramp_rows`` rows following
    ``after_rows`` — the slow upstream-degradation shape that must
    still cross the burn threshold.  The per-row ramp fraction is a
    pure function of the global row index, so the injected stream is
    identical regardless of batch boundaries.

    Deterministic like every injector: the NaN decision sequence is a
    pure function of ``(seed, name)`` and the row index.  Counters:
    ``rows_seen`` / ``rows_injected`` / ``nans_injected`` — the drill's
    injection ledger.  The input is never mutated in place (clients
    may reuse their row buffers)."""

    def __init__(self, plan: ChaosPlan, *, feature: int,
                 shift: float = 0.0, scale: float = 1.0,
                 nan_rate: float = 0.0, after_rows: int = 0,
                 ramp_rows: int = 0, name: str = "drift"):
        self.feature = int(feature)
        self.shift = float(shift)
        self.scale = float(scale)
        self.nan_rate = float(nan_rate)
        self.after_rows = int(after_rows)
        self.ramp_rows = int(ramp_rows)
        self._chan = plan.channel(name)
        self._lock = threading.Lock()
        self.rows_seen = 0
        self.rows_injected = 0
        self.nans_injected = 0

    def __call__(self, X):
        X = np.asarray(X)
        squeeze = X.ndim == 1
        if squeeze:
            X = X[None, :]
        n = X.shape[0]
        with self._lock:
            start = self.rows_seen
            self.rows_seen += n
        k0 = max(0, self.after_rows - start)
        if k0 >= n:
            return X[0] if squeeze else X
        X = X.astype(np.float32, copy=True)
        if self.ramp_rows > 0:
            # ramp fraction per global row index past the cut: row
            # ``after_rows + j`` carries (j+1)/ramp_rows of the full
            # perturbation, saturating at 1 — batch-boundary invariant
            j = np.arange(start + k0, start + n) - self.after_rows
            frac = np.minimum((j + 1) / self.ramp_rows, 1.0).astype(
                np.float32)
            eff_scale = 1.0 + (self.scale - 1.0) * frac
            eff_shift = self.shift * frac
            col = X[k0:, self.feature] * eff_scale + eff_shift
        else:
            col = X[k0:, self.feature] * self.scale + self.shift
        if self.nan_rate > 0:
            mask = np.fromiter(
                (self._chan.fire(self.nan_rate)
                 for _ in range(n - k0)), bool, count=n - k0)
            col[mask] = np.nan
            with self._lock:
                self.nans_injected += int(mask.sum())
        X[k0:, self.feature] = col
        with self._lock:
            self.rows_injected += n - k0
        return X[0] if squeeze else X


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
