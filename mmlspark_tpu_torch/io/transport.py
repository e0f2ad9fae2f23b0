"""Unified resilient exchange transport.

The port's copy of ``mmlspark_tpu/io/transport.py``, stdlib only: the
frame layout, the handshake, the channel numbers and the CRC32C are the
reference's byte for byte, so a port endpoint and a reference endpoint
complete and resume sessions with each other.  One framed,
flow-controlled, resumable byte transport carries every socket protocol
of the serving plane — scoring request routing, worker stats beacons,
the ``/metrics`` scrape fan-in and the fleet's partial scores:

* **Framing** — length-prefixed binary frames with a fixed 28-byte
  header and a CRC32C over the payload; a corrupt or oversized frame is
  a typed error (:class:`ChecksumError` / :class:`FrameTooLarge`),
  never unbounded buffering or a stray ``UnicodeDecodeError``.
* **Handshake** — a 5-byte magic+version preamble followed by a tokened
  HELLO; non-protocol peers are dropped before they touch any state,
  wrong tokens get an ERROR frame and a close.  The token
  authenticates joiners — it does not encrypt the line (see
  docs/transport.md §Security for the canonical caveat).
* **Channels** — one TCP connection multiplexes logical channels
  (:data:`CH_SCORING`, :data:`CH_ELASTIC`, :data:`CH_STATS`,
  :data:`CH_METRICS`, :data:`CH_CONTROL`); each frame names its
  channel, so a slow metrics scrape shares the link with scoring
  traffic without a second protocol.
* **Flow control** — credit-based: a receiver grants an initial window
  and replenishes in batches as it *delivers* frames; a sender that
  exhausts credits blocks (counted as a backpressure stall) and raises
  :class:`Backpressure` past ``send_timeout_s`` — bounded queues on
  both sides, never an unbounded ``sendall`` pile-up.
* **Keepalive** — transport-level PING/PONG with an idle-receive
  deadline detects half-open TCP links (peer died without a FIN) and
  tears them down so the resume machinery can take over.
* **Deadline propagation** — each DATA frame carries the remaining
  milliseconds its sender gave it; receivers get it alongside the
  payload and can drop already-dead work instead of scoring it.
* **Resumable sessions** — every DATA frame is sequence-numbered per
  direction and cumulatively acked; senders keep unacked frames and a
  reconnect (bounded exponential backoff, jittered) replays exactly the
  suffix the peer has not seen — the receiver drops duplicates by
  sequence number, so a link blip loses nothing and duplicates nothing.
* **Binary payloads** — the frame header's ``flags`` field
  gained :data:`FLAG_BINARY`: a frame so marked carries raw bytes that
  are handed to the app ``on_message`` verbatim — no JSON encode on
  the sender, no ``json.loads`` on the receiver, zero per-value Python
  objects on the wire path.  The capability is NEGOTIATED at handshake
  (``bin: 1`` in HELLO/HELLO_ACK, see :attr:`Session.peer_binary`);
  ``send_bytes`` refuses when the peer did not negotiate it, so a
  version-skewed peer degrades to the JSON wire instead of receiving
  frames it would misparse.  The scoring hot path rides this as the
  raw-float32 wire (:mod:`mmlspark_tpu_torch.io.wire`).
* **Trace context** — ``send(..., tc={"tid": ...})`` attaches
  a reserved ``_tc`` payload key carrying the trace id and the sender's
  wall clock; both endpoints journal per-hop transport spans
  (``hop_enqueue`` / ``hop_send`` / ``hop_ack`` on the sender,
  ``hop_deliver`` with the send→recv clock offset on the receiver, a
  ``retrans`` flag on replayed sends), so ``tools/trace_report.py`` can
  stitch a scoring request's driver-side and worker-side spans into ONE
  cross-process timeline.  The ``_tc`` key is stripped before the app's
  ``on_message`` sees the payload.

Telemetry: all endpoints share :data:`transport_stats` (registered
under the ``transport`` namespace): ``frames_sent`` / ``frames_recvd``
/ ``bytes_sent`` / ``bytes_recvd`` / ``retransmits`` / ``crc_drops`` /
``dup_drops`` / ``backpressure_stalls`` / ``reconnects`` / ``resumes``
/ ``session_resets`` / ``keepalive_drops`` / ``oversize_rejected`` /
``handshake_rejects`` / ``bin_frames_sent`` / ``bin_frames_recvd``,
plus per-channel DATA payload byte counters
(``payload_bytes_sent_ch<N>`` / ``payload_bytes_recvd_ch<N>``) and the
wire codec timers (``encode_json`` / ``decode_json`` here;
``encode_binary`` / ``decode_binary`` recorded by
:mod:`mmlspark_tpu_torch.io.wire`) — the encode/decode cost of the two wires
is readable off one scrape, and ``tools/bench_serving.py --wire``
commits the A/B from exactly these numbers.

Chaos: :class:`~mmlspark_tpu_torch.io.chaos.ChaosTransport` wraps either
end's socket via ``TransportConfig.socket_wrap`` (frame bitflips, ack
loss, half-open stalls, mid-frame resets) so the drills exercise the
transport itself.  See docs/transport.md for the frame layout, channel
ids, resume semantics and tuning knobs.
"""

from __future__ import annotations

import hmac
import json
import logging
import random
import socket
import struct
import threading
import time
import uuid
from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

from ..core.capacity import capacity_enabled
from ..core.profiler import get_profiler
from ..core.profiling import StageStats
from ..core.telemetry import get_journal, get_registry

log = logging.getLogger(__name__)

__all__ = [
    "Backpressure", "CH_CONTROL", "CH_ELASTIC", "CH_METRICS",
    "CH_SCORING", "CH_STATS", "ChecksumError", "FLAG_BINARY",
    "FrameTooLarge", "HandshakeError", "Session", "TransportClient",
    "TransportConfig", "TransportError", "TransportServer", "crc32c",
    "parse_address", "transport_stats",
]

# -- protocol constants ------------------------------------------------------

#: connection preamble: 4 magic bytes + 1 version byte, sent by the
#: dialing side before any frame — a peer that does not lead with this
#: is not speaking the protocol and is dropped without touching state
MAGIC = b"MTPX"
VERSION = 1

# frame types (transport-internal; apps only ever see DATA payloads)
T_DATA = 1        # app payload on a channel; sequenced + acked
T_HELLO = 2       # client handshake: token, session id, last_recv
T_HELLO_ACK = 3   # server handshake answer: resumed?, last_recv, credits
T_ACK = 4         # bare cumulative ack (ack rides every header too)
T_CREDIT = 5      # flow-control grant (count in the seq field)
T_PING = 6        # keepalive probe
T_PONG = 7        # keepalive answer
T_ERROR = 8       # typed refusal: {code, detail}; sender closes after
T_CLOSE = 9       # orderly end of session: no resume expected

#: frame-header flag: the payload is raw bytes, NOT JSON — delivered
#: to the app ``on_message`` verbatim.  Only valid on T_DATA frames and
#: only after both peers negotiated ``bin`` at handshake; the scoring
#: hot path's raw-float32 wire (io/wire.py) rides this flag.
FLAG_BINARY = 0x0001

#: logical channels — one connection carries all of them
CH_CONTROL = 0    # session control: app hello, ready beacons, stop
CH_SCORING = 1    # scoring request routing: park / reply / expire / ack
CH_ELASTIC = 2    # elastic training: lease beacons, rendezvous control
CH_STATS = 3      # periodic worker stats beacons
CH_METRICS = 4    # /metrics scrape round-trips

#: header after the u32 length prefix:
#: type(u8) channel(u8) flags(u16) seq(u64) ack(u64) deadline_ms(u32)
#: then crc32c(u32) — 28 bytes total, then the payload.  The CRC
#: covers the 24 header bytes BEFORE it plus the payload, so a flipped
#: bit anywhere past the length prefix is caught (a corrupt ack or seq
#: would silently poison session state, worse than corrupt payload)
_HPREFIX = struct.Struct("<BBHQQI")
_CRC = struct.Struct("<I")
HEADER_BYTES = _HPREFIX.size + _CRC.size
_LEN = struct.Struct("<I")


# -- CRC32C (Castagnoli) -----------------------------------------------------

def _make_crc32c_table() -> Tuple[int, ...]:
    poly = 0x82F63B78
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ poly if c & 1 else c >> 1
        table.append(c)
    return tuple(table)


_CRC_TABLE = _make_crc32c_table()


def _crc32c_py(data: bytes, crc: int = 0) -> int:
    """Table-driven pure-Python CRC32C — the always-available fallback
    (~200 ns/byte; exchange frames are small, so still off every
    per-row hot path)."""
    c = crc ^ 0xFFFFFFFF
    tab = _CRC_TABLE
    for b in data:
        c = tab[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


try:                                    # C extension when the image has
    import google_crc32c as _gcrc32c    # it; no new dependency is added

    def crc32c(data: bytes, crc: int = 0) -> int:
        """CRC32C (Castagnoli) of ``data`` — the per-frame integrity
        check (native extension fast path; chaining via ``crc`` matches
        concatenation, same as the pure-Python fallback)."""
        return _gcrc32c.extend(crc, data)

    # the wire format is pinned by the RFC 3720 vector: refuse a fast
    # path that would frame with a DIFFERENT polynomial
    if crc32c(b"123456789") != 0xE3069283:   # pragma: no cover
        raise ImportError("google_crc32c produced a non-Castagnoli CRC")
except (ImportError, AttributeError):        # pragma: no cover
    crc32c = _crc32c_py


# -- typed errors ------------------------------------------------------------


class TransportError(OSError):
    """Base transport failure.  Subclasses ``OSError`` on purpose: every
    pre-transport call site guarded its bespoke socket writes with
    ``except OSError`` — those guards keep working unchanged."""


class FrameTooLarge(TransportError):
    """A frame exceeded ``max_frame_bytes`` (refused on send; on
    receive the link is closed instead of buffering without bound)."""


class ChecksumError(TransportError):
    """Payload CRC32C mismatch — the stream is poisoned; the link is
    closed and session resume replays the suffix."""


class HandshakeError(TransportError):
    """Magic/version/token refused during connection setup."""


class Backpressure(TransportError):
    """Send credits exhausted beyond ``send_timeout_s`` — the peer is
    not draining; the caller must shed or retry, not queue more."""


class _ProtocolError(TransportError):
    """Framing/sequencing violation (gap, unknown type) — link closed."""


# -- address parsing ---------------------------------------------------------


def parse_address(address: str) -> Tuple[str, int]:
    """Parse ``host:port`` (including bracketed IPv6 ``[::1]:9000``)
    with validation — malformed addresses raise a clear ``ValueError``
    here instead of failing deep inside ``create_connection``."""
    if not isinstance(address, str) or not address.strip():
        raise ValueError(f"malformed exchange address {address!r}: "
                         "expected 'host:port'")
    addr = address.strip()
    if addr.startswith("["):                   # bracketed IPv6
        end = addr.find("]")
        if end < 0:
            raise ValueError(f"malformed IPv6 address {address!r}: "
                             "missing closing ']'")
        host, rest = addr[1:end], addr[end + 1:]
        if not rest.startswith(":"):
            raise ValueError(f"malformed address {address!r}: expected "
                             "':port' after the bracketed IPv6 host")
        port_s = rest[1:]
    else:
        host, sep, port_s = addr.rpartition(":")
        if not sep or not host:
            raise ValueError(f"malformed exchange address {address!r}: "
                             "expected 'host:port'")
        if ":" in host and not host.startswith("["):
            raise ValueError(
                f"ambiguous IPv6 address {address!r}: bracket the host "
                f"as '[{host}]:{port_s}'")
    if not host:
        raise ValueError(f"malformed address {address!r}: empty host")
    try:
        port = int(port_s)
    except ValueError:
        raise ValueError(f"malformed address {address!r}: port "
                         f"{port_s!r} is not an integer") from None
    if not 0 < port < 65536:
        raise ValueError(f"malformed address {address!r}: port {port} "
                         "outside 1..65535")
    return host, port


# -- config + shared telemetry -----------------------------------------------


@dataclass
class TransportConfig:
    """Tuning knobs for one endpoint (documented in docs/transport.md)."""
    #: hard per-frame ceiling, enforced on send AND receive
    max_frame_bytes: int = 8 << 20
    #: flow-control window granted to the peer at handshake
    initial_credits: int = 256
    #: receiver re-grants after delivering this many frames
    credit_batch: int = 32
    #: receiver sends a bare ACK after this many unacked deliveries
    ack_every: int = 16
    #: send a PING when nothing was sent for this long
    keepalive_interval_s: float = 2.0
    #: declare the link half-open when nothing was RECEIVED for this
    #: long (must comfortably exceed the interval)
    keepalive_timeout_s: float = 10.0
    #: how long a blocked (credit-starved) send waits before raising
    #: :class:`Backpressure`
    send_timeout_s: float = 30.0
    #: handshake must complete within this long (silent peers dropped)
    preauth_timeout_s: float = 30.0
    #: how long the server keeps a disconnected session's state alive
    #: for resume before declaring it lost
    resume_grace_s: float = 30.0
    #: client reconnect budget: attempts, (base, cap) seconds; delays
    #: are exponential and jittered
    reconnect_tries: int = 5
    reconnect_backoff: Tuple[float, float] = (0.1, 2.0)
    connect_timeout_s: float = 10.0
    #: offer the FLAG_BINARY payload capability in the client HELLO.
    #: Production leaves this on; the wire-format A/B bench
    #: (``tools/bench_serving.py --wire json``) pins it off so BOTH
    #: directions measurably ride the JSON fallback
    offer_binary: bool = True
    #: chaos hook: wraps every raw socket right after connect/accept
    #: (:class:`~mmlspark_tpu_torch.io.chaos.ChaosTransport` plugs in here)
    socket_wrap: Optional[Callable[[socket.socket], Any]] = None


def _new_stats() -> StageStats:
    s = StageStats()
    for k in ("frames_sent", "frames_recvd", "bytes_sent", "bytes_recvd",
              "retransmits", "crc_drops", "dup_drops",
              "backpressure_stalls", "reconnects", "resumes",
              "session_resets", "keepalive_drops", "oversize_rejected",
              "handshake_rejects", "bin_frames_sent", "bin_frames_recvd"):
        s.incr(k, 0)
    # per-channel DATA payload bytes: the wire-format A/B
    # (tools/bench_serving.py --wire) reads payload volume per channel
    # straight off a scrape instead of instrumenting call sites
    for ch in (CH_CONTROL, CH_SCORING, CH_ELASTIC, CH_STATS, CH_METRICS):
        s.incr(f"payload_bytes_sent_ch{ch}", 0)
        s.incr(f"payload_bytes_recvd_ch{ch}", 0)
    return s


#: process-wide transport counters, shared by every endpoint in the
#: process and federated under the ``transport`` namespace so every
#: ``/metrics`` scrape carries them
transport_stats = _new_stats()
# JSON wire codec timers, resolved once (timer() locks per call — a
# measurable tax at per-frame rates; the binary codec in io/wire.py
# caches its timers the same way, so the A/B stays apples-to-apples)
_ENC_JSON = transport_stats.timer("encode_json")
_DEC_JSON = transport_stats.timer("decode_json")
# the continuous profiler's unified phase view: the codec
# timers are ALIASED (shared histogram objects — zero extra work per
# frame); only the wire-write phase records explicitly, on a timer
# resolved once
_PROF = get_profiler()
_PROF.alias("transport.encode_json", _ENC_JSON)
_PROF.alias("transport.decode_json", _DEC_JSON)
_PT_WIRE = _PROF.timer("transport.wire_write")
# the wire-write histogram is SHARED back into the transport namespace
# (same zero-copy adopt the profiler aliases use) so the capacity
# monitor's transport resource can window it from the registry — the
# knee estimator reads throughput (frames_sent) against wire-write
# latency, both under ns="transport"
transport_stats.adopt("wire_write", _PT_WIRE)
# per-channel payload-byte counter KEYS, precomputed for the same
# reason (no per-frame f-string build; channels above the table fall
# back to on-the-fly names)
_PB_SENT = tuple(f"payload_bytes_sent_ch{c}" for c in range(8))
_PB_RECVD = tuple(f"payload_bytes_recvd_ch{c}" for c in range(8))
_stats_registered = threading.Event()


def _ensure_registered() -> None:
    if not _stats_registered.is_set():
        get_registry().register("transport", transport_stats)
        _stats_registered.set()


# -- frame codec -------------------------------------------------------------


def encode_frame(ftype: int, channel: int, payload: bytes, *,
                 seq: int = 0, ack: int = 0, deadline_ms: int = 0,
                 flags: int = 0,
                 max_frame_bytes: int = 8 << 20) -> bytes:
    """One wire frame: u32 length, 28-byte header, payload."""
    size = HEADER_BYTES + len(payload)
    if size > max_frame_bytes:
        raise FrameTooLarge(
            f"frame of {size} bytes exceeds max_frame_bytes="
            f"{max_frame_bytes}")
    prefix = _HPREFIX.pack(ftype, channel, flags, seq, ack,
                           min(int(deadline_ms), 0xFFFFFFFF))
    crc = crc32c(payload, crc32c(prefix))
    return _LEN.pack(size) + prefix + _CRC.pack(crc) + payload


def _kill_socket(sock) -> None:
    """Tear a socket down so that a recv() blocked on it in ANOTHER
    thread wakes up: plain ``close()`` only drops the fd — the blocked
    reader can stay parked forever; ``shutdown`` delivers the EOF."""
    try:
        sock.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    try:
        sock.close()
    except OSError:
        pass


def _recv_exact(sock, n: int) -> bytes:
    """Read exactly ``n`` bytes or raise ``ConnectionError`` on EOF."""
    chunks = []
    got = 0
    while got < n:
        chunk = sock.recv(min(65536, n - got))
        if not chunk:
            raise ConnectionError("transport: peer closed mid-frame")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks) if len(chunks) != 1 else chunks[0]


def read_frame(sock, max_frame_bytes: int
               ) -> Tuple[int, int, int, int, int, int, bytes]:
    """Read one frame: ``(type, channel, flags, seq, ack, deadline_ms,
    payload)``.  Oversized frames raise :class:`FrameTooLarge` (the
    link must be closed — the stream cannot be re-synced); CRC
    mismatches raise :class:`ChecksumError`."""
    size = _LEN.unpack(_recv_exact(sock, 4))[0]
    if size > max_frame_bytes:
        transport_stats.incr("oversize_rejected")
        raise FrameTooLarge(
            f"incoming frame of {size} bytes exceeds max_frame_bytes="
            f"{max_frame_bytes}")
    if size < HEADER_BYTES:
        raise _ProtocolError(f"frame shorter than header ({size} bytes)")
    buf = _recv_exact(sock, size)
    ftype, channel, flags, seq, ack, deadline_ms = \
        _HPREFIX.unpack_from(buf)
    crc = _CRC.unpack_from(buf, _HPREFIX.size)[0]
    payload = buf[HEADER_BYTES:]
    if crc32c(payload, crc32c(buf[:_HPREFIX.size])) != crc:
        transport_stats.incr("crc_drops")
        raise ChecksumError(
            f"frame CRC32C mismatch on channel {channel} (seq {seq})")
    transport_stats.incr("frames_recvd")
    transport_stats.incr("bytes_recvd", 4 + size)
    return ftype, channel, flags, seq, ack, deadline_ms, payload


# -- session -----------------------------------------------------------------


class Session:
    """One resumable, flow-controlled, sequenced message stream.

    Both endpoints hold one ``Session`` per logical peer; the TCP
    connection underneath may come and go — ``attach``/``detach`` swap
    it while sequence numbers, the unacked replay buffer and the
    receive cursor persist, which is what makes a reconnect lossless
    and duplicate-free.

    ``send`` is safe from any thread.  Delivery callbacks run on the
    endpoint's read pump thread (same threading contract as the old
    line-protocol readers).
    """

    def __init__(self, sid: str, cfg: TransportConfig, *,
                 on_message: Optional[Callable] = None,
                 name: str = "session"):
        self.sid = sid
        self.cfg = cfg
        self.name = name
        self.on_message = on_message
        #: app scratch (the serving driver stores the worker slot here)
        self.meta: Dict[str, Any] = {}
        #: the peer negotiated :data:`FLAG_BINARY` payloads at handshake
        #: (``bin: 1`` in HELLO/HELLO_ACK); gates :meth:`send_bytes` so
        #: a version-skewed peer keeps getting the JSON wire
        self.peer_binary = False
        self._sock: Any = None
        self._slock = threading.Lock()      # wire write serialization
        self._cv = threading.Condition()    # credits + connect state
        self._credits = 0
        #: the credit window the peer last granted whole — the
        #: denominator for the ``credit_occupancy`` saturation gauge
        #: (1 - credits/window).  Taps are gated on the flag
        #: cached at session construction — one bool check per send
        #: when capacity observability is off.
        self._credit_window = max(1, int(cfg.initial_credits))
        self._cap_taps = capacity_enabled()
        self._next_seq = 0                  # last DATA seq assigned
        self._peer_ack = 0                  # highest seq peer confirmed
        #: seq -> (channel, payload, abs_deadline_monotonic|None, flags)
        self._unacked: "OrderedDict[int, Tuple[int, bytes, Optional[float], int]]" = OrderedDict()
        self._recv_seq = 0                  # highest contiguous seq seen
        self._since_ack = 0
        self._since_credit = 0
        #: seq -> trace id for in-flight TRACED frames (bounded by the
        #: replay buffer: entries drop when their seq is acked) and the
        #: subset already wired once (a second wire write is a
        #: retransmission, flagged on its hop_send span)
        self._traced: Dict[int, str] = {}
        self._traced_sent: set = set()
        #: highest seq actually written to the CURRENT link; the wire
        #: writer (``flush``) only ever writes ``_wired + 1`` next, so
        #: DATA frames hit the wire in strict sequence order no matter
        #: how sends and resumes interleave — a receiver can never see
        #: a gap that wasn't real loss
        self._wired = 0
        self.connected = False
        self.closed = False
        self.last_recv = time.monotonic()
        self.last_send = time.monotonic()

    # ---- connection lifecycle ----

    def attach(self, sock, ready: bool = True) -> None:
        """Install a live socket.  ``ready=False`` installs it for
        handshake writes only (``mark_connected`` later opens the DATA
        path) — the server must not let queued DATA race ahead of its
        HELLO_ACK."""
        with self._cv:
            self._sock = sock
            self.last_recv = time.monotonic()
            if ready:
                self.connected = True
            self._cv.notify_all()

    def mark_connected(self) -> None:
        with self._cv:
            self.connected = True
            self._cv.notify_all()

    def detach(self, sock=None) -> None:
        """Drop the current link.  With ``sock`` given, detach only if
        that exact socket is still the attached one — a finished pump
        must not tear down the replacement link a takeover or resume
        already attached."""
        with self._cv:
            if sock is not None and self._sock is not sock:
                old = sock          # close the caller's dead socket
            else:
                old, self._sock = self._sock, None
                self.connected = False
            self._cv.notify_all()
        if old is not None:
            _kill_socket(old)

    def close(self) -> None:
        """Orderly end: best-effort CLOSE frame, then drop the link and
        refuse further sends."""
        with self._cv:
            if self.closed:
                return
            self.closed = True
            self._cv.notify_all()
        try:
            self._wire_send(T_CLOSE, CH_CONTROL, b"")
        except OSError:
            pass
        self.detach()

    # ---- sending ----

    def _wire_send(self, ftype: int, channel: int, payload: bytes, *,
                   seq: int = 0, deadline_ms: int = 0) -> None:
        frame = encode_frame(ftype, channel, payload, seq=seq,
                             ack=self._recv_seq, deadline_ms=deadline_ms,
                             max_frame_bytes=self.cfg.max_frame_bytes)
        with self._slock:
            sock = self._sock
            if sock is None:
                raise TransportError("transport: link down")
            sock.sendall(frame)
            self.last_send = time.monotonic()
        transport_stats.incr("frames_sent")
        transport_stats.incr("bytes_sent", len(frame))

    def send(self, channel: int, obj: Any, *,
             deadline_ms: Optional[float] = None,
             timeout: Optional[float] = None,
             tc: Optional[Dict[str, Any]] = None) -> int:
        """Send one JSON message on ``channel``; returns its sequence
        number.  Blocks while credits are exhausted (a backpressure
        stall), raising :class:`Backpressure` past ``timeout``
        (default ``cfg.send_timeout_s``).  While the link is down the
        frame is queued in the replay buffer and goes out on resume;
        a CLOSEd session refuses with :class:`TransportError`.

        ``tc={"tid": trace_id}`` attaches the trace context as the
        reserved ``_tc`` payload key (requires a dict ``obj``), stamps
        the sender's wall clock into it, and journals ``hop_enqueue`` /
        ``hop_send`` / ``hop_ack`` spans for this frame's life so the
        trace reader can reconstruct the transport hop."""
        tid = None
        if tc is not None and isinstance(obj, dict):
            tid = str(tc.get("tid") or "") or None
        if tid:
            obj = dict(obj)
            obj["_tc"] = {"tid": tid, "sts": round(time.time(), 6)}
        t0 = time.perf_counter()
        payload = json.dumps(obj).encode("utf-8")
        _ENC_JSON.record(time.perf_counter() - t0)
        return self._enqueue(channel, payload, 0, deadline_ms,
                             timeout, tid)

    def send_bytes(self, channel: int, data, *,
                   deadline_ms: Optional[float] = None,
                   timeout: Optional[float] = None) -> int:
        """Send one RAW binary message on ``channel`` — the payload
        bytes reach the peer's ``on_message`` verbatim (no JSON on
        either side; :data:`FLAG_BINARY` rides the frame header).
        Requires the peer to have negotiated binary payloads at
        handshake (:attr:`peer_binary`) — callers gate on that flag and
        fall back to :meth:`send`; calling without it is a programming
        error and raises :class:`TransportError` rather than feeding a
        peer frames it would misparse.  Same credit/backpressure/replay
        semantics as :meth:`send`."""
        if not self.peer_binary:
            raise TransportError(
                f"{self.name}: peer did not negotiate binary payloads "
                "(send_bytes requires the handshake 'bin' capability)")
        payload = bytes(data)
        transport_stats.incr("bin_frames_sent")
        return self._enqueue(channel, payload, FLAG_BINARY, deadline_ms,
                             timeout, None)

    def _enqueue(self, channel: int, payload: bytes, flags: int,
                 deadline_ms: Optional[float],
                 timeout: Optional[float],
                 tid: Optional[str]) -> int:
        if HEADER_BYTES + len(payload) > self.cfg.max_frame_bytes:
            raise FrameTooLarge(
                f"message of {len(payload)} bytes exceeds "
                f"max_frame_bytes={self.cfg.max_frame_bytes}")
        budget = self.cfg.send_timeout_s if timeout is None else timeout
        deadline = time.monotonic() + budget
        with self._cv:
            if self.closed:
                raise TransportError("transport: session closed")
            stalled = False
            while self._credits <= 0 and not self.closed:
                stalled = True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    transport_stats.incr("backpressure_stalls")
                    raise Backpressure(
                        f"{self.name}: no send credits for {budget:.1f}s "
                        f"on channel {channel} (peer not draining)")
                self._cv.wait(min(remaining, 0.5))
            if self.closed:
                raise TransportError("transport: session closed")
            if stalled:
                transport_stats.incr("backpressure_stalls")
            self._credits -= 1
            if self._cap_taps:
                self._note_occupancy_locked()
            self._next_seq += 1
            seq = self._next_seq
            abs_deadline = (time.monotonic() + deadline_ms / 1e3
                            if deadline_ms else None)
            self._unacked[seq] = (channel, payload, abs_deadline, flags)
            if tid:
                self._traced[seq] = tid
        transport_stats.incr(
            _PB_SENT[channel] if channel < len(_PB_SENT)
            else f"payload_bytes_sent_ch{channel}", len(payload))
        if tid:
            get_journal().emit("hop_enqueue", tid=tid, channel=channel,
                               seq=seq, session=self.name)
        self.flush()
        return seq

    def flush(self) -> int:
        """Write every queued-but-unwired DATA frame, in strict
        sequence order, to the current link.  THE single wire writer
        for DATA frames: concurrent senders and the resume path all
        funnel through here under one lock, so the peer can never
        observe a sequence gap.  A dead link simply stops the flush —
        the frames stay queued for the next resume."""
        n = 0
        with self._slock:
            while True:
                with self._cv:
                    if not self.connected or self.closed:
                        return n
                    sock = self._sock
                    nxt = self._wired + 1
                    entry = self._unacked.get(nxt)
                if sock is None or entry is None:
                    return n
                channel, payload, abs_deadline, flags = entry
                remaining = 0
                if abs_deadline is not None:
                    remaining = max(
                        1, int((abs_deadline - time.monotonic()) * 1e3))
                frame = encode_frame(
                    T_DATA, channel, payload, seq=nxt,
                    ack=self._recv_seq, deadline_ms=remaining,
                    flags=flags,
                    max_frame_bytes=self.cfg.max_frame_bytes)
                t_w = time.perf_counter()
                try:
                    sock.sendall(frame)
                except OSError:
                    return n   # link died; resume re-flushes the rest
                if _PROF.enabled:
                    _PT_WIRE.record(time.perf_counter() - t_w)
                with self._cv:
                    self._wired = nxt
                    tid = self._traced.get(nxt)
                    retrans = tid is not None \
                        and nxt in self._traced_sent
                    if tid is not None:
                        self._traced_sent.add(nxt)
                self.last_send = time.monotonic()
                transport_stats.incr("frames_sent")
                transport_stats.incr("bytes_sent", len(frame))
                if tid is not None:
                    ev = {"tid": tid, "channel": channel, "seq": nxt,
                          "session": self.name}
                    if retrans:
                        ev["retrans"] = 1
                    get_journal().emit("hop_send", **ev)
                n += 1

    def prepare_resume(self, peer_last: int) -> int:
        """A (re)connect handshake told us the peer has everything up
        to ``peer_last``: drop the acked prefix and REWIND the wire
        cursor so the next ``flush`` retransmits exactly the unseen
        suffix.  Must run BEFORE the new link opens for DATA (attach /
        mark_connected), so no concurrent send can flush from the old
        cursor.  Returns the number of frames that will be
        retransmitted (were wired on a previous link)."""
        self.acknowledge(peer_last)
        with self._cv:
            redo = max(0, min(self._wired, self._next_seq) - peer_last)
            self._wired = peer_last
        if redo:
            transport_stats.incr("retransmits", redo)
        return redo

    def acknowledge(self, upto: int) -> None:
        """Peer confirmed everything ``<= upto``: drop it from the
        replay buffer (and close any traced frames' hop spans)."""
        acked_traced = []
        with self._cv:
            if upto <= self._peer_ack:
                return
            self._peer_ack = upto
            while self._unacked and next(iter(self._unacked)) <= upto:
                self._unacked.popitem(last=False)
            for seq in [s for s in self._traced if s <= upto]:
                acked_traced.append((seq, self._traced.pop(seq)))
                self._traced_sent.discard(seq)
        for seq, tid in acked_traced:
            get_journal().emit("hop_ack", tid=tid, seq=seq,
                               session=self.name)

    def _note_occupancy_locked(self) -> None:
        """Refresh the ``credit_occupancy`` gauge (fraction of the
        granted window currently consumed — 1.0 means the next send
        blocks on backpressure).  Called under ``self._cv``."""
        transport_stats.set_gauge(
            "credit_occupancy",
            round(1.0 - self._credits / self._credit_window, 4))

    def grant(self, n: int) -> None:
        """Receive an incremental flow-control grant of ``n`` frames."""
        with self._cv:
            self._credits += n
            if self._credits > self._credit_window:
                # the peer widened the window (credits above the last
                # whole grant): track it so occupancy stays in [0, 1]
                self._credit_window = self._credits
            if self._cap_taps:
                self._note_occupancy_locked()
            self._cv.notify_all()

    def set_credits(self, n: int) -> None:
        """(Re)connect: the peer granted a fresh window — REPLACE the
        balance (a stale pre-blip balance must not compound)."""
        with self._cv:
            self._credits = n
            self._credit_window = max(1, int(n))
            if self._cap_taps:
                self._note_occupancy_locked()
            self._cv.notify_all()

    def send_credit(self, n: int) -> None:
        """Grant the PEER ``n`` more frames (the count rides the seq
        field; CREDIT frames carry no payload)."""
        self._wire_send(T_CREDIT, CH_CONTROL, b"", seq=n)

    # ---- receiving ----

    def on_data_frame(self, channel: int, flags: int, seq: int,
                      deadline_ms: int, payload: bytes) -> None:
        """Sequence-check one inbound DATA frame and deliver it.
        Duplicates (replay overlap after a resume) are dropped by seq;
        a sequence GAP means the stream lost frames the resume protocol
        should have replayed — that is a protocol violation and the
        link is torn down rather than delivering out of order."""
        if seq <= self._recv_seq:
            transport_stats.incr("dup_drops")
            # refresh the peer's ack cursor so it stops replaying
            try:
                self._wire_send(T_ACK, CH_CONTROL, b"")
            except OSError:
                pass
            return
        if seq != self._recv_seq + 1:
            raise _ProtocolError(
                f"{self.name}: sequence gap (have {self._recv_seq}, "
                f"got {seq})")
        self._recv_seq = seq
        self._since_ack += 1
        self._since_credit += 1
        if self._since_ack >= self.cfg.ack_every:
            self._since_ack = 0
            try:
                self._wire_send(T_ACK, CH_CONTROL, b"")
            except OSError:
                pass
        transport_stats.incr(
            _PB_RECVD[channel] if channel < len(_PB_RECVD)
            else f"payload_bytes_recvd_ch{channel}", len(payload))
        if flags & FLAG_BINARY:
            # raw payload: hand the bytes to the app verbatim — the
            # scoring wire's whole point is that NOTHING decodes here
            transport_stats.incr("bin_frames_recvd")
            obj: Any = payload
        else:
            t0 = time.perf_counter()
            obj = json.loads(payload.decode("utf-8"))
            _DEC_JSON.record(time.perf_counter() - t0)
        if isinstance(obj, dict) and "_tc" in obj:
            # reserved trace-context key: strip it before the app sees
            # the payload, journal the delivery hop with the send→recv
            # wall-clock offset (network + skew — on one host, network)
            tc = obj.pop("_tc")
            if isinstance(tc, dict) and tc.get("tid"):
                try:
                    offset_ms = round(
                        (time.time() - float(tc["sts"])) * 1e3, 3)
                except (KeyError, TypeError, ValueError):
                    offset_ms = None
                get_journal().emit(
                    "hop_deliver", tid=str(tc["tid"]), channel=channel,
                    seq=seq, offset_ms=offset_ms, session=self.name)
        try:
            if self.on_message is not None:
                try:
                    self.on_message(self, channel, obj,
                                    deadline_ms if deadline_ms else None)
                except Exception:  # noqa: BLE001 - a malformed message
                    # (version-skewed peer, app bug) must cost exactly
                    # ONE message, never the connection thread — the
                    # guarantee the old line-protocol reader gave for
                    # its stray KeyErrors
                    log.exception(
                        "%s: message handler failed on channel %d; "
                        "dropping that message", self.name, channel)
        finally:
            if self._since_credit >= self.cfg.credit_batch:
                batch, self._since_credit = self._since_credit, 0
                try:
                    self.send_credit(batch)
                except OSError:
                    pass   # link died; resume re-grants a full window

    def pump(self, sock) -> None:
        """Read frames off ``sock`` until it dies or the session ends.
        Raises nothing: all link failures end the pump after counting;
        the caller decides whether to resume."""
        try:
            while not self.closed:
                (ftype, channel, flags, seq, ack, deadline_ms,
                 payload) = read_frame(sock, self.cfg.max_frame_bytes)
                self.last_recv = time.monotonic()
                if ack:
                    self.acknowledge(ack)
                if ftype == T_DATA:
                    self.on_data_frame(channel, flags, seq, deadline_ms,
                                       payload)
                elif ftype == T_CREDIT:
                    self.grant(seq)
                elif ftype == T_PING:
                    try:
                        self._wire_send(T_PONG, CH_CONTROL, b"")
                    except OSError:
                        pass
                elif ftype in (T_PONG, T_ACK):
                    pass                     # header bookkeeping only
                elif ftype == T_CLOSE:
                    with self._cv:
                        self.closed = True
                        self._cv.notify_all()
                elif ftype == T_ERROR:
                    log.warning("%s: peer error frame: %s", self.name,
                                payload[:200].decode("utf-8", "replace"))
                    with self._cv:
                        self.closed = True
                        self._cv.notify_all()
                else:
                    raise _ProtocolError(
                        f"{self.name}: unknown frame type {ftype}")
        except (ChecksumError, FrameTooLarge, _ProtocolError) as e:
            # poisoned / hostile stream: kill the link; session resume
            # replays whatever the teardown lost
            log.warning("%s: closing link: %s", self.name, e)
        except (OSError, ValueError):
            pass                             # link died / torn JSON tail

    def keepalive_tick(self) -> bool:
        """One keepalive step; returns False when the link is half-open
        (nothing received for ``keepalive_timeout_s``) — the caller
        must tear the connection down."""
        now = time.monotonic()
        if not self.connected:
            return True
        if now - self.last_recv > self.cfg.keepalive_timeout_s:
            transport_stats.incr("keepalive_drops")
            log.warning("%s: half-open link (nothing received for "
                        "%.1fs); dropping", self.name,
                        now - self.last_recv)
            return False
        if now - self.last_send >= self.cfg.keepalive_interval_s:
            try:
                self._wire_send(T_PING, CH_CONTROL, b"")
            except OSError:
                pass
        return True

    # ---- introspection ----

    @property
    def unacked_frames(self) -> int:
        with self._cv:
            return len(self._unacked)

    def reset_stream(self, credits: int) -> None:
        """Forget all stream state (the server lost our session): seqs
        restart, the replay buffer is dropped, a fresh window applies.
        The app layer is responsible for re-establishing its state
        (re-hello, re-park)."""
        with self._cv:
            self._next_seq = 0
            self._peer_ack = 0
            self._recv_seq = 0
            self._since_ack = 0
            self._since_credit = 0
            self._wired = 0
            self._unacked.clear()
            self._traced.clear()
            self._traced_sent.clear()
            self._credits = credits
            self._credit_window = max(1, int(credits))
            if self._cap_taps:
                self._note_occupancy_locked()
            self._cv.notify_all()
        transport_stats.incr("session_resets")


# -- server ------------------------------------------------------------------


class TransportServer:
    """Accepts transport connections, authenticates, and keeps sessions
    resumable across link drops.

    ``on_message(session, channel, obj, deadline_ms)`` runs on the
    connection's read pump; ``on_session(session)`` fires once per NEW
    session (not on resume); ``on_session_lost(session)`` fires when a
    disconnected session's ``resume_grace_s`` expires, when the peer
    sends CLOSE, or when :meth:`drop_session` is called — exactly once
    per session.

    The listener binds in the constructor (so the address is known and
    early dialers queue in the backlog) and accepting starts at
    :meth:`start` — the pre-start dial pattern the serving exchange
    relies on.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0, *,
                 token: str = "", cfg: Optional[TransportConfig] = None,
                 on_message: Optional[Callable] = None,
                 on_session: Optional[Callable] = None,
                 on_session_lost: Optional[Callable] = None,
                 name: str = "transport-server"):
        self.cfg = cfg or TransportConfig()
        self.token = token
        self.name = name
        self.on_message = on_message
        self.on_session = on_session
        self.on_session_lost = on_session_lost
        self.sessions: Dict[str, Session] = {}
        self._dc_since: Dict[str, float] = {}   # sid -> detach time
        self._lock = threading.Lock()
        self._closing = threading.Event()
        self._listener = socket.socket()
        self._listener.setsockopt(socket.SOL_SOCKET,
                                  socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(128)
        self._listener.settimeout(0.2)
        self._accept_thread: Optional[threading.Thread] = None
        self._reaper_thread: Optional[threading.Thread] = None
        _ensure_registered()

    @property
    def address(self) -> Tuple[str, int]:
        return self._listener.getsockname()[:2]

    def start(self) -> "TransportServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name=f"{self.name}-accept",
            daemon=True)
        self._accept_thread.start()
        self._reaper_thread = threading.Thread(
            target=self._reaper_loop, name=f"{self.name}-reaper",
            daemon=True)
        self._reaper_thread.start()
        return self

    def stop(self) -> None:
        self._closing.set()
        try:
            self._listener.close()
        except OSError:
            pass
        with self._lock:
            sessions = list(self.sessions.values())
            self.sessions.clear()
            self._dc_since.clear()
        for s in sessions:
            s.close()
        for t in (self._accept_thread, self._reaper_thread):
            if t is not None:
                t.join(timeout=5)

    def drop_session(self, sid: str, *, notify: bool = True) -> None:
        """Forget a session now (no resume).  ``notify`` fires
        ``on_session_lost`` — the takeover path passes False because
        the slot moved, it was not lost."""
        with self._lock:
            session = self.sessions.pop(sid, None)
            self._dc_since.pop(sid, None)
        if session is None:
            return
        session.close()
        if notify and self.on_session_lost is not None:
            try:
                self.on_session_lost(session)
            except Exception:  # noqa: BLE001
                log.exception("%s: on_session_lost failed", self.name)

    # ---- internals ----

    def _accept_loop(self) -> None:
        while not self._closing.is_set():
            try:
                conn, _addr = self._listener.accept()
            except (TimeoutError, OSError):
                continue
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True,
                             name=f"{self.name}-conn").start()

    def _reaper_loop(self) -> None:
        while not self._closing.wait(0.5):
            horizon = time.monotonic() - self.cfg.resume_grace_s
            with self._lock:
                expired = [sid for sid, t in self._dc_since.items()
                           if t < horizon]
            for sid in expired:
                with self._lock:
                    s = self.sessions.get(sid)
                    if s is not None and s.connected:
                        # resumed while the entry aged (park/attach
                        # race): live sessions are never reaped
                        self._dc_since.pop(sid, None)
                        continue
                log.warning("%s: session %s resume grace expired; "
                            "declaring it lost", self.name, sid[:8])
                self.drop_session(sid)

    def _handshake(self, conn
                   ) -> Optional[Tuple[Session, bool, int, int]]:
        """Run the server half of the handshake.  Returns ``(session,
        resumed, peer_last_recv, peer_granted_credits)`` or ``None``
        when the peer was refused (already closed)."""
        preamble = _recv_exact(conn, len(MAGIC) + 1)
        if preamble[:len(MAGIC)] != MAGIC:
            transport_stats.incr("handshake_rejects")
            log.warning("%s: dropping non-protocol peer (bad magic)",
                        self.name)
            return None
        if preamble[len(MAGIC)] != VERSION:
            transport_stats.incr("handshake_rejects")
            self._refuse(conn, "bad_version",
                         f"server speaks v{VERSION}, "
                         f"peer sent v{preamble[len(MAGIC)]}")
            return None
        ftype, _ch, _fl, _seq, _ack, _dl, payload = read_frame(
            conn, self.cfg.max_frame_bytes)
        if ftype != T_HELLO:
            transport_stats.incr("handshake_rejects")
            self._refuse(conn, "bad_handshake",
                         "first frame must be HELLO")
            return None
        hello = json.loads(payload.decode("utf-8"))
        if not hmac.compare_digest(
                str(hello.get("token", "")).encode("utf-8"),
                self.token.encode("utf-8")):
            transport_stats.incr("handshake_rejects")
            log.warning("%s: dropping peer with bad or missing token",
                        self.name)
            self._refuse(conn, "bad_token", "token mismatch")
            return None
        sid = str(hello.get("session") or "") or uuid.uuid4().hex
        peer_last = int(hello.get("last_recv", 0))
        peer_credits = int(hello.get("credits",
                                     self.cfg.initial_credits))
        with self._lock:
            session = self.sessions.get(sid)
            resumed = session is not None
            if session is None:
                session = Session(sid, self.cfg,
                                  on_message=self._dispatch,
                                  name=f"{self.name}:{sid[:8]}")
                self.sessions[sid] = session
            self._dc_since.pop(sid, None)
        # binary-payload capability: negotiated per HANDSHAKE (a resume
        # from an upgraded or downgraded peer re-evaluates it)
        session.peer_binary = bool(hello.get("bin"))
        if resumed:
            session.detach()   # a takeover replaces any stale link
        return session, resumed, peer_last, peer_credits

    def _refuse(self, conn, code: str, detail: str) -> None:
        try:
            payload = json.dumps({"code": code,
                                  "detail": detail}).encode("utf-8")
            conn.sendall(encode_frame(T_ERROR, CH_CONTROL, payload))
        except OSError:
            pass
        try:
            conn.close()
        except OSError:
            pass

    def _dispatch(self, session: Session, channel: int, obj: Any,
                  deadline_ms: Optional[float]) -> None:
        if self.on_message is not None:
            self.on_message(session, channel, obj, deadline_ms)

    def _serve_conn(self, conn) -> None:
        session = None
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            conn.settimeout(self.cfg.preauth_timeout_s)
            if self.cfg.socket_wrap is not None:
                conn = self.cfg.socket_wrap(conn)
            shake = self._handshake(conn)
            if shake is None:
                return
            session, resumed, peer_last, peer_credits = shake
            if resumed:
                # rewind the wire cursor BEFORE the link opens for
                # DATA: a concurrent send must replay the unseen
                # suffix, not continue from the dead link's cursor
                session.prepare_resume(peer_last)
            # ready=False: the socket serves the HELLO_ACK only —
            # queued DATA must not race ahead of it
            session.attach(conn, ready=False)
            ack_payload = json.dumps({
                "session": session.sid, "resumed": resumed,
                "last_recv": session._recv_seq,
                "credits": self.cfg.initial_credits,
                "bin": 1 if session.peer_binary else 0}).encode("utf-8")
            session._wire_send(T_HELLO_ACK, CH_CONTROL, ack_payload)
        except (OSError, ValueError, KeyError):
            # pre-auth timeout, torn handshake, garbage peer — nothing
            # registered (or the session stays parked for resume)
            try:
                conn.close()
            except OSError:
                pass
            if session is not None:
                self._park(session)
            return
        self._run_session(session, conn, resumed, peer_credits)

    def _run_session(self, session: Session, conn, resumed: bool,
                     peer_credits: int) -> None:
        try:
            conn.settimeout(None)
            # the peer's HELLO granted our send window; a resume
            # REPLACES any stale pre-blip balance
            session.set_credits(peer_credits)
            session.mark_connected()
            # clear any disconnect stamp the OLD link's teardown raced
            # in between attach and mark_connected — a stale stamp
            # would silently shorten the next blip's resume grace
            with self._lock:
                self._dc_since.pop(session.sid, None)
            if resumed:
                transport_stats.incr("resumes")
                get_journal().emit("transport_resume",
                                   session=session.name,
                                   unacked=session.unacked_frames)
                session.flush()   # retransmit the unseen suffix
            elif self.on_session is not None:
                try:
                    self.on_session(session)
                except Exception:  # noqa: BLE001
                    log.exception("%s: on_session failed", self.name)
            ka = threading.Thread(target=self._keepalive,
                                  args=(session, conn), daemon=True,
                                  name=f"{self.name}-keepalive")
            ka.start()
            session.pump(conn)
        finally:
            self._park(session, conn)

    def _park(self, session: Session, conn=None) -> None:
        """The link died: keep the session for resume (or finish it if
        the peer CLOSEd)."""
        session.detach(conn)
        if session.closed:
            self.drop_session(session.sid)
            return
        with self._lock:
            if session.sid in self.sessions and not session.connected:
                self._dc_since.setdefault(session.sid, time.monotonic())

    def _keepalive(self, session: Session, conn) -> None:
        step = max(0.2, self.cfg.keepalive_interval_s / 2)
        while (session.connected and session._sock is conn
               and not self._closing.is_set() and not session.closed):
            if not session.keepalive_tick():
                _kill_socket(conn)   # wake the pump; resume takes over
                return
            time.sleep(step)


# -- client ------------------------------------------------------------------


class TransportClient:
    """Dials a :class:`TransportServer`, keeps ONE resumable session
    across reconnects (bounded exponential backoff with jitter), and
    replays unacked frames on resume.

    Callbacks (all optional):

    * ``on_message(session, channel, obj, deadline_ms)`` — inbound app
      payloads, on the read pump thread.
    * ``on_connect(resumed: bool)`` — after every successful handshake
      (the serving worker sends its app hello + re-parks here).
    * ``on_session_reset()`` — the server did NOT recognize our session
      (state reaped / server restarted): stream state was reset and the
      app must re-establish its world.
    * ``on_disconnect()`` — the link just dropped (reconnect begins).
    * ``on_down()`` — the reconnect budget is exhausted; the session is
      closed and stays closed.
    """

    def __init__(self, address, *, token: str = "",
                 cfg: Optional[TransportConfig] = None,
                 on_message: Optional[Callable] = None,
                 on_connect: Optional[Callable] = None,
                 on_session_reset: Optional[Callable] = None,
                 on_disconnect: Optional[Callable] = None,
                 on_down: Optional[Callable] = None,
                 name: str = "transport-client"):
        if isinstance(address, str):
            address = parse_address(address)
        self.address = (address[0], int(address[1]))
        self.token = token
        self.cfg = cfg or TransportConfig()
        self.name = name
        self.on_connect = on_connect
        self.on_session_reset = on_session_reset
        self.on_disconnect = on_disconnect
        self.on_down = on_down
        self.session = Session(uuid.uuid4().hex, self.cfg,
                               on_message=on_message, name=name)
        self._lock = threading.Lock()
        self._pump_thread: Optional[threading.Thread] = None
        self._ka_thread: Optional[threading.Thread] = None
        self._reconnecting = False
        #: set by every dead pump; consumed by the reconnect loop — a
        #: reconnect REQUEST must never be lost to the in-progress
        #: guard (see _reconnect_loop)
        self._reconnect_pending = False
        self._local_close = False
        _ensure_registered()

    # ---- public surface ----

    @property
    def connected(self) -> bool:
        return self.session.connected

    @property
    def closed(self) -> bool:
        return self.session.closed

    def send(self, channel: int, obj: Any, *,
             deadline_ms: Optional[float] = None,
             timeout: Optional[float] = None,
             tc: Optional[Dict[str, Any]] = None) -> int:
        return self.session.send(channel, obj, deadline_ms=deadline_ms,
                                 timeout=timeout, tc=tc)

    def send_bytes(self, channel: int, data, *,
                   deadline_ms: Optional[float] = None,
                   timeout: Optional[float] = None) -> int:
        return self.session.send_bytes(channel, data,
                                       deadline_ms=deadline_ms,
                                       timeout=timeout)

    def connect(self, *, retries: Optional[int] = None
                ) -> "TransportClient":
        """Dial and handshake; raises on failure after the bounded
        retry budget (``cfg.reconnect_tries`` unless overridden)."""
        budget = self.cfg.reconnect_tries if retries is None else retries
        last: Optional[BaseException] = None
        for attempt in range(max(1, int(budget) + 1)):
            if attempt:
                time.sleep(self._backoff(attempt - 1))
            try:
                self._dial_once()
                return self
            except HandshakeError:
                raise    # deterministic refusal: retrying cannot help
            except (OSError, ValueError) as e:
                last = e
        raise TransportError(
            f"{self.name}: could not reach "
            f"{self.address[0]}:{self.address[1]} after "
            f"{budget + 1} attempts: {last}") from last

    def close(self) -> None:
        self._local_close = True
        self.session.close()
        t = self._pump_thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5)

    # ---- internals ----

    def _backoff(self, attempt: int) -> float:
        base, cap = self.cfg.reconnect_backoff
        delay = min(base * (2 ** attempt), cap)
        # jitter spreads simultaneous reconnects (a killed exchange
        # would otherwise see every worker re-dial in lockstep)
        return delay * random.uniform(0.5, 1.5)

    def _dial_once(self) -> None:
        sock = socket.create_connection(
            self.address, timeout=self.cfg.connect_timeout_s)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self.cfg.socket_wrap is not None:
                sock = self.cfg.socket_wrap(sock)
            sock.settimeout(self.cfg.preauth_timeout_s)
            sock.sendall(MAGIC + bytes([VERSION]))
            hello = json.dumps({
                "token": self.token, "session": self.session.sid,
                "last_recv": self.session._recv_seq,
                "credits": self.cfg.initial_credits,
                "bin": 1 if self.cfg.offer_binary else 0
                }).encode("utf-8")
            sock.sendall(encode_frame(
                T_HELLO, CH_CONTROL, hello,
                max_frame_bytes=self.cfg.max_frame_bytes))
            ftype, _ch, _fl, _seq, _ack, _dl, payload = read_frame(
                sock, self.cfg.max_frame_bytes)
            if ftype == T_ERROR:
                err = json.loads(payload.decode("utf-8"))
                raise HandshakeError(
                    f"{self.name}: server refused handshake: "
                    f"{err.get('code')} ({err.get('detail')})")
            if ftype != T_HELLO_ACK:
                raise HandshakeError(
                    f"{self.name}: expected HELLO_ACK, got frame type "
                    f"{ftype}")
            ack = json.loads(payload.decode("utf-8"))
            resumed = bool(ack.get("resumed"))
            credits = int(ack.get("credits",
                                  self.cfg.initial_credits))
            # binary capability confirmed by the server (an old server
            # omits the key → JSON wire everywhere)
            self.session.peer_binary = bool(ack.get("bin"))
            sock.settimeout(None)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise
        had_state = self.session._next_seq > 0 \
            or self.session._recv_seq > 0
        if resumed:
            # rewind BEFORE the link opens so any concurrent send
            # flushes the replay suffix in order
            self.session.prepare_resume(int(ack.get("last_recv", 0)))
            self.session.set_credits(credits)
            self.session.attach(sock)
            transport_stats.incr("resumes")
            get_journal().emit("transport_resume", session=self.name,
                               unacked=self.session.unacked_frames)
            self.session.flush()
        else:
            if had_state:
                # the server forgot us: full stream reset — the app
                # must rebuild its world (re-hello, re-park)
                log.warning("%s: server did not recognize session %s; "
                            "resetting stream state", self.name,
                            self.session.sid[:8])
                self.session.reset_stream(credits)
            else:
                self.session.set_credits(credits)
            self.session.attach(sock)
            self.session.flush()
        self._start_pumps(sock)
        if not resumed and had_state and self.on_session_reset is not None:
            try:
                self.on_session_reset()
            except Exception:  # noqa: BLE001
                log.exception("%s: on_session_reset failed", self.name)
        if self.on_connect is not None:
            try:
                self.on_connect(resumed)
            except Exception:  # noqa: BLE001
                log.exception("%s: on_connect failed", self.name)

    def _start_pumps(self, sock) -> None:
        self._pump_thread = threading.Thread(
            target=self._pump, args=(sock,), daemon=True,
            name=f"{self.name}-pump")
        self._pump_thread.start()
        self._ka_thread = threading.Thread(
            target=self._keepalive, args=(sock,), daemon=True,
            name=f"{self.name}-keepalive")
        self._ka_thread.start()

    def _pump(self, sock) -> None:
        self.session.pump(sock)
        self.session.detach(sock)
        if self.session.closed:
            # PEER-initiated end (T_CLOSE / T_ERROR) is still "session
            # over" for the app — a worker blocked on stop_evt must
            # learn about it; a locally requested close() already has
            # its caller in control and gets no callback
            if not self._local_close and self.on_down is not None:
                try:
                    self.on_down()
                except Exception:  # noqa: BLE001
                    log.exception("%s: on_down failed", self.name)
            return
        # unexpected drop: reconnect with bounded, jittered backoff
        if self.on_disconnect is not None:
            try:
                self.on_disconnect()
            except Exception:  # noqa: BLE001
                log.exception("%s: on_disconnect failed", self.name)
        self._reconnect_loop()

    def _keepalive(self, sock) -> None:
        step = max(0.2, self.cfg.keepalive_interval_s / 2)
        while (self.session.connected and self.session._sock is sock
               and not self.session.closed):
            if not self.session.keepalive_tick():
                _kill_socket(sock)   # wake the pump → reconnect path
                return
            time.sleep(step)

    def _reconnect_loop(self) -> None:
        """Re-dial with bounded, jittered backoff.  Entry records a
        reconnect REQUEST before the in-progress guard: a link that
        dies milliseconds after a successful resume (a poisoned link
        the chaos drill builds deliberately) has its pump call here
        while the PREVIOUS loop is still unwinding past its dial — the
        old guard silently dropped that request and the client never
        reconnected again.  Now the running loop re-checks the pending
        flag after every successful dial (and once more as it exits),
        so a racing teardown always gets its redial."""
        with self._lock:
            self._reconnect_pending = True
            if self._reconnecting or self.session.closed:
                return
            self._reconnecting = True
        try:
            while True:
                with self._lock:
                    if self.session.closed \
                            or not self._reconnect_pending:
                        return
                    self._reconnect_pending = False
                redialed = False
                for attempt in range(
                        max(0, int(self.cfg.reconnect_tries))):
                    time.sleep(self._backoff(attempt))
                    if self.session.closed:
                        return
                    try:
                        self._dial_once()
                        transport_stats.incr("reconnects")
                        redialed = True
                        break
                    except (OSError, ValueError):
                        continue
                if not redialed:
                    log.warning("%s: reconnect budget exhausted; "
                                "session down", self.name)
                    self.session.close()
                    if self.on_down is not None:
                        try:
                            self.on_down()
                        except Exception:  # noqa: BLE001
                            log.exception("%s: on_down failed",
                                          self.name)
                    return
                # dialed: loop — if the new link already died, its pump
                # set _reconnect_pending and the next pass redials
        finally:
            with self._lock:
                self._reconnecting = False
                retry = self._reconnect_pending \
                    and not self.session.closed
            if retry:
                # a pump died between our last pending check and the
                # guard release: process its request (bounded — each
                # recursion consumes one pending request)
                self._reconnect_loop()
