"""Raw-float32 scoring wire: the zero-copy binary payload codec.

The port's copy of ``mmlspark_tpu/io/wire.py``; its blocks are the
reference's byte for byte.  JSON payloads cost one Python float object
per value, both directions, on every park frame and every reply.  This
module is the negotiated binary alternative that rides
:data:`~mmlspark_tpu_torch.io.transport.FLAG_BINARY` frames on the SCORING
channel:

* **Requests** (:func:`pack_matrix` / :func:`unpack_matrix`) — a 12-byte
  preamble ``(kind, rid_len, rows, cols)`` + the request id + one packed
  C-order ``(rows, cols)`` float32 block.  The receiver decodes the
  whole block with ONE ``np.frombuffer`` reshape
  (:meth:`~mmlspark_tpu_torch.io.scoring.ColumnPlan.decode` accepts the
  resulting array views directly): zero JSON, zero per-value Python
  objects.  Column order is the model's canonical feature order — the
  same contract the JSON wire's ``features`` vector already used.
* **Replies** (:func:`pack_replies` / :func:`unpack_replies`) — ONE
  frame per (session, micro-batch): an entry table
  ``(rid_len, n_values)`` per row followed by a single contiguous
  float32 block holding every row's margins back to back.  The sender
  serializes straight from the margin ndarray — no ``tolist()``, no
  per-row tuples of Python floats.
* **Partials** (``kind=K_PARTIAL`` on :func:`pack_matrix`) — the
  sharded fleet's tree-range partial margin blocks
  (:mod:`mmlspark_tpu_torch.io.fleet`): same matrix layout, the ``rid`` is
  the fleet request id.

Malformed payloads raise the typed :class:`WireError` — the serving
driver turns that into a per-request 400 (when the rid is recoverable,
:func:`peek_rid`), NEVER a connection teardown: one bad client costs
one request, exactly the per-row-400 contract the JSON decode path
already gives.

Telemetry: pack/unpack times land in the shared transport stats
(``encode_binary`` / ``decode_binary`` timers under ``ns="transport"``)
so the JSON-vs-binary codec cost is readable off any ``/metrics``
scrape; ``tools/bench_serving.py --wire`` commits the A/B.
"""

from __future__ import annotations

import struct
import time
from typing import Any, List, Sequence, Tuple

import numpy as np

from ..core.profiler import get_profiler
from .transport import transport_stats

__all__ = [
    "BinaryReq", "K_PARTIAL", "K_REPLY", "K_REQ", "WireError",
    "pack_matrix", "pack_replies", "peek_rid", "unpack_matrix",
    "unpack_replies",
]

#: payload kinds (first byte of every binary scoring payload)
K_REQ = 1        # feature matrix: score these rows
K_REPLY = 2      # batched margin replies (entry table + value block)
K_PARTIAL = 3    # tree-range partial margin sums (fleet reduce input)

#: matrix preamble: kind(u8) reserved(u8) rid_len(u16) rows(u32) cols(u32)
_MAT = struct.Struct("<BBHII")
#: reply preamble: kind(u8) reserved(u8) pad(u16) count(u32)
_REP = struct.Struct("<BBHI")
#: reply entry: rid_len(u16) n_values(u16)
_ENT = struct.Struct("<HH")

#: sanity ceiling on matrix width — a corrupt preamble must fail the
#: typed way, not attempt a terabyte reshape
MAX_COLS = 1 << 20

# the codec timers, resolved ONCE: StageStats.timer() takes a lock per
# call, a measurable tax at per-frame rates on the hot path
_ENC = transport_stats.timer("encode_binary")
_DEC = transport_stats.timer("decode_binary")
# profile-view aliases: shared histogram objects, so the
# binary codec phases cost nothing extra per frame
get_profiler().alias("transport.encode_binary", _ENC)
get_profiler().alias("transport.decode_binary", _DEC)


class WireError(ValueError):
    """Malformed binary scoring payload (truncated preamble, length
    mismatch, absurd dimensions).  Costs one request, never the
    connection."""


class BinaryReq:
    """A decoded binary scoring request as parked on the exchange
    queue: the float32 row view plus the frame-header deadline (binary
    payloads carry no ``_deadline_ms`` key — the deadline rides the
    transport header instead).  The engine's
    :class:`~mmlspark_tpu_torch.io.scoring.ColumnPlan` consumes the ``X``
    view directly."""

    __slots__ = ("X", "deadline_ms")

    def __init__(self, X: np.ndarray, deadline_ms=None):
        self.X = X
        self.deadline_ms = deadline_ms


def pack_matrix(rid: str, X: np.ndarray, kind: int = K_REQ) -> bytes:
    """Pack a ``(rows, cols)`` float32 matrix (a scoring request, or a
    fleet partial with ``kind=K_PARTIAL``).  ``X`` is made C-contiguous
    float32; the payload is preamble + rid + the raw block — one memcpy
    into the frame, nothing per value."""
    t0 = time.perf_counter()
    X = np.ascontiguousarray(X, dtype=np.float32)
    if X.ndim == 1:
        X = X.reshape(1, -1)
    if X.ndim != 2:
        raise WireError(f"matrix payload must be 2-D, got shape "
                        f"{X.shape}")
    rid_b = rid.encode("utf-8")
    if len(rid_b) > 0xFFFF:
        raise WireError(f"rid of {len(rid_b)} bytes exceeds the u16 "
                        "preamble field")
    buf = b"".join((_MAT.pack(kind, 0, len(rid_b), X.shape[0],
                              X.shape[1]),
                    rid_b, memoryview(X).cast("B")))
    _ENC.record(time.perf_counter() - t0)
    return buf


def peek_rid(buf) -> str:
    """Best-effort request id recovery from a (possibly malformed)
    matrix payload, so a bad preamble can still be answered with a
    per-request 400 instead of silently timing out the client.
    Returns ``""`` when unrecoverable."""
    if len(buf) < _MAT.size:
        return ""
    _k, _r, rid_len, _rows, _cols = _MAT.unpack_from(buf)
    end = _MAT.size + rid_len
    if rid_len == 0 or end > len(buf):
        return ""
    try:
        return bytes(buf[_MAT.size:end]).decode("utf-8")
    except UnicodeDecodeError:
        return ""


def unpack_matrix(buf) -> Tuple[int, str, np.ndarray]:
    """Decode a matrix payload: ``(kind, rid, X)`` where ``X`` is a
    read-only ``(rows, cols)`` float32 view over the frame bytes — ONE
    ``np.frombuffer`` reshape, no copies, no per-value objects.  Raises
    :class:`WireError` on any structural problem."""
    t0 = time.perf_counter()
    if len(buf) < _MAT.size:
        raise WireError(f"matrix payload of {len(buf)} bytes is shorter "
                        f"than the {_MAT.size}-byte preamble")
    kind, _r, rid_len, rows, cols = _MAT.unpack_from(buf)
    if kind not in (K_REQ, K_PARTIAL):
        raise WireError(f"unexpected matrix payload kind {kind}")
    if cols == 0 or cols > MAX_COLS:
        raise WireError(f"matrix payload claims {cols} columns")
    off = _MAT.size + rid_len
    want = off + rows * cols * 4
    if want != len(buf):
        raise WireError(
            f"matrix payload length mismatch: preamble claims "
            f"{rows}x{cols} float32 (+{rid_len}B rid = {want}B), frame "
            f"carries {len(buf)}B")
    try:
        rid = bytes(buf[_MAT.size:off]).decode("utf-8")
    except UnicodeDecodeError as e:
        raise WireError(f"non-UTF-8 rid in matrix payload: {e}") from e
    X = np.frombuffer(buf, np.float32, rows * cols, off).reshape(
        rows, cols)
    _DEC.record(time.perf_counter() - t0)
    return kind, rid, X


def pack_replies(entries: Sequence[Tuple[str, Any]]) -> bytes:
    """Pack one micro-batch of scored replies — ``entries`` is
    ``[(rid, values), ...]`` where ``values`` is a numpy scalar (single
    class) or a ``(K,)`` margin row.  The values serialize straight
    from the ndarray rows into ONE contiguous float32 block (this is
    the reply path that skips the per-row ``tolist()`` build)."""
    t0 = time.perf_counter()
    heads: List[bytes] = [b""]      # slot 0 becomes the preamble
    rids: List[bytes] = []
    vals: List[np.ndarray] = []
    for rid, v in entries:
        rid_b = rid.encode("utf-8")
        row = np.atleast_1d(np.asarray(v, dtype=np.float32)).ravel()
        if len(rid_b) > 0xFFFF or row.size > 0xFFFF:
            raise WireError("reply entry exceeds u16 preamble fields")
        heads.append(_ENT.pack(len(rid_b), row.size))
        rids.append(rid_b)
        vals.append(row)
    heads[0] = _REP.pack(K_REPLY, 0, 0, len(entries))
    block = (np.concatenate(vals) if vals
             else np.empty(0, np.float32))
    buf = b"".join(heads + rids + [memoryview(block).cast("B")])
    _ENC.record(time.perf_counter() - t0)
    return buf


def unpack_replies(buf) -> List[Tuple[str, np.ndarray]]:
    """Decode a reply payload into ``[(rid, values), ...]`` — the value
    arrays are float32 views into one frombuffer over the shared block.
    Raises :class:`WireError` on structural problems."""
    t0 = time.perf_counter()
    if len(buf) < _REP.size or buf[0] != K_REPLY:
        raise WireError("not a reply payload")
    _k, _r, _p, count = _REP.unpack_from(buf)
    off = _REP.size
    ent_bytes = count * _ENT.size
    if off + ent_bytes > len(buf):
        raise WireError(f"reply payload truncated in its {count}-entry "
                        "table")
    lens = [_ENT.unpack_from(buf, off + i * _ENT.size)
            for i in range(count)]
    off += ent_bytes
    rids: List[str] = []
    for rid_len, _n in lens:
        if off + rid_len > len(buf):
            raise WireError("reply payload truncated in its rid table")
        try:
            rids.append(bytes(buf[off:off + rid_len]).decode("utf-8"))
        except UnicodeDecodeError as e:
            raise WireError(f"non-UTF-8 rid in reply payload: "
                            f"{e}") from e
        off += rid_len
    total = sum(n for _l, n in lens)
    if off + total * 4 != len(buf):
        raise WireError(
            f"reply payload length mismatch: entry table claims "
            f"{total} float32 values, frame carries "
            f"{len(buf) - off} trailing bytes")
    block = np.frombuffer(buf, np.float32, total, off)
    out: List[Tuple[str, np.ndarray]] = []
    pos = 0
    for rid, (_l, n) in zip(rids, lens):
        out.append((rid, block[pos:pos + n]))
        pos += n
    _DEC.record(time.perf_counter() - t0)
    return out
