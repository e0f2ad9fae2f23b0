"""The port's framed transport (``mmlspark_tpu_torch.io.transport``) and
raw-float32 wire (``io.wire``) against the JAX package's, on the CPU.

* Frames, CRC32C values (the C extension where present and the
  pure-Python table, which is what runs where the extension is absent),
  request and reply blocks are the reference's byte for byte;
  ``parse_address`` accepts and refuses what the reference does.
* Interop: a port client completes a session with a reference server
  and a reference client with a port server, and both sessions resume
  after the port's ``ChaosTransport`` kills the link mid-frame, with no
  message lost or duplicated.
* The port alone: handshake, credit flow control, deadlines, keepalive,
  resume after link kills, ACK loss and bit flips, the negotiated binary
  wire, the transport's telemetry, and the framing guard (only
  ``io/transport.py`` frames bytes on a socket in the port).
"""

import os
import re
import socket
import struct
import threading
import time

import numpy as np
import pytest

from mmlspark_tpu.io import transport as rtp
from mmlspark_tpu.io import wire as rwire
from mmlspark_tpu_torch.io import transport as tp
from mmlspark_tpu_torch.io import wire
from mmlspark_tpu_torch.io.chaos import ChaosPlan, ChaosTransport
from mmlspark_tpu_torch.io.transport import (CH_CONTROL, CH_SCORING,
                                             Backpressure, ChecksumError,
                                             FrameTooLarge, HandshakeError,
                                             Session, TransportClient,
                                             TransportConfig,
                                             TransportServer, crc32c,
                                             encode_frame, parse_address,
                                             read_frame)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _drain(lst, n, timeout=10.0):
    deadline = time.time() + timeout
    while len(lst) < n and time.time() < deadline:
        time.sleep(0.005)
    return len(lst)


def _echo_server(mod=tp, token="tok", cfg=None):
    """A ``mod.TransportServer`` echoing every scoring message (JSON or
    binary) back."""

    def on_msg(sess, ch, obj, dl):
        if ch != mod.CH_SCORING:
            return
        if isinstance(obj, (bytes, memoryview)):
            sess.send_bytes(ch, bytes(obj))
        elif obj.get("op") == "echo":
            sess.send(ch, {"op": "reply", "v": obj["v"]})

    return mod.TransportServer(token=token, cfg=cfg, on_message=on_msg,
                               name="echo-server").start()


# -- byte parity -------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 3, 9, 64, 1000])
def test_crc32c_equals_the_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n,
                                             dtype=np.uint8).tobytes()
    want = rtp.crc32c(data)
    assert tp.crc32c(data) == want
    assert tp._crc32c_py(data) == want == rtp._crc32c_py(data)
    # chaining matches concatenation in both forms
    h = len(data) // 2
    assert tp._crc32c_py(data[h:], tp._crc32c_py(data[:h])) == want


def test_crc32c_known_answer():
    # RFC 3720's CRC32C (Castagnoli) vector
    assert crc32c(b"123456789") == 0xE3069283
    assert tp._crc32c_py(b"123456789") == 0xE3069283
    assert crc32c(b"") == 0


FRAMES = [
    dict(ftype="T_DATA", channel=CH_SCORING, payload=b'{"x": 1}', seq=7,
         ack=3, deadline_ms=1500),
    dict(ftype="T_DATA", channel=CH_SCORING,
         payload=np.arange(6, dtype=np.float32).tobytes(), seq=1,
         flags="FLAG_BINARY"),
    dict(ftype="T_HELLO", channel=CH_CONTROL,
         payload=b'{"token": "t", "session": "s1", "bin": 1}'),
    dict(ftype="T_ACK", channel=0, payload=b"", ack=2 ** 40 + 5),
    dict(ftype="T_PING", channel=0, payload=b""),
    dict(ftype="T_DATA", channel=3, payload=b"y" * 3000, seq=2 ** 33,
         ack=11, deadline_ms=0),
]


@pytest.mark.parametrize("case", range(len(FRAMES)))
def test_encode_frame_equals_the_reference(case):
    f = dict(FRAMES[case])

    def args(mod):
        return dict(f, ftype=getattr(mod, f["ftype"]),
                    **({"flags": getattr(mod, f["flags"])}
                       if "flags" in f else {}))

    frame = encode_frame(**args(tp))
    want = rtp.encode_frame(**args(rtp))
    assert frame == want
    # and each package reads the other's frame back
    a, b = socket.socketpair()
    try:
        a.sendall(want)
        got = read_frame(b, 1 << 20)
        a.sendall(frame)
        assert rtp.read_frame(b, 1 << 20) == got
        assert got[-1] == f["payload"]
    finally:
        a.close()
        b.close()


def test_frame_constants_equal_the_reference():
    names = ("MAGIC", "VERSION", "T_HELLO", "T_HELLO_ACK", "T_DATA",
             "T_ACK", "T_PING", "T_PONG", "T_ERROR", "FLAG_BINARY",
             "CH_SCORING", "CH_CONTROL", "CH_STATS", "CH_METRICS",
             "HEADER_BYTES")
    assert {n: getattr(tp, n) for n in names} \
        == {n: getattr(rtp, n) for n in names}


@pytest.mark.parametrize("rows,cols", [(1, 6), (5, 50), (64, 3)])
def test_pack_matrix_equals_the_reference(rows, cols):
    X = np.random.default_rng(rows).normal(size=(rows, cols)).astype(
        np.float32)
    for kind in (wire.K_REQ, wire.K_PARTIAL):
        buf = wire.pack_matrix("rid-7", X, kind=kind)
        assert buf == rwire.pack_matrix("rid-7", X, kind=kind)
        k, rid, M = wire.unpack_matrix(buf)
        assert (k, rid) == (kind, "rid-7")
        assert np.array_equal(M, X)
        assert wire.peek_rid(buf) == rwire.peek_rid(buf) == "rid-7"


def test_pack_replies_equals_the_reference():
    rng = np.random.default_rng(1)
    entries = [("a", np.float32(rng.normal())),
               ("bb", rng.normal(size=3).astype(np.float32)),
               ("c", 0.25), ("d", [1.5, -2.0])]
    buf = wire.pack_replies(entries)
    assert buf == rwire.pack_replies(entries)
    got, want = wire.unpack_replies(buf), rwire.unpack_replies(buf)
    assert [r for r, _ in got] == [r for r, _ in want] == [
        "a", "bb", "c", "d"]
    for (_, v1), (_, v2) in zip(got, want):
        assert np.asarray(v1).tobytes() == np.asarray(v2).tobytes()


def test_binary_req_equals_the_reference():
    X = np.arange(12, dtype=np.float32).reshape(3, 4)
    a, b = wire.BinaryReq(X), rwire.BinaryReq(X)
    assert np.array_equal(a.X, b.X)
    with pytest.raises(wire.WireError):
        wire.unpack_matrix(b"\x00\x01")
    with pytest.raises(rwire.WireError):
        rwire.unpack_matrix(b"\x00\x01")


@pytest.mark.parametrize("addr", [
    "10.0.0.1:8080", "myhost:1", " host:65535 ", "[::1]:9000",
    "[fe80::2]:80", "", "hostonly", ":8080", "host:", "host:notaport",
    "host:0", "host:70000", "[::1]", "[::1]8080", "[::1:9000",
    "fe80::2:80x", "fe80::2:80"])
def test_parse_address_equals_the_reference(addr):
    try:
        want = rtp.parse_address(addr)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            parse_address(addr)
        assert str(got.value) == str(e)
    else:
        assert parse_address(addr) == want


# -- interop with the reference ------------------------------------------------

def _interop(server_mod, client_mod):
    """A ``client_mod`` client talks to a ``server_mod`` echo server; the
    first two links die mid-frame at their 7th send (the port's
    ChaosTransport on the port's side); every message, JSON and binary,
    comes back once, in order, bit for bit."""
    plan = ChaosPlan(seed=4)
    conn_n = [0]

    def wrap(sock):
        conn_n[0] += 1
        if conn_n[0] <= 2:
            return ChaosTransport(sock, plan, kill_on_sends={7},
                                  name=f"interop{conn_n[0]}")
        return sock

    port_side = TransportConfig(socket_wrap=wrap,
                                reconnect_backoff=(0.05, 0.2),
                                ack_every=4)
    srv = _echo_server(server_mod, token="t",
                       cfg=port_side if server_mod is tp else None)
    got = []
    try:
        ccfg = (port_side if client_mod is tp else client_mod
                .TransportConfig(reconnect_backoff=(0.05, 0.2),
                                 ack_every=4))
        c = client_mod.TransportClient(
            srv.address, token="t", cfg=ccfg,
            on_message=lambda s, ch, o, d: got.append(
                bytes(o) if isinstance(o, (bytes, memoryview))
                else o["v"])).connect()
        assert c.session.peer_binary
        rng = np.random.default_rng(3)
        sent = []
        for i in range(30):
            if i % 3 == 2:
                b = rng.normal(size=8).astype(np.float32).tobytes()
                c.send_bytes(client_mod.CH_SCORING, b, timeout=10.0)
                sent.append(b)
            else:
                c.send(client_mod.CH_SCORING,
                       {"op": "echo", "v": [i, i * 0.5]}, timeout=10.0)
                sent.append([i, i * 0.5])
            time.sleep(0.002)
        assert _drain(got, 30, timeout=20.0) == 30
        assert got == sent                  # none lost, none twice
        assert conn_n[0] > 1                # the kills fired
        c.close()
    finally:
        srv.stop()


def test_port_client_resumes_with_reference_server():
    _interop(server_mod=rtp, client_mod=tp)


def test_reference_client_resumes_with_port_server():
    _interop(server_mod=tp, client_mod=rtp)


# -- the port's transport ------------------------------------------------------

class TestFrameCodec:
    def test_bitflips_rejected(self):
        for pos in (-3, 8):
            a, b = socket.socketpair()
            try:
                frame = bytearray(encode_frame(tp.T_DATA, 1, b"hello-crc",
                                               seq=9, ack=5))
                frame[pos] ^= 0x10
                a.sendall(bytes(frame))
                with pytest.raises(ChecksumError):
                    read_frame(b, 1 << 20)
            finally:
                a.close()
                b.close()

    def test_oversize_typed_errors(self):
        with pytest.raises(FrameTooLarge):
            encode_frame(tp.T_DATA, 1, b"x" * 100, max_frame_bytes=64)
        a, b = socket.socketpair()
        try:
            a.sendall(struct.pack("<I", 1 << 30) + b"junk")
            with pytest.raises(FrameTooLarge):
                read_frame(b, 1 << 20)
        finally:
            a.close()
            b.close()
        s = Session("sid", TransportConfig(max_frame_bytes=256))
        with pytest.raises(FrameTooLarge):
            s.send(CH_SCORING, {"blob": "y" * 1024})


class TestHandshake:
    def test_token_and_echo_roundtrip(self):
        srv = _echo_server()
        got = []
        try:
            c = TransportClient(srv.address, token="tok",
                                on_message=lambda s, ch, o, d:
                                got.append(o)).connect()
            for i in range(10):
                c.send(CH_SCORING, {"op": "echo", "v": i})
            assert _drain(got, 10) == 10
            assert [o["v"] for o in got] == list(range(10))
            c.close()
        finally:
            srv.stop()

    def test_wrong_token_refused_no_session(self):
        srv = _echo_server()
        try:
            with pytest.raises(HandshakeError, match="bad_token"):
                TransportClient(srv.address, token="nope").connect(
                    retries=0)
            assert srv.sessions == {}
        finally:
            srv.stop()

    def test_garbage_peers_dropped_cleanly(self):
        srv = _echo_server()
        got = []
        try:
            for data in (b"GET / HTTP/1.1\r\n\r\n", b"\xff\xfe\x00bin"):
                g = socket.create_connection(srv.address, timeout=5)
                g.sendall(data)
                time.sleep(0.1)
                g.close()
            time.sleep(0.2)
            assert srv.sessions == {}
            c = TransportClient(srv.address, token="tok",
                                on_message=lambda s, ch, o, d:
                                got.append(o)).connect()
            c.send(CH_SCORING, {"op": "echo", "v": 41})
            assert _drain(got, 1) == 1 and got[0]["v"] == 41
            c.close()
        finally:
            srv.stop()


class TestFlowControl:
    def test_credit_exhaustion_backpressure(self):
        stalls0 = tp.transport_stats.snapshot()["counters"][
            "backpressure_stalls"]
        block = threading.Event()
        cfg = TransportConfig(initial_credits=4, credit_batch=1)
        srv = TransportServer(token="t", cfg=cfg,
                              on_message=lambda *a: block.wait(20),
                              name="wedged").start()
        try:
            c = TransportClient(srv.address, token="t",
                                cfg=cfg).connect()
            with pytest.raises(Backpressure):
                for i in range(32):
                    c.send(CH_SCORING, {"op": "echo", "v": i},
                           timeout=0.3)
            assert tp.transport_stats.snapshot()["counters"][
                "backpressure_stalls"] > stalls0
            block.set()
            c.close()
        finally:
            block.set()
            srv.stop()

    def test_credits_replenish_under_steady_drain(self):
        cfg = TransportConfig(initial_credits=8, credit_batch=2,
                              ack_every=4)
        got = []
        srv = TransportServer(token="t", cfg=cfg,
                              on_message=lambda s, ch, o, d: got.append(o),
                              name="drain").start()
        try:
            c = TransportClient(srv.address, token="t",
                                cfg=cfg).connect()
            for i in range(100):
                c.send(CH_SCORING, {"v": i}, timeout=5.0)
            assert _drain(got, 100) == 100
            assert [o["v"] for o in got] == list(range(100))
            c.close()
        finally:
            srv.stop()


def test_header_deadline_reaches_receiver():
    seen = []
    srv = TransportServer(token="t", on_message=lambda s, ch, o, d:
                          seen.append(d)).start()
    try:
        c = TransportClient(srv.address, token="t").connect()
        c.send(CH_SCORING, {"op": "x"}, deadline_ms=2500)
        c.send(CH_SCORING, {"op": "y"})
        assert _drain(seen, 2) == 2
        assert seen[0] == pytest.approx(2500, abs=150)
        assert seen[1] is None
        c.close()
    finally:
        srv.stop()


def test_half_open_link_detected_and_resumed():
    """A server that goes silent without closing is torn down by the
    client's keepalive; the reconnect resumes and replays."""
    plan = ChaosPlan(seed=5)
    conn_n = [0]

    def wrap(sock):
        conn_n[0] += 1
        if conn_n[0] == 1:
            return ChaosTransport(sock, plan, half_open_after=4,
                                  name="halfopen")
        return sock

    drops0 = tp.transport_stats.snapshot()["counters"]["keepalive_drops"]
    srv = _echo_server(token="t", cfg=TransportConfig(socket_wrap=wrap))
    got = []
    try:
        c = TransportClient(
            srv.address, token="t",
            cfg=TransportConfig(keepalive_interval_s=0.2,
                                keepalive_timeout_s=1.0,
                                reconnect_backoff=(0.05, 0.2)),
            on_message=lambda s, ch, o, d: got.append(o)).connect()
        for i in range(20):
            c.send(CH_SCORING, {"op": "echo", "v": i})
        assert _drain(got, 20, timeout=15.0) == 20
        assert [o["v"] for o in got] == list(range(20))
        assert tp.transport_stats.snapshot()["counters"][
            "keepalive_drops"] > drops0
        c.close()
    finally:
        srv.stop()


@pytest.mark.parametrize("fault", ["kill", "ack_loss", "bitflip"])
def test_resume_loses_and_duplicates_nothing(fault):
    """Seeded mid-frame link kills, dropped ACKs then a kill, and frame
    bit flips: every message arrives once, in order, bit for bit."""
    plan = ChaosPlan(seed={"kill": 1234, "ack_loss": 9,
                           "bitflip": 31}[fault])
    conn_n = [0]

    def wrap(sock):
        conn_n[0] += 1
        if fault == "kill" and conn_n[0] <= 3:
            return ChaosTransport(sock, plan, kill_on_sends={9},
                                  name=f"kill{conn_n[0]}")
        if fault == "ack_loss" and conn_n[0] == 1:
            return ChaosTransport(sock, plan, ack_drop_rate=1.0,
                                  kill_on_sends={14}, name="ackdrop")
        if fault == "bitflip" and conn_n[0] <= 2:
            return ChaosTransport(sock, plan, bitflip_rate=0.08,
                                  name=f"flip{conn_n[0]}")
        return sock

    c0 = tp.transport_stats.snapshot()["counters"]
    client_wrap = fault == "ack_loss"
    scfg = TransportConfig() if client_wrap else TransportConfig(
        socket_wrap=wrap)
    ccfg = TransportConfig(reconnect_backoff=(0.05, 0.2),
                           ack_every=2 if client_wrap else 4,
                           **({"socket_wrap": wrap} if client_wrap
                              else {}))
    srv = _echo_server(token="t", cfg=scfg)
    got = []
    try:
        c = TransportClient(srv.address, token="t", cfg=ccfg,
                            on_message=lambda s, ch, o, d:
                            got.append(o)).connect()
        payloads = [[i, i * 0.5, f"s{i}"] for i in range(40)]
        for v in payloads:
            c.send(CH_SCORING, {"op": "echo", "v": v}, timeout=10.0)
            time.sleep(0.002)
        assert _drain(got, 40, timeout=20.0) == 40
        assert [o["v"] for o in got] == payloads
        assert conn_n[0] > 1
        c1 = tp.transport_stats.snapshot()["counters"]
        if fault == "bitflip":
            assert c1["crc_drops"] > c0["crc_drops"]
        c.close()
    finally:
        srv.stop()


def test_session_reset_callback_when_server_forgot():
    srv = _echo_server(token="t")
    resets, got = [], []
    try:
        c = TransportClient(
            srv.address, token="t",
            cfg=TransportConfig(reconnect_backoff=(0.05, 0.2)),
            on_message=lambda s, ch, o, d: got.append(o),
            on_session_reset=lambda: resets.append(1)).connect()
        c.send(CH_SCORING, {"op": "echo", "v": 1})
        assert _drain(got, 1) == 1
        srv.sessions.pop(c.session.sid).detach()
        deadline = time.time() + 10
        while not resets and time.time() < deadline:
            time.sleep(0.02)
        assert resets
        got.clear()
        c.send(CH_SCORING, {"op": "echo", "v": 2})
        assert _drain(got, 1) == 1 and got[0]["v"] == 2
        c.close()
    finally:
        srv.stop()


class TestBinaryWire:
    def test_negotiated_and_bytes_roundtrip(self):
        srv = _echo_server(token="t")
        got = []
        try:
            c = TransportClient(srv.address, token="t",
                                on_message=lambda s, ch, o, d:
                                got.append(bytes(o))).connect()
            assert c.session.peer_binary
            blocks = [np.arange(i + 1, dtype=np.float32).tobytes()
                      for i in range(10)]
            before = tp.transport_stats.snapshot()["counters"]
            for b in blocks:
                c.send_bytes(CH_SCORING, b)
            assert _drain(got, 10) == 10
            assert got == blocks
            after = tp.transport_stats.snapshot()["counters"]
            assert after["bin_frames_sent"] > before["bin_frames_sent"]
            assert after[f"payload_bytes_sent_ch{CH_SCORING}"] >= before[
                f"payload_bytes_sent_ch{CH_SCORING}"] + sum(
                    map(len, blocks))
            c.close()
        finally:
            srv.stop()

    def test_send_bytes_refused_without_negotiation(self):
        s = Session("sid", TransportConfig())
        assert not s.peer_binary
        with pytest.raises(tp.TransportError, match="negotiate"):
            s.send_bytes(CH_SCORING, b"\x00\x01")


def test_transport_stats_registered_and_rendered():
    from mmlspark_tpu_torch.core.telemetry import get_registry
    srv = _echo_server(token="t")
    try:
        assert "transport" in get_registry().namespaces()
        text = get_registry().render_prometheus()
        assert 'ns="transport"' in text
        for name in ("frames_sent", "retransmits", "crc_drops",
                     "backpressure_stalls", "reconnects",
                     "keepalive_drops"):
            assert f'event="{name}"' in text
    finally:
        srv.stop()


class TestNoBespokeFraming:
    """Only ``io/transport.py`` frames bytes on a socket in the port."""

    def _py_files(self):
        for root, _dirs, files in os.walk(
                os.path.join(REPO, "mmlspark_tpu_torch")):
            for f in files:
                if f.endswith(".py"):
                    yield os.path.join(root, f)

    def test_no_line_readers_outside_transport(self):
        offenders = [
            os.path.relpath(p, REPO) for p in self._py_files()
            if not p.endswith(os.path.join("io", "transport.py"))
            and re.search(r"makefile\(['\"]r['\"]",
                          open(p, encoding="utf-8").read())]
        assert not offenders, offenders

    def test_no_newline_json_socket_framing_outside_transport(self):
        pat = re.compile(r"json\.dumps\([^\n]*\)\s*\+\s*[\"']\\n[\"']")
        offenders = []
        for path in self._py_files():
            if path.endswith(os.path.join("io", "transport.py")):
                continue
            src = open(path, encoding="utf-8").read()
            if re.search(r"^\s*import socket|^\s*from socket|"
                         r"import socket as", src, re.M) \
                    and pat.search(src):
                offenders.append(os.path.relpath(path, REPO))
        assert not offenders, offenders
