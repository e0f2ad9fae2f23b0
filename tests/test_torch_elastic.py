"""The port's elastic layer (``gbdt/elastic.py``) and training fault
injectors (``io/chaos.py``) on the CPU: the counterpart of the reference's
``tests/test_chaos_training.py`` (its injector, watchdog, rendezvous and
supervisor classes).

* The injectors: ``corrupt_file``'s modes, ``ChaosHeartbeat``'s single
  stall and its rate (which needs a plan), ``read_ckpt_boundary`` on the
  meta a save leaves, ``ChaosControllerKill`` firing once the boundary
  is durable (its kill replaced by a recorder), and a plan's channels
  drawing the reference's decisions for the same seed.
* The watchdog: a stall between the straggler threshold and the lease
  timeout counts a straggler and never a loss; a silent peer is lost
  once; ages come from local observation, so a lease file's mtime far
  in the past does not age a peer that keeps writing.
* The lease beacons over the transport: two watchdogs beacon through a
  ``HeartbeatHub`` whose links a ``ChaosTransport`` cuts mid-frame, and
  neither loses the other (the sessions resume); a peer that stops
  beaconing is lost; the training drill's phase 4
  (``transport_heartbeat_drill``) passes every verdict; a gang
  controller takes ``--heartbeat-transport``.
* The rendezvous: transient failures back off and succeed, parameter
  errors are not retried, spent retries raise, and a real one-rank gloo
  rendezvous on localhost forms (in a subprocess).
* The supervisor: a failed round respawns the whole gang on a fresh
  port; spent restarts raise; a hung round is killed.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu.io.chaos import ChaosPlan as RefChaosPlan
from mmlspark_tpu_torch.gbdt import checkpoint as ck_mod
from mmlspark_tpu_torch.gbdt import elastic
from mmlspark_tpu_torch.gbdt.elastic import (RESTART_EXIT_CODE,
                                             ElasticConfig,
                                             HeartbeatHub,
                                             HeartbeatWatchdog,
                                             initialize_with_retry,
                                             supervise)
from mmlspark_tpu_torch.io import chaos
from mmlspark_tpu_torch.io import transport as tp
from mmlspark_tpu_torch.io.chaos import (ChaosControllerKill,
                                         ChaosHeartbeat, ChaosPlan,
                                         ChaosTransport, corrupt_file,
                                         read_ckpt_boundary)
from mmlspark_tpu_torch.tools import chaos_training

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- injectors -----------------------------------------------------------------

def test_corrupt_file_modes(tmp_path):
    p = str(tmp_path / "snap.bin")
    payload = bytes(range(256)) * 4
    with open(p, "wb") as fh:
        fh.write(payload)
    corrupt_file(p, mode="torn")
    assert os.path.getsize(p) == len(payload) // 2
    with open(p, "wb") as fh:
        fh.write(payload)
    corrupt_file(p, ChaosPlan(seed=3), mode="bitflip")
    assert os.path.getsize(p) == len(payload)
    got = open(p, "rb").read()
    assert sum(a != b for a, b in zip(got, payload)) == 1
    with pytest.raises(ValueError, match="unknown corruption mode"):
        corrupt_file(p, mode="gamma-ray")
    open(p, "wb").close()
    with pytest.raises(ValueError, match="empty"):
        corrupt_file(p, mode="torn")


@pytest.mark.parametrize("seed", [1, 42, "drill"])
def test_plan_channels_draw_the_reference_decisions(seed):
    ours, ref = ChaosPlan(seed), RefChaosPlan(seed)
    for name in ("boost_step", "ckpt", "heartbeat"):
        a, b = ours.channel(name), ref.channel(name)
        assert [a.fire(0.3) for _ in range(50)] == \
            [b.fire(0.3) for _ in range(50)]
        assert a.uniform(0, 100) == b.uniform(0, 100)
    assert ours.counts() == ref.counts()


def test_chaos_heartbeat_stalls_once_and_needs_a_plan_for_a_rate():
    hb = ChaosHeartbeat(after_s=0.0, stall_s=0.05)
    t0 = time.monotonic()
    hb()
    hb()
    assert hb.stalls == 1 and time.monotonic() - t0 >= 0.05
    with pytest.raises(ValueError, match="needs a ChaosPlan"):
        ChaosHeartbeat(rate=0.5)
    jitter = ChaosHeartbeat(ChaosPlan(seed=2), rate=1.0, rate_stall_s=0.0)
    for _ in range(3):
        jitter()
    assert jitter.stalls == 3


def _save_boundary(ck, it):
    rng1, rng2 = (np.random.default_rng(s) for s in (1, 2))
    ck_mod._ckpt_save(ck, "fp", it, [], np.zeros(4, np.float32),
                      np.zeros(0, np.float32), np.ones(4, np.float32),
                      rng1, rng2, np.inf, -1)


def test_read_ckpt_boundary(tmp_path):
    ck = str(tmp_path / "ck")
    assert read_ckpt_boundary(ck) is None
    _save_boundary(ck, 6)
    assert read_ckpt_boundary(ck) == 6
    corrupt_file(os.path.join(ck, ck_mod._CKPT_FILE), mode="torn")
    assert read_ckpt_boundary(ck) is None


def test_controller_kill_fires_once_the_boundary_is_durable(tmp_path,
                                                            monkeypatch):
    ck = str(tmp_path / "ck")
    killed = []

    monkeypatch.setattr(chaos, "kill_process", killed.append)
    killer = ChaosControllerKill(ck, 4, poll_s=0.01)
    killer.start()
    _save_boundary(ck, 2)
    time.sleep(0.1)
    assert killed == []
    _save_boundary(ck, 4)
    # with the kill stubbed out the thread ends after its one kill
    killer.join(timeout=10)
    assert not killer.is_alive()
    assert killed == [os.getpid()]


def test_kill_process_kills():
    proc = subprocess.Popen(["sleep", "30"])
    assert chaos.kill_process(proc) == proc.pid
    assert proc.wait(timeout=10) == -9


# -- the watchdog ----------------------------------------------------------

def _cfg(d, pid, **kw):
    base = dict(heartbeat_dir=d, process_id=pid, num_processes=2,
                heartbeat_interval_s=0.05, straggler_age_s=0.25,
                lease_timeout_s=30.0, startup_grace_s=5.0)
    base.update(kw)
    return ElasticConfig(**base)


def _wait(cond, limit_s=5.0):
    deadline = time.time() + limit_s
    while not cond() and time.time() < deadline:
        time.sleep(0.02)
    return cond()


def test_stall_counts_a_straggler_not_a_loss(tmp_path):
    d = str(tmp_path / "hb")
    stall = ChaosHeartbeat(after_s=0.2, stall_s=0.6)
    lost = []
    w0 = HeartbeatWatchdog(_cfg(d, 0),
                           on_peer_lost=lambda p, a: lost.append(p))
    w1 = HeartbeatWatchdog(_cfg(d, 1), write_hook=stall)
    w0.start(), w1.start()
    try:
        _wait(lambda: w0.stats.counter("heartbeat_stalls") > 0)
        assert w0.stats.counter("heartbeat_stalls") >= 1
        assert stall.stalls == 1
        assert lost == [] and w0.stats.counter("peer_lost") == 0
        snap = w0.stats.snapshot()
        assert "heartbeat_age_ms" in snap["gauges"]
        assert {"heartbeat_stalls", "peer_lost"} <= set(snap["counters"])
    finally:
        w0.stop(), w1.stop()


def test_lease_expiry_fires_on_peer_lost_once(tmp_path):
    d = str(tmp_path / "hb")
    lost = []
    w0 = HeartbeatWatchdog(
        _cfg(d, 0, lease_timeout_s=0.4, startup_grace_s=0.2),
        on_peer_lost=lambda p, a: lost.append((p, a)))
    w0.start()       # peer 1 never writes
    try:
        _wait(lambda: lost)
        time.sleep(0.3)          # a second firing would land here
        assert [p for p, _ in lost] == [1]
        assert w0.stats.counter("peer_lost") == 1
        assert w0.stats.gauge("heartbeat_age_ms") >= 400.0
    finally:
        w0.stop()


def test_peer_age_is_local_observation_not_the_file_clock(tmp_path):
    """A peer whose lease file carries a clock far in the past, but which
    keeps advancing it, is young: ages are measured between local
    observations of the lease changing."""
    d = str(tmp_path / "hb")
    w0 = HeartbeatWatchdog(_cfg(d, 0))
    os.makedirs(d)
    path = w0.path_for(1)
    for k in range(3):
        open(path, "w").close()
        os.utime(path, (1e6 + k, 1e6 + k))       # 1970, moving forward
        ages = w0.peer_ages()
        assert ages[1] < 1.0
        time.sleep(0.05)
    assert w0.peer_ages()[1] >= 0.0
    os.remove(path)
    assert w0.peer_ages()[1] == float("inf")


def test_restart_exit_code_and_transport_mode():
    assert RESTART_EXIT_CODE == 76
    assert RESTART_EXIT_CODE not in (0, 1, -9)
    cfg = ElasticConfig("", 0, 2, transport_address="127.0.0.1:1",
                        transport_token="t")
    assert (cfg.transport_address, cfg.transport_token) == \
        ("127.0.0.1:1", "t")


# -- lease beacons over the transport --------------------------------------

def _beacon_cfg(hub, pid, **kw):
    base = dict(heartbeat_dir="", process_id=pid, num_processes=2,
                heartbeat_interval_s=0.05, straggler_age_s=1.0,
                lease_timeout_s=3.0, startup_grace_s=5.0,
                transport_address=hub.address, transport_token="tok")
    base.update(kw)
    return ElasticConfig(**base)


def test_beacons_survive_cut_links_without_a_false_loss():
    """The hub's side of every link is cut mid-frame at its 6th and 15th
    send (``ChaosTransport``): each session resumes, beacons flow again,
    and no watchdog declares its live peer lost or even a straggler."""
    plan = ChaosPlan(seed=4)
    wraps = []

    def wrap(sock):
        wraps.append(ChaosTransport(sock, plan, kill_on_sends={6, 15}))
        return wraps[-1]

    resumes0 = tp.transport_stats.counter("resumes")
    hub = HeartbeatHub(token="tok",
                       cfg=tp.TransportConfig(socket_wrap=wrap)).start()
    lost, dogs = [], []
    try:
        for pid in range(2):
            dogs.append(HeartbeatWatchdog(
                _beacon_cfg(hub, pid),
                on_peer_lost=lambda p, a: lost.append(p)).start())
        assert _wait(lambda: sum(w.resets for w in wraps) >= 2
                     and all(d.peer_ages()[1 - i] < 0.5
                             for i, d in enumerate(dogs)))
        time.sleep(0.5)
        ages = [d.peer_ages()[1 - i] for i, d in enumerate(dogs)]
    finally:
        for d in dogs:
            d.stop()
        hub.stop()
    assert lost == [] and max(ages) < 1.0
    assert tp.transport_stats.counter("resumes") > resumes0
    assert [d.stats.counter("heartbeat_stalls") for d in dogs] == [0, 0]


def test_a_silent_beacon_peer_is_lost_once():
    """Controller 1 stops beaconing (its watchdog stops): controller 0
    ages it past the lease by its own clock and loses it once."""
    hub = HeartbeatHub(token="tok").start()
    lost = []
    dogs = [HeartbeatWatchdog(
        _beacon_cfg(hub, pid, straggler_age_s=0.2, lease_timeout_s=0.6),
        on_peer_lost=lambda p, a: lost.append(p)).start()
        for pid in range(2)]
    try:
        assert _wait(lambda: dogs[0].peer_ages()[1] < 0.2)
        dogs[1].stop()
        assert _wait(lambda: lost == [1])
        time.sleep(0.3)
    finally:
        for d in dogs:
            d.stop()
        hub.stop()
    assert lost == [1]
    assert dogs[0].stats.counter("peer_lost") == 1


def test_transport_heartbeat_drill_passes():
    """The training drill's phase 4, shortened: the link cuts resume, the
    injected stall is counted, no peer is lost."""
    verdicts, detail = chaos_training.transport_heartbeat_drill(
        runtime_s=2.0)
    assert all(verdicts.values()), (verdicts, detail)
    assert detail["injected_stalls"] == 1 and detail["link_kills"] == 2


def test_controller_arguments_take_the_transport():
    args = elastic.parse_args(["--heartbeat-transport", "127.0.0.1:9",
                               "--heartbeat-token", "tok"])
    assert (args.heartbeat_transport, args.heartbeat_token,
            args.heartbeat_dir) == ("127.0.0.1:9", "tok", "")
    with pytest.raises(SystemExit):
        elastic.parse_args([])


# -- the rendezvous --------------------------------------------------------

#: the rendezvous store the tests below hand out in place of a TCPStore
STORE = object()


@pytest.fixture
def fake_store(monkeypatch):
    monkeypatch.setattr(elastic, "_rendezvous_store", lambda *a: STORE)


def test_transient_failures_back_off_then_succeed(monkeypatch, fake_store):
    calls, naps = [], []

    def flaky(**kw):
        calls.append(kw)
        if len(calls) < 3:
            raise RuntimeError("rendezvous not ready")

    monkeypatch.setattr(torch.distributed, "init_process_group", flaky)
    used = initialize_with_retry("127.0.0.1:1", 2, 0, retries=4,
                                 backoff_s=0.1, sleep=naps.append)
    assert used == 2
    assert naps == [0.1, 0.2]
    assert calls[-1] == dict(backend="gloo", store=STORE, world_size=2,
                             rank=0)


@pytest.mark.parametrize("error", [ValueError, TypeError])
def test_parameter_errors_not_retried(error, monkeypatch, fake_store):
    calls = []

    def bad(**kw):
        calls.append(kw)
        raise error("world_size must be positive")

    monkeypatch.setattr(torch.distributed, "init_process_group", bad)
    with pytest.raises(error):
        initialize_with_retry("127.0.0.1:1", 0, 0, retries=3,
                              sleep=lambda s: None)
    assert len(calls) == 1


def test_exhausted_retries_raise(monkeypatch, fake_store):
    naps = []
    monkeypatch.setattr(
        torch.distributed, "init_process_group",
        lambda **kw: (_ for _ in ()).throw(RuntimeError("down")))
    with pytest.raises(RuntimeError, match="after 3 attempts"):
        initialize_with_retry("127.0.0.1:1", 2, 0, retries=2,
                              backoff_s=0.1, sleep=naps.append)
    assert naps == [0.1, 0.2]


RENDEZVOUS = r'''
import sys
import torch
from mmlspark_tpu_torch.gbdt.elastic import free_port, initialize_with_retry
used = initialize_with_retry(f"127.0.0.1:{free_port()}", 1, 0,
                             backend="gloo")
t = torch.ones(3)
torch.distributed.all_reduce(t)
print(used, torch.distributed.get_world_size(), t.tolist())
torch.distributed.destroy_process_group()
'''


def test_one_rank_gloo_rendezvous_forms():
    """A real rendezvous on localhost, in a process of its own (a process
    group outlives the test in the process that formed it)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, "-c", RENDEZVOUS], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split("\n")[-2] == "0 1 [1.0, 1.0, 1.0]"


# -- the supervisor --------------------------------------------------------

class _FakeProc:
    def __init__(self, rc, hang=False):
        self.returncode = rc
        self._hang = hang
        self.killed = False

    def wait(self, timeout=None):
        if self._hang and not self.killed:
            raise subprocess.TimeoutExpired("worker", timeout)
        return self.returncode

    def poll(self):
        return None if self._hang and not self.killed else self.returncode

    def kill(self):
        self.killed = True


def test_failed_round_respawns_whole_gang_on_a_fresh_port():
    rounds = []

    def spawn(attempt, port):
        rounds.append((attempt, port))
        if attempt == 0:        # a killed member and a lease abandon
            return [_FakeProc(-9), _FakeProc(RESTART_EXIT_CODE)]
        return [_FakeProc(0), _FakeProc(0)]

    assert supervise(spawn, max_restarts=3, verbose=False) == 1
    assert [a for a, _ in rounds] == [0, 1]
    assert rounds[0][1] != rounds[1][1]


def test_exhausted_restarts_raise():
    with pytest.raises(RuntimeError, match="after 2 rounds"):
        supervise(lambda a, p: [_FakeProc(1)], max_restarts=1,
                  verbose=False)


def test_hung_round_is_killed_and_retried():
    hung = []

    def spawn(attempt, port):
        if attempt == 0:
            hung.append(_FakeProc(0, hang=True))
            return [hung[0], _FakeProc(0)]
        return [_FakeProc(0)]

    assert supervise(spawn, max_restarts=1, round_timeout_s=0.0,
                     verbose=False) == 1
    assert hung[0].killed
