"""A gang of controller processes over ``torch.distributed``: each process
holds only its own data shards, gathers every cross-shard partial in
shard order, and so writes the one-controller sharded fit's model text
byte for byte (which ``tests/test_torch_sharded_ingest.py`` holds to the
reference's).

The gangs run as subprocesses of ``python -m
mmlspark_tpu_torch.gbdt.elastic --device cpu`` on one torch thread each,
every ``communicate`` under a timeout that kills the gang (a process
group must not outlive a test in its worker), and a round whose
rendezvous port was taken retries on a fresh one.  Then the checkpoint
kill and resume under the supervisor, and unit tests of the gang mesh,
the backend choice, the unanimous resume verdict and the refusals.
"""

import json
import os
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.core.mesh import Mesh
from mmlspark_tpu_torch.gbdt import elastic, engine, get_objective
from mmlspark_tpu_torch.gbdt.checkpoint import _ckpt_unanimous, train_stats
from mmlspark_tpu_torch.gbdt.distributed import prepare_arrays_from_shards
from mmlspark_tpu_torch.gbdt.elastic import (free_port,
                                             initialize_with_retry,
                                             select_backend)
from mmlspark_tpu_torch.tools import chaos_training
from torch_parity import one_torch_thread  # noqa: F401 - fixture

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: one gang round's limit: a round takes 5-12 s on one busy core, so a
#: hung rendezvous costs the test worker this much and no more
TIMEOUT_S = 90


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"      # one torch thread per controller
    return env


def _spawn(pid, port, tmp, args):
    cmd = [sys.executable, "-m", "mmlspark_tpu_torch.gbdt.elastic",
           "--coordinator", f"127.0.0.1:{port}", "--num-processes", "2",
           "--process-id", str(pid), "--device", "cpu",
           "--heartbeat-dir", os.path.join(tmp, "hb"),
           "--out", os.path.join(tmp, "model.txt"),
           "--stats-out", os.path.join(tmp, f"stats_p{pid}.json"), *args]
    return subprocess.Popen(cmd, env=_env(), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _addr_in_use(err):
    return "EADDRINUSE" in err or "address already in use" in err.lower()


def _run_gang(tmp, args, attempts=3):
    """One two-controller round; the whole round retries on a fresh port
    when the rendezvous port was taken in between.  Returns each
    controller's stats."""
    for _ in range(attempts):
        port = free_port()
        procs = [_spawn(pid, port, tmp, args) for pid in range(2)]
        deadline = time.monotonic() + TIMEOUT_S
        try:
            outs = [p.communicate(timeout=max(1.0,
                                              deadline - time.monotonic()))
                    for p in procs]
        except subprocess.TimeoutExpired:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.communicate()
            raise
        errs = [e for _, e in outs]
        if any(p.returncode for p in procs) and any(map(_addr_in_use, errs)):
            continue
        for p, (out, err) in zip(procs, outs):
            assert p.returncode == 0, err[-3000:]
            assert "ELASTIC_OK" in out
        stats = []
        for pid in range(2):
            with open(os.path.join(tmp, f"stats_p{pid}.json")) as fh:
                stats.append(json.load(fh))
        return stats
    raise AssertionError("the rendezvous port stayed taken")


def _one_controller_text(args):
    """The one-controller sharded fit of the same arguments: every shard
    on a mesh of CPU devices in this process."""
    a = elastic.parse_args(["--heartbeat-dir", "unused", "--device", "cpu",
                            "--num-processes", "2", *args])
    booster = elastic.sharded_fit(a, None, torch.device("cpu"))[0]
    return booster.save_native_model_string()


GANGS = {
    # 2 controllers x 1 shard: bagging and feature fraction (the defaults)
    "2x1": ["--rows", "500", "--iterations", "8"],
    # 2 x 2 shards (D = 4), unequal, with validation and early stopping
    "2x2_validation": ["--rows", "700", "--iterations", "20",
                       "--shards-per-process", "2", "--cuts", "100,290,480",
                       "--val-rows", "120", "--esr", "3",
                       "--learning-rate", "0.5"],
    # 2 x 2, unequal: multiclass GOSS with quantized gradients (the
    # grid's peaks are gathered too); its one-controller text is held to
    # the reference's in tests/test_torch_sharded_ingest.py
    "2x2_goss_multiclass_quantized": [
        "--rows", "900", "--iterations", "6", "--shards-per-process", "2",
        "--cuts", "150,400,620", "--num-class", "3", "--boosting", "goss",
        "--quantized", "16", "--bagging-fraction", "1"],
}


@pytest.mark.parametrize("case", list(GANGS))
def test_gang_writes_the_one_controller_text(case, tmp_path,
                                             one_torch_thread):  # noqa: F811
    args = GANGS[case]
    stats = _run_gang(str(tmp_path), args)
    with open(tmp_path / "model.txt") as fh:
        gang_text = fh.read()
    assert gang_text == _one_controller_text(args)
    for s in stats:
        assert s["backend"] == "gloo"
        assert s["fit_info"]["gang_backend"] == "gloo"
        assert s["fit_info"]["processes"] == "2"
        assert s["gathers"]["gathers"] > 0 and s["gathers"]["bytes"] > 0


def test_killed_controller_gang_resumes_to_the_same_text(
        tmp_path, one_torch_thread):  # noqa: F811
    """Controller 1 SIGKILLed once boundary 4 is durable: the survivor is
    torn down, the supervisor respawns the gang, and both controllers
    resume from the boundary and write the uninterrupted text."""
    args = ["--rows", "600", "--iterations", "12", "--lease-timeout", "3"]
    res = chaos_training.run_phase("kill", str(tmp_path), ["--device", "cpu",
                                                           *args],
                                   checkpoint_chunk=4, kill=True,
                                   phase_timeout=TIMEOUT_S, env=_env())
    assert res["restarts"] == 1
    assert -9 in res["exit_codes"]["0"]
    assert all(rc != 0 for rc in res["exit_codes"]["0"])
    last = res["stats"]["1"]
    assert [last[p]["train"]["counters"]["ckpt_resumed"]
            for p in ("0", "1")] == [1, 1]
    assert res["ckpt_leftover"] == []
    assert res["model"] == _one_controller_text(args + [
        "--checkpoint-chunk", "4"])


# -- units -------------------------------------------------------------------

def test_gang_mesh_numbers_shards_process_major():
    mesh = Mesh(["cpu"] * 2, process_index=1, process_count=2)
    assert (mesh.data, mesh.local_data, mesh.data_offset, len(mesh)) == \
        (4, 2, 2, 2)
    assert mesh.is_gang
    with pytest.raises(ValueError, match="would span processes"):
        Mesh(["cpu"], feature=2, process_index=0, process_count=2)
    assert not Mesh(["cpu"] * 2).is_gang


def test_gang_layout_builds_only_its_own_shards():
    """Process 1 of 2 passes None for shards 0 and 1: it lays out shards 2
    and 3 alone, padded to the largest shard, and never reads a None
    slot."""
    rng = np.random.default_rng(0)
    sizes = [30, 50, 40, 45]
    bins = [None, None] + [rng.integers(0, 8, (s, 3)).astype(np.uint8)
                           for s in sizes[2:]]
    labels = [np.ones(s) for s in sizes]
    pieces = []
    arrays = prepare_arrays_from_shards(
        bins, labels, [np.ones(s) for s in sizes],
        Mesh(["cpu"] * 2, process_index=1, process_count=2), 0.0,
        shard_rows=sizes, piece_spy=pieces.append)
    assert arrays.shard0 == 2 and arrays.data_shards == 4
    assert len(arrays.bins) == 2 and pieces
    assert all(shape[0] == max(sizes) for shape in pieces)
    for k, d in enumerate((2, 3)):
        np.testing.assert_array_equal(arrays.bins[k][:sizes[d]].numpy(),
                                      bins[d])
    with pytest.raises(ValueError, match="slots \\[2\\] are None"):
        prepare_arrays_from_shards(
            [np.zeros((30, 3), np.uint8), None, None, bins[3]], labels,
            [np.ones(s) for s in sizes],
            Mesh(["cpu"] * 2, process_index=1, process_count=2), 0.0,
            shard_rows=sizes)


def _gang_fit(**params):
    sizes = [40, 50]
    rng = np.random.default_rng(1)
    from mmlspark_tpu_torch.gbdt import fit_bin_mapper
    X = rng.normal(size=(90, 3))
    mapper = fit_bin_mapper(X, max_bin=15)
    bins = [None, mapper.transform_packed(X[40:])]
    labels = [np.zeros(40), np.ones(50)]
    return engine.train(
        bins, labels, None, mapper, get_objective("binary"),
        engine.TrainParams(num_iterations=2, verbosity=0, **params),
        mesh=Mesh(["cpu"], process_index=1, process_count=2),
        shard_rows=sizes)


@pytest.mark.parametrize("params,match", [
    (dict(collective="ring"), "Queue B items 3-5"),
    (dict(histogram_method="pallas_ring"), "Queue B items 3-5"),
    (dict(parallelism="voting"), "Queue A item 10"),
    (dict(boosting="dart"), "Queue A item 10"),
    (dict(fault_tolerant_retries=1), "faultTolerantRetries.*Queue A item 10"),
])
def test_gang_refusals_name_the_roadmap(params, match):
    """What a gang does not run raises before its first collective."""
    with pytest.raises(NotImplementedError, match=match):
        _gang_fit(**params)


def test_gang_needs_per_shard_lists():
    with pytest.raises(ValueError, match="per-shard lists"):
        engine.train(np.zeros((10, 2), np.uint8), np.zeros(10), None, None,
                     get_objective("binary"), engine.TrainParams(),
                     mesh=Mesh(["cpu"], process_index=0, process_count=2))


@pytest.mark.parametrize("devices,backend", [
    (["cuda:0", "cuda:0"], "gloo"),       # ranks sharing one card
    (["cuda:0", "cuda:1"], "nccl"),       # a card each
    (["cpu", "cpu"], "gloo"),
    (["cuda:0", "cpu"], "gloo"),
    (None, "gloo"),
    (["a/cuda:0", "b/cuda:0"], "nccl"),   # two hosts, a card each
    (["a/cuda:0", "a/cuda:0"], "gloo"),
])
def test_backend_follows_the_topology(devices, backend):
    assert select_backend(devices) == backend


def test_every_rank_sees_every_ranks_device():
    """Each rank publishes its host and device in the rendezvous store
    and reads the others', so both ranks choose the same backend."""
    port = free_port()
    stores = [elastic._rendezvous_store(f"127.0.0.1:{port}", 2, pid)
              for pid in range(2)]
    with ThreadPoolExecutor(2) as ex:
        seen = list(ex.map(lambda pid: elastic.gang_devices(
            stores[pid], 2, pid, torch.device("cuda", 0)), range(2)))
    assert seen[0] == seen[1] == [f"{socket.gethostname()}/cuda:0"] * 2
    assert select_backend(seen[0]) == "gloo"


@pytest.mark.parametrize("devices,backend", [
    (["h/cuda:0", "h/cuda:0"], "gloo"),   # ranks sharing the host's card
    (["h/cuda:0", "h/cuda:1"], "nccl"),
])
def test_backend_is_chosen_once_and_kept_across_retries(devices, backend,
                                                        monkeypatch):
    """The gang's devices are read once, before the group forms; a
    failure retries the same backend, never another."""
    calls, reads = [], []

    def flaky(**kw):
        calls.append(kw["backend"])
        if len(calls) < 3:
            raise RuntimeError("rendezvous not ready")

    def read(store, n, pid, device):
        reads.append(device)
        return devices

    monkeypatch.setattr(torch.distributed, "init_process_group", flaky)
    monkeypatch.setattr(elastic, "_rendezvous_store", lambda *a: object())
    monkeypatch.setattr(elastic, "gang_devices", read)
    initialize_with_retry("127.0.0.1:1", 2, 0, retries=3, backoff_s=0.0,
                          sleep=lambda s: None, device="cuda:0")
    assert calls == [backend] * 3 and reads == ["cuda:0"]


@pytest.mark.parametrize("mine,peer,resumes", [
    (1, 0, False),     # a peer rejected its part: the whole gang is fresh
    (1, 1, True),
    (0, 1, False),
])
def test_one_rejection_starts_the_whole_gang_fresh(mine, peer, resumes,
                                                   monkeypatch):
    """The resume verdict is unanimous: a snapshot this process loaded is
    dropped when a peer rejected its own part, and counted discarded.
    Process 0 of a two-process gang; the all-gather hands back the peer's
    verdict."""
    def all_gather(out, x):
        out[0].copy_(x)
        out[1].fill_(peer)

    monkeypatch.setattr(torch.distributed, "all_gather", all_gather)
    snap = {"it": 4} if mine else None
    mesh = Mesh(["cpu"], process_index=0, process_count=2)
    before = train_stats.snapshot()["counters"]["ckpt_discarded"]
    assert _ckpt_unanimous(snap, mesh) is (snap if resumes else None)
    assert train_stats.snapshot()["counters"]["ckpt_discarded"] == \
        before + (mine and not peer)
    # off a gang the verdict is this process's own
    assert _ckpt_unanimous(snap, Mesh(["cpu"] * 2)) is snap


def test_snapshot_bytes_skip_a_file_a_peer_removes(tmp_path, monkeypatch):
    """A gang's processes remove their older state files while another
    counts the directory's bytes: a file gone in between counts 0 (it
    once ended a controller with ``FileNotFoundError``)."""
    (tmp_path / "boost_checkpoint.npz").write_bytes(b"x" * 10)
    gone = str(tmp_path / "mesh_state_p001_it000005.npz")
    real_glob = engine.glob.glob
    monkeypatch.setattr(engine.glob, "glob",
                        lambda pattern: real_glob(pattern) + [gone])
    assert engine._npz_bytes(str(tmp_path)) == 10
