"""Chunk-boundary checkpoints and resume in the port (``checkpoint_dir``,
``gbdt/checkpoint.py``) against the JAX reference, on the CPU.

Inputs come from numpy seeds at small sizes (a few hundred rows, 8
features); both packages are pinned to ``histogram_method="segment"``.

* A fit killed by SIGKILL in a subprocess after a boundary resumes
  in-process and writes the model text of the port's uninterrupted fit
  and of the reference's, byte for byte: serially with bagging, feature
  fraction and early stopping, and on a D = 2 mesh.
* The port saves at the reference's boundaries (``read_ckpt_boundary``
  after each iteration, each package reading its own directory).
* Resumes in-process, each equal to the uninterrupted fit: GOSS,
  multiclass, quantized and EFB (serial and mesh), rf, D = 4 with psum
  and validation, data+feature 2 × 2, voting, init scores and
  ``train_incremental``.
* A torn or bit-flipped meta or chunk file, a stale chunk cadence and a
  snapshot of another fit are discarded and counted, and the fit starts
  fresh; the fingerprint covers labels, weights, init scores, params and
  topology, and leaves out ``checkpoint_dir`` and ``checkpoint_chunk``;
  the directory is cleared on success; DART and lambdarank warn and stay
  inert; callbacks are called once per iteration, in order.
"""

import logging
import os
import signal
import subprocess
import sys

import jax
import numpy as np
import pytest

from mmlspark_tpu.core.mesh import build_mesh as ref_build_mesh
from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit
from mmlspark_tpu.gbdt.engine import TrainParams as RefParams
from mmlspark_tpu.gbdt.engine import train as ref_train
from mmlspark_tpu.gbdt.objectives import get_objective as ref_objective
from mmlspark_tpu.io.chaos import read_ckpt_boundary as ref_boundary
from mmlspark_tpu_torch import LightGBMClassifier, LightGBMRanker
from mmlspark_tpu_torch.core.mesh import build_mesh
from mmlspark_tpu_torch.gbdt import checkpoint as ck_mod
from mmlspark_tpu_torch.gbdt import engine
from mmlspark_tpu_torch.gbdt import fit_bin_mapper, get_objective
from mmlspark_tpu_torch.gbdt.engine import (TrainParams, train,
                                            train_incremental)
from mmlspark_tpu_torch.io.chaos import corrupt_file, read_ckpt_boundary
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the data, the metric and the port's fit of a kill test, shared by this
#: module and the subprocess it kills
SETUP = r'''
import numpy as np
from mmlspark_tpu_torch.core.mesh import build_mesh
from mmlspark_tpu_torch.gbdt import fit_bin_mapper, get_objective
from mmlspark_tpu_torch.gbdt.engine import TrainParams, train

LAYOUTS = {
    # serial: bagging every 2nd iteration, feature fraction, early
    # stopping on a validation set; boundaries every 4 iterations
    "serial": dict(d=1, val=True, chunk=4, kill_at=9, params=dict(
        num_iterations=24, learning_rate=0.3, bagging_fraction=0.7,
        bagging_freq=2, feature_fraction=0.8, early_stopping_round=8)),
    # a D = 2 data mesh with psum; boundaries every 3 iterations
    "mesh_d2": dict(d=2, val=False, chunk=3, kill_at=7, params=dict(
        num_iterations=12, collective="psum", bagging_fraction=0.7,
        bagging_freq=2, feature_fraction=0.8)),
}


def make_data(n=480, f=8, seed=7):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=n)
         > 0).astype(np.float64)
    return X, y, rng.random(n) < 0.25


def logloss(margins, labels, weights):
    p = np.clip(1.0 / (1.0 + np.exp(-margins)), 1e-15, 1 - 1e-15)
    return float(-np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p)))


def port_fit(name, ckpt="", callbacks=None):
    lay = LAYOUTS[name]
    X, y, val = make_data()
    tr = ~val if lay["val"] else np.ones(len(y), bool)
    m = fit_bin_mapper(X[tr], max_bin=31)
    kw = {}
    if lay["val"]:
        kw = dict(val_bins=m.transform(X[val], "cpu"), val_labels=y[val],
                  val_metric=logloss)
    mesh = (build_mesh(lay["d"], devices=["cpu"] * lay["d"])
            if lay["d"] > 1 else None)
    params = TrainParams(num_leaves=7, verbosity=0,
                         histogram_method="segment", checkpoint_dir=ckpt,
                         checkpoint_chunk=lay["chunk"], **lay["params"])
    return train(m.transform(X[tr], "cpu"), y[tr], None, m,
                 get_objective("binary"), params, device="cpu", mesh=mesh,
                 callbacks=callbacks, **kw)
'''

KILL_SCRIPT = SETUP + r'''
import os, signal, sys
import torch
torch.set_num_threads(1)
name, ckpt = sys.argv[1], sys.argv[2]


def killer(it, trees):
    if it >= LAYOUTS[name]["kill_at"]:
        os.kill(os.getpid(), signal.SIGKILL)   # no cleanup runs


port_fit(name, ckpt, [killer])
'''

_shared = {}
exec(SETUP, _shared)
LAYOUTS, make_data, logloss, port_fit = (
    _shared[k] for k in ("LAYOUTS", "make_data", "logloss", "port_fit"))


class _Interrupt(Exception):
    """Raised by a callback to end a fit between two boundaries."""


def _counters():
    return dict(engine.train_stats.snapshot()["counters"])


def _delta(before, key):
    return _counters()[key] - before[key]


def _ref_fit(name, ckpt, callbacks):
    lay = LAYOUTS[name]
    X, y, val = make_data()
    tr = ~val if lay["val"] else np.ones(len(y), bool)
    m = ref_fit(X[tr], max_bin=31)
    kw = {}
    if lay["val"]:
        kw = dict(val_bins=m.transform_packed(X[val]), val_labels=y[val],
                  val_metric=logloss)
    mesh = (ref_build_mesh(data=lay["d"], devices=jax.devices()[:lay["d"]])
            if lay["d"] > 1 else None)
    params = RefParams(num_leaves=7, verbosity=0,
                       histogram_method="segment", checkpoint_dir=ckpt,
                       checkpoint_chunk=lay["chunk"], **lay["params"])
    return ref_train(m.transform_packed(X[tr]), y[tr], None, m,
                     ref_objective("binary"), params, mesh=mesh,
                     callbacks=callbacks, **kw)


@pytest.fixture(scope="module", params=list(LAYOUTS))
def layout(request, tmp_path_factory):
    """Per layout: the port's plain fit, and each package's checkpointed
    fit with the boundary each read after every iteration."""
    name = request.param
    tmp = tmp_path_factory.mktemp(name)
    out = {"name": name, "plain": port_fit(name).save_native_model_string()}
    for pkg, fit, read in (("port", port_fit, read_ckpt_boundary),
                           ("ref", _ref_fit, ref_boundary)):
        ck = str(tmp / pkg)
        seen = []
        booster = fit(name, ck, [lambda it, trees, ck=ck, seen=seen:
                                 seen.append((it, read(ck)))])
        out[pkg] = (booster.save_native_model_string(), seen)
    return out


def test_killed_fit_resumes_bit_identical(layout, tmp_path):
    """SIGKILL after a boundary; the resumed fit writes the port's and the
    reference's uninterrupted model text."""
    name, lay = layout["name"], LAYOUTS[layout["name"]]
    ck = str(tmp_path / "ck")
    script = tmp_path / "kill.py"
    script.write_text(KILL_SCRIPT)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run([sys.executable, str(script), name, ck], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == -signal.SIGKILL, r.stderr[-3000:]
    boundary = lay["kill_at"] // lay["chunk"] * lay["chunk"]
    assert read_ckpt_boundary(ck) == boundary
    before = _counters()
    text = port_fit(name, ck).save_native_model_string()
    assert _delta(before, "ckpt_resumed") == 1
    assert engine.last_checkpoint["resumed_from"] == boundary
    assert os.listdir(ck) == []
    assert text == layout["plain"] == layout["ref"][0]


def test_save_boundaries_equal_reference(layout):
    port_text, port_seen = layout["port"]
    ref_text, ref_seen = layout["ref"]
    assert port_seen == ref_seen
    assert {b for _, b in port_seen} - {None}
    assert port_text == ref_text == layout["plain"]


# -- in-process resumes ------------------------------------------------------

def _onehot_data(n=360, seed=11):
    """Two numeric columns and six one-hot columns (EFB bundles them)."""
    rng = np.random.default_rng(seed)
    X = np.zeros((n, 8))
    X[:, :2] = rng.normal(size=(n, 2))
    c = rng.integers(0, 6, size=n)
    X[np.arange(n), 2 + c] = 1.0
    y = (X[:, 0] + (c % 3 == 0) + 0.3 * rng.normal(size=n) > 0.5)
    return X, y.astype(np.float64)


def _data(n=360, seed=3, classes=1):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 8))
    s = X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + 0.5 * rng.normal(size=n)
    if classes == 1:
        return X, (s > 0).astype(np.float64)
    return X, np.digitize(s, [-0.6, 0.6]).astype(np.float64)


RESUMES = {
    "goss": dict(boosting="goss"),
    "goss_d2": dict(boosting="goss", d=2),
    "multiclass": dict(classes=3),
    "multiclass_feature_1x2": dict(classes=3, d=1, feature=2,
                                   parallelism="feature"),
    "quantized": dict(quantized_grad="16"),
    "quantized_d2": dict(quantized_grad="8", d=2, collective="psum"),
    "efb": dict(efb=True),
    "efb_d2": dict(efb=True, d=2, collective="psum"),
    "rf": dict(boosting="rf", bagging_fraction=0.7, bagging_freq=1),
    "d4_psum_val": dict(d=4, collective="psum", val=True,
                        early_stopping_round=5, learning_rate=0.3),
    "data_feature_2x2": dict(d=2, feature=2, parallelism="data+feature",
                             bagging_fraction=0.8, bagging_freq=3),
    "voting_4": dict(d=4, parallelism="voting", top_k=3),
    "init_scores": dict(init_scores=True),
}


def _resume_case(case, ckpt="", callbacks=None):
    kw = dict(RESUMES[case])
    d, feature = kw.pop("d", 1), kw.pop("feature", 1)
    classes = kw.pop("classes", 1)
    efb, val = kw.pop("efb", False), kw.pop("val", False)
    init = kw.pop("init_scores", False)
    X, y = _onehot_data() if efb else _data(classes=classes)
    m = fit_bin_mapper(X, max_bin=31)
    vmask = np.random.default_rng(2).random(len(y)) < 0.25
    tr = ~vmask if val else np.ones(len(y), bool)
    extra = {}
    if val:
        extra = dict(val_bins=m.transform(X[vmask], "cpu"),
                     val_labels=y[vmask], val_metric=logloss)
    if init:
        extra["init_scores"] = np.sin(X[tr, 3]) * 0.5
    mesh = (build_mesh(d, feature, devices=["cpu"] * (d * feature))
            if d * feature > 1 else None)
    obj = (get_objective("multiclass", num_class=3) if classes > 1
           else get_objective("binary"))
    params = TrainParams(num_iterations=10, num_leaves=7, verbosity=0,
                         histogram_method="segment", checkpoint_dir=ckpt,
                         checkpoint_chunk=3, enable_bundle=efb, **kw)
    return train(m.transform(X[tr], "cpu"), y[tr], None, m, obj, params,
                 device="cpu", mesh=mesh, callbacks=callbacks, **extra)


def _interrupted(fit, ck, kill_at):
    """``fit(ck, callbacks)`` ended by a callback at ``kill_at``, then
    resumed; returns the resumed booster's text."""
    def killer(it, trees):
        if it >= kill_at:
            raise _Interrupt

    with pytest.raises(_Interrupt):
        fit(ck, [killer])
    assert read_ckpt_boundary(ck) is not None
    before = _counters()
    text = fit(ck, None).save_native_model_string()
    assert _delta(before, "ckpt_resumed") == 1
    assert os.listdir(ck) == []
    return text


@pytest.mark.parametrize("case", list(RESUMES))
def test_resume_in_process_bit_identical(case, tmp_path):
    plain = _resume_case(case).save_native_model_string()
    if RESUMES[case].get("efb"):
        assert int(engine.last_fit_info["efb_bundles"]) > 0
    text = _interrupted(lambda ck, cbs: _resume_case(case, ck, cbs),
                        str(tmp_path / "ck"), kill_at=4)
    assert text == plain


def test_train_incremental_resumes(tmp_path):
    X, y = _data(seed=5)
    m = fit_bin_mapper(X, max_bin=31)
    bins = m.transform_packed(X).numpy()
    base = train(bins, y, None, m, get_objective("binary"),
                 TrainParams(num_iterations=4, num_leaves=7, verbosity=0,
                             histogram_method="segment"), device="cpu")

    def fit(ck, cbs):
        return train_incremental(
            bins, y, m, init_booster=base, objective=get_objective("binary"),
            params=TrainParams(num_iterations=9, num_leaves=7, verbosity=0,
                               histogram_method="segment",
                               checkpoint_dir=ck, checkpoint_chunk=3),
            device="cpu", callbacks=cbs)

    plain = fit("", None).save_native_model_string()
    assert _interrupted(fit, str(tmp_path / "ck"), kill_at=4) == plain


# -- snapshots that must not resume --------------------------------------

def _small_fit(ck, callbacks=None, **kw):
    X, y = _data(n=300, seed=9)
    m = fit_bin_mapper(X, max_bin=31)
    params = TrainParams(**{**dict(num_iterations=9, num_leaves=7,
                                   verbosity=0, histogram_method="segment",
                                   checkpoint_dir=ck, checkpoint_chunk=3),
                            **kw})
    return train(m.transform(X, "cpu"), y, None, m, get_objective("binary"),
                 params, device="cpu", callbacks=callbacks)


@pytest.fixture(scope="module")
def small_plain():
    return _small_fit("").save_native_model_string()


def _kill_small(ck, kill_at=4):
    def killer(it, trees):
        if it >= kill_at:
            raise _Interrupt

    with pytest.raises(_Interrupt):
        _small_fit(ck, [killer])


@pytest.mark.parametrize("target,mode", [("meta", "torn"),
                                         ("meta", "bitflip"),
                                         ("chunk", "torn")])
def test_corrupt_snapshot_degrades_to_fresh(target, mode, tmp_path,
                                            small_plain):
    ck = str(tmp_path / "ck")
    _kill_small(ck)
    name = (ck_mod._CKPT_FILE if target == "meta"
            else ck_mod._CKPT_CHUNK.format(0))
    corrupt_file(os.path.join(ck, name), mode=mode)
    before = _counters()
    text = _small_fit(ck).save_native_model_string()
    assert _delta(before, "ckpt_discarded") == 1
    assert _delta(before, "ckpt_resumed") == 0
    assert engine.last_checkpoint["resumed_from"] is None
    assert text == small_plain
    assert os.listdir(ck) == []


def test_snapshot_of_another_fit_is_discarded(tmp_path, small_plain):
    ck = str(tmp_path / "ck")
    _kill_small(ck)
    before = _counters()
    # another learning rate: another fit, whose forest this must be
    other = _small_fit(ck, learning_rate=0.2).save_native_model_string()
    assert _delta(before, "ckpt_discarded") == 1
    assert other == _small_fit("", learning_rate=0.2
                               ).save_native_model_string() != small_plain


def test_stale_chunk_cadence_discarded(tmp_path, small_plain):
    """A chunk file holding another tree count than the meta endorses
    (a crash between a chunk write and the meta, then a resume at another
    cadence) is discarded, never stitched into the forest."""
    ck = str(tmp_path / "ck")
    _kill_small(ck, kill_at=7)
    with np.load(os.path.join(ck, ck_mod._CKPT_CHUNK.format(1))) as z:
        chunk = ck_mod._chunk_from(z)
    short = ck_mod.TreeChunk(chunk.trees[:1], chunk.grew[:1])
    ck_mod._write_atomic(os.path.join(ck, ck_mod._CKPT_CHUNK.format(1)),
                         ck_mod._chunk_arrays(short))
    before = _counters()
    text = _small_fit(ck).save_native_model_string()
    assert _delta(before, "ckpt_discarded") == 1
    assert text == small_plain


def test_directory_cleared_on_success_and_counts(tmp_path, small_plain):
    ck = str(tmp_path / "ck")
    before = _counters()
    text = _small_fit(ck).save_native_model_string()
    assert text == small_plain
    assert _delta(before, "ckpt_saved") == 2          # boundaries 3 and 6
    assert engine.last_checkpoint["saves"] == 2
    assert len(engine.last_checkpoint["bytes"]) == 2
    assert os.listdir(ck) == []


# -- the fingerprint -------------------------------------------------------

def _fp(mesh=None, **change):
    X, y = _data(n=64, seed=4)
    m = fit_bin_mapper(X, max_bin=31)
    args = dict(n=64, f=8, K=1, params=TrainParams(num_iterations=8),
                labels=y, bins=m.transform(X, "cpu"), weights=np.ones(64),
                init_scores=None)
    args.update(change)
    if mesh is None:
        return ck_mod._ckpt_fingerprint(**args)
    args["w"] = args.pop("weights")
    return ck_mod._ckpt_fingerprint_mesh(**args, mesh=mesh)


@pytest.mark.parametrize("what", ["labels", "weights", "init_scores",
                                  "params", "bins"])
def test_fingerprint_covers_inputs(what):
    change = {
        "labels": lambda: dict(labels=np.r_[1.0, np.zeros(63)]),
        "weights": lambda: dict(weights=np.r_[2.0, np.ones(63)]),
        "init_scores": lambda: dict(init_scores=np.zeros(64)),
        "params": lambda: dict(params=TrainParams(num_iterations=8,
                                                  seed=7)),
        "bins": lambda: dict(bins=fit_bin_mapper(
            np.random.default_rng(0).normal(size=(64, 8)),
            max_bin=31).transform(np.random.default_rng(0).normal(
                size=(64, 8)), "cpu")),
    }[what]()
    assert _fp(**change) != _fp()


def test_fingerprint_covers_topology():
    meshes = [build_mesh(2, devices=["cpu"] * 2),
              build_mesh(4, devices=["cpu"] * 4),
              build_mesh(2, 2, devices=["cpu"] * 4)]
    fps = {_fp(mesh=m) for m in meshes} | {_fp()}
    fps.add(_fp(mesh=meshes[0], params=TrainParams(num_iterations=8,
                                                   collective="ring")))
    assert len(fps) == 5


@pytest.mark.parametrize("ignored", [
    dict(checkpoint_dir="/elsewhere"), dict(checkpoint_chunk=5),
    dict(pass_through={"checkpoint_chunk": "5"})])
def test_fingerprint_leaves_out_checkpoint_settings(ignored):
    assert _fp(params=TrainParams(num_iterations=8, **ignored)) == _fp()


# -- the snapshot files ----------------------------------------------------

def test_tree_chunk_round_trip_keeps_model_text(tmp_path):
    """Categorical and numeric trees written to a chunk file and read
    back give the same model text byte for byte."""
    rng = np.random.default_rng(8)
    X = rng.normal(size=(300, 4))
    X[:, 3] = rng.integers(0, 12, size=300)
    y = ((X[:, 0] > 0) ^ np.isin(X[:, 3], (2, 5, 7))).astype(np.float64)
    model = LightGBMClassifier(
        numIterations=3, numLeaves=5, device="cpu", verbosity=0,
        categoricalSlotIndexes=[3]).fit(
            {"features": X, "label": y}).getModel()
    assert any(t.num_cat for t in model.trees)
    path = str(tmp_path / "chunk.npz")
    ck_mod._write_atomic(path, ck_mod._chunk_arrays(
        ck_mod.TreeChunk(model.trees, [True] * 3)))
    with np.load(path) as z:
        back = ck_mod._chunk_from(z)
    text = model.save_native_model_string()
    model.trees = back.trees
    assert back.grew == [True] * 3
    assert model.save_native_model_string() == text


def test_mesh_snapshot_round_trip_and_mismatch_discard(tmp_path):
    """Replicas along a feature axis are written once when equal and each
    when they differ; every device gets its own scores back."""
    import torch
    ck = str(tmp_path / "ck")
    a = torch.arange(6, dtype=torch.float32)
    scores = [a, a.clone(), a + 10, a + 20]      # 2 data × 2 feature
    val = torch.zeros(5)
    rng1, rng2 = (np.random.default_rng(s) for s in (1, 2))
    ck_mod._ckpt_save_mesh(ck, "fp", 4, [], scores, val, np.ones(12),
                           rng1, rng2, 0.25, 3, feature=2)
    with np.load(os.path.join(ck, ck_mod._CKPT_MESH_STATE.format(0, 4))
                 ) as z:
        names = [s["device"] for s in ck_mod._read_meta(z)["shards"]
                 if s["name"] == "scores"]
    assert names == [0, 2, 3]
    before = _counters()
    assert ck_mod._ckpt_load_mesh(ck, "other", scores, val, 2) is None
    assert _delta(before, "ckpt_discarded") == 1
    snap = ck_mod._ckpt_load_mesh(ck, "fp", scores, val, 2)
    assert snap["it"] == 4 and snap["best_iter"] == 3
    assert snap["rng_state"] == rng1.bit_generator.state
    for got, want in zip(snap["scores"], scores):
        assert np.array_equal(got, want.numpy())


def test_train_stats_counters_seeded():
    counters = engine.train_stats.snapshot()["counters"]
    for k in ("chunks_replayed", "ckpt_saved", "ckpt_resumed",
              "ckpt_discarded"):
        assert k in counters


def test_clear_removes_every_generation(tmp_path):
    ck = str(tmp_path)
    assert ck_mod._ckpt_glob(ck_mod._CKPT_CHUNK) == "boost_chunk_*.npz"
    assert ck_mod._ckpt_glob(ck_mod._CKPT_MESH_STATE) == \
        "mesh_state_p*_it*.npz"
    names = [ck_mod._CKPT_FILE, ck_mod._CKPT_FILE + ".tmp",
             ck_mod._CKPT_CHUNK.format(0), ck_mod._CKPT_CHUNK.format(10 ** 7),
             ck_mod._CKPT_CHUNK.format(3) + ".tmp",
             ck_mod._CKPT_MESH_STATE.format(0, 8)]
    for nm in names + ["unrelated.txt"]:
        open(os.path.join(ck, nm), "w").close()
    ck_mod._ckpt_clear(ck)
    assert os.listdir(ck) == ["unrelated.txt"]


# -- the surface ------------------------------------------------------------

def test_estimator_checkpoint_dir_and_pass_through(tmp_path):
    X, y = _data(n=300, seed=6)
    table = {"features": X, "label": y}
    kw = dict(numIterations=6, numLeaves=5, device="cpu", verbosity=0)
    plain = LightGBMClassifier(**kw).fit(table).getNativeModel()
    ck = str(tmp_path / "ck")
    got = LightGBMClassifier(checkpointDir=ck, faultTolerantRetries=1,
                             passThroughArgs="checkpoint_chunk=2",
                             **kw).fit(table).getNativeModel()
    assert got == plain
    assert engine.last_checkpoint["saves"] == 2          # 2 and 4
    assert os.listdir(ck) == []
    p = LightGBMClassifier(passThroughArgs=(
        f"checkpoint_dir={ck} fault_tolerant_retries=2"))._train_params()
    assert (p.checkpoint_dir, p.fault_tolerant_retries) == (ck, 2)


def _inert_fit(kind, ck):
    X, y = _data(n=300, seed=12)
    table = {"features": X, "label": y, "q": np.arange(300) // 10}
    kw = dict(numIterations=4, numLeaves=5, device="cpu", verbosity=0,
              checkpointDir=ck)
    if kind == "dart":
        est = LightGBMClassifier(boostingType="dart", **kw)
    else:
        table["label"] = np.digitize(X[:, 0], [-0.5, 0.5]).astype(float)
        est = LightGBMRanker(groupCol="q", **kw)
        if kind == "mesh_lambdarank":
            est.setMesh(build_mesh(2, devices=["cpu"] * 2))
    return est.fit(table).getNativeModel()


@pytest.mark.parametrize("kind", ["dart", "lambdarank", "mesh_lambdarank"])
def test_dart_and_lambdarank_warn_and_stay_inert(kind, tmp_path, caplog):
    ck = str(tmp_path / "ck")
    plain = _inert_fit(kind, "")
    with caplog.at_level(logging.WARNING):
        got = _inert_fit(kind, ck)
    assert got == plain
    assert "checkpoint_dir is inert" in caplog.text
    assert not os.path.exists(ck) or os.listdir(ck) == []


@pytest.mark.parametrize("case", ["serial", "mesh_d2", "dart"])
def test_callbacks_called_in_order(case):
    X, y = _data(n=300, seed=13)
    m = fit_bin_mapper(X, max_bin=31)
    seen = []
    mesh = build_mesh(2, devices=["cpu"] * 2) if case == "mesh_d2" else None
    booster = train(m.transform(X, "cpu"), y, None, m,
                    get_objective("binary"),
                    TrainParams(num_iterations=11, num_leaves=5, verbosity=0,
                                boosting="dart" if case == "dart"
                                else "gbdt"),
                    device="cpu", mesh=mesh,
                    callbacks=[lambda it, trees: seen.append(
                        (it, len(trees)))])
    assert seen == [(i, i + 1) for i in range(11)]
    assert len(booster.trees) == 11
