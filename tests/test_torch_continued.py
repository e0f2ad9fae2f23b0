"""Continued training in the port against the JAX reference, on the CPU.

The reference is pinned to ``histogramMethod="segment"``; inputs come from
numpy seeds at small sizes (2,000 rows, 8 features, 5 iterations on top of
a 5-iteration base model).

* ``initModelPath``: the merged model text equals the reference's byte for
  byte, serially, on a data mesh with psum at D = 2, under GOSS, for a
  multiclass model, and with early stopping on a validation set (whose
  scores start at the base model's margins).
* ``initScoreCol`` (gbdt, GOSS, DART, and a data mesh with a pad row)
  and ``train_incremental`` (continuation from binned rows through the
  bins' representative values) likewise.
* The refusals are the reference's: DART and rf continuations (also DART
  asked for through ``passThroughArgs``), a base model of another class
  count or feature count, and a mesh ranker with init scores.
  ``checkpointDir``, refused by the first slices, is accepted, set
  directly or through ``passThroughArgs``, and writes the model text of
  the same fit without it.
"""

import os

import jax
import numpy as np
import pytest

from mmlspark_tpu.core.mesh import build_mesh as ref_build_mesh
from mmlspark_tpu.gbdt import LightGBMClassifier as RefClassifier
from mmlspark_tpu.gbdt import LightGBMRanker as RefRanker
from mmlspark_tpu.gbdt import LightGBMRegressor as RefRegressor
from mmlspark_tpu.gbdt import Booster as RefBooster
from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit
from mmlspark_tpu.gbdt.engine import TrainParams as RefParams
from mmlspark_tpu.gbdt.engine import train_incremental as ref_incremental
from mmlspark_tpu.gbdt.objectives import get_objective as ref_objective
from mmlspark_tpu_torch import (LightGBMClassifier, LightGBMRanker,
                                LightGBMRegressor, build_mesh)
from mmlspark_tpu_torch.gbdt import (Booster, fit_bin_mapper, get_objective,
                                     train_incremental)
from mmlspark_tpu_torch.gbdt.engine import TrainParams
from torch_parity import data, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N, F = 2000, 8
KW = dict(numIterations=5, learningRate=0.3, numLeaves=7, minDataInLeaf=10,
          maxBin=63, verbosity=0)


def _table(objective, seed=3):
    X, y = data(objective, n=N, f=F, seed=seed)
    return {"features": X, "label": y}


def _base(tmp_path, objective, **kw):
    """A 5-iteration port model of ``objective`` saved as LightGBM text:
    ``(path, model text)``."""
    est = (LightGBMRegressor if objective == "regression"
           else LightGBMClassifier)
    extra = {} if objective == "regression" else {"objective": objective}
    model = est(device="cpu", **KW, **extra, **kw).fit(_table(objective))
    path = str(tmp_path / f"base_{objective}.txt")
    model.saveNativeModel(path)
    return path, model.getNativeModel()


def _blocks(text):
    """The tree blocks of a model text, each from ``Tree=`` to its
    ``shrinkage`` line."""
    body = text.split("end of trees")[0]
    return ["Tree=" + b for b in body.split("Tree=")[1:]]


CASES = {
    "serial": ("binary", {}, None),
    "data_psum_2": ("binary", dict(collective="psum"), 2),
    "goss": ("binary", dict(boostingType="goss", topRate=0.3,
                            otherRate=0.2), None),
    "multiclass": ("multiclass", {}, None),
    "early_stopping": ("binary", dict(validationIndicatorCol="val",
                                      earlyStoppingRound=2,
                                      numIterations=30), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_model_continuation_equals_reference(tmp_path, case):
    objective, kw, shards = CASES[case]
    path, base_text = _base(tmp_path, objective)
    table = _table(objective, seed=4)
    if "validationIndicatorCol" in kw:
        table["val"] = np.random.default_rng(5).random(N) < 0.25
    extra = {} if objective == "binary" else {"objective": objective}
    ref = RefClassifier(histogramMethod="segment", initModelPath=path,
                        **{**KW, **extra, **kw})
    port = LightGBMClassifier(device="cpu", initModelPath=path,
                              **{**KW, **extra, **kw})
    if shards:
        ref.setMesh(ref_build_mesh(data=shards,
                                   devices=jax.devices()[:shards]))
        port.setMesh(build_mesh(shards, devices=["cpu"] * shards))
    want = ref.fit(table).getNativeModel()
    got = port.fit(table).getNativeModel()
    assert got == want
    K = 3 if objective == "multiclass" else 1
    base_blocks = _blocks(base_text)
    assert _blocks(got)[:len(base_blocks)] == base_blocks
    merged = len(_blocks(got)) // K
    assert f"[num_iterations: {merged}]" in got
    if case == "early_stopping":
        assert merged < 5 + 30
    else:
        assert merged == 10


ISCORE_CASES = {
    "gbdt": ({}, None, N),
    "goss": (dict(boostingType="goss", topRate=0.3, otherRate=0.2), None, N),
    "dart": (dict(boostingType="dart", dropRate=0.5, skipDrop=0.0), None,
             N),
    # 1,999 rows on 4 shards: the pad row keeps the plain init score
    "data_psum_4_padded": (dict(collective="psum"), 4, N - 1),
}


@pytest.mark.parametrize("case", sorted(ISCORE_CASES))
def test_init_score_col_equals_reference(tmp_path, case):
    kw, shards, n = ISCORE_CASES[case]
    path, _ = _base(tmp_path, "binary")
    table = {k: v[:n] for k, v in _table("binary", seed=4).items()}
    base = Booster.load_native_model(path, "cpu")
    table["offset"] = base.predict_margin(table["features"]).numpy() \
        .astype(np.float64)
    ref = RefClassifier(histogramMethod="segment", initScoreCol="offset",
                        **KW, **kw)
    port = LightGBMClassifier(device="cpu", initScoreCol="offset", **KW,
                              **kw)
    if shards:
        ref.setMesh(ref_build_mesh(data=shards,
                                   devices=jax.devices()[:shards]))
        port.setMesh(build_mesh(shards, devices=["cpu"] * shards))
    want = ref.fit(table).getNativeModel()
    got = port.fit(table).getNativeModel()
    assert got == want
    if case == "gbdt":
        # the same offsets through initModelPath grow the same trees
        cont = LightGBMClassifier(device="cpu", initModelPath=path,
                                  **KW).fit(table).getNativeModel()
        assert _blocks(cont)[5:] == [
            b.replace(f"Tree={i}\n", f"Tree={i + 5}\n", 1)
            for i, b in enumerate(_blocks(got))]


def test_train_incremental_equals_reference(tmp_path):
    path, _ = _base(tmp_path, "regression")
    X, y = data("regression", n=N, f=F, seed=4)
    params = dict(num_iterations=5, learning_rate=0.3, num_leaves=7,
                  min_data_in_leaf=10, max_bin=63, verbosity=0)
    rmap = ref_fit(X, max_bin=63)
    pmap = fit_bin_mapper(X, max_bin=63)
    want = ref_incremental(
        rmap.transform_packed(X), y, rmap,
        init_booster=RefBooster.load_native_model(path),
        objective=ref_objective("regression"),
        params=RefParams(histogram_method="segment", **params))
    got = train_incremental(
        pmap.transform(X, "cpu").numpy(), y, pmap,
        init_booster=Booster.load_native_model(path, "cpu"),
        objective=get_objective("regression"),
        params=TrainParams(histogram_method="segment", **params),
        device="cpu")
    assert got.save_native_model_string() == \
        want.save_native_model_string()
    assert got.device == "cpu" and len(got.trees) == 10


def _raises_like_reference(ref_fit_call, port_fit_call, exc):
    with pytest.raises(exc) as r:
        ref_fit_call()
    with pytest.raises(exc) as p:
        port_fit_call()
    return str(r.value), str(p.value)


@pytest.mark.parametrize("kw", [
    dict(boostingType="dart"),
    dict(boostingType="rf", baggingFraction=0.8, baggingFreq=1),
    dict(passThroughArgs="boosting=dart"),
], ids=["dart", "rf", "dart_pass_through"])
def test_continuing_dart_or_rf_is_refused(tmp_path, kw):
    path, _ = _base(tmp_path, "binary")
    table = _table("binary")
    ref, port = _raises_like_reference(
        lambda: RefClassifier(initModelPath=path, **KW, **kw).fit(table),
        lambda: LightGBMClassifier(device="cpu", initModelPath=path, **KW,
                                   **kw).fit(table),
        ValueError)
    assert port == ref and "gbdt or goss" in port


@pytest.mark.parametrize("mismatch", ["num_class", "features"])
def test_a_base_model_of_another_shape_is_refused(tmp_path, mismatch):
    path, _ = _base(tmp_path, "multiclass" if mismatch == "num_class"
                    else "binary")
    table = _table("binary")
    if mismatch == "features":
        table["features"] = table["features"][:, :F - 1]
    ref, port = _raises_like_reference(
        lambda: RefClassifier(initModelPath=path, **KW).fit(table),
        lambda: LightGBMClassifier(device="cpu", initModelPath=path,
                                   **KW).fit(table),
        ValueError)
    assert port == ref


def test_a_mesh_ranker_with_init_scores_is_refused():
    X, y = data("binary", n=400, f=4)
    table = {"features": X, "label": y, "query": np.arange(400) // 10,
             "offset": np.zeros(400)}
    kw = dict(numIterations=2, numLeaves=4, minDataInLeaf=5, verbosity=0,
              groupCol="query", initScoreCol="offset")
    _raises_like_reference(
        lambda: RefRanker(**kw).setMesh(ref_build_mesh(
            data=2, devices=jax.devices()[:2])).fit(table),
        lambda: LightGBMRanker(device="cpu", **kw).setMesh(build_mesh(
            2, devices=["cpu"] * 2)).fit(table),
        NotImplementedError)


def test_checkpoint_dir_is_still_refused(tmp_path):
    """``checkpointDir`` is no longer refused (the name is from when it
    was): set directly or through
    ``passThroughArgs`` it fits, leaves its directory empty, and writes
    the plain fit's model text."""
    plain = LightGBMClassifier(device="cpu", **KW).fit(
        _table("binary")).getNativeModel()
    for kw in (dict(checkpointDir=str(tmp_path / "a")),
               dict(passThroughArgs=f"checkpoint_dir={tmp_path / 'b'} "
                                    "checkpoint_chunk=2")):
        got = LightGBMClassifier(device="cpu", **kw, **KW).fit(
            _table("binary")).getNativeModel()
        assert got == plain
    assert not os.path.exists(tmp_path / "a")      # one chunk: no save
    assert os.listdir(tmp_path / "b") == []
