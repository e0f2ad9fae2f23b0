"""Stage persistence, ``passThroughArgs`` and ``profileTraceDir`` in the
port, against the JAX reference on the CPU.

* ``passThroughArgs``: the model text equals the reference's byte for byte
  (keys naming engine params apply and are not recorded; the others are
  recorded as given), and the port's ``TrainParams`` fields plus the
  reference-only ones it names are the reference's fields.
* ``profileTraceDir`` writes a Chrome trace of the fit.
* ``save`` / ``load`` of the three models, of an estimator and of a
  ``Pipeline`` and its ``PipelineModel``: transform outputs equal bit for
  bit.  A model directory and a pipeline directory saved by the reference
  load into the port (by bare class name) and score as the reference does,
  bit for bit.
* In a fresh interpreter, loading a reference-saved directory and fitting
  a continuation imports neither ``jax`` nor ``mmlspark_tpu``.
"""

import dataclasses
import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from mmlspark_tpu.core.pipeline import PipelineModel as RefPipelineModel
from mmlspark_tpu.gbdt import LightGBMClassificationModel as RefClsModel
from mmlspark_tpu.gbdt import LightGBMClassifier as RefClassifier
from mmlspark_tpu.gbdt.engine import TrainParams as RefParams
from mmlspark_tpu_torch import (LightGBMClassificationModel,
                                LightGBMClassifier, LightGBMRanker,
                                LightGBMRankerModel, LightGBMRegressionModel,
                                LightGBMRegressor)
from mmlspark_tpu_torch.core import Pipeline, PipelineModel
from mmlspark_tpu_torch.gbdt.engine import REFERENCE_ONLY_PARAMS, TrainParams
from torch_parity import data, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(numIterations=5, learningRate=0.3, numLeaves=7, minDataInLeaf=10,
          maxBin=63, verbosity=0)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _binary_table(n=1000):
    X, y = data("binary", n=n, f=6)
    return {"features": X, "label": y}


def _equal_tables(a, b):
    assert set(a) == set(b)
    for k in a:
        va, vb = np.asarray(a[k]), np.asarray(b[k])
        if va.dtype == object:
            va, vb = np.stack(va), np.stack(vb)
        assert np.array_equal(va, vb), k


def test_pass_through_args_model_text_equals_reference():
    table = _binary_table()
    args = ("min_data_in_leaf=7 num_leaves=5 packed_gather=true "
            "checkpoint_chunk=8 metric_freq=3 foo=bar")
    want = RefClassifier(histogramMethod="segment", passThroughArgs=args,
                         **KW).fit(table).getNativeModel()
    got = LightGBMClassifier(device="cpu", passThroughArgs=args,
                             **KW).fit(table).getNativeModel()
    assert got == want
    assert "[foo: bar]" in got and "[num_leaves: 5]" in got
    assert "packed_gather" not in got


def test_train_params_fields_are_the_reference_fields():
    port = {f.name for f in dataclasses.fields(TrainParams)}
    ref = {f.name for f in dataclasses.fields(RefParams)}
    assert port | set(REFERENCE_ONLY_PARAMS) == ref
    assert not port & set(REFERENCE_ONLY_PARAMS)
    with pytest.raises(ValueError, match="cannot be coerced"):
        TrainParams(pass_through={"num_leaves": "many"})


def test_profile_trace_dir_writes_a_trace(tmp_path):
    out = tmp_path / "trace"
    LightGBMClassifier(device="cpu", profileTraceDir=str(out),
                       **KW).fit(_binary_table(300))
    paths = glob.glob(str(out / "*.trace.json"))
    assert len(paths) == 1
    with open(paths[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("histogram" in str(e.get("name", "")) or
               e.get("ph") == "X" for e in events)


@pytest.mark.parametrize("stage", ["classifier", "regressor", "ranker"])
def test_model_and_estimator_round_trip(tmp_path, stage):
    objective = "regression" if stage == "regressor" else "binary"
    X, y = data(objective, n=600, f=5)
    table = {"features": X, "label": y, "query": np.arange(600) // 12}
    est_cls, model_cls = {
        "classifier": (LightGBMClassifier, LightGBMClassificationModel),
        "regressor": (LightGBMRegressor, LightGBMRegressionModel),
        "ranker": (LightGBMRanker, LightGBMRankerModel)}[stage]
    kw = dict(KW, device="cpu")
    if stage == "ranker":
        kw["groupCol"] = "query"
    est = est_cls(**kw)
    est.save(str(tmp_path / "est"))
    loaded_est = est_cls.load(str(tmp_path / "est"))
    assert dict(loaded_est._iterSetParams()) == dict(est._iterSetParams())
    model = est.fit(table)
    model.save(str(tmp_path / "model"))
    with pytest.raises(FileExistsError):
        model.save(str(tmp_path / "model"))
    loaded = model_cls.load(str(tmp_path / "model"))
    assert loaded.getDevice() == "cpu"
    # a loaded model's text keeps the trees, not the fit's parameters
    assert loaded.getNativeModel() == \
        model.getNativeModel().split("parameters:")[0] + "parameters:\n" \
        + "end of parameters\n"
    _equal_tables(loaded.transform(table), model.transform(table))
    _equal_tables(loaded_est.fit(table).transform(table),
                  model.transform(table))


def test_pipeline_round_trip(tmp_path):
    table = _binary_table(600)
    pipe = Pipeline(stages=[LightGBMClassifier(device="cpu", **KW)])
    pipe.save(str(tmp_path / "pipe"))
    loaded_pipe = Pipeline.load(str(tmp_path / "pipe"))
    model = pipe.fit(table)
    assert isinstance(model, PipelineModel)
    model.write().overwrite().save(str(tmp_path / "pm"))
    loaded = PipelineModel.read().load(str(tmp_path / "pm"))
    out = model.transform(table)
    _equal_tables(loaded.transform(table), out)
    _equal_tables(loaded_pipe.fit(table).transform(table), out)


def test_reference_saved_directories_load_and_score_alike(tmp_path):
    table = _binary_table(600)
    text = LightGBMClassifier(device="cpu", **KW).fit(table).getNativeModel()
    ref = RefClsModel.loadNativeModelFromString(text)
    ref.setFeaturesShapCol("shap")
    ref.save(str(tmp_path / "model"))
    RefPipelineModel([ref]).save(str(tmp_path / "pm"))
    want = ref.transform(table)
    got = LightGBMClassificationModel.load(str(tmp_path / "model"))
    assert got.getNativeModel() == ref.getNativeModel()
    _equal_tables(got.setDevice("cpu").transform(table), want)
    pm = PipelineModel.load(str(tmp_path / "pm"))
    pm.stages[0].setDevice("cpu")
    _equal_tables(pm.transform(table), want)


_NO_JAX = r"""
import json, sys
before = set(sys.modules)
from mmlspark_tpu_torch.core.serialize import load_stage
model = load_stage(sys.argv[1]).setDevice("cpu")
import numpy as np
X = np.random.default_rng(0).normal(size=(400, 6))
y = (X[:, 0] > 0).astype(float)
model.saveNativeModel(sys.argv[2])
from mmlspark_tpu_torch import LightGBMClassifier
cont = LightGBMClassifier(device="cpu", numIterations=2, numLeaves=4,
                          verbosity=0, initModelPath=sys.argv[2]).fit(
    {"features": X, "label": y})
new = set(sys.modules) - before
print(json.dumps({"trees": len(cont.getModel().trees),
                  "class": type(model).__module__,
                  "bad": sorted(m for m in new if m.split(".")[0] in
                                ("jax", "jaxlib", "mmlspark_tpu"))}))
"""


def test_loading_and_continuing_import_no_jax(tmp_path):
    text = LightGBMClassifier(device="cpu", **KW).fit(
        _binary_table(400)).getNativeModel()
    RefClsModel.loadNativeModelFromString(text).save(str(tmp_path / "m"))
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run(
        [sys.executable, "-c", _NO_JAX, str(tmp_path / "m"),
         str(tmp_path / "base.txt")],
        capture_output=True, text=True, env=env, cwd=str(tmp_path),
        timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res == {"trees": 7, "class": "mmlspark_tpu_torch.gbdt.classifier",
                   "bad": []}
