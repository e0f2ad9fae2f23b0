"""End-to-end fit → transform of the port against the JAX reference, on
the CPU, plus the port's package rules: its entry points default to CUDA,
unported features refuse, and it imports nothing of JAX or the reference.

Parity gate (ROADMAP.md Queue A item 8): on the vendored datasets the
forests have identical structure and the held-out AUC / RMSE agree within
1e-3 relative.  The reference pins ``histogramMethod="segment"``.  On the
CPU the port follows the reference's float order throughout, so the
LightGBM model texts agree byte for byte as well.
"""

import ast
import gzip
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score

from mmlspark_tpu.gbdt import LightGBMClassifier as RefClassifier
from mmlspark_tpu.gbdt import LightGBMRegressor as RefRegressor
from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit
from mmlspark_tpu.gbdt.engine import TrainParams as RefParams
from mmlspark_tpu.gbdt.engine import train as ref_train
from mmlspark_tpu.gbdt.objectives import get_objective as ref_objective
from mmlspark_tpu_torch import LightGBMClassifier, LightGBMRegressor
from mmlspark_tpu_torch.gbdt import fit_bin_mapper, get_objective
from mmlspark_tpu_torch.gbdt.engine import TrainParams, train
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "tests", "benchmarks", "data")


def _load_csv_gz(name):
    with gzip.open(os.path.join(DATA_DIR, name), "rt") as fh:
        fh.readline()
        rows = np.asarray([[float(v) for v in line.split(",")]
                           for line in fh])
    return rows[:, :-1].astype(np.float32), rows[:, -1]


def _same_structure(ref_trees, port_trees):
    assert len(port_trees) == len(ref_trees)
    for i, (a, b) in enumerate(zip(ref_trees, port_trees)):
        for k in ("split_feature", "threshold", "left_child", "right_child",
                  "decision_type", "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k),
                                          err_msg=f"tree {i} {k}")
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-6, err_msg=f"tree {i}")


def test_breast_cancer_classifier_matches_reference():
    X, y = _load_csv_gz("breast_cancer.csv.gz")
    idx = np.random.default_rng(7).permutation(len(y))
    tr, te = idx[:400], idx[400:]
    kw = dict(numIterations=80, numLeaves=15, learningRate=0.1,
              minDataInLeaf=10, verbosity=0, seed=42)
    train_t = {"features": X[tr], "label": y[tr]}
    ref = RefClassifier(histogramMethod="segment", **kw).fit(train_t)
    port = LightGBMClassifier(device="cpu", histogramMethod="segment",
                              **kw).fit(train_t)
    _same_structure(ref.getModel().trees, port.getModel().trees)
    test_t = {"features": X[te]}
    ref_auc = roc_auc_score(
        y[te], np.asarray(ref.transform(test_t)["probability"])[:, 1])
    out = port.transform(test_t)
    port_auc = roc_auc_score(y[te], out["probability"][:, 1])
    assert abs(port_auc - ref_auc) <= 1e-3 * ref_auc
    assert port.getNativeModel() == ref.getNativeModel()
    assert out["rawPrediction"].shape == (len(te), 2)
    assert set(np.unique(out["prediction"])) <= {0.0, 1.0}


def test_diabetes_regressor_matches_reference():
    X, y = _load_csv_gz("diabetes.csv.gz")
    idx = np.random.default_rng(8).permutation(len(y))
    tr, te = idx[:310], idx[310:]
    kw = dict(numIterations=120, numLeaves=7, learningRate=0.05,
              minDataInLeaf=10, verbosity=0, seed=42)
    train_t = {"features": X[tr], "label": y[tr]}
    ref = RefRegressor(histogramMethod="segment", **kw).fit(train_t)
    port = LightGBMRegressor(device="cpu", **kw).fit(train_t)
    _same_structure(ref.getModel().trees, port.getModel().trees)
    test_t = {"features": X[te]}
    rmse = {name: float(np.sqrt(np.mean(
        (np.asarray(m.transform(test_t)["prediction"]) - y[te]) ** 2)))
        for name, m in (("ref", ref), ("port", port))}
    assert abs(rmse["port"] - rmse["ref"]) <= 1e-3 * rmse["ref"]
    assert port.getNativeModel() == ref.getNativeModel()


@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_train_with_bagging_and_feature_fraction(objective):
    """The numpy bagging and feature-fraction streams draw the reference's
    rows and features."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(3000, 8)).astype(np.float32)
    y = X[:, 0] + X[:, 1] * X[:, 2] + rng.normal(size=3000) * 0.2
    if objective == "binary":
        y = (y > 0).astype(np.float64)
    common = dict(num_iterations=8, num_leaves=15, bagging_fraction=0.7,
                  bagging_freq=3, feature_fraction=0.6, seed=5,
                  bagging_seed=6, verbosity=0)
    rmap = ref_fit(X, max_bin=63)
    ref = ref_train(rmap.transform_packed(X), y, None, rmap,
                    ref_objective(objective),
                    RefParams(max_bin=63, histogram_method="segment",
                              **common))
    pmap = fit_bin_mapper(X, max_bin=63)
    port = train(pmap.transform(X, "cpu"), y, None, pmap,
                 get_objective(objective), TrainParams(max_bin=63, **common),
                 device="cpu")
    _same_structure(ref.trees, port.trees)
    assert port.save_native_model_string() == ref.save_native_model_string()


def test_estimators_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    X = np.random.default_rng(0).normal(size=(100, 3))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        LightGBMClassifier(numIterations=2).fit(
            {"features": X, "label": (X[:, 0] > 0).astype(float)})


#: features the first slices refused, each ported since (continued
#: training, initModelPath, is tested in tests/test_torch_continued.py;
#: checkpoints in tests/test_torch_checkpoint.py): they fit now
ASKS = [dict(passThroughArgs="checkpoint_dir=ckpt"),
        dict(checkpointDir="ckpt")]
#: features a later slice ported: they fit now, on both estimators
LIFTED = [
    dict(boostingType="goss"), dict(earlyStoppingRound=5),
    dict(quantizedGrad="16"), dict(validationIndicatorCol="val"),
    dict(boostingType="dart"), dict(objective="poisson"),
    dict(objective="huber"), dict(enableBundle=True),
]


@pytest.mark.parametrize("ask", ASKS, ids=lambda a: next(iter(a.items()))[0]
                         + "=" + str(next(iter(a.values()))))
def test_unported_features_refuse(ask, tmp_path, monkeypatch):
    """The asks the first slices refused (the name is from then) fit
    now, and checkpointing leaves its directory (``ckpt`` under the
    working directory) empty."""
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 3))
    table = {"features": X, "label": X[:, 0], "val": X[:, 1] > 0}
    model = LightGBMRegressor(numIterations=2, device="cpu", **ask).fit(
        table)
    assert len(model.getModel().trees) == 2
    assert not (tmp_path / "ckpt").exists() or \
        not list((tmp_path / "ckpt").iterdir())


@pytest.mark.parametrize("ask", LIFTED, ids=lambda a: next(iter(
    a.items()))[0] + "=" + str(next(iter(a.values()))))
def test_lifted_features_fit(ask):
    """boostingType="goss" and "dart", quantizedGrad,
    validationIndicatorCol, earlyStoppingRound, the poisson and huber
    objectives and enableBundle fit on both estimators and score every
    row."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(400, 3))
    table = {"features": X, "label": (X[:, 0] > 0).astype(float),
             "val": X[:, 1] > 0.5}
    kw = dict(numIterations=3, numLeaves=4, minDataInLeaf=5,
              device="cpu", verbosity=0, **ask)
    if "earlyStoppingRound" in ask:
        kw["validationIndicatorCol"] = "val"
    for est in (LightGBMClassifier(**kw), LightGBMRegressor(**kw)):
        model = est.fit(table)
        assert 1 <= len(model.getModel().trees) <= 3
        assert np.isfinite(model.transform(table)["prediction"]).all()


def test_multiclass_labels_refuse():
    """3-class labels no longer refuse: they fit as multiclass, with one
    tree per class per iteration, as the reference's auto-promotion
    does."""
    X = np.random.default_rng(0).normal(size=(90, 2))
    model = LightGBMClassifier(device="cpu", numIterations=2,
                               minDataInLeaf=5).fit(
        {"features": X, "label": np.arange(90) % 3})
    booster = model.getModel()
    assert booster.num_class == 3 and len(booster.trees) == 6
    assert booster.objective_str == "multiclass num_class:3"
    assert model.transform({"features": X})["probability"].shape == (90, 3)


def _port_sources():
    pkg = os.path.join(REPO, "mmlspark_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(root, f)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "mmlspark_tpu")


def test_port_sources_import_neither_jax_nor_the_reference():
    """AST scan: the image preloads jax, so sys.modules alone cannot show
    that the port avoids it."""
    bad = []
    for path in _port_sources():
        with open(path) as fh:
            tree = ast.parse(fh.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad


def test_importing_the_port_loads_no_reference_module():
    code = (
        "import sys, pkgutil, importlib\n"
        "before = set(sys.modules)\n"
        "import mmlspark_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "new = set(sys.modules) - before\n"
        "print(sorted(m for m in new if m == 'mmlspark_tpu' "
        "or m.startswith('mmlspark_tpu.')))\n"
        "print(len([m for m in new if m.startswith('mmlspark_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": REPO})
    assert out.returncode == 0, out.stderr
    leaked, loaded = out.stdout.split("\n")[:2]
    assert leaked == "[]"
    assert int(loaded) >= 10
