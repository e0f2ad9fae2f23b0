"""The port's native forest scorer (``native/fastforest.cc``) against the
port's device walk and the JAX reference's native scorer, on the CPU.

Forests: binary, multiclass (K = 3) and with categorical columns, fitted
by the port (1,000 rows, 6 features, 6 iterations) and loaded into the
reference from the model text; the rows scored carry NaNs and, in the
categorical columns, unseen and negative categories.

* ``predict_margin`` of a CPU booster (the native scorer),
  ``predictor()`` (``mode == "native"``) and the port's device walk
  (``predictor(backend="jit")``) equal the reference's
  ``predictor(backend="native")`` bit for bit: the whole forest, an
  iteration count, and tree ranges without the init score.
* The native wrapper refuses a forest whose arrays disagree in shape, and
  the predictor refuses rows with too few features.
"""

import numpy as np
import pytest

from mmlspark_tpu.gbdt import Booster as RefBooster
from mmlspark_tpu_torch import LightGBMClassifier, native
from torch_parity import (data, one_torch_thread,
                          reference_native)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread",
                                     "reference_native")

KW = dict(numIterations=6, learningRate=0.3, numLeaves=7, minDataInLeaf=10,
          maxBin=63, verbosity=0, device="cpu")


def _rows(X, categorical):
    X = X.copy()
    rng = np.random.default_rng(12)
    X[rng.random(X.shape) < 0.05] = np.nan
    if categorical:
        X[::7, -1] = 999.0
        X[3::11, -2] = -1.0
        X[5::13, -1] = 2.5
    return X


@pytest.fixture(scope="module", params=["binary", "multiclass",
                                        "categorical"])
def forest(request):
    """``(port booster, reference booster, rows to score, K)``."""
    cat = request.param == "categorical"
    objective = "multiclass" if request.param == "multiclass" else "binary"
    X, y = data(objective, n=1000, f=6, categorical=cat)
    kw = dict(KW, objective=objective)
    if cat:
        kw["categoricalSlotIndexes"] = [4, 5]
    booster = LightGBMClassifier(**kw).fit(
        {"features": X, "label": y}).getModel()
    ref = RefBooster.load_native_model_string(
        booster.save_native_model_string())
    return booster, ref, _rows(X, cat), booster.num_class


def test_native_margins_equal_the_walk_and_the_reference(forest):
    booster, ref, X, K = forest
    calls = native.predict_forest.calls
    pred = booster.predictor()
    assert pred.mode == "native"
    got = pred(X).numpy()
    assert native.predict_forest.calls == calls + 1
    assert got.shape == ((len(X),) if K == 1 else (len(X), K))
    want = np.asarray(ref.predictor(backend="native")(X))
    assert ref.predictor(backend="native").mode == "native"
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(booster.predict_margin(X).numpy(), want)
    np.testing.assert_array_equal(
        booster.predictor(backend="jit")(X).numpy(), want)
    np.testing.assert_array_equal(np.asarray(ref.predict_margin(X)), want)


def test_native_num_iteration_and_tree_ranges_equal_the_reference(forest):
    booster, ref, X, K = forest
    for it in (1, 4):
        got = booster.predictor(num_iteration=it)(X).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            ref.predictor(num_iteration=it, backend="native")(X)))
        np.testing.assert_array_equal(
            got, booster.predict_margin(X, it).numpy())
    T = len(booster.trees)
    for lo, hi in ((0, 2 * K), (2 * K, T)):
        got = booster.predictor(tree_range=(lo, hi),
                                include_init_score=False)(X).numpy()
        np.testing.assert_array_equal(got, np.asarray(ref.predictor(
            backend="native", tree_range=(lo, hi),
            include_init_score=False)(X)))
        np.testing.assert_array_equal(got, booster.predictor(
            backend="jit", tree_range=(lo, hi),
            include_init_score=False)(X).numpy())


def test_mismatched_shapes_raise(forest):
    booster, _, X, K = forest
    h = booster._host_stack()
    good = {k: h[k] for k, _ in native.FOREST_ARRAYS}
    out = np.zeros((len(X), K), np.float32)
    Xf = np.ascontiguousarray(np.nan_to_num(X), np.float32)
    for key, bad in (("thr", good["thr"][:, :-1]),
                     ("left", good["left"][:-1]),
                     ("single", good["single"][:-1]),
                     ("leaf", good["leaf"][:-1]),
                     ("feat", good["feat"].astype(np.int64))):
        with pytest.raises((ValueError, TypeError)):
            native.predict_forest(Xf, {**good, key: np.ascontiguousarray(
                bad)}, K, h["has_cat"], out)
    with pytest.raises(ValueError, match="out"):
        native.predict_forest(Xf, good, K, h["has_cat"], out[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        native.predict_forest(np.asfortranarray(Xf), good, K, h["has_cat"],
                              out)
    with pytest.raises(ValueError, match="feature index"):
        booster.predictor()(X[:, :3])
    with pytest.raises(ValueError, match="feature index"):
        booster.predict_margin(X[:, :3])
