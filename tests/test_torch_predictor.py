"""The port's serving surface of the Booster against the JAX reference, on
the CPU: :class:`CompiledPredictor` (``Booster.predictor``) and
``predict_leaf_index``.

Forests: binary, multiclass (K = 3) and with categorical columns, each
fitted by the port (1,000 rows, 6 features, 5 iterations) and loaded into
the reference from its model text.  The rows scored carry NaNs and, in the
categorical columns, unseen and negative categories.

* ``predictor()`` margins (on these CPU boosters the native scorer,
  ``mode == "native"``) equal the reference's ``predictor(backend="jit")``,
  the port's ``predictor(backend="jit")`` and its own ``predict_margin``
  bit for bit, for the whole forest, an iteration count and tree ranges
  with and without the init score; the partials of a split forest sum to
  the full margins within rtol 1e-5 and atol 1e-5 (the reference's bound).
* ``predict_leaf_index`` equals the reference's bit for bit.
* The contract's errors: tree ranges off the class boundaries or outside
  the forest, ``num_iteration`` with a range, a stale predictor, and
  ``backend="native"`` on a booster whose device is a card (the native
  scorer runs on the CPU).
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.gbdt import Booster as RefBooster
from mmlspark_tpu_torch import LightGBMClassifier
from mmlspark_tpu_torch.gbdt import CompiledPredictor
from torch_parity import data, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(numIterations=5, learningRate=0.3, numLeaves=7, minDataInLeaf=10,
          maxBin=63, verbosity=0, device="cpu")
FORESTS = ("binary", "multiclass", "categorical")


def _score_rows(X, categorical):
    X = X.copy()
    rng = np.random.default_rng(11)
    X[rng.random(X.shape) < 0.05] = np.nan
    if categorical:
        X[::7, -1] = 999.0
        X[3::11, -2] = -1.0
    return X


@pytest.fixture(scope="module", params=FORESTS)
def forest(request):
    """``(port booster, reference booster, rows to score, K)``."""
    name = request.param
    cat = name == "categorical"
    objective = "multiclass" if name == "multiclass" else "binary"
    X, y = data(objective, n=1000, f=6, categorical=cat)
    kw = dict(KW, objective=objective)
    if cat:
        kw["categoricalSlotIndexes"] = [4, 5]
    booster = LightGBMClassifier(**kw).fit(
        {"features": X, "label": y}).getModel()
    ref = RefBooster.load_native_model_string(
        booster.save_native_model_string())
    return booster, ref, _score_rows(X, cat), booster.num_class


def test_predictor_equals_reference_and_predict_margin(forest):
    booster, ref, X, K = forest
    pred = booster.predictor()
    assert isinstance(pred, CompiledPredictor) and pred.mode == "native"
    got = pred(X).numpy()
    assert np.array_equal(got, booster.predict_margin(X).numpy())
    assert np.array_equal(got, np.asarray(ref.predictor(backend="jit")(X)))
    walk = booster.predictor(backend="jit")
    assert walk.mode == "jit" and np.array_equal(walk(X).numpy(), got)
    got3 = booster.predictor(num_iteration=3, backend="jit")(X).numpy()
    assert np.array_equal(got3, booster.predict_margin(X, 3).numpy())
    assert np.array_equal(got3, np.asarray(
        ref.predictor(num_iteration=3, backend="jit")(X)))


def test_tree_range_partials_equal_reference_and_sum_to_the_margins(forest):
    booster, ref, X, K = forest
    booster.init_score = ref.init_score = 0.25
    try:
        T = len(booster.trees)
        cut = 2 * K
        full = booster.predictor()(X).numpy()
        parts = []
        for rng_, init in (((0, cut), True), ((cut, T), False)):
            p = booster.predictor(tree_range=rng_,
                                  include_init_score=init)(X).numpy()
            r = np.asarray(ref.predictor(backend="jit", tree_range=rng_,
                                         include_init_score=init)(X))
            assert np.array_equal(p, r)
            parts.append(p)
        np.testing.assert_allclose(parts[0] + parts[1], full, rtol=1e-5,
                                   atol=1e-5)
        empty = booster.predictor(tree_range=(cut, cut))
        assert empty.mode == "empty"
        assert np.array_equal(empty(X).numpy(), np.asarray(
            ref.predictor(backend="jit", tree_range=(cut, cut))(X)))
    finally:
        booster.init_score = ref.init_score = 0.0


def test_leaf_indices_equal_reference(forest):
    booster, ref, X, _ = forest
    got = booster.predict_leaf_index(X).numpy()
    want = np.asarray(ref.predict_leaf_index(X))
    assert got.dtype == np.int32 and got.shape == (len(X), len(ref.trees))
    assert np.array_equal(got, want)


def test_predictor_contract_errors(forest, monkeypatch):
    booster, _, X, K = forest
    T = len(booster.trees)
    bad = [dict(tree_range=(0, T + K)),
           dict(tree_range=(0, K), num_iteration=1)]
    if K > 1:
        bad += [dict(tree_range=(1, T)), dict(tree_range=(0, K + 1))]
    for kw in bad:
        with pytest.raises(ValueError):
            booster.predictor(**kw)
    with pytest.raises(ValueError, match="backend"):
        booster.predictor(backend="xla")
    # a booster on a card: the device resolves as it would there
    from mmlspark_tpu_torch.gbdt import booster as booster_mod
    monkeypatch.setattr(booster_mod, "resolve_device", torch.device)
    monkeypatch.setattr(booster, "device", "cuda:0")
    with pytest.raises(RuntimeError, match="runs on the CPU"):
        booster.predictor(backend="native")
    monkeypatch.undo()
    with pytest.raises(ValueError, match="feature index"):
        booster.predictor()(X[:, :3])


def test_a_stale_predictor_raises(forest):
    booster, _, X, _ = forest
    pred = booster.predictor()
    pred(X)
    booster.invalidate_cache()
    with pytest.raises(RuntimeError, match="stale"):
        pred(X)
    fresh = booster.predictor()
    assert np.array_equal(fresh(X).numpy(),
                          booster.predict_margin(X).numpy())
    grown = booster.extended(booster)
    assert grown.device == booster.device
    assert np.array_equal(fresh(X).numpy(),
                          booster.predict_margin(X).numpy())
