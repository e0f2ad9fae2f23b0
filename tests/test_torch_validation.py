"""Validation sets and early stopping in the port against the JAX
reference, on the CPU.

The reference is pinned to ``histogram_method="segment"``; inputs come
from numpy seeds at small sizes (1,200 rows, 6 features, a quarter of
them flagged for validation).

* The estimators: ``validationIndicatorCol`` with ``earlyStoppingRound``
  on the binary classifier (with weights), the L2 regressor and the
  multiclass classifier write the reference's model text byte for byte
  and stop at the reference's iteration, before ``numIterations``; the
  mapper is fit on the training rows only.
* ``engine.train`` with a validation set, model text and stop iteration
  byte for byte: binary under every learner (serial; data psum / ring at
  D = 2, 4; voting ring at D = 4; feature 1 × 2; data+feature 2 × 2), L2
  serially, on the data ring and voting at D = 4, multiclass serially and
  on feature 1 × 2, and with categorical columns.
* The stop rule's corner: an iteration in which no class's tree splits,
  with validation on, is kept and recorded as the stop, as the
  reference's post-hoc cut does.
* The validation metrics the port records equal the metric of the
  reference's scores recomputed from its model text.
"""

import numpy as np
import pytest

from mmlspark_tpu.gbdt import LightGBMClassifier as RefClassifier
from mmlspark_tpu.gbdt import LightGBMRegressor as RefRegressor
from mmlspark_tpu_torch import LightGBMClassifier, LightGBMRegressor
from mmlspark_tpu_torch.gbdt import engine
from torch_parity import (LEARNERS, data, fit_pair,
                          one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ES = dict(num_iterations=40, learning_rate=0.4, num_leaves=7,
          min_data_in_leaf=10, early_stopping_round=3)


def _val_mask(n, seed=5):
    return np.random.default_rng(seed).random(n) < 0.25


def _stop(booster):
    return int(booster.params["num_iterations"])


@pytest.mark.parametrize("objective", ["binary", "regression", "multiclass"])
def test_estimator_early_stopping_equals_reference(objective):
    X, y = data(objective)
    table = {"features": X, "label": y, "val": _val_mask(len(y))}
    kw = dict(numIterations=40, learningRate=0.4, numLeaves=7,
              minDataInLeaf=10, verbosity=0, validationIndicatorCol="val",
              earlyStoppingRound=3)
    if objective == "binary":
        table["w"] = np.random.default_rng(6).uniform(0.5, 2.0, len(y))
        kw["weightCol"] = "w"
    if objective == "regression":
        ref, port = RefRegressor, LightGBMRegressor
    else:
        ref, port = RefClassifier, LightGBMClassifier
        kw["objective"] = objective
    want = ref(histogramMethod="segment", **kw).fit(table).getModel()
    got = port(device="cpu", **kw).fit(table).getModel()
    assert got.save_native_model_string() == want.save_native_model_string()
    assert _stop(got) == _stop(want) < 40
    assert engine.last_validation["stop_iteration"] == _stop(got)
    assert engine.last_validation["best_iteration"] == _stop(got) - 1
    assert len(engine.last_validation["metrics"]) == \
        _stop(got) + ES["early_stopping_round"]


CASES = ([("binary", name) for name in LEARNERS]
         + [("regression", name) for name in ("serial", "data_ring_4",
                                               "voting_ring_4")]
         + [("multiclass", name) for name in ("serial", "feature_1x2")])


@pytest.mark.parametrize("objective,learner", CASES,
                         ids=["-".join(c) for c in CASES])
def test_early_stopping_forest_equals_reference(objective, learner):
    d, feature, kw = LEARNERS[learner]
    X, y = data(objective)
    ref, port = fit_pair(X, y, objective, d, feature,
                         val=_val_mask(len(y)), **kw, **ES)
    assert port.save_native_model_string() == ref.save_native_model_string()
    assert _stop(port) == _stop(ref) < ES["num_iterations"]
    assert engine.last_fit_info["data_shards"] == str(d)


@pytest.mark.parametrize("learner", ["serial", "data_psum_2"])
def test_early_stopping_with_categorical_columns(learner):
    d, feature, kw = LEARNERS[learner]
    X, y = data("binary", categorical=True)
    ref, port = fit_pair(X, y, "binary", d, feature, val=_val_mask(len(y)),
                         categorical=(4, 5), **kw, **ES)
    assert port.save_native_model_string() == ref.save_native_model_string()
    assert any(t.num_cat > 0 for t in port.trees)


def test_a_stump_iteration_ends_the_forest_with_validation_on():
    """With ``min_gain_to_split`` 80 some multiclass iterations stump;
    with validation on, the loop runs on past the first iteration in
    which no class grew, as the reference's does, and the forest is cut
    after it."""
    X, y = data("multiclass")
    kw = dict(num_iterations=12, num_leaves=7, min_data_in_leaf=10,
              min_gain_to_split=80.0, early_stopping_round=6)
    ref, port = fit_pair(X, y, "multiclass", val=_val_mask(len(y)), **kw)
    assert port.save_native_model_string() == ref.save_native_model_string()
    leaves = np.array([t.num_leaves for t in port.trees]).reshape(-1, 3)
    assert (leaves[-1] == 1).all() and _stop(port) == len(leaves) - 1
    assert len(engine.last_validation["metrics"]) > len(leaves)


def test_recorded_metrics_equal_the_reference_margins():
    """Each recorded validation metric is the metric of the reference's
    validation margins after that iteration (its model text, scored
    ``num_iteration`` trees at a time)."""
    X, y = data("binary")
    val = _val_mask(len(y))
    ref, port = fit_pair(X, y, "binary", val=val, **ES)
    metric = LightGBMClassifier()._val_metric()
    want = [metric(np.asarray(ref.predict_margin(X[val], num_iteration=i)),
                   y[val], None) for i in range(1, _stop(ref) + 1)]
    got = engine.last_validation["metrics"][:_stop(ref)]
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("leaves,categorical", [(15, False), (7, True),
                                                (1, False)])
def test_binned_walk_equals_reference(leaves, categorical):
    """``predict_tree_binned`` (the validation walk, as many steps as the
    tree is deep) gives the reference's leaf values on every row: grown
    trees with numeric and categorical nodes, and a stump."""
    import jax.numpy as jnp
    import torch
    from mmlspark_tpu.gbdt import grower as ref_grower
    from mmlspark_tpu_torch.gbdt import grower
    rng = np.random.default_rng(leaves)
    bins = rng.integers(0, 32, size=(3000, 5)).astype(np.uint8)
    fi = np.zeros((5, 3), np.float32)
    fi[:, 0] = 1.0
    if categorical:
        fi[[1, 3], 1] = 1.0
        fi[[1, 3], 2] = 31.0
    g = rng.normal(size=3000) + (bins[:, 1] % 3 == 0)
    gh = np.stack([g, np.full(3000, 0.25), np.ones(3000)], 1).astype(
        np.float32)
    cfg = grower.GrowerConfig(num_leaves=max(leaves, 2), num_bins=32,
                              min_data_in_leaf=10,
                              use_categorical=categorical,
                              min_gain_to_split=0.0 if leaves > 1 else 1e9)
    tree, _ = grower.grow_tree(torch.from_numpy(bins), torch.from_numpy(gh),
                               fi, cfg)
    assert int(tree.num_leaves) == leaves
    ref_tree = ref_grower.TreeArrays(**{
        k: jnp.asarray(v.numpy().astype(np.uint32) if k == "node_cat_bits"
                       else v.numpy()) for k, v in tree._asdict().items()})
    want = np.asarray(ref_grower.predict_tree_binned(
        ref_tree, jnp.asarray(bins), cfg.num_leaves))
    got = grower.predict_tree_binned(tree, torch.from_numpy(bins),
                                     cfg.num_leaves).numpy()
    np.testing.assert_array_equal(got, want)
    assert grower.tree_depth(tree) <= cfg.num_leaves - 1


def test_logloss_of_saturated_margins_is_the_reference_nan():
    """The reference's binary logloss clips float32 probabilities to [1e-15,
    1 − 1e-15], and 1 − 1e-15 rounds to 1 in float32: a margin above
    ~16.6 gives p = 1 and a non-finite metric, which early stopping reads
    as no improvement.  The port keeps the reference's metric (ROADMAP
    Queue C: open in both packages)."""
    ref = RefClassifier()
    ref._resolved_objective = "binary"
    port = LightGBMClassifier()
    port._resolved_objective = "binary"
    margins = np.array([0.5, 17.0, -3.0], np.float32)
    labels = np.array([1.0, 1.0, 0.0])
    with np.errstate(all="ignore"):
        want = ref._val_metric()(margins, labels, None)
        got = port._val_metric()(margins, labels, None)
        finite = port._val_metric()(margins[[0, 2]], labels[[0, 2]], None)
    assert np.isnan(want) and np.isnan(got)
    assert finite == ref._val_metric()(margins[[0, 2]], labels[[0, 2]], None)
