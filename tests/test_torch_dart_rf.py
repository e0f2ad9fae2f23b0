"""DART and random-forest boosting in the port against the JAX reference,
on the CPU.

The reference is pinned to ``histogram_method="segment"``; inputs come
from numpy seeds at small sizes (1,000 rows, 6 features, 5 iterations).

* DART (``boosting="dart"``): the drop draw consumes the reference's
  numpy stream in its order; fits write the reference's model text byte
  for byte with LightGBM's default drops and with heavy drops
  (``skip_drop=0``, ``drop_rate=0.5``: drops in most iterations),
  serially, multiclass, on the data psum at D = 2 and on a 1 × 2 feature
  mesh.  A ring request keeps psum with the downgrade ``"dart"``,
  quantized training turns off (``quantized_unsupported``), and early
  stopping is refused.
* rf (``boosting="rf"``): model text byte for byte serially (binary,
  multiclass, L2), on the data ring at D = 4 and voting at D = 4, and
  with a validation set and early stopping (the metric reads the running
  average of the unshrunk trees); under ``pallas_ring`` the same
  structure with leaf values within rtol 1e-5 (the reference's fused
  kernel sums each cell through a ``dot_general``, the port's twin in row
  order).  rf without bagging is refused.
"""

import numpy as np
import pytest

from mmlspark_tpu.gbdt import engine as ref_engine
from mmlspark_tpu_torch.gbdt import engine
from torch_parity import (LEARNERS, data, fit_pair,
                          one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(num_iterations=5, num_leaves=7, min_data_in_leaf=10)
DEFAULT_DROPS = dict(boosting="dart")
HEAVY_DROPS = dict(boosting="dart", skip_drop=0.0, drop_rate=0.5)
RF = dict(boosting="rf", bagging_fraction=0.7, bagging_freq=1)


def _text(b):
    return b.save_native_model_string()


@pytest.mark.parametrize("kw", [dict(drop_rate=0.1, max_drop=50,
                                     skip_drop=0.5),
                                dict(drop_rate=0.5, max_drop=3,
                                     skip_drop=0.0),
                                dict(drop_rate=0.9, max_drop=0,
                                     skip_drop=0.2)])
def test_drop_draws_equal_reference(kw):
    """The same drops from the same ``drop_seed`` over 60 iterations,
    ``max_drop`` cuts included (``max_drop <= 0``: no limit)."""
    ours = np.random.default_rng(4)
    theirs = np.random.default_rng(4)
    p = engine.TrainParams(**kw)
    rp = ref_engine.TrainParams(**kw)
    drops = 0
    for n_units in range(60):
        a = engine._dart_draw_drops(ours, n_units, p)
        b = ref_engine._dart_draw_drops(theirs, n_units, rp)
        np.testing.assert_array_equal(a, b)
        drops += len(a)
    assert drops > 0


@pytest.mark.parametrize("objective,learner,drops", [
    ("binary", "serial", "default"), ("binary", "serial", "heavy"),
    ("regression", "serial", "heavy"), ("multiclass", "serial", "heavy"),
    ("binary", "data_psum_2", "heavy"), ("binary", "feature_1x2", "heavy"),
    ("multiclass", "data_psum_2", "default")])
def test_dart_model_text_equals_reference(objective, learner, drops):
    X, y = data(objective, n=1000)
    d, feature, kw = LEARNERS[learner]
    dart = DEFAULT_DROPS if drops == "default" else HEAVY_DROPS
    ref, port = fit_pair(X, y, objective, d=d, feature=feature, **kw,
                         **SMALL, **dart)
    assert _text(port) == _text(ref)
    # DART rescales earlier trees: their shrinkage records the final scale
    scales = [t.shrinkage for t in port.trees]
    if drops == "heavy":
        assert len(set(scales)) > 1
    assert port.params["boosting"] == "dart"


def test_dart_ring_keeps_psum_with_reason_dart():
    X, y = data("binary", n=1000)
    ref, port = fit_pair(X, y, "binary", d=2, collective="ring", **SMALL,
                         **HEAVY_DROPS)
    assert _text(port) == _text(ref)
    info = engine.last_fit_info
    assert (info["collective"], info["collective_downgrade"]) == \
        ("psum", "dart")


def test_dart_turns_quantized_training_off():
    X, y = data("binary", n=1000)
    ref, port = fit_pair(X, y, "binary", quantized_grad="16", **SMALL,
                         **DEFAULT_DROPS)
    assert _text(port) == _text(ref)
    assert engine.last_fit_info["quantized_downgrade"] == \
        "quantized_unsupported"
    assert engine.last_fit_info["quantized_bits"] == "0"


def test_dart_refuses_early_stopping():
    X, y = data("binary", n=300)
    with pytest.raises(NotImplementedError, match="early stopping"):
        fit_pair(X, y, "binary", early_stopping_round=3,
                 val=np.arange(300) % 4 == 0, **SMALL, **DEFAULT_DROPS)


@pytest.mark.parametrize("objective,learner", [
    ("binary", "serial"), ("multiclass", "serial"),
    ("regression", "serial"), ("binary", "data_ring_4"),
    ("binary", "voting_ring_4"), ("regression", "data_psum_2")])
def test_rf_model_text_equals_reference(objective, learner):
    X, y = data(objective, n=1000)
    d, feature, kw = LEARNERS[learner]
    ref, port = fit_pair(X, y, objective, d=d, feature=feature,
                         feature_fraction=0.8, **kw, **SMALL, **RF)
    assert _text(port) == _text(ref)
    # the trees are averaged: each carries 1 / iterations
    assert {t.shrinkage for t in port.trees} == \
        {1.0 / (len(port.trees) // port.num_class)}


def test_rf_validation_stops_where_the_reference_does():
    X, y = data("binary", n=1000)
    val = np.random.default_rng(5).random(1000) < 0.25
    ref, port = fit_pair(X, y, "binary", val=val, early_stopping_round=2,
                         **{**SMALL, "num_iterations": 12}, **RF)
    assert _text(port) == _text(ref)
    metrics = engine.last_validation["metrics"]
    assert len(metrics) >= 3 and all(np.isfinite(metrics))
    assert engine.last_validation["stop_iteration"] == \
        int(ref.params["num_iterations"])


def test_rf_margins_equal_reference():
    rng = np.random.default_rng(0)
    row = rng.normal(size=100).astype(np.float32)
    for it in (0, 1, 6):
        np.testing.assert_array_equal(
            engine._rf_margins(0.37, row, it),
            ref_engine._rf_margins(0.37, row, it))


@pytest.mark.parametrize("d", [2, 4])
def test_rf_pallas_ring_matches_reference(d):
    X, y = data("binary", n=1000)
    ref, port = fit_pair(X, y, "binary", d=d, collective="ring",
                         method="pallas_ring", **SMALL, **RF)
    assert len(port.trees) == len(ref.trees)
    for a, b in zip(ref.trees, port.trees):
        for k in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-6)
    assert engine.last_fit_info["histogram_method"] == "pallas_ring"


@pytest.mark.parametrize("bag", [dict(), dict(bagging_fraction=0.7),
                                 dict(bagging_freq=1)])
def test_rf_refuses_without_bagging(bag):
    X, y = data("binary", n=300)
    with pytest.raises(ValueError, match="requires bagging"):
        fit_pair(X, y, "binary", boosting="rf", **SMALL, **bag)
