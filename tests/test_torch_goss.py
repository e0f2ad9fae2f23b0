"""GOSS (``boostingType="goss"``) in the port against the JAX reference,
on the CPU.

The reference is pinned to ``histogram_method="segment"``; inputs come
from numpy seeds at small sizes (1,200 rows, 6 features).

* The sample: :func:`..distributed.stable_order` equals ``jnp.argsort``
  (and of the negated vector) on ties, zeros and NaN, and
  :func:`..distributed.goss_sample` picks the reference's rows (the
  reference's own ``argsort`` / ``uniform`` / ``take`` sequence) on the
  two-valued influence of iteration 0, on shard-padding zeros and on
  multiclass influence.
* Fits, model text byte for byte: binary under every learner (serial;
  data psum / ring at D = 2, 4; voting ring at D = 4; feature 1 × 2;
  data+feature 2 × 2), L2 serially and on voting, multiclass serially and
  on the data psum at D = 2, categorical columns, GOSS with validation
  and early stopping, and the estimators.
* A sample that covers every row falls back to gbdt as the reference's
  does; GOSS with bagging and rates outside (0, 1) refuse.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.gbdt import LightGBMClassifier as RefClassifier
from mmlspark_tpu_torch import LightGBMClassifier
from mmlspark_tpu_torch.gbdt.distributed import goss_sample, stable_order
from mmlspark_tpu_torch.ops.threefry import prng_key, split
from torch_parity import (LEARNERS, data, fit_pair,
                          one_torch_thread)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOSS = dict(boosting="goss", num_iterations=5, num_leaves=7,
            min_data_in_leaf=10)


def _ties(n=2000, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.choice([0.0, 0.25, 0.5, 1.0], size=n).astype(np.float32)
    x[rng.random(n) < 0.05] = np.nan
    return x


@pytest.mark.parametrize("descending", [False, True])
def test_stable_order_equals_jnp_argsort(descending):
    for x in (_ties(), np.random.default_rng(1).random(5000).astype(
            np.float32), np.zeros(64, np.float32)):
        want = np.asarray(jnp.argsort(-x if descending else x))
        got = stable_order(torch.from_numpy(x), descending).numpy()
        np.testing.assert_array_equal(got, want)


def _ref_sample(g, h, key, k1, k2, amp):
    """The reference's GOSS sample (engine.py ``_boost_scan_goss``)."""
    infl = (jnp.abs(g * h) if g.ndim == 1
            else jnp.sum(jnp.abs(g * h), axis=1))
    rank = jnp.argsort(-infl)
    rk = jax.random.uniform(key, (g.shape[0] - k1,))
    idx = jnp.concatenate([rank[:k1], jnp.take(rank[k1:],
                                               jnp.argsort(rk)[:k2])])
    w = jnp.concatenate([jnp.ones(k1, jnp.float32),
                         jnp.full(k2, amp, jnp.float32)])
    return np.asarray(idx), np.asarray(w)


@pytest.mark.parametrize("case", ["init_ties", "pad_zeros", "multiclass"])
def test_goss_sample_equals_reference(case):
    rng = np.random.default_rng(2)
    n, k1, k2, amp = 3000, 600, 300, 8.0
    if case == "init_ties":
        # iteration 0 from the label average: g and h take two values
        y = rng.random(n) < 0.3
        g = np.where(y, -0.7, 0.3).astype(np.float32)
        h = np.where(y, 0.21, 0.21).astype(np.float32)
    elif case == "pad_zeros":
        g = rng.normal(size=n).astype(np.float32)
        h = rng.uniform(0.1, 0.25, n).astype(np.float32)
        g[-700:] *= 0.0
        h[-700:] *= 0.0
    else:
        g = rng.normal(size=(n, 3)).astype(np.float32)
        h = rng.uniform(0.1, 0.25, (n, 3)).astype(np.float32)
    key = jax.random.split(jax.random.PRNGKey(3), 5)[2]
    want = _ref_sample(jnp.asarray(g), jnp.asarray(h), key, k1, k2, amp)
    got = goss_sample(torch.from_numpy(g), torch.from_numpy(h),
                      split(prng_key(3), 5)[2], k1, k2, amp)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b)


CASES = ([("binary", name) for name in LEARNERS]
         + [("regression", name) for name in ("serial", "voting_ring_4")]
         + [("multiclass", name) for name in ("serial", "data_psum_2")])


@pytest.mark.parametrize("objective,learner", CASES,
                         ids=["-".join(c) for c in CASES])
def test_goss_forest_equals_reference(objective, learner):
    d, feature, kw = LEARNERS[learner]
    X, y = data(objective)
    ref, port = fit_pair(X, y, objective, d, feature, **kw, **GOSS)
    assert port.save_native_model_string() == ref.save_native_model_string()
    assert port.params["boosting"] == "goss"


@pytest.mark.parametrize("learner", ["serial", "data_ring_4"])
def test_goss_with_categorical_columns(learner):
    d, feature, kw = LEARNERS[learner]
    X, y = data("binary", categorical=True)
    ref, port = fit_pair(X, y, "binary", d, feature, categorical=(4, 5),
                         **kw, **GOSS)
    assert port.save_native_model_string() == ref.save_native_model_string()


def test_goss_with_early_stopping_equals_reference():
    X, y = data("binary")
    val = np.random.default_rng(5).random(len(y)) < 0.25
    ref, port = fit_pair(X, y, "binary", val=val,
                         **{**GOSS, "num_iterations": 40,
                            "learning_rate": 0.4,
                            "early_stopping_round": 3})
    assert port.save_native_model_string() == ref.save_native_model_string()
    assert int(port.params["num_iterations"]) < 40


def test_goss_estimator_equals_reference():
    X, y = data("binary")
    kw = dict(numIterations=5, numLeaves=7, minDataInLeaf=10, verbosity=0,
              boostingType="goss", topRate=0.3, otherRate=0.2)
    table = {"features": X, "label": y}
    want = RefClassifier(histogramMethod="segment", **kw).fit(table)
    got = LightGBMClassifier(device="cpu", **kw).fit(table)
    assert got.getNativeModel() == want.getNativeModel()


def test_a_sample_of_every_row_falls_back_to_gbdt():
    X, y = data("binary")
    ref, port = fit_pair(X, y, "binary", top_rate=0.5, other_rate=0.4999,
                         **GOSS)
    assert port.save_native_model_string() == ref.save_native_model_string()
    gbdt = fit_pair(X, y, "binary", **{**GOSS, "boosting": "gbdt"})[1]
    assert [t.leaf_value.tolist() for t in port.trees] == \
        [t.leaf_value.tolist() for t in gbdt.trees]


@pytest.mark.parametrize("kw", [
    dict(baggingFraction=0.5, baggingFreq=1), dict(topRate=0.0),
    dict(otherRate=1.0), dict(topRate=0.6, otherRate=0.4)],
    ids=["bagging", "top0", "other1", "sum1"])
def test_goss_refuses_bagging_and_bad_rates(kw):
    X, y = data("binary", n=200)
    with pytest.raises(ValueError):
        LightGBMClassifier(device="cpu", boostingType="goss", numIterations=2,
                           **kw).fit({"features": X, "label": y})
