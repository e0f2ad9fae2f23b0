"""The port's objectives against the JAX reference's: ``init_score`` and
``grad_hess`` exact (the port evaluates the sigmoid in the order of the
reference's XLA CPU exp).

Every regression objective, cross_entropy and the transforms are held to
the reference's compiled program (``jax.jit``), where XLA fuses Gamma's
and Tweedie's products into their adds and folds Poisson's
``exp(max_delta_step)``: bit for bit.  ``train_loss`` is numpy on both
sides and equal.  Fits of each objective write the reference's model
text byte for byte (1,000 rows, 6 features, 4 iterations), and the
regressor's ``transform`` is the objective's output transform.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.gbdt import LightGBMRegressor as RefRegressor
from mmlspark_tpu.gbdt.objectives import get_objective as ref_get
from mmlspark_tpu_torch import LightGBMRegressor
from mmlspark_tpu_torch.gbdt.objectives import get_objective
from torch_parity import data, fit_pair, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES = [("binary", {}),
         ("binary", {"sigmoid": 0.7}),
         ("binary", {"is_unbalance": True}),
         ("binary", {"scale_pos_weight": 3.0}),
         ("regression", {})]


def _data(name, seed=0, n=4000):
    rng = np.random.default_rng(seed)
    scores = (rng.normal(size=n) * 3).astype(np.float32)
    if name == "binary":
        labels = (rng.random(n) < 0.3).astype(np.float64)
    else:
        labels = rng.normal(size=n) * 10 + 2
    weights = rng.uniform(0.5, 2.0, size=n)
    return scores, labels, weights


@pytest.mark.parametrize("name,kw", CASES)
def test_init_score_is_exact(name, kw):
    _, labels, weights = _data(name)
    ref, port = ref_get(name, **kw), get_objective(name, **kw)
    ref.prepare(labels, weights)
    port.prepare(labels, weights)
    assert port.init_score(labels, weights) == \
        ref.init_score(labels, weights)
    assert port.model_str == ref.model_str


@pytest.mark.parametrize("name,kw", CASES)
def test_grad_hess_allclose(name, kw):
    scores, labels, weights = _data(name, seed=1)
    ref, port = ref_get(name, **kw), get_objective(name, **kw)
    ref.prepare(labels, weights)
    port.prepare(labels, weights)
    rg, rh = ref.grad_hess(jnp.asarray(scores),
                           jnp.asarray(labels, jnp.float32),
                           jnp.asarray(weights, jnp.float32))
    pg, ph = port.grad_hess(torch.from_numpy(scores),
                            torch.as_tensor(labels, dtype=torch.float32),
                            torch.as_tensor(weights, dtype=torch.float32))
    assert pg.dtype == torch.float32 and ph.dtype == torch.float32
    np.testing.assert_array_equal(pg.numpy(), np.asarray(rg))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(rh))


def test_sigmoid_matches_xla_bit_for_bit():
    import jax
    from mmlspark_tpu_torch.gbdt.objectives import sigmoid
    rng = np.random.default_rng(2)
    x = np.concatenate([
        (rng.normal(size=50_000) * 8).astype(np.float32),
        np.linspace(-100, 100, 20_001, dtype=np.float32),
        np.array([np.nan, np.inf, -np.inf, 0.0, -0.0], np.float32)])
    np.testing.assert_array_equal(sigmoid(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jax.nn.sigmoid)(x)))


@pytest.mark.parametrize("name", ["huber", "quantile", "lambdarank"])
def test_unported_objectives_raise(name):
    """Every reference objective is ported now; an unknown name still
    raises, and lambdarank's stub refuses ``grad_hess`` as the
    reference's does, so a ranker's gradients come from its queries."""
    obj = get_objective(name)
    assert obj.model_str == ref_get(name).model_str
    with pytest.raises(ValueError, match="Unknown objective"):
        get_objective(name + "_x")
    if name == "lambdarank":
        x = torch.zeros(4)
        with pytest.raises(ValueError, match="LightGBMRanker"):
            obj.grad_hess(x, x, x)
        assert obj.init_score(np.zeros(4), np.ones(4)) == 0.0


#: (name, kwargs, label family) of the objectives this file holds to the
#: reference's compiled program
REGRESSION = [
    ("regression_l1", {}, "real"), ("mae", {}, "real"),
    ("huber", {"alpha": 0.9}, "real"), ("huber", {"alpha": 2.5}, "real"),
    ("fair", {"fair_c": 1.0}, "real"), ("fair", {"fair_c": 0.3}, "real"),
    ("poisson", {"poisson_max_delta_step": 0.7}, "count"),
    ("poisson", {"poisson_max_delta_step": 0.1}, "count"),
    ("poisson", {"poisson_max_delta_step": 2.3}, "count"),
    ("quantile", {"alpha": 0.9}, "real"), ("quantile", {"alpha": 0.25},
                                           "real"),
    ("mape", {}, "real"), ("gamma", {}, "positive"),
    ("tweedie", {"tweedie_variance_power": 1.5}, "count"),
    ("tweedie", {"tweedie_variance_power": 1.2}, "count"),
    ("cross_entropy", {}, "prob"), ("xentropy", {}, "prob"),
]


def _labels(family, n, rng):
    z = rng.normal(size=n)
    if family == "count":
        return rng.poisson(np.exp(0.5 * z)).astype(np.float64)
    if family == "positive":
        return rng.gamma(2.0, np.exp(0.3 * z) / 2.0)
    if family == "prob":
        return 1.0 / (1.0 + np.exp(-2 * z))
    y = 3 * z + rng.standard_t(2, size=n)
    y[:50] = 0.0            # exact zeros: sign(0), |y| < 1 in mape
    return y


def _ids(case):
    name, kw, _ = case
    return name + "".join(f"-{v}" for v in kw.values())


@pytest.mark.parametrize("case", REGRESSION, ids=_ids)
def test_regression_objectives_equal_compiled_reference(case):
    name, kw, family = case
    rng = np.random.default_rng(7)
    n = 6000
    scores = (rng.normal(size=n) * 2).astype(np.float32)
    scores[:20] = 0.0
    labels = _labels(family, n, rng).astype(np.float32)
    scores[20:40] = labels[20:40]   # d = 0 exactly
    weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    ref, port = ref_get(name, **kw), get_objective(name, **kw)
    w64 = weights.astype(np.float64)
    ref.prepare(labels, w64)
    port.prepare(labels, w64)
    assert port.init_score(labels, w64) == ref.init_score(labels, w64)
    assert port.model_str == ref.model_str
    rg, rh = jax.jit(ref.grad_hess)(scores, labels, weights)
    pg, ph = port.grad_hess(*map(torch.from_numpy,
                                 (scores, labels, weights)))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(rg))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(rh))
    want = np.asarray(jax.jit(ref.transform_prediction)(scores))
    got = port.transform_prediction(torch.from_numpy(scores)).numpy()
    np.testing.assert_array_equal(got, want)


def test_poisson_constant_is_the_folded_one():
    """XLA folds ``exp(max_delta_step)`` to the float32 nearest the exact
    value; the port's hessian factor has the same bits."""
    for mds in (0.7, 0.1, 0.35, 1.0, 2.3, 5.0, 0.013):
        want = np.asarray(jax.jit(lambda: jnp.exp(mds))())
        got = np.float32(np.exp(mds))
        assert want.view(np.int32) == got.view(np.int32), mds
        h = get_objective("poisson", poisson_max_delta_step=mds).grad_hess(
            torch.zeros(1), torch.zeros(1), torch.ones(1))[1]
        assert h.numpy().view(np.int32)[0] == want.view(np.int32)


@pytest.mark.parametrize("name,kw", [("binary", {}), ("binary",
                                                     {"sigmoid": 0.7}),
                                     ("regression", {}),
                                     ("multiclass", {}),
                                     ("multiclassova", {})])
def test_train_loss_and_transform_equal_reference(name, kw):
    rng = np.random.default_rng(3)
    n = 2000
    K = 3 if name.startswith("multiclass") else 1
    scores = (rng.normal(size=(n, K) if K > 1 else n) * 2
              ).astype(np.float32)
    labels = (rng.integers(0, K, size=n) if K > 1 else
              (rng.random(n) < 0.4)).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=n)
    ref, port = (get(name, num_class=K, **kw) for get in (ref_get,
                                                          get_objective))
    for weights in (None, w):
        assert port.train_loss(scores, labels, weights) == \
            ref.train_loss(scores, labels, weights)
    want = np.asarray(jax.jit(ref.transform_prediction)(scores))
    got = port.transform_prediction(torch.from_numpy(scores)).numpy()
    if name == "multiclassova":
        # the reference adds the row with XLA's reduction; the port in
        # index order (equal for a row of 3 up to one ulp of the sum)
        np.testing.assert_allclose(got, want, rtol=2e-7, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


FIT = [("regression_l1", "real"), ("huber", "real"), ("fair", "real"),
       ("poisson", "count"), ("quantile", "real"), ("mape", "real"),
       ("gamma", "positive"), ("tweedie", "count"),
       ("cross_entropy", "prob")]


#: objectives whose gradients hold a product XLA may or may not fuse into
#: the following add, depending on the fused program around it: the port
#: rounds as the reference's compiled ``grad_hess`` does (held bit for bit
#: above), and the boosting scan may round a few rows one ulp apart
FMA_CONTEXT = ("gamma", "tweedie")


@pytest.mark.parametrize("name,family", FIT)
def test_objective_fit_model_text_equals_reference(name, family):
    """Model text byte for byte; for ``FMA_CONTEXT`` the same trees
    (features, thresholds, children, counts) with leaf and internal
    values within rtol 1e-5 (a few ulp of the gradient sums)."""
    X, _ = data("regression", n=1000)
    y = _labels(family, 1000, np.random.default_rng(11))
    ref, port = fit_pair(X, y, name, num_iterations=4, num_leaves=7,
                         min_data_in_leaf=10)
    if name not in FMA_CONTEXT:
        assert port.save_native_model_string() == \
            ref.save_native_model_string()
        np.testing.assert_array_equal(port.predict(X, device="cpu").numpy(),
                                      np.asarray(ref.predict(X)))
        return
    assert len(port.trees) == len(ref.trees)
    for a, b in zip(ref.trees, port.trees):
        for k in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        for k in ("leaf_value", "internal_value"):
            np.testing.assert_allclose(getattr(b, k), getattr(a, k),
                                       rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.predict(X, device="cpu").numpy(),
                               np.asarray(ref.predict(X)), rtol=1e-5)


def test_regressor_transform_applies_the_objective():
    """The estimators' ``alpha`` / ``fairC`` / ``poissonMaxDeltaStep`` /
    ``tweedieVariancePower`` reach the objective, and ``transform`` is
    ``objective.transform_prediction`` of the margins."""
    rng = np.random.default_rng(5)
    X = rng.normal(size=(600, 4))
    y = rng.poisson(np.exp(0.4 * X[:, 0])).astype(np.float64)
    table = {"features": X, "label": y}
    kw = dict(numIterations=3, numLeaves=5, minDataInLeaf=10, verbosity=0,
              objective="poisson", poissonMaxDeltaStep=0.4)
    port = LightGBMRegressor(device="cpu", **kw).fit(table)
    ref = RefRegressor(histogramMethod="segment", **kw).fit(table)
    assert port.getNativeModel() == ref.getNativeModel()
    margin = port.getModel().predict_margin(X, device="cpu")
    want = get_objective("poisson", poisson_max_delta_step=0.4) \
        .transform_prediction(margin).numpy().astype(np.float64)
    np.testing.assert_array_equal(port.transform(table)["prediction"], want)
    np.testing.assert_array_equal(port.transform(table)["prediction"],
                                  ref.transform(table)["prediction"])
    est = LightGBMRegressor(alpha=0.3, fairC=2.0, poissonMaxDeltaStep=0.2,
                            tweedieVariancePower=1.7)
    assert est._objective_kwargs() == dict(
        alpha=0.3, fair_c=2.0, poisson_max_delta_step=0.2,
        tweedie_variance_power=1.7)
