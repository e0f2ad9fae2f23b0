"""Multiclass (softmax) and multiclassova in the port against the JAX
reference, on the CPU.

The reference is pinned to ``histogram_method="segment"``; inputs come
from numpy seeds at small sizes, K = 3 classes.

* The softmax equals ``jax.nn.softmax`` bit for bit (XLA's CPU exp and
  order) over 10⁵ drawn rows for K = 3 and K = 5, as
  ``test_sigmoid_matches_xla_bit_for_bit`` pins the sigmoid.
* Both objectives' ``grad_hess`` equal the reference's exactly.
* Fits write the reference's model text byte for byte: serially, with
  the data learner (psum and ring, D = 2 and 4), voting at D = 4, feature
  1 × 2, and with a ``min_gain_to_split`` that stumps some classes' trees
  and then stops the fit (the first iteration in which no class grew).
* ``Booster.predict`` and the classifier's rawPrediction, probability and
  prediction equal the reference's; 3-class labels promote a binary
  classifier to multiclass, as in the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.mesh import build_mesh as ref_build_mesh
from mmlspark_tpu.gbdt import LightGBMClassifier as RefClassifier
from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit
from mmlspark_tpu.gbdt.engine import TrainParams as RefParams
from mmlspark_tpu.gbdt.engine import train as ref_train
from mmlspark_tpu.gbdt.objectives import get_objective as ref_objective
from mmlspark_tpu_torch import LightGBMClassifier
from mmlspark_tpu_torch.core.mesh import build_mesh
from mmlspark_tpu_torch.gbdt import engine, fit_bin_mapper, get_objective
from mmlspark_tpu_torch.gbdt.engine import TrainParams, train
from mmlspark_tpu_torch.gbdt.objectives import softmax
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K = 3
OBJECTIVES = ["multiclass", "multiclassova"]


@pytest.mark.parametrize("k", [3, 5])
def test_softmax_matches_xla_bit_for_bit(k):
    rng = np.random.default_rng(k)
    x = np.concatenate([
        (rng.normal(size=(100_000, k)) * 8).astype(np.float32),
        (rng.normal(size=(2_000, k)) * 60).astype(np.float32),
        np.array([[0.0, -0.0] + [1e-30] * (k - 2),
                  [88.0] * k, [-100.0] + [100.0] * (k - 1)], np.float32)])
    np.testing.assert_array_equal(softmax(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jax.nn.softmax)(x)))


@pytest.mark.parametrize("name,kw", [("multiclass", {}),
                                     ("softmax", {}),
                                     ("multiclassova", {}),
                                     ("ova", {"sigmoid": 0.7})])
@pytest.mark.parametrize("k", [3, 5])
def test_multiclass_grad_hess_equal_reference(name, kw, k):
    rng = np.random.default_rng(k)
    n = 4000
    scores = (rng.normal(size=(n, k)) * 3).astype(np.float32)
    labels = rng.integers(0, k, size=n).astype(np.float64)
    weights = rng.uniform(0.5, 2.0, size=n)
    ref, port = (f(name, num_class=k, **kw)
                 for f in (ref_objective, get_objective))
    assert port.model_str == ref.model_str
    assert port.num_model_per_iteration == ref.num_model_per_iteration == k
    assert port.init_score(labels, weights) == \
        ref.init_score(labels, weights)
    want = ref.grad_hess(jnp.asarray(scores),
                         jnp.asarray(labels, jnp.float32),
                         jnp.asarray(weights, jnp.float32))
    got = port.grad_hess(torch.from_numpy(scores),
                         torch.as_tensor(labels, dtype=torch.float32),
                         torch.as_tensor(weights, dtype=torch.float32))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _data(n=900, seed=4):
    """Three classes: the argmax of three noisy scores of six normal
    features."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    s = np.stack([X[:, 0], X[:, 1] - X[:, 2], 0.5 * X[:, 3] + 0.3], 1) \
        + rng.normal(size=(n, K)) * 0.6
    return X, s.argmax(1).astype(np.float64)


SMALL = dict(num_iterations=4, num_leaves=7, min_data_in_leaf=10,
             max_bin=63, verbosity=0)


def _fit_ref(X, y, objective, d=1, feature=1, **kw):
    mapper = ref_fit(X, max_bin=SMALL["max_bin"])
    mesh = None if d * feature == 1 else ref_build_mesh(
        data=d, feature=feature, devices=jax.devices()[:d * feature])
    return ref_train(mapper.transform_packed(X), y, None, mapper,
                     ref_objective(objective, num_class=K),
                     RefParams(histogram_method="segment",
                               **{**SMALL, **kw}), mesh=mesh)


def _fit_port(X, y, objective, d=1, feature=1, **kw):
    mapper = fit_bin_mapper(X, max_bin=SMALL["max_bin"])
    mesh = None if d * feature == 1 else build_mesh(
        d, feature, devices=["cpu"] * (d * feature))
    return train(mapper.transform(X, "cpu"), y, None, mapper,
                 get_objective(objective, num_class=K),
                 TrainParams(histogram_method="segment", **{**SMALL, **kw}),
                 device="cpu", mesh=mesh)


FIT_CASES = [
    (1, 1, {}), (1, 1, dict(bagging_fraction=0.7, bagging_freq=2,
                            feature_fraction=0.6)),
    (2, 1, dict(collective="psum")), (2, 1, dict(collective="ring")),
    (4, 1, dict(collective="psum")), (4, 1, dict(collective="ring")),
    (4, 1, dict(collective="ring", parallelism="voting", top_k=2)),
    (1, 2, dict(parallelism="feature")),
]


@pytest.mark.parametrize("d,feature,kw", FIT_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_multiclass_forest_text_equals_reference(objective, d, feature, kw):
    X, y = _data()
    want = _fit_ref(X, y, objective, d, feature, **kw)
    got = _fit_port(X, y, objective, d, feature, **kw)
    assert len(got.trees) == SMALL["num_iterations"] * K
    assert got.save_native_model_string() == want.save_native_model_string()
    assert engine.last_fit_info["data_shards"] == str(d)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_multiclass_stops_at_the_first_iteration_no_class_grew(objective):
    """With ``min_gain_to_split`` 80 some classes' trees are stumps for
    several iterations before every class stumps at once; the fit keeps
    that iteration's K stumps and records it as the stop."""
    X, y = _data()
    kw = dict(num_iterations=12, min_gain_to_split=80.0)
    want = _fit_ref(X, y, objective, **kw)
    got = _fit_port(X, y, objective, **kw)
    assert got.save_native_model_string() == want.save_native_model_string()
    leaves = np.array([t.num_leaves for t in got.trees]).reshape(-1, K)
    assert len(leaves) < 12 and (leaves[-1] == 1).all()
    assert ((leaves[:-1] == 1).any(axis=1) & (leaves[:-1] > 1).any(axis=1)
            ).any()
    assert got.params["num_iterations"] == str(len(leaves) - 1)


@pytest.mark.parametrize("objective", OBJECTIVES)
def test_multiclass_predictions_equal_the_reference(objective):
    X, y = _data()
    kw = dict(numIterations=5, numLeaves=7, minDataInLeaf=10, verbosity=0,
              objective=objective)
    t = {"features": X, "label": y}
    want = RefClassifier(histogramMethod="segment", **kw).fit(t)
    got = LightGBMClassifier(device="cpu", **kw).fit(t)
    assert got.getNativeModel() == want.getNativeModel()
    Q = np.random.default_rng(5).normal(size=(300, 6)) * 2
    np.testing.assert_array_equal(
        got.getModel().predict(Q, device="cpu").numpy(),
        np.asarray(want.getModel().predict(Q)))
    a, b = got.transform({"features": Q}), want.transform({"features": Q})
    for col in ("rawPrediction", "probability", "prediction"):
        np.testing.assert_array_equal(np.asarray(a[col]), np.asarray(b[col]))
    assert a["probability"].shape == (300, K)
    assert got.numClasses == K


def test_three_label_classes_promote_to_multiclass():
    X, y = _data()
    kw = dict(numIterations=3, numLeaves=7, minDataInLeaf=10, verbosity=0)
    t = {"features": X, "label": y}
    got = LightGBMClassifier(device="cpu", **kw).fit(t)
    assert got.getModel().num_class == K
    assert got.getNativeModel() == RefClassifier(
        histogramMethod="segment", **kw).fit(t).getNativeModel()
    with pytest.raises(ValueError, match="NaN"):
        LightGBMClassifier(device="cpu", objective="multiclass", **kw).fit(
            {"features": X, "label": np.where(y == 2, np.nan, y)})
