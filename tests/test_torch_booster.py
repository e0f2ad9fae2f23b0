"""The port's Booster against the JAX reference's, on the CPU.

A forest fitted by the reference is carried across as numpy arrays
(``mmlspark_tpu_torch.convert``); its margins, its LightGBM model text and
the vendored golden model must agree exactly with the reference's.
"""

import dataclasses
import os

import numpy as np
import pytest

from mmlspark_tpu.gbdt import Booster as RefBooster
from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit
from mmlspark_tpu.gbdt.engine import TrainParams as RefParams
from mmlspark_tpu.gbdt.engine import train as ref_train
from mmlspark_tpu.gbdt.objectives import get_objective as ref_objective
from mmlspark_tpu_torch.convert import (bin_mapper_from_arrays,
                                        booster_from_arrays)
from mmlspark_tpu_torch.gbdt.booster import Booster, ModelDigestError

GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "lightgbm_v3_golden.txt")


def _data(seed=0, n=1500, f=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random(X.shape) < 0.05] = np.nan
    y = np.nan_to_num(X[:, 0]) * 2 + np.sin(np.nan_to_num(X[:, 1]) * 3) \
        + rng.normal(size=n) * 0.3
    return X, y


@pytest.fixture(scope="module", params=["binary", "regression"])
def fitted(request):
    X, y = _data()
    if request.param == "binary":
        y = (y > 0).astype(np.float64)
    mapper = ref_fit(X, max_bin=63)
    booster = ref_train(mapper.transform_packed(X), y, None, mapper,
                        ref_objective(request.param),
                        RefParams(num_iterations=12, num_leaves=15,
                                  max_bin=63, histogram_method="segment",
                                  verbosity=0))
    port = booster_from_arrays(
        [dataclasses.asdict(t) for t in booster.trees],
        objective=booster.objective_str, init_score=booster.init_score,
        num_class=booster.num_class,
        mapper=bin_mapper_from_arrays(mapper.upper_bounds,
                                      mapper.has_missing,
                                      mapper.num_total_bins,
                                      mapper.missing_bin),
        feature_names=booster.feature_names, params=booster.params,
        device="cpu")
    return X, booster, port


def _queries(X):
    """Training rows, rows exactly at every threshold, and edge values."""
    rng = np.random.default_rng(3)
    edge = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e30, -1e30])
    extra = rng.choice(edge, size=(64, X.shape[1]))
    return np.concatenate([X, extra]).astype(np.float32)


def test_converted_margins_are_bit_identical(fitted):
    X, booster, port = fitted
    Q = _queries(X)
    want = np.asarray(booster.predict_margin(Q))
    got = port.predict_margin(Q).numpy()
    np.testing.assert_array_equal(got, want)
    for k in (1, 5):
        np.testing.assert_array_equal(
            port.predict_margin(Q, num_iteration=k).numpy(),
            np.asarray(booster.predict_margin(Q, num_iteration=k)))


def test_threshold_rows_score_identically(fitted):
    X, booster, port = fitted
    t = booster.trees[0]
    Q = np.tile(np.nanmean(X, axis=0), (len(t.threshold), 1))
    Q[np.arange(len(t.threshold)), t.split_feature] = t.threshold
    Q = Q.astype(np.float32)
    np.testing.assert_array_equal(port.predict_margin(Q).numpy(),
                                  np.asarray(booster.predict_margin(Q)))


def test_model_text_is_identical(fitted):
    _, booster, port = fitted
    assert port.save_native_model_string() == \
        booster.save_native_model_string()


def test_model_files_cross_load(fitted, tmp_path):
    X, booster, port = fitted
    p1, p2 = str(tmp_path / "port.txt"), str(tmp_path / "ref.txt")
    port.save_native_model(p1)
    booster.save_native_model(p2)
    assert open(p1).read() == open(p2).read()
    back = RefBooster.load_native_model(p1)
    mine = Booster.load_native_model(p2, device="cpu")
    Q = _queries(X)
    np.testing.assert_array_equal(mine.predict_margin(Q).numpy(),
                                  np.asarray(back.predict_margin(Q)))


def test_corrupt_model_file_is_refused(fitted, tmp_path):
    _, _, port = fitted
    p = str(tmp_path / "m.txt")
    port.save_native_model(p)
    text = open(p).read()
    with open(p, "w") as fh:
        fh.write(text.replace("Tree=1", "Tree=7", 1))
    with pytest.raises(ModelDigestError):
        Booster.load_native_model(p, device="cpu")


@pytest.fixture(scope="module")
def golden_text():
    with open(GOLDEN) as fh:
        return fh.read()


def test_golden_model_loads_and_scores_identically(golden_text):
    """The golden file holds a numeric and a categorical tree; query
    points cover NaN, unseen, negative and fractional categories."""
    ref = RefBooster.load_native_model_string(golden_text)
    port = Booster.load_native_model_string(golden_text, device="cpu")
    rng = np.random.default_rng(0)
    age = rng.uniform(10, 95, size=200)
    income = rng.uniform(0, 2e5, size=200)
    city = rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 8, 40, -1, -0.5, 2.5, np.nan],
                      size=200)
    Q = np.stack([age, income, city], axis=1)
    Q[::13, 0] = np.nan
    Q[::7, 1] = 100000.5
    Q = Q.astype(np.float32)
    np.testing.assert_array_equal(port.predict_margin(Q).numpy(),
                                  np.asarray(ref.predict_margin(Q)))
    np.testing.assert_array_equal(port.predict(Q).numpy(),
                                  np.asarray(ref.predict(Q)))
    assert port.save_native_model_string() == ref.save_native_model_string()


#: a margin whose probability ``torch.sigmoid`` rounds 2 ulp away from
#: ``jax.nn.sigmoid`` (f32 bits -1120146669, -0.04587848)
TIED_MARGIN = np.array([-1120146669], np.int32).view(np.float32)


def _margin_model_text(margins, sigmoid):
    """A LightGBM text model of one balanced tree over feature 0 whose
    leaf k, reached by x0 = k, holds ``margins[k]``."""
    L = len(margins)
    split_feature, threshold, left, right = [], [], [], []

    def build(lo, hi):
        if hi - lo == 1:
            return ~lo
        node = len(threshold)
        mid = (lo + hi) // 2
        split_feature.append(0)
        threshold.append(mid - 0.5)
        left.append(None)
        right.append(None)
        left[node] = build(lo, mid)
        right[node] = build(mid, hi)
        return node

    build(0, L)

    def ints(a):
        return " ".join(str(int(v)) for v in a)

    def floats(a):
        return " ".join(repr(float(v)) for v in a)

    tree = [
        "Tree=0", f"num_leaves={L}", "num_cat=0",
        f"split_feature={ints(split_feature)}",
        f"split_gain={floats([1.0] * (L - 1))}",
        f"threshold={floats(threshold)}",
        f"decision_type={ints([2] * (L - 1))}",
        f"left_child={ints(left)}", f"right_child={ints(right)}",
        f"leaf_value={floats(np.asarray(margins, np.float32))}",
        f"leaf_weight={floats([1.0] * L)}", f"leaf_count={ints([1] * L)}",
        f"internal_value={floats([0.0] * (L - 1))}",
        f"internal_weight={floats([1.0] * (L - 1))}",
        f"internal_count={ints([1] * (L - 1))}",
        "is_linear=0", "shrinkage=1", "", ""]
    return "\n".join([
        "tree", "version=v3", "num_class=1", "num_tree_per_iteration=1",
        "label_index=0", "max_feature_idx=0",
        f"objective=binary sigmoid:{sigmoid:g}", "feature_names=x",
        f"feature_infos=[0:{L - 1}]", "", *tree, "end of trees", "",
        "parameters:", "end of parameters", ""])


@pytest.mark.parametrize("sigmoid", [1.0, 0.5])
def test_binary_probabilities_equal_the_reference_bit_for_bit(sigmoid):
    """Booster.predict's probabilities against the reference's on the
    margins of one tree: the tied margin above and 2,047 drawn from
    N(0, 4^2); both packages must evaluate XLA's sigmoid."""
    rng = np.random.default_rng(0)
    margins = np.concatenate(
        [TIED_MARGIN, (rng.normal(size=2047) * 4).astype(np.float32)])
    text = _margin_model_text(margins, sigmoid)
    ref = RefBooster.load_native_model_string(text)
    port = Booster.load_native_model_string(text, device="cpu")
    X = np.arange(len(margins), dtype=np.float32)[:, None]
    np.testing.assert_array_equal(port.predict_margin(X).numpy(), margins)
    np.testing.assert_array_equal(np.asarray(ref.predict_margin(X)),
                                  margins)
    np.testing.assert_array_equal(port.predict(X).numpy(),
                                  np.asarray(ref.predict(X)))


def test_predict_on_cuda_raises_without_a_gpu(golden_text):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    port = Booster.load_native_model_string(golden_text)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.predict_margin(np.zeros((2, 3), np.float32))
