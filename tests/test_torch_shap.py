"""TreeSHAP in the port against the JAX reference, on the CPU.

``Booster.predict_contrib`` runs the port's copy of the reference's
TreeSHAP on the host, so its contributions equal the reference's
(``np.array_equal``) on binary, multiclass and categorical forests: the
port's fits, loaded into both packages from their model text (the text
keeps 17 decimals, so a loaded leaf value can differ from the fitted one
in its last bits, in both packages alike).  They satisfy local accuracy
within the reference's tolerance (rtol 1e-5, atol 1e-5).
``featuresShapCol`` appends the reference's column on the classifier, the
regressor and the ranker.
"""

import numpy as np
import pytest

from mmlspark_tpu.gbdt import Booster as RefBooster
from mmlspark_tpu.gbdt import (LightGBMClassificationModel as RefClsModel,
                               LightGBMRankerModel as RefRankModel,
                               LightGBMRegressionModel as RefRegModel)
from mmlspark_tpu_torch import (LightGBMClassificationModel,
                                LightGBMClassifier, LightGBMRanker,
                                LightGBMRankerModel, LightGBMRegressionModel,
                                LightGBMRegressor)
from mmlspark_tpu_torch.gbdt import Booster
from torch_parity import data, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KW = dict(numIterations=5, learningRate=0.3, numLeaves=7, minDataInLeaf=10,
          maxBin=63, verbosity=0, device="cpu")


@pytest.mark.parametrize("name", ["binary", "multiclass", "categorical"])
def test_contributions_equal_reference(name):
    cat = name == "categorical"
    objective = "multiclass" if name == "multiclass" else "binary"
    X, y = data(objective, n=1000, f=6, categorical=cat)
    kw = dict(KW, objective=objective)
    if cat:
        kw["categoricalSlotIndexes"] = [4, 5]
    text = LightGBMClassifier(**kw).fit(
        {"features": X, "label": y}).getNativeModel()
    booster = Booster.load_native_model_string(text, "cpu")
    ref = RefBooster.load_native_model_string(text)
    rows = X[:40].copy()
    rows[::5, 1] = np.nan
    got = booster.predict_contrib(rows)
    assert np.array_equal(got, ref.predict_contrib(rows))
    K, f = booster.num_class, X.shape[1]
    per_class = got.reshape(len(rows), K, f + 1).sum(-1)
    margins = booster.predict_margin(rows).numpy().reshape(len(rows), K)
    np.testing.assert_allclose(per_class, margins, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("stage", ["classifier", "regressor", "ranker"])
def test_features_shap_col_equals_reference(stage):
    objective = "regression" if stage == "regressor" else "binary"
    X, y = data(objective, n=600, f=5)
    table = {"features": X, "label": y, "query": np.arange(600) // 12}
    est, model_cls, ref_cls = {
        "classifier": (LightGBMClassifier, LightGBMClassificationModel,
                       RefClsModel),
        "regressor": (LightGBMRegressor, LightGBMRegressionModel,
                      RefRegModel),
        "ranker": (LightGBMRanker, LightGBMRankerModel, RefRankModel)}[stage]
    kw = dict(KW, featuresShapCol="shap")
    if stage == "ranker":
        kw["groupCol"] = "query"
    fitted = est(**kw).fit(table)
    np.testing.assert_allclose(
        np.stack(fitted.transform(table)["shap"]).sum(1),
        fitted.getModel().predict_margin(X).numpy(), rtol=1e-5, atol=1e-5)
    text = fitted.getNativeModel()
    got = model_cls.loadNativeModelFromString(text, "cpu") \
        .setFeaturesShapCol("shap").transform(table)
    want = ref_cls.loadNativeModelFromString(text) \
        .setFeaturesShapCol("shap").transform(table)
    assert np.array_equal(np.stack(got["shap"]), np.stack(want["shap"]))
    assert np.array_equal(got["prediction"], want["prediction"])
