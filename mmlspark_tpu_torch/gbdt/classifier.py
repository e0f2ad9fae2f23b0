"""LightGBMClassifier / LightGBMClassificationModel.

The port's counterpart of ``mmlspark_tpu/gbdt/classifier.py``: binary and
multiclass (``multiclass`` / ``multiclassova``, or more than two label
classes, which promote to ``multiclass``), with the same output columns,
rawPrediction (margin vector), probability and prediction, and the
SHAP column when ``featuresShapCol`` is set.
"""

from __future__ import annotations

import numpy as np

from ..core.params import (Param, TypeConverters, HasProbabilityCol,
                           HasRawPredictionCol)
from ..core.schema import DataTable, features_matrix
from .base import LightGBMBase, LightGBMModelBase
from .booster import Booster


class _ClassifierParams(HasProbabilityCol, HasRawPredictionCol):
    isUnbalance = Param("isUnbalance",
                        "Up-weight the rare class in binary training",
                        default=False, typeConverter=TypeConverters.toBool)
    scalePosWeight = Param("scalePosWeight", "Weight of positive class",
                           default=1.0, typeConverter=TypeConverters.toFloat)
    sigmoid = Param("sigmoid", "Sigmoid scaling for binary objective",
                    default=1.0, typeConverter=TypeConverters.toFloat)
    thresholds = Param("thresholds",
                       "Per-class prediction thresholds (optional)",
                       default=None, typeConverter=TypeConverters.toListFloat)


class LightGBMClassifier(LightGBMBase, _ClassifierParams):
    _default_objective = "binary"

    def __init__(self, **kwargs):
        kwargs.setdefault("objective", "binary")
        super().__init__(**kwargs)

    def _objective_kwargs(self):
        return dict(sigmoid=self.getSigmoid(),
                    is_unbalance=self.getIsUnbalance(),
                    scale_pos_weight=self.getScalePosWeight())

    def _prepare_labels(self, y):
        """Labels as the objective takes them: class ids for a multiclass
        objective (NaN refused), else floats; more than two classes
        promote the fit to ``multiclass`` with K = max label + 1 (kept
        off the param map: a fit does not change the estimator)."""
        y = np.asarray(y)
        self._num_class = 1
        self._resolved_objective = self.getObjective()
        if self.getObjective() in ("multiclass", "softmax",
                                   "multiclassova", "ova"):
            if y.dtype.kind == "f" and np.isnan(y).any():
                raise ValueError(
                    "multiclass labels contain NaN; labels must be "
                    "integer class ids in [0, num_class)")
            return y.astype(np.int64)
        uniq = np.unique(y[~np.isnan(y.astype(np.float64))]) \
            if y.dtype.kind == "f" else np.unique(y)
        if len(uniq) > 2:
            self._resolved_objective = "multiclass"
            self._num_class = int(np.max(y)) + 1
            return y.astype(np.int64)
        return y.astype(np.float64)

    def _val_metric(self):
        """Validation logloss (the reference's): binary through the
        sigmoid, multi-logloss through :func:`_softmax` for a multiclass
        objective; weighted by the validation weights."""
        obj = getattr(self, "_resolved_objective", self.getObjective())

        if obj in ("multiclass", "softmax", "multiclassova", "ova"):
            def logloss_mc(scores, labels, weights):
                p = _softmax(scores)
                n = len(labels)
                eps = 1e-15
                ll = -np.log(np.clip(
                    p[np.arange(n), labels.astype(int)], eps, 1.0))
                if weights is not None:
                    return float(np.average(ll, weights=weights))
                return float(np.mean(ll))
            return logloss_mc

        sig = self.getSigmoid()

        def logloss(scores, labels, weights):
            p = 1.0 / (1.0 + np.exp(-sig * scores))
            eps = 1e-15
            p = np.clip(p, eps, 1 - eps)
            ll = -(labels * np.log(p) + (1 - labels) * np.log(1 - p))
            if weights is not None:
                return float(np.average(ll, weights=weights))
            return float(np.mean(ll))
        return logloss

    def _make_model(self, booster: Booster) -> "LightGBMClassificationModel":
        return LightGBMClassificationModel(booster=booster)


class LightGBMClassificationModel(LightGBMModelBase, _ClassifierParams):

    def _transform(self, table: DataTable) -> DataTable:
        X = features_matrix(table, self.getFeaturesCol())
        margins = self._margins(X)
        if margins.ndim == 1:
            raw = np.stack([-margins, margins], axis=1)
            p1 = 1.0 / (1.0 + np.exp(-self.getSigmoid() * margins))
            prob = np.stack([1.0 - p1, p1], axis=1)
        else:
            raw = margins
            prob = _softmax(margins)
        thresholds = self.getThresholds()
        if thresholds:
            pred = np.argmax(prob / np.asarray(thresholds)[None, :], axis=1)
        else:
            pred = np.argmax(prob, axis=1)
        out = self._with_shap(table, X)
        if self.getRawPredictionCol():
            out = out.withColumn(self.getRawPredictionCol(), raw)
        if self.getProbabilityCol():
            out = out.withColumn(self.getProbabilityCol(), prob)
        return out.withColumn(self.getPredictionCol(),
                              pred.astype(np.float64))

    @property
    def numClasses(self) -> int:
        return max(self._booster.num_class, 2)


def _softmax(x):
    """Row softmax in numpy, as the reference's estimator computes its
    multiclass probability column (for ``multiclassova`` too)."""
    z = x - np.max(x, axis=-1, keepdims=True)
    e = np.exp(z)
    return e / np.sum(e, axis=-1, keepdims=True)
