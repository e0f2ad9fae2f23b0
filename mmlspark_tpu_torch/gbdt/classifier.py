"""LightGBMClassifier / LightGBMClassificationModel (binary).

The port's counterpart of ``mmlspark_tpu/gbdt/classifier.py``: the same
output columns, rawPrediction (margin vector), probability and
prediction.  Multiclass is not ported yet.
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
        y = np.asarray(y)
        uniq = np.unique(y[~np.isnan(y.astype(np.float64))]) \
            if y.dtype.kind == "f" else np.unique(y)
        if len(uniq) > 2:
            raise NotImplementedError(
                f"{len(uniq)} label classes: multiclass training is not "
                "ported to mmlspark_tpu_torch yet")
        return y.astype(np.float64)

    def _make_model(self, booster: Booster) -> "LightGBMClassificationModel":
        return LightGBMClassificationModel(booster=booster)


class LightGBMClassificationModel(LightGBMModelBase, _ClassifierParams):

    def _transform(self, table: DataTable) -> DataTable:
        margins = self._margins(features_matrix(table,
                                                self.getFeaturesCol()))
        if margins.ndim != 1:
            raise NotImplementedError(
                "multiclass scoring is not ported yet")
        raw = np.stack([-margins, margins], axis=1)
        p1 = 1.0 / (1.0 + np.exp(-self.getSigmoid() * margins))
        prob = np.stack([1.0 - p1, p1], axis=1)
        thresholds = self.getThresholds()
        if thresholds:
            pred = np.argmax(prob / np.asarray(thresholds)[None, :], axis=1)
        else:
            pred = np.argmax(prob, axis=1)
        out = table
        if self.getRawPredictionCol():
            out = out.withColumn(self.getRawPredictionCol(), raw)
        if self.getProbabilityCol():
            out = out.withColumn(self.getProbabilityCol(), prob)
        return out.withColumn(self.getPredictionCol(),
                              pred.astype(np.float64))

    @property
    def numClasses(self) -> int:
        return max(self._booster.num_class, 2)
