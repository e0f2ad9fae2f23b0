"""LightGBMRegressor / LightGBMRegressionModel (l2 regression).

The port's counterpart of ``mmlspark_tpu/gbdt/regressor.py``; the other
regression objectives are not ported yet.
"""

from __future__ import annotations

import numpy as np

from ..core.schema import DataTable, features_matrix
from .base import LightGBMBase, LightGBMModelBase
from .booster import Booster


class LightGBMRegressor(LightGBMBase):
    _default_objective = "regression"

    def _make_model(self, booster: Booster) -> "LightGBMRegressionModel":
        return LightGBMRegressionModel(booster=booster)


class LightGBMRegressionModel(LightGBMModelBase):

    def _transform(self, table: DataTable) -> DataTable:
        X = features_matrix(table, self.getFeaturesCol())
        pred = self._booster.predict(X, device=self.getDevice())
        return table.withColumn(self.getPredictionCol(),
                                pred.cpu().numpy().astype(np.float64))
