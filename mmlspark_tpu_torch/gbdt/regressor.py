"""LightGBMRegressor / LightGBMRegressionModel.

The port's counterpart of ``mmlspark_tpu/gbdt/regressor.py``: the
regression objectives l2, l1, huber, fair, poisson, quantile, mape,
gamma, tweedie and cross_entropy, with the objective's output transform
on ``transform``.
"""

from __future__ import annotations

import numpy as np

from ..core.params import Param, TypeConverters
from ..core.schema import DataTable, features_matrix
from .base import LightGBMBase, LightGBMModelBase
from .booster import Booster


class LightGBMRegressor(LightGBMBase):
    _default_objective = "regression"

    alpha = Param("alpha", "Alpha for huber/quantile objectives", default=0.9,
                  typeConverter=TypeConverters.toFloat)
    fairC = Param("fairC", "C for fair objective", default=1.0,
                  typeConverter=TypeConverters.toFloat)
    poissonMaxDeltaStep = Param("poissonMaxDeltaStep",
                                "Safety for poisson optimization",
                                default=0.7,
                                typeConverter=TypeConverters.toFloat)
    tweedieVariancePower = Param("tweedieVariancePower",
                                 "Tweedie variance power", default=1.5,
                                 typeConverter=TypeConverters.toFloat)

    def _objective_kwargs(self):
        return dict(alpha=self.getAlpha(), fair_c=self.getFairC(),
                    poisson_max_delta_step=self.getPoissonMaxDeltaStep(),
                    tweedie_variance_power=self.getTweedieVariancePower())

    def _val_metric(self):
        """Validation l2: the (weighted) mean squared error."""
        def l2(scores, labels, weights):
            d = (scores - labels) ** 2
            if weights is not None:
                return float(np.average(d, weights=weights))
            return float(np.mean(d))
        return l2

    def _make_model(self, booster: Booster) -> "LightGBMRegressionModel":
        return LightGBMRegressionModel(booster=booster)


class LightGBMRegressionModel(LightGBMModelBase):

    def _transform(self, table: DataTable) -> DataTable:
        X = features_matrix(table, self.getFeaturesCol())
        pred = self._booster.predict(X, device=self.getDevice())
        out = self._with_shap(table, X)
        return out.withColumn(self.getPredictionCol(),
                              pred.cpu().numpy().astype(np.float64))
