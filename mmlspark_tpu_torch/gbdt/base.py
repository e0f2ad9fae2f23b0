"""LightGBM-compatible estimator base.

The port's counterpart of ``mmlspark_tpu/gbdt/base.py``: bin the features
on the host (:func:`.binning.fit_bin_mapper`), build the objective, and
run the serial boosting loop (:func:`.engine.train`) on ``device``.  Param
names mirror the reference's (and so the reference's public API); the
port adds ``device``.  Params whose feature is not ported yet are
declared so that asking for one raises ``NotImplementedError`` instead of
training something else.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..core.params import (Param, Params, TypeConverters, HasFeaturesCol,
                           HasLabelCol, HasPredictionCol, HasWeightCol,
                           HasValidationIndicatorCol)
from ..core.pipeline import Estimator, Model
from ..core.schema import DataTable, features_matrix
from .binning import fit_bin_mapper
from .booster import Booster
from .engine import TrainParams, train
from .objectives import get_objective


class HasDevice(Params):
    device = Param("device", "Torch device the stage runs on: 'cuda' "
                   "(default; raises without a GPU) or 'cpu'",
                   default="cuda", typeConverter=TypeConverters.toString)


class LightGBMParams(HasFeaturesCol, HasDevice, HasLabelCol,
                     HasPredictionCol, HasWeightCol,
                     HasValidationIndicatorCol):
    """Shared LightGBM params — names track the reference's."""

    numIterations = Param("numIterations", "Number of boosting iterations",
                          default=100, typeConverter=TypeConverters.toInt)
    learningRate = Param("learningRate", "Shrinkage rate", default=0.1,
                         typeConverter=TypeConverters.toFloat)
    numLeaves = Param("numLeaves", "Max leaves per tree", default=31,
                      typeConverter=TypeConverters.toInt)
    maxDepth = Param("maxDepth", "Max tree depth (<=0 means no limit)",
                     default=-1, typeConverter=TypeConverters.toInt)
    maxBin = Param("maxBin", "Max number of feature bins", default=255,
                   typeConverter=TypeConverters.toInt)
    lambdaL1 = Param("lambdaL1", "L1 regularization", default=0.0,
                     typeConverter=TypeConverters.toFloat)
    lambdaL2 = Param("lambdaL2", "L2 regularization", default=0.0,
                     typeConverter=TypeConverters.toFloat)
    minSumHessianInLeaf = Param("minSumHessianInLeaf",
                                "Minimal sum of hessians in one leaf",
                                default=1e-3,
                                typeConverter=TypeConverters.toFloat)
    minDataInLeaf = Param("minDataInLeaf",
                          "Minimal number of rows in one leaf", default=20,
                          typeConverter=TypeConverters.toInt)
    minGainToSplit = Param("minGainToSplit", "Minimal split gain",
                           default=0.0, typeConverter=TypeConverters.toFloat)
    baggingFraction = Param("baggingFraction", "Row subsample fraction",
                            default=1.0, typeConverter=TypeConverters.toFloat)
    baggingFreq = Param("baggingFreq",
                        "Resample rows every k iterations (0 disables)",
                        default=0, typeConverter=TypeConverters.toInt)
    baggingSeed = Param("baggingSeed", "Bagging seed", default=3,
                        typeConverter=TypeConverters.toInt)
    featureFraction = Param("featureFraction",
                            "Feature subsample fraction per tree",
                            default=1.0, typeConverter=TypeConverters.toFloat)
    boostFromAverage = Param("boostFromAverage",
                             "Start scores from the label average",
                             default=True, typeConverter=TypeConverters.toBool)
    verbosity = Param("verbosity", "Engine verbosity", default=1,
                      typeConverter=TypeConverters.toInt)
    objective = Param("objective", "Training objective", default="regression",
                      typeConverter=TypeConverters.toString)
    seed = Param("seed", "Random seed", default=42,
                 typeConverter=TypeConverters.toInt)
    histogramMethod = Param("histogramMethod",
                            "Histogram backend: auto, pallas, pallas_fused "
                            "(the CUDA kernels on a GPU), pallas_bf16 (the "
                            "kernels in bf16 accumulation), segment or "
                            "onehot (plain, CPU only)", default="auto",
                            typeConverter=TypeConverters.toString)
    # -- params of features the port has not reached yet (ROADMAP.md) ------
    boostingType = Param("boostingType", "gbdt (goss, dart and rf are not "
                         "ported yet)", default="gbdt",
                         typeConverter=TypeConverters.toString)
    earlyStoppingRound = Param("earlyStoppingRound", "Early stopping is not "
                               "ported yet; 0 disables", default=0,
                               typeConverter=TypeConverters.toInt)
    categoricalSlotIndexes = Param(
        "categoricalSlotIndexes", "Categorical features are not ported yet",
        default=None, typeConverter=TypeConverters.toListInt)
    categoricalSlotNames = Param(
        "categoricalSlotNames", "Categorical features are not ported yet",
        default=None, typeConverter=TypeConverters.toListString)
    quantizedGrad = Param("quantizedGrad", "Quantized-gradient training is "
                          "not ported yet; 'off'", default="off",
                          typeConverter=TypeConverters.toString)
    enableBundle = Param("enableBundle", "Exclusive Feature Bundling is not "
                         "ported yet", default=False,
                         typeConverter=TypeConverters.toBool)
    initModelPath = Param("initModelPath", "Continued training is not "
                          "ported yet", default="",
                          typeConverter=TypeConverters.toString)
    checkpointDir = Param("checkpointDir", "Checkpoints are not ported yet",
                          default="", typeConverter=TypeConverters.toString)

    def _refuse_unported(self) -> None:
        asks = {
            "earlyStoppingRound": self.getEarlyStoppingRound() > 0,
            "validationIndicatorCol": bool(
                self.getValidationIndicatorCol()),
            "categoricalSlotIndexes": bool(
                self.getCategoricalSlotIndexes()),
            "categoricalSlotNames": bool(self.getCategoricalSlotNames()),
            "quantizedGrad": str(self.getQuantizedGrad()).lower()
            not in ("off", "", "0", "false", "none"),
            "enableBundle": self.getEnableBundle(),
            "initModelPath": bool(self.getInitModelPath()),
            "checkpointDir": bool(self.getCheckpointDir()),
        }
        asked = [k for k, v in asks.items() if v]
        if asked:
            raise NotImplementedError(
                f"{', '.join(asked)}: not ported to mmlspark_tpu_torch yet "
                "(ROADMAP.md lists what the first slice left out)")

    def _train_params(self) -> TrainParams:
        return TrainParams(
            num_iterations=self.getNumIterations(),
            learning_rate=self.getLearningRate(),
            num_leaves=self.getNumLeaves(),
            max_depth=self.getMaxDepth(),
            max_bin=self.getMaxBin(),
            lambda_l1=self.getLambdaL1(),
            lambda_l2=self.getLambdaL2(),
            min_data_in_leaf=self.getMinDataInLeaf(),
            min_sum_hessian_in_leaf=self.getMinSumHessianInLeaf(),
            min_gain_to_split=self.getMinGainToSplit(),
            bagging_fraction=self.getBaggingFraction(),
            bagging_freq=self.getBaggingFreq(),
            feature_fraction=self.getFeatureFraction(),
            boost_from_average=self.getBoostFromAverage(),
            seed=self.getSeed(),
            bagging_seed=self.getBaggingSeed(),
            boosting=self.getBoostingType(),
            histogram_method=self.getHistogramMethod(),
            verbosity=self.getVerbosity(),
        )


class LightGBMBase(Estimator, LightGBMParams):
    """Shared fit() orchestration for the classifier and the regressor."""

    _default_objective = "regression"

    def _objective_kwargs(self) -> Dict:
        return {}

    def _prepare_labels(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y, np.float64)

    def _make_model(self, booster: Booster) -> "LightGBMModelBase":
        raise NotImplementedError

    def _fit(self, table: DataTable) -> "LightGBMModelBase":
        self._refuse_unported()
        X = features_matrix(table, self.getFeaturesCol())
        y = self._prepare_labels(table[self.getLabelCol()])
        wcol = self.getWeightCol()
        w = np.asarray(table[wcol], np.float64) if wcol else None
        objective = get_objective(
            self.getObjective() or self._default_objective,
            **self._objective_kwargs())
        feature_names = list(
            getattr(table[self.getFeaturesCol()], "columns", [])) or None
        mapper = fit_bin_mapper(X, max_bin=self.getMaxBin(),
                                seed=self.getSeed())
        device = self.getDevice()
        booster = train(mapper.transform(X, device), y, w, mapper,
                        objective, self._train_params(),
                        feature_names=feature_names)
        model = self._make_model(booster)
        model.setParams(**{k: v for k, v in self._iterSetParams()
                           if model.hasParam(k)})
        return model


class LightGBMModelBase(Model, HasFeaturesCol, HasDevice,
                        HasPredictionCol):
    """Shared scoring transformer; holds a :class:`Booster`."""

    def __init__(self, booster: Booster = None, **kwargs):
        super().__init__(**kwargs)
        self._booster = booster

    def getModel(self) -> Booster:
        return self._booster

    def getNativeModel(self) -> str:
        return self._booster.save_native_model_string()

    def saveNativeModel(self, path: str, overwrite: bool = True) -> None:
        """Save in LightGBM text format; ``overwrite=False`` refuses to
        clobber an existing file."""
        import os
        if not overwrite and os.path.exists(path):
            raise FileExistsError(f"{path} exists and overwrite=False")
        self._booster.save_native_model(path)

    @classmethod
    def loadNativeModel(cls, path: str, device: str = "cuda"
                        ) -> "LightGBMModelBase":
        return cls(booster=Booster.load_native_model(path, device),
                   device=device)

    @classmethod
    def loadNativeModelFromString(cls, model_str: str, device: str = "cuda"
                                  ) -> "LightGBMModelBase":
        return cls(booster=Booster.load_native_model_string(model_str,
                                                            device),
                   device=device)

    def getFeatureImportances(self, importance_type: str = "split"):
        return list(self._booster.feature_importances(importance_type))

    def _margins(self, X: np.ndarray) -> np.ndarray:
        return self._booster.predict_margin(
            X, device=self.getDevice()).cpu().numpy()
