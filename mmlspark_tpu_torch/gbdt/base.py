"""LightGBM-compatible estimator base.

The port's counterpart of ``mmlspark_tpu/gbdt/base.py``: bin the features
on the host (:func:`.binning.fit_bin_mapper`), build the objective, and
run the boosting loop (:func:`.engine.train`) on ``device`` — serially, or
over a mesh pinned with :meth:`setMesh` or, on a host with more than one
card, built over all of them (as ``parallelism`` lays them out) for a fit
of at least ``autoMeshMinRows`` rows.  Param names mirror the reference's
(and so the reference's public API); the port adds ``device``.
``initModelPath`` continues a saved model (its margins seed the scores and
its trees come first in the fitted forest), ``initScoreCol`` seeds the
scores with per-row offsets, and ``profileTraceDir`` records a
``torch.profiler`` trace of the fit.  Cluster-shaped params
(``useBarrierExecutionMode``, ``numTasks``, ``numThreads``) are accepted
and recorded but do not change the fit, as in the reference.
``checkpointDir`` and ``faultTolerantRetries`` reach the engine's
chunk-boundary checkpoints and chunk replay.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from ..core.params import (Param, Params, TypeConverters, HasFeaturesCol,
                           HasLabelCol, HasPredictionCol, HasWeightCol,
                           HasValidationIndicatorCol)
from ..core.pipeline import Estimator, Model
from ..core.profiling import maybe_trace
from ..core.schema import DataTable, features_matrix
from ..device import resolve_device
from .binning import BinMapper, fit_bin_mapper
from .booster import Booster
from .distributed import resolve_mesh
from .engine import TrainParams, train
from .objectives import get_objective


class HasDevice(Params):
    device = Param("device", "Torch device the stage runs on: 'cuda' "
                   "(default; raises without a GPU) or 'cpu'",
                   default="cuda", typeConverter=TypeConverters.toString)


class HasFeaturesShapCol(Params):
    featuresShapCol = Param("featuresShapCol",
                            "Output column for SHAP values (empty disables)",
                            default="", typeConverter=TypeConverters.toString)


class LightGBMParams(HasFeaturesCol, HasDevice, HasFeaturesShapCol,
                     HasLabelCol, HasPredictionCol, HasWeightCol,
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
                            "onehot (plain, CPU only); pallas_ring fuses "
                            "the segment gather, histogram and ring "
                            "reduction into one kernel on a mesh",
                            default="auto",
                            typeConverter=TypeConverters.toString)
    parallelism = Param("parallelism",
                        "Tree learner parallelism: serial, data, voting "
                        "(PV-Tree: each data shard votes topK features "
                        "and only the voted columns are reduced), "
                        "feature or data+feature; a pinned mesh's shape "
                        "decides which axes a fit has",
                        default="data", typeConverter=TypeConverters.toString)
    autoMeshMinRows = Param(
        "autoMeshMinRows",
        "Minimum training rows before fit() shards across all CUDA cards "
        "of the host when no mesh is pinned and there is more than one; "
        "smaller fits train serially.  setMesh() always shards; 0 shards "
        "every fit on a multi-card host", default=65536,
        typeConverter=TypeConverters.toInt)
    collective = Param("collective",
                       "Cross-shard histogram reduction on mesh fits: auto "
                       "or psum (the shard-order sum) or ring (the "
                       "ring_allreduce kernel)", default="auto",
                       typeConverter=TypeConverters.toString)
    topK = Param("topK", "Voting parallelism: features each data shard "
                 "votes per split", default=20,
                 typeConverter=TypeConverters.toInt)
    categoricalSlotIndexes = Param(
        "categoricalSlotIndexes", "Feature indexes treated as categorical "
        "(non-negative integer values)", default=None,
        typeConverter=TypeConverters.toListInt)
    categoricalSlotNames = Param(
        "categoricalSlotNames", "Feature names treated as categorical "
        "(resolved against the features column names)", default=None,
        typeConverter=TypeConverters.toListString)
    catSmooth = Param("catSmooth", "Categorical smoothing (cat_smooth)",
                      default=10.0, typeConverter=TypeConverters.toFloat)
    catL2 = Param("catL2", "Extra L2 for categorical splits (cat_l2)",
                  default=10.0, typeConverter=TypeConverters.toFloat)
    maxCatThreshold = Param(
        "maxCatThreshold", "Max categories on the smaller split side",
        default=32, typeConverter=TypeConverters.toInt)
    maxCatToOnehot = Param(
        "maxCatToOnehot", "Cardinality at or below which one-vs-rest "
        "splits are used", default=4, typeConverter=TypeConverters.toInt)
    boostingType = Param("boostingType",
                         "gbdt (plain boosting), goss (gradient-based "
                         "one-side sampling), dart (dropout boosting) or "
                         "rf (random forest)", default="gbdt",
                         typeConverter=TypeConverters.toString)
    dropRate = Param("dropRate", "dart: per-tree dropout probability",
                     default=0.1, typeConverter=TypeConverters.toFloat)
    maxDrop = Param("maxDrop", "dart: max trees dropped per iteration",
                    default=50, typeConverter=TypeConverters.toInt)
    skipDrop = Param("skipDrop", "dart: probability of skipping dropout "
                     "for an iteration", default=0.5,
                     typeConverter=TypeConverters.toFloat)
    dropSeed = Param("dropSeed", "dart: dropout random seed", default=4,
                     typeConverter=TypeConverters.toInt)
    topRate = Param("topRate",
                    "GOSS: fraction of rows kept by largest gradient",
                    default=0.2, typeConverter=TypeConverters.toFloat)
    otherRate = Param("otherRate",
                      "GOSS: fraction of remaining rows sampled (amplified "
                      "by (1-topRate)/otherRate)", default=0.1,
                      typeConverter=TypeConverters.toFloat)
    earlyStoppingRound = Param("earlyStoppingRound",
                               "Stop when the validation metric has not "
                               "improved for this many iterations (rows "
                               "flagged by validationIndicatorCol); 0 "
                               "disables", default=0,
                               typeConverter=TypeConverters.toInt)
    quantizedGrad = Param(
        "quantizedGrad",
        "Quantized-gradient training (LightGBM use_quantized_grad "
        "analog): 'off' keeps f32 gradients; '16'/'8' discretize (g,h) "
        "per boost round onto a seeded stochastically-rounded integer "
        "grid, accumulate histograms in int32 and cross shards in the "
        "narrowest wire dtype the row count admits.  Gains still "
        "evaluate in f32", default="off",
        typeConverter=TypeConverters.toString)
    enableBundle = Param(
        "enableBundle",
        "Exclusive Feature Bundling (LightGBM enable_bundle): merge "
        "mutually-exclusive sparse features (one-hot blocks) into single "
        "bundle columns so histogram work scales with bundles, not "
        "features.  Off by default; serial gbdt/rf/multiclass only",
        default=False, typeConverter=TypeConverters.toBool)
    maxConflictRate = Param(
        "maxConflictRate",
        "EFB conflict budget (LightGBM max_conflict_rate): fraction of "
        "rows allowed to violate exclusivity inside one bundle",
        default=0.0, typeConverter=TypeConverters.toFloat)
    useBarrierExecutionMode = Param(
        "useBarrierExecutionMode",
        "Accepted for API parity; the mesh's devices are always driven "
        "together", default=False, typeConverter=TypeConverters.toBool)
    numTasks = Param("numTasks",
                     "Accepted for API parity; the mesh shape decides "
                     "task layout", default=0,
                     typeConverter=TypeConverters.toInt)
    numThreads = Param("numThreads", "Accepted for API parity", default=0,
                       typeConverter=TypeConverters.toInt)
    initScoreCol = Param("initScoreCol", "Column with per-row initial scores",
                         default=None, typeConverter=TypeConverters.toString)
    initModelPath = Param(
        "initModelPath",
        "Path to a saved native (LightGBM-text) model to CONTINUE "
        "training from: its margins seed the boosting scores and its "
        "trees prepend the fitted forest (LightGBM's init_model / "
        "keep_training_booster)", default="",
        typeConverter=TypeConverters.toString)
    passThroughArgs = Param("passThroughArgs",
                            "Raw 'key=value key=value' LightGBM param string "
                            "recorded into the model file",
                            default="", typeConverter=TypeConverters.toString)
    profileTraceDir = Param(
        "profileTraceDir",
        "Directory for a torch.profiler trace of the whole fit, host and "
        "card (empty disables); a Chrome trace, readable in Perfetto",
        default="", typeConverter=TypeConverters.toString)
    checkpointDir = Param(
        "checkpointDir",
        "Directory for chunk-boundary training checkpoints: a killed "
        "fit re-run with the same settings resumes from the last "
        "completed chunk, bit-identically (empty disables)", default="",
        typeConverter=TypeConverters.toString)
    faultTolerantRetries = Param(
        "faultTolerantRetries",
        "Chunk-level training failure recovery: snapshot boosting state "
        "at chunk boundaries and replay a failed chunk up to this many "
        "times (0 disables)", default=0,
        typeConverter=TypeConverters.toInt)

    def _train_params(self) -> TrainParams:
        pass_through = {}
        for tok in self.getPassThroughArgs().split():
            if "=" in tok:
                k, _, v = tok.partition("=")
                pass_through[k] = v
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
            early_stopping_round=self.getEarlyStoppingRound(),
            boost_from_average=self.getBoostFromAverage(),
            seed=self.getSeed(),
            bagging_seed=self.getBaggingSeed(),
            boosting=self.getBoostingType(),
            top_rate=self.getTopRate(),
            other_rate=self.getOtherRate(),
            drop_rate=self.getDropRate(),
            max_drop=self.getMaxDrop(),
            skip_drop=self.getSkipDrop(),
            drop_seed=self.getDropSeed(),
            quantized_grad=self.getQuantizedGrad(),
            enable_bundle=self.getEnableBundle(),
            max_conflict_rate=self.getMaxConflictRate(),
            histogram_method=self.getHistogramMethod(),
            parallelism=self.getParallelism(),
            collective=self.getCollective(),
            top_k=self.getTopK(),
            cat_smooth=self.getCatSmooth(),
            cat_l2=self.getCatL2(),
            max_cat_threshold=self.getMaxCatThreshold(),
            max_cat_to_onehot=self.getMaxCatToOnehot(),
            verbosity=self.getVerbosity(),
            fault_tolerant_retries=self.getFaultTolerantRetries(),
            checkpoint_dir=self.getCheckpointDir(),
            pass_through=pass_through,
        )


class LightGBMBase(Estimator, LightGBMParams):
    """Shared fit() orchestration for the classifier, the regressor and
    the ranker."""

    __abstractstage__ = True

    _default_objective = "regression"
    _mesh = None

    def setMesh(self, mesh) -> "LightGBMBase":
        """Pin a mesh (:func:`..core.mesh.build_mesh`) for training: the
        fit runs on the mesh's devices, its rows sharded over the data
        axis and its features over the feature axis."""
        self._mesh = mesh
        return self

    def _fit_mesh(self, n_rows: int, ranking: bool = False):
        """The mesh this fit shards over: the pinned one, else all CUDA
        cards when the host has more than one, the device is CUDA, the fit
        is neither GOSS nor DART nor lambdarank (per-shard sampling and
        query packing are choices the caller makes by pinning a mesh, as
        in the reference) and there are at least ``autoMeshMinRows``
        training rows; else None (serial)."""
        parallelism = self.getParallelism()
        mesh = self._mesh
        if mesh is not None:
            if torch.device(self.getDevice()).type != mesh.device_type:
                raise ValueError(
                    f"device={self.getDevice()!r} does not match the mesh's "
                    f"{mesh.device_type} devices; the mesh decides where "
                    "the fit runs")
            return mesh
        device = resolve_device(self.getDevice())
        if (parallelism != "serial" and device.type == "cuda"
                and self.getBoostingType() not in ("goss", "dart")
                and not ranking
                and torch.cuda.device_count() > 1
                and n_rows >= self.getAutoMeshMinRows()):
            return resolve_mesh(parallelism)
        return None

    def _objective_kwargs(self) -> Dict:
        return {}

    def _prepare_labels(self, y: np.ndarray) -> np.ndarray:
        return np.asarray(y, np.float64)

    def _resolve_objective(self, y: np.ndarray):
        """The fit's objective: the resolved name (a classifier may promote
        to multiclass) with its class count, K = max label + 1 for the
        multiclass objectives."""
        name = getattr(self, "_resolved_objective", None) \
            or self.getObjective() or self._default_objective
        num_class = getattr(self, "_num_class", 1)
        if name in ("multiclass", "softmax", "multiclassova",
                    "ova") and num_class <= 1:
            num_class = int(np.max(y)) + 1
        return get_objective(name, num_class=num_class,
                             **self._objective_kwargs())

    def _categorical_indexes(self, feature_names):
        """``categoricalSlotIndexes`` and the indexes of
        ``categoricalSlotNames`` among the feature names, sorted."""
        idx = list(self.getCategoricalSlotIndexes() or [])
        for nm in self.getCategoricalSlotNames() or []:
            if not feature_names or nm not in feature_names:
                raise ValueError(
                    f"categoricalSlotNames: {nm!r} not found among feature "
                    f"columns {feature_names}")
            idx.append(feature_names.index(nm))
        return sorted(set(idx))

    def _make_model(self, booster: Booster) -> "LightGBMModelBase":
        raise NotImplementedError

    def _val_metric(self):
        """The validation metric ``(margins, labels, weights) -> float``,
        lower is better (numpy on the host)."""
        raise NotImplementedError

    def _val_metric_fn(self, table: DataTable, val_rows):
        """The validation metric of this fit; a ranker's closes over the
        validation rows' queries."""
        return self._val_metric()

    def _ranking_info(self, table: DataTable, train_rows):
        """A ranker's query structure for the engine; None otherwise."""
        return None

    def _init_model(self, params: TrainParams, objective, X: np.ndarray,
                    device) -> Optional[Booster]:
        """The model ``initModelPath`` continues, loaded on ``device``, or
        None; the reference's checks, on the resolved boosting type (a
        ``passThroughArgs`` boosting key must not get past them)."""
        path = self.getInitModelPath()
        if not path:
            return None
        if params.boosting in ("dart", "rf"):
            raise ValueError(
                "initModelPath requires boostingType gbdt or goss: dart "
                "re-weights (and rf averages) the WHOLE ensemble, which is "
                "not additive over a frozen prefix")
        booster = Booster.load_native_model(path, device)
        if booster.num_class != objective.num_model_per_iteration:
            raise ValueError(
                f"initModelPath model has num_class={booster.num_class}, "
                f"this fit trains {objective.num_model_per_iteration}")
        if booster.max_feature_idx != X.shape[1] - 1:
            raise ValueError(
                f"initModelPath model was trained on "
                f"{booster.max_feature_idx + 1} features, this table has "
                f"{X.shape[1]}")
        return booster

    def _fit(self, table: DataTable) -> "LightGBMModelBase":
        X = features_matrix(table, self.getFeaturesCol())
        y = self._prepare_labels(table[self.getLabelCol()])
        wcol = self.getWeightCol()
        w = np.asarray(table[wcol], np.float64) if wcol else None
        # rows flagged by validationIndicatorCol form the validation set:
        # the mapper is fit on the training rows alone and bins both
        vcol = self.getValidationIndicatorCol()
        val = np.asarray(table[vcol]).astype(bool) if vcol else None
        X_train, y_train, w_train = X, y, w
        train_rows = slice(None)
        if val is not None:
            train_rows = ~val
            X_train, y_train = X[~val], y[~val]
            w_train = w[~val] if w is not None else None
        has_val = val is not None and val.any()
        objective = self._resolve_objective(y)
        feature_names = list(
            getattr(table[self.getFeaturesCol()], "columns", [])) or None
        cat_idx = self._categorical_indexes(feature_names)
        ranking_info = self._ranking_info(table, train_rows)
        mesh = self._fit_mesh(len(y_train), ranking_info is not None)
        mapper = fit_bin_mapper(X_train, max_bin=self.getMaxBin(),
                                seed=self.getSeed(),
                                categorical_features=cat_idx or None)
        device = self.getDevice() if mesh is None else mesh.devices[0]
        params = self._train_params()
        iscol = self.getInitScoreCol()
        init_scores = (np.asarray(table[iscol], np.float64)[train_rows]
                       if iscol else None)
        # continued training (LightGBM init_model): boost from the saved
        # model's margins, computed on the fit's device; its trees come
        # first in the fitted forest
        init_booster = self._init_model(params, objective, X, device)
        val_kwargs = {}
        if init_booster is not None:
            margins = init_booster.predict_margin(
                X_train, device=device).cpu().numpy().astype(np.float64)
            init_scores = (margins if init_scores is None
                           else init_scores + margins)
            if has_val:
                # the validation margins seed the validation scores, so
                # early stopping follows the merged model
                val_kwargs["val_init_scores"] = init_booster.predict_margin(
                    X[val], device=device).cpu().numpy().astype(np.float64)
        if has_val:
            val_kwargs.update(
                val_bins=fit_codes(mapper, X[val], device),
                val_labels=y[val],
                val_weights=w[val] if w is not None else None,
                val_metric=self._val_metric_fn(table, val))
        with maybe_trace(self.getProfileTraceDir()):
            booster = train(fit_codes(mapper, X_train, device), y_train,
                            w_train, mapper, objective, params,
                            feature_names=feature_names, mesh=mesh,
                            ranking_info=ranking_info,
                            init_scores=init_scores, **val_kwargs)
        if init_booster is not None:
            booster = init_booster.extended(booster)
        model = self._make_model(booster)
        model.setParams(**{k: v for k, v in self._iterSetParams()
                           if model.hasParam(k)})
        return model


def fit_codes(mapper: BinMapper, X: np.ndarray, device) -> torch.Tensor:
    """The bin codes a fit trains on, on ``device``: binned on the host by
    the native kernel (:meth:`BinMapper.transform_packed`) and copied to
    the device as one byte a cell, as the reference's fit ships them; above
    256 bins (int32 codes) binned on the device
    (:meth:`BinMapper.transform`)."""
    if mapper.bin_dtype == torch.uint8:
        return mapper.transform_packed(X).to(device)
    return mapper.transform(X, device)


class LightGBMModelBase(Model, HasFeaturesCol, HasDevice,
                        HasFeaturesShapCol, HasPredictionCol):
    """Shared scoring transformer; holds a :class:`Booster`.  ``save`` /
    ``load`` keep the booster as ``model.lgb.txt`` in the stage directory
    (the reference's layout: either package loads the other's), loaded on
    the model's ``device``."""

    __abstractstage__ = True

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
        if not overwrite and os.path.exists(path):
            raise FileExistsError(f"{path} exists and overwrite=False")
        self._booster.save_native_model(path)

    @classmethod
    def loadNativeModel(cls, path: str, device: str = "cuda"
                        ) -> "LightGBMModelBase":
        return cls(booster=Booster.load_native_model(path, device),
                   device=device)

    @classmethod
    def loadNativeModelFromFile(cls, path: str, device: str = "cuda"
                                ) -> "LightGBMModelBase":
        """The reference's alias of :meth:`loadNativeModel`."""
        return cls.loadNativeModel(path, device)

    @classmethod
    def loadNativeModelFromString(cls, model_str: str, device: str = "cuda"
                                  ) -> "LightGBMModelBase":
        return cls(booster=Booster.load_native_model_string(model_str,
                                                            device),
                   device=device)

    def _with_shap(self, table: DataTable, X) -> DataTable:
        """``table`` with the ``featuresShapCol`` column (each row's
        TreeSHAP contributions) when the param is set."""
        col = self.getFeaturesShapCol()
        if not col:
            return table
        contribs = self._booster.predict_contrib(X)
        arr = np.empty(len(contribs), dtype=object)
        for i, row in enumerate(contribs):
            arr[i] = row
        return table.withColumn(col, arr)

    def getFeatureImportances(self, importance_type: str = "split"):
        return list(self._booster.feature_importances(importance_type))

    def _save_extra(self, path: str) -> None:
        with open(os.path.join(path, "model.lgb.txt"), "w") as f:
            f.write(self._booster.save_native_model_string())

    def _load_extra(self, path: str) -> None:
        self._booster = Booster.load_native_model(
            os.path.join(path, "model.lgb.txt"), self.getDevice())

    def _margins(self, X: np.ndarray) -> np.ndarray:
        return self._booster.predict_margin(
            X, device=self.getDevice()).cpu().numpy()
