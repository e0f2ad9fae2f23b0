from .classifier import LightGBMClassifier, LightGBMClassificationModel
from .regressor import LightGBMRegressor, LightGBMRegressionModel
from .ranking import LightGBMRanker, LightGBMRankerModel, ndcg_at_k
from .booster import Booster, CompiledPredictor, HostTree
from .binning import BinMapper, fit_bin_mapper
from .engine import TrainParams, train, train_incremental
from .grower import GrowerConfig, TreeArrays, grow_tree
from .objectives import Objective, get_objective

__all__ = [
    "LightGBMClassifier", "LightGBMClassificationModel",
    "LightGBMRegressor", "LightGBMRegressionModel",
    "LightGBMRanker", "LightGBMRankerModel", "ndcg_at_k",
    "Booster", "CompiledPredictor", "HostTree", "BinMapper",
    "fit_bin_mapper", "TrainParams", "train", "train_incremental",
    "GrowerConfig", "TreeArrays", "grow_tree", "Objective", "get_objective",
]
