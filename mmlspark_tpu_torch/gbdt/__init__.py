from .classifier import LightGBMClassifier, LightGBMClassificationModel
from .regressor import LightGBMRegressor, LightGBMRegressionModel
from .booster import Booster, HostTree
from .binning import BinMapper, fit_bin_mapper
from .engine import TrainParams, train
from .grower import GrowerConfig, TreeArrays, grow_tree
from .objectives import Objective, get_objective

__all__ = [
    "LightGBMClassifier", "LightGBMClassificationModel",
    "LightGBMRegressor", "LightGBMRegressionModel",
    "Booster", "HostTree", "BinMapper", "fit_bin_mapper",
    "TrainParams", "train", "GrowerConfig", "TreeArrays", "grow_tree",
    "Objective", "get_objective",
]
