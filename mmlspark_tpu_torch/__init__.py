"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

First slice: single-device LightGBM fit → transform
(:class:`LightGBMClassifier`, :class:`LightGBMRegressor`) with the
gradient-histogram kernels written by hand in CUDA for Hopper
(``csrc/histogram.cu``).  Entry points run on ``"cuda"`` unless the caller
asks for ``"cpu"``.  The package imports torch and numpy, never jax and
nothing of ``mmlspark_tpu``.
"""

from .device import resolve_device
from .gbdt import (LightGBMClassifier, LightGBMClassificationModel,
                   LightGBMRegressor, LightGBMRegressionModel, Booster)

__all__ = ["resolve_device", "LightGBMClassifier",
           "LightGBMClassificationModel", "LightGBMRegressor",
           "LightGBMRegressionModel", "Booster"]
