"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

LightGBM fit → transform (:class:`LightGBMClassifier`,
:class:`LightGBMRegressor`, :class:`LightGBMRanker`) on one device, or data-parallel over the
shards of a :class:`Mesh` (:func:`build_mesh`, pinned with ``setMesh``),
with the gradient-histogram kernels (``csrc/histogram.cu``) and the ring
collectives (``csrc/ring.cu``) written by hand in CUDA for Hopper; the
serving plane (:mod:`.io`: HTTP servers, the micro-batch scoring engine,
the framed transport, the predictor fleet) puts a booster's predictor
behind requests.  Entry points run on ``"cuda"`` unless the caller asks
for ``"cpu"``.  The
package imports torch and numpy, never jax and nothing of
``mmlspark_tpu``.
"""

from .core.mesh import Mesh, build_mesh
from .device import resolve_device
from .gbdt import (LightGBMClassifier, LightGBMClassificationModel,
                   LightGBMRegressor, LightGBMRegressionModel,
                   LightGBMRanker, LightGBMRankerModel, ndcg_at_k, Booster)

__all__ = ["resolve_device", "Mesh", "build_mesh", "LightGBMClassifier",
           "LightGBMClassificationModel", "LightGBMRegressor",
           "LightGBMRegressionModel", "LightGBMRanker",
           "LightGBMRankerModel", "ndcg_at_k", "Booster"]
