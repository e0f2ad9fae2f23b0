"""Training objectives: gradient/hessian functions.

The port's counterpart of ``mmlspark_tpu/gbdt/objectives.py`` for the
objectives of its first slice, ``binary`` and ``regression`` (l2).
``init_score`` is host numpy, identical to the reference's; ``grad_hess``
is torch on the scores' device.  Semantics track LightGBM.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Tensor = torch.Tensor

_F32_TINY = 2.0 ** -126
#: the Cephes exp polynomial of XLA's CPU backend (float32 constants)
_EXP_CLAMP = (-87.80000305175781, 88.80000305175781)
_LOG2E = 1.44269502162933349609375
_LN2_HI, _LN2_LO = 0.693359375, -2.12194440e-4
_EXP_POLY = (1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3,
             4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1)


def fma32(a: Tensor, b, c) -> Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add rounds
    it (the float32 product is exact in float64)."""
    b = b.double() if isinstance(b, Tensor) else float(np.float32(b))
    c = c.double() if isinstance(c, Tensor) else float(np.float32(c))
    return (a.double() * b + c).float()


def sigmoid(x: Tensor) -> Tensor:
    """``1 / (1 + exp(-x))`` in float32, evaluated as the reference's XLA
    CPU backend evaluates ``jax.nn.sigmoid``: its Cephes polynomial exp
    with fused multiply-adds, and subnormal results flushed to zero.  The
    binary objective's gradients then agree with the reference's bit for
    bit, so both packages grow the same trees."""
    v = torch.clamp(-x, *_EXP_CLAMP)
    n = torch.floor(fma32(v, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma32(n, -_LN2_HI, v)
    r = fma32(n, -_LN2_LO, r)
    p = fma32(r, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        p = fma32(p, r, c)
    y = 1.0 + fma32(p, r * r, r)
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = 1.0 / (y * two_n + 1.0)
    return torch.where(out < _F32_TINY, 0.0, out)


class Objective:
    """Base: subclasses define grad/hess and the boost-from-average init."""

    name = "base"
    num_model_per_iteration = 1
    #: substring written into the LightGBM model file objective line
    model_str = "custom"

    def prepare(self, labels: np.ndarray, weights: np.ndarray) -> None:
        """Resolve label statistics (class weights etc.); called once
        before training."""

    def init_score(self, labels: np.ndarray, weights: np.ndarray) -> float:
        return 0.0

    def grad_hess(self, scores: Tensor, labels: Tensor,
                  weights: Tensor) -> Tuple[Tensor, Tensor]:
        raise NotImplementedError


class BinaryObjective(Objective):
    name = "binary"
    model_str = "binary sigmoid:1"

    def __init__(self, sigmoid_coef: float = 1.0, is_unbalance: bool = False,
                 scale_pos_weight: float = 1.0):
        self.sigma = float(sigmoid_coef)
        self.is_unbalance = is_unbalance
        self.scale_pos_weight = float(scale_pos_weight)
        self.model_str = f"binary sigmoid:{self.sigma:g}"
        self._pos_w = 1.0  # resolved by prepare() from label stats
        self._neg_w = 1.0

    def prepare(self, labels, weights):
        pos = float(np.sum(weights * (labels > 0)))
        neg = float(np.sum(weights)) - pos
        if self.is_unbalance and pos > 0 and neg > 0:
            # up-weight whichever class is rarer, as LightGBM does
            if pos < neg:
                self._pos_w = neg / pos
            else:
                self._neg_w = pos / neg
        elif self.scale_pos_weight != 1.0:
            self._pos_w = self.scale_pos_weight

    def init_score(self, labels, weights):
        pos = float(np.sum(weights * (labels > 0)))
        neg = float(np.sum(weights)) - pos
        if pos <= 0 or neg <= 0:
            return 0.0
        p = pos / (pos + neg)
        return float(np.log(p / (1.0 - p)) / self.sigma)

    def grad_hess(self, scores, labels, weights):
        p = sigmoid(self.sigma * scores)
        w = weights * torch.where(labels > 0, self._pos_w, self._neg_w)
        g = self.sigma * (p - labels) * w
        h = self.sigma * self.sigma * p * (1.0 - p) * w
        return g, h


class RegressionL2(Objective):
    name = "regression"
    model_str = "regression"

    def init_score(self, labels, weights):
        s = float(np.sum(weights))
        return float(np.sum(weights * labels) / s) if s > 0 else 0.0

    def grad_hess(self, scores, labels, weights):
        return (scores - labels) * weights, weights


#: reference objective names whose port is still to come (ROADMAP.md,
#: "Left out of the first slice")
_NOT_PORTED = ("regression_l1", "l1", "mae", "huber", "fair", "poisson",
               "quantile", "mape", "gamma", "tweedie", "cross_entropy",
               "xentropy", "multiclass", "softmax", "multiclassova", "ova",
               "lambdarank")


def get_objective(name: str, **kwargs) -> Objective:
    name = name.lower()
    if name == "binary":
        return BinaryObjective(
            sigmoid_coef=kwargs.get("sigmoid", 1.0),
            is_unbalance=kwargs.get("is_unbalance", False),
            scale_pos_weight=kwargs.get("scale_pos_weight", 1.0))
    if name in ("regression", "regression_l2", "l2", "mean_squared_error",
                "mse"):
        return RegressionL2()
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"objective {name!r} is not ported to mmlspark_tpu_torch yet "
            "(ROADMAP.md Queue A item 3); binary and regression are")
    raise ValueError(f"Unknown objective {name!r}")
