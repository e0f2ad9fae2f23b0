"""Training objectives: gradient/hessian functions.

The port's counterpart of ``mmlspark_tpu/gbdt/objectives.py`` for
``binary``, ``regression`` (l2), ``multiclass`` (softmax) and
``multiclassova``.
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


def exp32(x: Tensor) -> Tensor:
    """float32 ``exp(x)`` as XLA's CPU backend evaluates it: its Cephes
    polynomial with fused multiply-adds, the argument clamped to
    [-87.8, 88.8], and subnormal results flushed to zero."""
    v = torch.clamp(x, *_EXP_CLAMP)
    n = torch.floor(fma32(v, _LOG2E, 0.5)).clamp(-127.0, 127.0)
    r = fma32(n, -_LN2_HI, v)
    r = fma32(n, -_LN2_LO, r)
    p = fma32(r, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        p = fma32(p, r, c)
    y = 1.0 + fma32(p, r * r, r)
    two_n = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    return _flush(y * two_n)


def _flush(x: Tensor) -> Tensor:
    return torch.where(x.abs() < _F32_TINY, 0.0, x)


def sigmoid(x: Tensor) -> Tensor:
    """``1 / (1 + exp(-x))`` in float32, evaluated as the reference's XLA
    CPU backend evaluates ``jax.nn.sigmoid`` (:func:`exp32`), subnormal
    results flushed to zero.  The binary objective's gradients then agree
    with the reference's bit for bit, so both packages grow the same
    trees."""
    return _flush(1.0 / (exp32(-x) + 1.0))


def softmax(x: Tensor) -> Tensor:
    """Softmax over the last axis in float32, in the order of
    ``jax.nn.softmax`` on XLA's CPU backend: subtract the row's max,
    :func:`exp32`, add the row in order, divide."""
    e = exp32(x - x.amax(-1, keepdim=True))
    return _flush(e / sum_last(e))


def sum_last(x: Tensor) -> Tensor:
    """Sum over the last axis, kept, added in index order (XLA's CPU order
    for a row of at most 32)."""
    tot = x[..., :1].clone()
    for k in range(1, x.shape[-1]):
        tot += x[..., k:k + 1]
    return tot


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


class MulticlassOvaObjective(Objective):
    """One-vs-all multiclass (LightGBM ``multiclassova``): K independent
    sigmoid classifiers, one tree per class per iteration."""

    name = "multiclassova"

    def __init__(self, num_class: int, sigmoid_coef: float = 1.0):
        if num_class < 2:
            raise ValueError("multiclassova requires num_class >= 2")
        self.num_class = int(num_class)
        self.num_model_per_iteration = self.num_class
        self.sigma = float(sigmoid_coef)
        self.model_str = (f"multiclassova num_class:{self.num_class} "
                          f"sigmoid:{self.sigma:g}")

    def grad_hess(self, scores, labels, weights):
        """scores ``(n, K)``, labels ``(n,)`` class ids → ``(n, K)``."""
        y = _one_hot(labels, self.num_class, scores.dtype)
        p = sigmoid(self.sigma * scores)
        w = weights[:, None]
        g = self.sigma * (p - y) * w
        h = self.sigma * self.sigma * p * (1.0 - p) * w
        return g, h


class MulticlassObjective(Objective):
    """Softmax over K per-class score columns (LightGBM ``multiclass``);
    K trees per iteration."""

    name = "multiclass"

    def __init__(self, num_class: int):
        if num_class < 2:
            raise ValueError("multiclass requires num_class >= 2")
        self.num_class = int(num_class)
        self.num_model_per_iteration = self.num_class
        self.model_str = f"multiclass num_class:{self.num_class}"
        self.factor = self.num_class / (self.num_class - 1.0)

    def grad_hess(self, scores, labels, weights):
        """scores ``(n, K)``, labels ``(n,)`` class ids → ``(n, K)``."""
        p = softmax(scores)
        y = _one_hot(labels, self.num_class, p.dtype)
        w = weights[:, None]
        g = (p - y) * w
        h = self.factor * p * (1.0 - p) * w
        return g, h


def _one_hot(labels: Tensor, num_class: int, dtype) -> Tensor:
    """``jax.nn.one_hot`` of the labels truncated to int32: an id outside
    ``[0, num_class)`` gives a row of zeros."""
    ids = labels.to(torch.int32).to(torch.int64)
    return (ids[:, None] == torch.arange(num_class, device=labels.device)
            ).to(dtype)


#: reference objective names whose port is still to come (ROADMAP.md
#: Queue A item 7)
_NOT_PORTED = ("regression_l1", "l1", "mae", "huber", "fair", "poisson",
               "quantile", "mape", "gamma", "tweedie", "cross_entropy",
               "xentropy", "lambdarank")


def get_objective(name: str, num_class: int = 1, **kwargs) -> Objective:
    name = name.lower()
    if name == "binary":
        return BinaryObjective(
            sigmoid_coef=kwargs.get("sigmoid", 1.0),
            is_unbalance=kwargs.get("is_unbalance", False),
            scale_pos_weight=kwargs.get("scale_pos_weight", 1.0))
    if name in ("regression", "regression_l2", "l2", "mean_squared_error",
                "mse"):
        return RegressionL2()
    if name in ("multiclass", "softmax"):
        return MulticlassObjective(num_class)
    if name in ("multiclassova", "ova"):
        return MulticlassOvaObjective(
            num_class, sigmoid_coef=kwargs.get("sigmoid", 1.0))
    if name in _NOT_PORTED:
        raise NotImplementedError(
            f"objective {name!r} is not ported to mmlspark_tpu_torch yet "
            "(ROADMAP.md Queue A item 7); binary, regression, multiclass "
            "and multiclassova are")
    raise ValueError(f"Unknown objective {name!r}")
