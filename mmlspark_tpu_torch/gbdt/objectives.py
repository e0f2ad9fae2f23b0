"""Training objectives: gradient/hessian functions.

The port's counterpart of ``mmlspark_tpu/gbdt/objectives.py``: ``binary``,
the regression family (``regression`` (l2), ``regression_l1``, ``huber``,
``fair``, ``poisson``, ``quantile``, ``mape``, ``gamma``, ``tweedie``),
``cross_entropy``, ``multiclass`` (softmax), ``multiclassova`` and the
``lambdarank`` stub whose gradients come from :mod:`.ranking`.
``init_score`` and ``train_loss`` are host numpy, identical to the
reference's; ``grad_hess`` and ``transform_prediction`` are torch on the
scores' device, rounded as the reference's compiled XLA CPU program
rounds them: its exp (:func:`exp32`), and one rounding where XLA fuses a
product into an add (:func:`fma32`: Gamma's ``1 − y·e^{−s}``, Tweedie's
``−y·a + b`` and its hessian's first product plus the second).  Semantics
track LightGBM.
"""

from __future__ import annotations

from typing import Optional, Tuple

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

    def transform_prediction(self, scores: Tensor) -> Tensor:
        """Raw margin → output space (the identity unless overridden)."""
        return scores

    def train_loss(self, scores: np.ndarray, labels: np.ndarray,
                   weights: Optional[np.ndarray] = None
                   ) -> Optional[float]:
        """The host training loss (numpy) where the objective has a closed
        form, else None."""
        return None


def _weighted_mean(loss: np.ndarray, weights) -> Optional[float]:
    w = (np.ones_like(loss) if weights is None
         else np.asarray(weights, np.float64))
    s = float(w.sum())
    return float((loss * w).sum() / s) if s > 0 else None


def _mean_init(labels, weights, empty: float) -> float:
    s = float(np.sum(weights))
    return float(np.sum(weights * labels) / s) if s > 0 else empty


def _f32(x: float) -> float:
    """A host constant as the float32 XLA folds it to."""
    return float(np.float32(x))


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

    def transform_prediction(self, scores):
        return sigmoid(self.sigma * scores)

    def train_loss(self, scores, labels, weights=None):
        """Weighted logloss (numpy, clipped for stability)."""
        y = (np.asarray(labels) > 0).astype(np.float64)
        p = 1.0 / (1.0 + np.exp(-self.sigma * np.asarray(
            scores, np.float64)))
        p = np.clip(p, 1e-12, 1.0 - 1e-12)
        return _weighted_mean(-(y * np.log(p) + (1.0 - y) * np.log(1.0 - p)),
                              weights)


class RegressionL2(Objective):
    name = "regression"
    model_str = "regression"

    def init_score(self, labels, weights):
        return _mean_init(labels, weights, 0.0)

    def grad_hess(self, scores, labels, weights):
        return (scores - labels) * weights, weights

    def train_loss(self, scores, labels, weights=None):
        """Weighted mean squared error (numpy)."""
        return _weighted_mean((np.asarray(scores, np.float64)
                               - np.asarray(labels, np.float64)) ** 2,
                              weights)


class RegressionL1(Objective):
    name = "regression_l1"
    model_str = "regression_l1"

    def init_score(self, labels, weights):
        return float(np.median(labels))

    def grad_hess(self, scores, labels, weights):
        return torch.sign(scores - labels) * weights, weights


class HuberObjective(Objective):
    name = "huber"
    model_str = "huber"

    def __init__(self, alpha: float = 0.9):
        self.alpha = float(alpha)

    def init_score(self, labels, weights):
        return _mean_init(labels, weights, 0.0)

    def grad_hess(self, scores, labels, weights):
        d = scores - labels
        a = _f32(self.alpha)
        g = torch.where(d.abs() <= a, d, a * torch.sign(d)) * weights
        return g, weights


class FairObjective(Objective):
    name = "fair"
    model_str = "fair"

    def __init__(self, c: float = 1.0):
        self.c = float(c)

    def grad_hess(self, scores, labels, weights):
        d = scores - labels
        ad = d.abs() + _f32(self.c)
        g = _f32(self.c) * d / ad * weights
        # a tensor numerator: torch's scalar / tensor multiplies by a
        # reciprocal, which rounds twice
        h = torch.full_like(ad, _f32(self.c * self.c)) / (ad * ad) * weights
        return g, h


def _log_mean_init(labels, weights) -> float:
    return float(np.log(max(_mean_init(labels, weights, 1.0), 1e-12)))


class PoissonObjective(Objective):
    name = "poisson"
    model_str = "poisson"

    def __init__(self, max_delta_step: float = 0.7):
        self.max_delta_step = float(max_delta_step)

    def init_score(self, labels, weights):
        return _log_mean_init(labels, weights)

    def grad_hess(self, scores, labels, weights):
        mu = exp32(scores)
        # XLA folds exp(max_delta_step) to the float32 nearest the exact
        # value
        h = mu * _f32(np.exp(self.max_delta_step)) * weights
        return (mu - labels) * weights, h

    def transform_prediction(self, scores):
        return exp32(scores)


class QuantileObjective(Objective):
    name = "quantile"
    model_str = "quantile"

    def __init__(self, alpha: float = 0.9):
        self.alpha = float(alpha)

    def init_score(self, labels, weights):
        return float(np.quantile(labels, self.alpha))

    def grad_hess(self, scores, labels, weights):
        g = torch.where(scores - labels >= 0, _f32(1.0 - self.alpha),
                        _f32(-self.alpha)) * weights
        return g, weights


class MapeObjective(Objective):
    name = "mape"
    model_str = "mape"

    def init_score(self, labels, weights):
        return float(np.median(labels))

    def grad_hess(self, scores, labels, weights):
        denom = torch.clamp(labels.abs(), min=1.0)
        return (torch.sign(scores - labels) / denom * weights,
                weights / denom)


class GammaObjective(Objective):
    """Gamma deviance with log link: g = 1 − y·e^{−s}, h = y·e^{−s}."""

    name = "gamma"
    model_str = "gamma"

    def init_score(self, labels, weights):
        return _log_mean_init(labels, weights)

    def grad_hess(self, scores, labels, weights):
        e = exp32(-scores)
        return fma32(-labels, e, 1.0) * weights, labels * e * weights

    def transform_prediction(self, scores):
        return exp32(scores)


class TweedieObjective(Objective):
    """Tweedie deviance, log link, variance power ρ ∈ (1, 2):
    g = −y·e^{(1−ρ)s} + e^{(2−ρ)s}, h its score derivative."""

    name = "tweedie"
    model_str = "tweedie"

    def __init__(self, rho: float = 1.5):
        if not 1.0 < rho < 2.0:
            raise ValueError("tweedie_variance_power must be in (1, 2), "
                             f"got {rho}")
        self.rho = float(rho)

    def init_score(self, labels, weights):
        return _log_mean_init(labels, weights)

    def grad_hess(self, scores, labels, weights):
        r1, r2 = _f32(1.0 - self.rho), _f32(2.0 - self.rho)
        a = exp32(r1 * scores)
        b = exp32(r2 * scores)
        g = fma32(-labels, a, b) * weights
        h = fma32(-labels * r1, a, r2 * b) * weights
        return g, h

    def transform_prediction(self, scores):
        return exp32(scores)


class CrossEntropyObjective(Objective):
    """Cross-entropy on probability labels in [0, 1]: the binary gradient
    g = σ(s) − y without hard 0/1 labels."""

    name = "cross_entropy"
    model_str = "cross_entropy"

    def init_score(self, labels, weights):
        p = _mean_init(labels, weights, 0.5)
        p = min(max(p, 1e-12), 1.0 - 1e-12)
        return float(np.log(p / (1.0 - p)))

    def grad_hess(self, scores, labels, weights):
        p = sigmoid(scores)
        h = torch.clamp(p * (1.0 - p), min=_f32(1e-16)) * weights
        return (p - labels) * weights, h

    def transform_prediction(self, scores):
        return sigmoid(scores)


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

    def transform_prediction(self, scores):
        p = sigmoid(self.sigma * scores)
        return p / torch.clamp(sum_last(p), min=1e-12)


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

    def transform_prediction(self, scores):
        return softmax(scores)

    def train_loss(self, scores, labels, weights=None):
        """Weighted softmax cross-entropy (numpy, log-sum-exp)."""
        s = np.asarray(scores, np.float64)
        s = s - s.max(axis=-1, keepdims=True)
        logp = s - np.log(np.exp(s).sum(axis=-1, keepdims=True))
        y = np.asarray(labels).astype(np.int64)
        return _weighted_mean(-logp[np.arange(len(y)), y], weights)


def _one_hot(labels: Tensor, num_class: int, dtype) -> Tensor:
    """``jax.nn.one_hot`` of the labels truncated to int32: an id outside
    ``[0, num_class)`` gives a row of zeros."""
    ids = labels.to(torch.int32).to(torch.int64)
    return (ids[:, None] == torch.arange(num_class, device=labels.device)
            ).to(dtype)


class LambdarankObjective(Objective):
    """Metadata only: a ranker's gradients come from its query structure
    (:mod:`.ranking`); the init score is 0."""

    name = "lambdarank"
    model_str = "lambdarank"

    def grad_hess(self, scores, labels, weights):
        raise ValueError(
            "objective='lambdarank' needs query structure; use "
            "LightGBMRanker (with groupCol) instead of "
            "LightGBMClassifier/Regressor")


def get_objective(name: str, num_class: int = 1, **kwargs) -> Objective:
    name = name.lower()
    sig = kwargs.get("sigmoid", 1.0)
    aliases = {
        "binary": lambda: BinaryObjective(
            sigmoid_coef=sig,
            is_unbalance=kwargs.get("is_unbalance", False),
            scale_pos_weight=kwargs.get("scale_pos_weight", 1.0)),
        "regression": RegressionL2, "regression_l2": RegressionL2,
        "l2": RegressionL2, "mean_squared_error": RegressionL2,
        "mse": RegressionL2,
        "regression_l1": RegressionL1, "l1": RegressionL1,
        "mae": RegressionL1,
        "huber": lambda: HuberObjective(alpha=kwargs.get("alpha", 0.9)),
        "fair": lambda: FairObjective(c=kwargs.get("fair_c", 1.0)),
        "poisson": lambda: PoissonObjective(
            max_delta_step=kwargs.get("poisson_max_delta_step", 0.7)),
        "quantile": lambda: QuantileObjective(alpha=kwargs.get("alpha", 0.9)),
        "mape": MapeObjective,
        "gamma": GammaObjective,
        "tweedie": lambda: TweedieObjective(
            rho=kwargs.get("tweedie_variance_power", 1.5)),
        "cross_entropy": CrossEntropyObjective,
        "xentropy": CrossEntropyObjective,
        "multiclass": lambda: MulticlassObjective(num_class),
        "softmax": lambda: MulticlassObjective(num_class),
        "multiclassova": lambda: MulticlassOvaObjective(num_class, sig),
        "ova": lambda: MulticlassOvaObjective(num_class, sig),
        "lambdarank": LambdarankObjective,
    }
    if name not in aliases:
        raise ValueError(f"Unknown objective {name!r}; "
                         f"supported: {sorted(aliases)}")
    return aliases[name]()
