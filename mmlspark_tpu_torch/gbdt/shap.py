"""TreeSHAP feature contributions (Lundberg et al. 2018, Algorithm 2).

The port's copy of ``mmlspark_tpu/gbdt/shap.py`` (numpy only, so the port
keeps its own): ``featuresShapCol`` / LightGBM's ``predict(...,
pred_contrib=True)``.  The exact path-dependent TreeSHAP over the
:class:`.booster.HostTree` forest: per tree, a recursive walk keeps the
"unique path" of features with their zero/one fractions and Shapley
permutation weights; the contributions satisfy local accuracy
(``sum(phi) + expected == margin``).

It runs on the host in both packages: explanation batches are small, and
the recursion is over tree paths, not rows × leaves.
"""

from __future__ import annotations

from typing import List

import numpy as np


def _thr32_up(threshold: np.ndarray) -> np.ndarray:
    """Thresholds rounded UP to float32 — the predictor's convention
    (booster._stack's thr32), so the f32 decision agrees with the exact
    f64 threshold for every f32-representable x."""
    v = threshold.astype(np.float32)
    low = v.astype(np.float64) < threshold
    v[low] = np.nextafter(v[low], np.float32(np.inf))
    return v


def _decide_left(tree, thr32: np.ndarray, node: int,
                 xrow: np.ndarray) -> bool:
    """Mirror _predict_forest's decision EXACTLY (f32 inputs vs up-rounded
    f32 thresholds; numeric NaN always right; categorical NaN by the
    missing_left bit; unseen/out-of-range categories right) — any
    divergence breaks SHAP local accuracy on those rows."""
    f = int(tree.split_feature[node])
    v = xrow[f]                                    # float32
    dt = int(tree.decision_type[node])
    if dt & 1:                                     # categorical bitset
        if np.isnan(v):
            return bool(dt & 2)                    # missing_left bit
        c = int(v)
        j = int(tree.threshold[node])
        w0, w1 = tree.cat_boundaries[j], tree.cat_boundaries[j + 1]
        words = tree.cat_threshold[w0:w1]
        if c < 0 or (c >> 5) >= len(words):
            return False                           # unseen -> right
        return bool((int(words[c >> 5]) >> (c & 31)) & 1)
    if np.isnan(v):
        return False                               # numeric NaN -> right
    return v <= thr32[node]


def _subtree_stats(tree):
    """(expected value, cover) per signed node id: count-weighted mean of
    leaf values below each node — LightGBM's ``Tree::ExpectedValue``."""
    m = len(tree.split_feature)
    exp_internal = np.zeros(m, np.float64)
    cov_internal = np.zeros(m, np.float64)

    def rec(node: int):
        if node < 0:
            leaf = ~node
            return (float(tree.leaf_value[leaf]),
                    float(max(tree.leaf_count[leaf], 1)))
        vl, cl = rec(int(tree.left_child[node]))
        vr, cr = rec(int(tree.right_child[node]))
        c = cl + cr
        v = (vl * cl + vr * cr) / c
        exp_internal[node] = v
        cov_internal[node] = c
        return v, c

    if m:
        rec(0)
    return exp_internal, cov_internal


class _Path:
    """The unique path: parallel arrays of feature index d, zero fraction
    z, one fraction o, and permutation weight w."""
    __slots__ = ("d", "z", "o", "w", "n")

    def __init__(self, cap: int):
        self.d = np.full(cap, -2, np.int64)
        self.z = np.zeros(cap, np.float64)
        self.o = np.zeros(cap, np.float64)
        self.w = np.zeros(cap, np.float64)
        self.n = 0

    def copy(self) -> "_Path":
        p = _Path(len(self.d))
        p.d[:] = self.d
        p.z[:] = self.z
        p.o[:] = self.o
        p.w[:] = self.w
        p.n = self.n
        return p


def _extend(p: _Path, pz: float, po: float, pi: int) -> None:
    i = p.n
    p.d[i], p.z[i], p.o[i] = pi, pz, po
    p.w[i] = 1.0 if i == 0 else 0.0
    for j in range(i - 1, -1, -1):
        p.w[j + 1] += po * p.w[j] * (j + 1) / (i + 1)
        p.w[j] = pz * p.w[j] * (i - j) / (i + 1)
    p.n = i + 1


def _unwind(p: _Path, i: int) -> None:
    l = p.n - 1
    o, z = p.o[i], p.z[i]
    n = p.w[l]
    for j in range(l - 1, -1, -1):
        if o != 0:
            t = p.w[j]
            p.w[j] = n * (l + 1) / ((j + 1) * o)
            n = t - p.w[j] * z * (l - j) / (l + 1)
        else:
            p.w[j] = p.w[j] * (l + 1) / (z * (l - j))
    for j in range(i, l):
        p.d[j], p.z[j], p.o[j] = p.d[j + 1], p.z[j + 1], p.o[j + 1]
    p.n = l


def _unwound_sum(p: _Path, i: int) -> float:
    l = p.n - 1
    o, z = p.o[i], p.z[i]
    total = 0.0
    n = p.w[l]
    for j in range(l - 1, -1, -1):
        if o != 0:
            t = n * (l + 1) / ((j + 1) * o)
            total += t
            n = p.w[j] - t * z * (l - j) / (l + 1)
        else:
            total += p.w[j] * (l + 1) / (z * (l - j))
    return total


class _TreePrep:
    """Row-independent per-tree precomputation, hoisted out of the row
    loop: expected values/covers per node, up-rounded f32 thresholds, and
    the path capacity."""
    __slots__ = ("exp_v", "cov", "thr32", "cap")

    def __init__(self, tree):
        self.exp_v, self.cov = _subtree_stats(tree)
        self.thr32 = _thr32_up(tree.threshold)
        self.cap = tree.max_depth() + 2


def tree_contribs(tree, prep: _TreePrep, xrow: np.ndarray,
                  phi: np.ndarray) -> None:
    """Accumulate one tree's SHAP contributions for one row into ``phi``
    (length f+1; the trailing slot takes the tree's expected value)."""
    if tree.num_leaves <= 1:
        phi[-1] += float(tree.leaf_value[0])
        return
    phi[-1] += prep.exp_v[0]

    def value(node: int) -> float:
        return (float(tree.leaf_value[~node]) if node < 0
                else prep.exp_v[node])

    def cover(node: int) -> float:
        return (float(max(tree.leaf_count[~node], 1)) if node < 0
                else prep.cov[node])

    def rec(node: int, path: _Path, pz: float, po: float, pi: int) -> None:
        path = path.copy()
        _extend(path, pz, po, pi)
        if node < 0:
            for i in range(1, path.n):
                w = _unwound_sum(path, i)
                phi[path.d[i]] += w * (path.o[i] - path.z[i]) * value(node)
            return
        f = int(tree.split_feature[node])
        left = _decide_left(tree, prep.thr32, node, xrow)
        hot = int(tree.left_child[node] if left else tree.right_child[node])
        cold = int(tree.right_child[node] if left
                   else tree.left_child[node])
        iz = io = 1.0
        k = -1
        for i in range(1, path.n):
            if path.d[i] == f:
                k = i
                break
        if k >= 0:
            iz, io = path.z[k], path.o[k]
            _unwind(path, k)
        c = cover(node)
        rec(hot, path, iz * cover(hot) / c, io, f)
        rec(cold, path, iz * cover(cold) / c, 0.0, f)

    rec(0, _Path(prep.cap), 1.0, 1.0, -1)


def predict_contrib(booster, X: np.ndarray) -> np.ndarray:
    """(n, K*(f+1)) SHAP contributions: per class, one value per feature
    plus the expected-value slot last (LightGBM pred_contrib layout).

    Inputs are cast to float32 like the jitted predictor, so the SHAP
    walk and the prediction walk take identical paths on every row.
    """
    X = np.asarray(X, np.float32)
    n = X.shape[0]
    f = booster.max_feature_idx + 1
    K = booster.num_class
    out = np.zeros((n, K, f + 1), np.float64)
    for t_idx, tree in enumerate(booster.trees):
        k = t_idx % K
        prep = _TreePrep(tree)
        for r in range(n):
            tree_contribs(tree, prep, X[r], out[r, k])
    if booster.init_score:
        out[:, :, -1] += booster.init_score
    return out.reshape(n, K * (f + 1))
