"""Quantile feature binning — the port's BinMapper.

The port's copy of ``mmlspark_tpu/gbdt/binning.py`` for numeric features
(categorical binning is not ported yet; see ROADMAP.md).  Bounds are
learned on host numpy exactly as the reference learns them; the transform
is a float64 ``torch.searchsorted`` on the requested device, the same
semantics as the reference's ``BinMapper.transform`` (``side="left"``
against float64 upper bounds, NaN → the trailing missing bin).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclass
class BinMapper:
    """Per-feature binning spec: ``upper_bounds[f]`` sorted ascending."""

    upper_bounds: List[np.ndarray]   # len f, each (num_bins_f - 1,) finite
    has_missing: np.ndarray          # (f,) bool
    num_total_bins: int              # B used for histogram sizing
    missing_bin: int                 # index reserved for NaN (== B - 1)

    @property
    def num_features(self) -> int:
        return len(self.upper_bounds)

    @property
    def bin_dtype(self) -> torch.dtype:
        """Narrowest integer dtype that holds every bin index."""
        return torch.uint8 if self.num_total_bins <= 256 else torch.int32

    def transform(self, X: np.ndarray, device: DeviceLike = "cuda"
                  ) -> torch.Tensor:
        """Map raw features ``(n, f)`` to bin indices on ``device``
        (``bin_dtype``), NaN → ``missing_bin``."""
        n, f = X.shape
        if f != self.num_features:
            raise ValueError(
                f"Expected {self.num_features} features, got {f}")
        dev = resolve_device(device)
        maxlen = max((len(ub) for ub in self.upper_bounds), default=0)
        bounds = np.full((f, max(maxlen, 1)), np.inf, np.float64)
        for j, ub in enumerate(self.upper_bounds):
            bounds[j, :len(ub)] = ub
        Xt = torch.as_tensor(np.ascontiguousarray(X.T, dtype=np.float64),
                             device=dev)
        out = torch.searchsorted(torch.as_tensor(bounds, device=dev), Xt,
                                 side="left")
        out = torch.where(torch.isnan(Xt), self.missing_bin, out)
        return out.T.to(self.bin_dtype).contiguous()

    def bin_threshold_value(self, feature: int, bin_idx: int) -> float:
        """Real-valued threshold for a split at ``bin <= bin_idx`` (the bin
        upper bound, as LightGBM stores it in the model file)."""
        ub = self.upper_bounds[feature]
        if bin_idx >= len(ub):
            # split isolating the top/missing bin: everything finite goes left
            return np.inf
        return float(ub[bin_idx])

    def feature_infos(self) -> List[str]:
        """LightGBM model-file ``feature_infos`` entries ([min:max])."""
        return ["none" if len(ub) == 0 else f"[{ub[0]:.6g}:{ub[-1]:.6g}]"
                for ub in self.upper_bounds]


def fit_bin_mapper(X: np.ndarray, max_bin: int = 255,
                   sample_cnt: int = 200000,
                   min_data_in_bin: int = 3,
                   seed: int = 0) -> BinMapper:
    """Learn per-feature bin upper bounds (GreedyFindBin analog).

    ``max_bin`` counts value bins; one extra trailing bin is reserved for
    missing values, giving ``num_total_bins = max_bin + 1``.
    """
    n, f = X.shape
    if n > sample_cnt:
        rng = np.random.default_rng(seed)
        idx = rng.choice(n, size=sample_cnt, replace=False)
        idx.sort()
        sample = X[idx]
    else:
        sample = X
    bounds: List[np.ndarray] = []
    has_missing = np.zeros(f, dtype=bool)
    for j in range(f):
        col = sample[:, j]
        nan = np.isnan(col)
        has_missing[j] = bool(nan.any())
        bounds.append(_find_bounds(col[~nan], max_bin, min_data_in_bin))
    num_total_bins = max_bin + 1
    return BinMapper(upper_bounds=bounds, has_missing=has_missing,
                     num_total_bins=num_total_bins,
                     missing_bin=num_total_bins - 1)


def _find_bounds(col: np.ndarray, max_bin: int,
                 min_data_in_bin: int) -> np.ndarray:
    """Distinct-value midpoints (merged to ``min_data_in_bin``) when the
    column has at most ``max_bin`` distinct values, else quantile cuts
    that reproduce ``np.quantile(..., method="linear")`` bit for bit."""
    if col.size == 0:
        return np.empty(0, dtype=np.float64)
    s = np.sort(col)
    change = np.empty(s.size, bool)
    change[0] = True
    np.not_equal(s[1:], s[:-1], out=change[1:])
    starts = np.nonzero(change)[0]
    if starts.size <= 1:
        return np.empty(0, dtype=np.float64)
    if starts.size <= max_bin:
        distinct = s[starts]
        counts = np.diff(np.append(starts, s.size))
        mids = (distinct[:-1] + distinct[1:]) / 2.0
        if min_data_in_bin > 1 and col.size >= 2 * min_data_in_bin:
            keep, acc = [], 0
            for i in range(len(mids)):
                acc += counts[i]
                if acc >= min_data_in_bin:
                    keep.append(mids[i])
                    acc = 0
            mids = np.asarray(keep, dtype=np.float64)
        return np.asarray(mids, dtype=np.float64)
    qs = np.linspace(0, 1, max_bin + 1)[1:-1]
    pos = qs * (s.size - 1)
    lo = pos.astype(np.int64)
    frac = pos - lo
    a = s[lo]
    b = s[np.minimum(lo + 1, s.size - 1)]
    # np.quantile's _lerp: the diff stays in the column dtype, the lerp
    # itself promotes to float64
    d = b - a
    cuts = np.where(frac >= 0.5, b - d * (1.0 - frac), a + d * frac)
    return np.unique(cuts).astype(np.float64)
