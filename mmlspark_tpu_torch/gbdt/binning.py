"""Quantile feature binning — the port's BinMapper.

The port's copy of ``mmlspark_tpu/gbdt/binning.py``.  Bounds and
category lists are learned on host numpy exactly as the reference learns
them.  :meth:`BinMapper.transform_packed`, what a fit of at most 256
bins bins its rows with, runs the reference's native ``fastbin`` kernel
on the host (:mod:`..native`); :meth:`BinMapper.transform` runs on the
requested device with the semantics of the reference's
``BinMapper.transform``: a numeric column is a float64
``torch.searchsorted`` (``side="left"`` against float64 upper bounds); a
categorical column maps each category to its bin by identity (the value
truncated to an integer); NaN, and a category that has no bin, go to the
trailing missing bin.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device


@dataclass
class BinMapper:
    """Per-feature binning spec: ``upper_bounds[f]`` sorted ascending.

    A categorical feature (``categorical[f]``) bins by category identity:
    ``cat_values[f]`` holds the raw (non-negative integer) category of
    each bin, most frequent first."""

    upper_bounds: List[np.ndarray]   # len f, each (num_bins_f - 1,) finite
    has_missing: np.ndarray          # (f,) bool
    num_total_bins: int              # B used for histogram sizing
    missing_bin: int                 # index reserved for NaN (== B - 1)
    categorical: Optional[np.ndarray] = None   # (f,) bool
    cat_values: Optional[List[Optional[np.ndarray]]] = None  # cat per bin

    @property
    def num_features(self) -> int:
        return len(self.upper_bounds)

    @property
    def has_categorical(self) -> bool:
        return self.categorical is not None and bool(self.categorical.any())

    def is_categorical(self, j: int) -> bool:
        return self.categorical is not None and bool(self.categorical[j])

    def feature_num_bins(self, j: int) -> int:
        """Value bins feature j uses (the missing bin not counted)."""
        if self.is_categorical(j):
            return len(self.cat_values[j])
        return len(self.upper_bounds[j]) + 1

    @property
    def bin_dtype(self) -> torch.dtype:
        """Narrowest integer dtype that holds every bin index."""
        return torch.uint8 if self.num_total_bins <= 256 else torch.int32

    def _fast_state(self, is64: bool):
        """The arrays :func:`..native.bin_columns` reads (the reference's
        ``_fast_state``), made once per mapper and input precision.

        For float32 inputs the float64 bounds are adjusted DOWN to the
        largest float32 ``c <= b``; then for every float32 value ``v``,
        ``c < v  ⇔  b < v`` (if ``c < v`` then ``v`` is a float32 above
        the largest float32 ≤ b, hence ``v > b``; conversely ``b < v``
        implies ``c ≤ b < v``), so uint8 bins from float32 comparisons
        match the float64 reference bit-exactly.  float64 inputs use the
        raw float64 bounds.  A uniform ``C``-cell grid per feature
        provides a starting hint; the kernel probes locally in both
        directions, so the hint only affects speed, never the result.
        Features whose bounds pack > 32 deep into one cell (degenerate
        hint) use plain binary search instead."""
        key = "_fs64" if is64 else "_fs32"
        cached = getattr(self, key, None)
        if cached is not None:
            return cached
        f = self.num_features
        C = 2048
        nb = np.asarray([len(ub) for ub in self.upper_bounds], np.int32)
        m = max(int(nb.max()), 1) if f else 1
        dt = np.float64 if is64 else np.float32
        bext = np.full((f, m), np.inf, dt)
        lo = np.zeros(f, np.float32)
        scale = np.zeros(f, np.float32)
        base = np.zeros((f, C), np.int32)
        use_table = np.zeros(f, np.uint8)
        for j, ub in enumerate(self.upper_bounds):
            if len(ub) == 0 or self.is_categorical(j):
                continue
            if is64:
                c = ub
            else:
                c = ub.astype(np.float32)
                over = c.astype(np.float64) > ub
                c[over] = np.nextafter(c[over], np.float32(-np.inf))
            bext[j, :len(c)] = c
            span = float(c[-1]) - float(c[0])
            if len(c) >= 8 and span > 0 and np.isfinite(span):
                lo[j] = np.float32(c[0])
                with np.errstate(over="ignore"):
                    scale_j = np.float32(C / (span * (1 + 1e-6)))
                if not np.isfinite(scale_j):   # span below ~f32 tiny
                    continue
                scale[j] = scale_j
                edges = (float(lo[j])
                         + np.arange(C, dtype=np.float64) / float(scale[j]))
                b0 = np.searchsorted(c, edges.astype(c.dtype), side="left")
                top = np.searchsorted(
                    c, np.nextafter((edges + 1.0 / float(scale[j])
                                     ).astype(c.dtype), np.inf), side="left")
                if int((top - b0).max()) <= 32:
                    base[j] = b0
                    use_table[j] = 1
        state = (bext, nb, base, lo, scale, use_table)
        object.__setattr__(self, key, state)
        return state

    def transform_packed(self, X: np.ndarray) -> torch.Tensor:
        """:meth:`transform` on the host into a CPU tensor of the
        narrowest dtype, through the native ``fastbin`` kernel
        (:func:`..native.bin_columns`, the reference's
        ``transform_packed``): what a fit bins its rows with before it
        copies the one-byte codes to its device, in place of a float64
        copy of ``X`` on the device.  Categorical columns go through
        :meth:`_transform_cat`.

        Exactness: the same codes as :meth:`transform` (float64
        semantics) for float32 and float64 inputs (see
        :meth:`_fast_state`).  Above 256 total bins, or for an ``X`` that
        is neither float32 nor float64, this is :meth:`transform` on the
        CPU, as the reference hands those to its torch path."""
        from .. import native
        X = np.asarray(X)
        n, f = X.shape
        if f != self.num_features:
            raise ValueError(
                f"Expected {self.num_features} features, got {f}")
        if self.bin_dtype != torch.uint8 or \
                X.dtype not in (np.float32, np.float64):
            return self.transform(X, "cpu")
        is64 = X.dtype == np.float64
        bext, nb, base, lo, scale, use_table = self._fast_state(is64)
        Xc = np.ascontiguousarray(X)
        out = np.empty(X.shape, np.uint8)
        native.bin_columns(Xc, bext, nb, base, lo, scale, use_table,
                           self.missing_bin, out)
        codes = torch.from_numpy(out)
        if self.has_categorical:
            for j in np.nonzero(self.categorical)[0]:
                codes[:, j] = self._transform_cat(
                    torch.from_numpy(X[:, j].astype(np.float64)), int(j))
        return codes

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
        for j in range(f):
            if self.is_categorical(j):
                out[j] = self._transform_cat(Xt[j], j)
        return out.T.to(self.bin_dtype).contiguous()

    def _transform_cat(self, col: torch.Tensor, j: int) -> torch.Tensor:
        """Bin of each value of categorical column ``j``: the value, NaN
        as −1, truncated to an integer and looked up among the column's
        categories; a value that is none of them goes to the missing
        bin."""
        cats = torch.as_tensor(self.cat_values[j], dtype=torch.int64,
                               device=col.device)
        if cats.numel() == 0:
            return torch.full(col.shape, self.missing_bin,
                              dtype=torch.int64, device=col.device)
        sorted_cats, order = torch.sort(cats)
        vals = torch.nan_to_num(col, nan=-1.0).to(torch.int64)
        pos = torch.searchsorted(sorted_cats, vals).clamp(
            max=len(sorted_cats) - 1)
        return torch.where(sorted_cats[pos] == vals, order[pos],
                           self.missing_bin)

    def bin_threshold_value(self, feature: int, bin_idx: int) -> float:
        """Real-valued threshold for a split at ``bin <= bin_idx`` (the bin
        upper bound, as LightGBM stores it in the model file)."""
        ub = self.upper_bounds[feature]
        if bin_idx >= len(ub):
            # split isolating the top/missing bin: everything finite goes left
            return np.inf
        return float(ub[bin_idx])

    def feature_infos(self) -> List[str]:
        """LightGBM model-file ``feature_infos`` entries: [min:max] for a
        numeric feature, the sorted categories joined by colons for a
        categorical one."""
        infos = []
        for j, ub in enumerate(self.upper_bounds):
            if self.is_categorical(j):
                cats = np.sort(self.cat_values[j])
                infos.append(":".join(str(int(c)) for c in cats) or "none")
            elif len(ub) == 0:
                infos.append("none")
            else:
                infos.append(f"[{ub[0]:.6g}:{ub[-1]:.6g}]")
        return infos

    def to_json(self) -> str:
        """The mapper as JSON, in the reference's format (``format`` 1):
        float64 bounds round-trip exactly, so a mapper saved by either
        package bins identically after ``from_json``."""
        doc = {
            "format": 1,
            "upper_bounds": [ub.tolist() for ub in self.upper_bounds],
            "has_missing": self.has_missing.astype(int).tolist(),
            "num_total_bins": int(self.num_total_bins),
            "missing_bin": int(self.missing_bin),
        }
        if self.categorical is not None:
            doc["categorical"] = self.categorical.astype(int).tolist()
            doc["cat_values"] = [None if cv is None else cv.tolist()
                                 for cv in (self.cat_values or [])]
        return json.dumps(doc, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "BinMapper":
        doc = json.loads(text)
        if doc.get("format") != 1:
            raise ValueError(
                f"unsupported BinMapper format {doc.get('format')!r}")
        cat = doc.get("categorical")
        return cls(
            upper_bounds=[np.asarray(ub, np.float64)
                          for ub in doc["upper_bounds"]],
            has_missing=np.asarray(doc["has_missing"], bool),
            num_total_bins=int(doc["num_total_bins"]),
            missing_bin=int(doc["missing_bin"]),
            categorical=None if cat is None else np.asarray(cat, bool),
            cat_values=None if cat is None else [
                None if cv is None else np.asarray(cv, np.float64)
                for cv in doc["cat_values"]])


def fit_bin_mapper(X: np.ndarray, max_bin: int = 255,
                   sample_cnt: int = 200000,
                   min_data_in_bin: int = 3,
                   seed: int = 0,
                   categorical_features: Optional[List[int]] = None
                   ) -> BinMapper:
    """Learn per-feature bin upper bounds (GreedyFindBin analog).

    ``max_bin`` counts value bins; one extra trailing bin is reserved for
    missing values, giving ``num_total_bins = max_bin + 1``.

    ``categorical_features``: column indexes binned by category identity
    (non-negative integer values, LightGBM's contract); the ``max_bin -
    1`` most frequent categories get bins, the rest join the missing bin.
    """
    n, f = X.shape
    if n > sample_cnt:
        rng = np.random.default_rng(seed)
        idx = rng.choice(n, size=sample_cnt, replace=False)
        idx.sort()
        sample = X[idx]
    else:
        sample = X
    cat_set = set(int(c) for c in (categorical_features or []))
    for c in cat_set:
        if not 0 <= c < f:
            raise ValueError(
                f"categorical feature index {c} out of range [0, {f})")
    bounds: List[np.ndarray] = []
    has_missing = np.zeros(f, dtype=bool)
    categorical = np.zeros(f, dtype=bool)
    cat_values: List[Optional[np.ndarray]] = [None] * f
    for j in range(f):
        col = sample[:, j]
        nan = np.isnan(col)
        has_missing[j] = bool(nan.any())
        col = col[~nan]
        if j in cat_set:
            categorical[j] = True
            cat_values[j] = _find_categories(col, max_bin, j)
            bounds.append(np.empty(0, dtype=np.float64))
        else:
            bounds.append(_find_bounds(col, max_bin, min_data_in_bin))
    num_total_bins = max_bin + 1
    return BinMapper(upper_bounds=bounds, has_missing=has_missing,
                     num_total_bins=num_total_bins,
                     missing_bin=num_total_bins - 1,
                     categorical=categorical if cat_set else None,
                     cat_values=cat_values if cat_set else None)


def _find_categories(col: np.ndarray, max_bin: int, j: int) -> np.ndarray:
    """The ``max_bin - 1`` most frequent categories of a column (NaN
    removed), most frequent first, ties by value (a stable sort of the
    counts)."""
    if col.size and (col < 0).any():
        raise ValueError(
            f"Categorical feature {j} has negative values; categories must "
            "be non-negative integers (LightGBM contract)")
    ints = col.astype(np.int64)
    if col.size and not np.array_equal(ints, col):
        raise ValueError(
            f"Categorical feature {j} has non-integer values")
    vals, counts = np.unique(ints, return_counts=True)
    order = np.argsort(-counts, kind="stable")
    return vals[order][:max_bin - 1].astype(np.int64)


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
