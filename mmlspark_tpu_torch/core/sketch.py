"""Streaming data sketches — the data-quality half of observability.

The port's copy of ``mmlspark_tpu/core/sketch.py``, numpy only, kept
line for line so a reference profile or a sketch snapshot serialises
alike from either package.

The systems half of the observability stack (metrics, traces, SLOs,
profiler) watches *how* the served model runs; nothing watched *what*
flows through it.  This module is the measurement substrate for the
drift subsystem (:mod:`mmlspark_tpu_torch.core.drift`): per-feature mergeable
streaming sketches cheap enough for the scoring hot path, plus the
fit-time **reference profile** they are compared against.

Design points:

* **Fixed, fit-time bucket edges.**  A :class:`StreamSketch` counts
  occupancy over a FIXED ascending edge array decided when the profile
  is built — per-feature edges come straight from the
  :class:`~mmlspark_tpu_torch.gbdt.binning.BinMapper`'s quantile bounds
  (downsampled to at most :data:`MAX_PROFILE_EDGES`), the
  prediction-margin edges from training-margin quantiles.  Fixed edges
  are what make sketches MERGEABLE with the same discipline the
  log-bucket latency histograms established: bucket counts
  are keyed by stable string indices, key-wise summing K workers'
  snapshots yields exactly the sketch of the concatenated rows, and
  PSI/JS recompute from the summed counts — never an average of
  per-worker divergences.
* **Welford moments + quality counters.**  Next to the bucket counts a
  sketch keeps exact ``count``/``nan``/``posinf``/``neginf`` tallies,
  out-of-training-range counters (``below``/``above`` relative to the
  binning-edge span) and mean/variance via a vectorized Welford/Chan
  update — integer counters merge bit-exactly; moments merge by the
  pairwise (Chan) formula.
* **Vectorized batch updates.**  :meth:`MatrixSketch.update` consumes
  the already-decoded float32 ``(n, f)`` scoring batch: one NaN/Inf
  mask pass plus one ``searchsorted``+``bincount`` per feature — no
  per-row Python.  The duty-cycle gate that keeps this off the latency
  budget lives in the monitor (:mod:`~mmlspark_tpu_torch.core.drift`), not
  here.
* **PSI / Jensen–Shannon.**  :func:`psi` and :func:`js_divergence`
  compare two count vectors (reference vs live) with epsilon
  smoothing; the NaN tally rides as a dedicated trailing slot of the
  distribution vector, so an all-NaN feature is a *distribution* shift
  (huge PSI), not just a null-rate delta.

Everything is numpy + stdlib; importable from the serving hot path and
the training engine alike.
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "MAX_PROFILE_EDGES", "MatrixSketch", "ReferenceProfile",
    "StreamSketch", "build_reference_profile", "js_divergence",
    "merge_sketch_snapshots", "psi",
]

#: cap on per-feature bucket-edge count in a reference profile: PSI over
#: a few dozen buckets is the standard discipline (more buckets = more
#: smoothing noise at serving batch sizes, and a fatter profile file)
MAX_PROFILE_EDGES = 31

#: schema stamp for persisted profiles
PROFILE_FORMAT = 1

#: smoothing floor for PSI/JS probabilities — a bucket the reference
#: never saw must not blow the divergence to infinity on one live row
EPS = 1e-4


def downsample_edges(edges: np.ndarray,
                     max_edges: int = MAX_PROFILE_EDGES) -> np.ndarray:
    """At most ``max_edges`` of ``edges``, evenly spaced by INDEX (i.e.
    by training quantile, since the binning bounds are quantile cuts) —
    always a SUBSET, so fine-bin counts regroup exactly onto the coarse
    buckets."""
    edges = np.asarray(edges, np.float64)
    if len(edges) <= max_edges:
        return edges
    idx = np.unique(np.linspace(0, len(edges) - 1, max_edges)
                    .round().astype(np.int64))
    return edges[idx]


class StreamSketch:
    """Streaming occupancy + moments over a fixed edge ladder.

    ``edges`` (ascending, possibly empty) define ``len(edges) + 1``
    value buckets via ``searchsorted(edges, v, side="left")`` — the
    identical bucketing rule :class:`~mmlspark_tpu_torch.gbdt.binning
    .BinMapper.transform` uses, so a live value lands in the same
    bucket its fine training bin rolls up to.  NaNs are tallied
    separately (never bucketed); ±Inf land in the end buckets AND bump
    their own counters.  ``lo``/``hi`` (optional, the training edge
    span) feed the out-of-training-range counters.
    """

    __slots__ = ("edges", "lo", "hi", "counts", "count", "nan",
                 "posinf", "neginf", "below", "above",
                 "_mean", "_m2")

    def __init__(self, edges: Sequence[float] = (),
                 lo: Optional[float] = None,
                 hi: Optional[float] = None):
        self.edges = np.asarray(edges, np.float64)
        self.lo = None if lo is None else float(lo)
        self.hi = None if hi is None else float(hi)
        self.counts = np.zeros(len(self.edges) + 1, np.int64)
        self.count = 0          # finite observations
        self.nan = 0
        self.posinf = 0
        self.neginf = 0
        self.below = 0
        self.above = 0
        self._mean = 0.0
        self._m2 = 0.0

    # -- updates -------------------------------------------------------------

    def update(self, values: np.ndarray) -> None:
        """Vectorized batch update (one pass, no per-row Python)."""
        v = np.asarray(values).ravel()
        if v.size == 0:
            return
        nan_mask = np.isnan(v)
        n_nan = int(nan_mask.sum())
        if n_nan:
            self.nan += n_nan
            v = v[~nan_mask]
            if v.size == 0:
                return
        self.posinf += int(np.count_nonzero(v == np.inf))
        self.neginf += int(np.count_nonzero(v == -np.inf))
        if self.lo is not None:
            self.below += int(np.count_nonzero(v < self.lo))
        if self.hi is not None:
            self.above += int(np.count_nonzero(v > self.hi))
        if len(self.edges):
            idx = np.searchsorted(self.edges, v, side="left")
            self.counts += np.bincount(idx, minlength=len(self.counts)
                                       ).astype(np.int64)
        else:
            self.counts[0] += v.size
        # Chan's batched Welford: merge the batch's exact moments into
        # the running ones (finite values only; an Inf would poison the
        # mean forever)
        fin = v[np.isfinite(v)]
        if fin.size:
            bm = float(fin.mean())
            bm2 = float(((fin - bm) ** 2).sum())
            n0, n1 = self.count, int(fin.size)
            delta = bm - self._mean
            tot = n0 + n1
            self._mean += delta * n1 / tot
            self._m2 += bm2 + delta * delta * n0 * n1 / tot
        self.count += int(v.size)

    def merge(self, other: "StreamSketch") -> "StreamSketch":
        if len(other.counts) != len(self.counts):
            raise ValueError("cannot merge sketches over different "
                             "edge ladders")
        self.counts += other.counts
        self.nan += other.nan
        self.posinf += other.posinf
        self.neginf += other.neginf
        self.below += other.below
        self.above += other.above
        n0, n1 = self.count, other.count
        if n1:
            delta = other._mean - self._mean
            tot = n0 + n1
            self._mean += delta * n1 / tot
            self._m2 += other._m2 + delta * delta * n0 * n1 / tot
        self.count += other.count
        return self

    # -- readings ------------------------------------------------------------

    @property
    def total(self) -> int:
        """All observations, NaNs included — the null-rate denominator."""
        return self.count + self.nan

    @property
    def mean(self) -> float:
        return self._mean if self.count else 0.0

    @property
    def var(self) -> float:
        return self._m2 / self.count if self.count else 0.0

    def null_rate(self) -> float:
        t = self.total
        return self.nan / t if t else 0.0

    def oor_rate(self) -> float:
        """Fraction of finite observations outside the training edge
        span (``None`` bounds contribute nothing)."""
        return (self.below + self.above) / self.count if self.count \
            else 0.0

    def dist_counts(self) -> np.ndarray:
        """The divergence vector: value-bucket counts plus one trailing
        missing slot — a NaN storm shifts the DISTRIBUTION, not just a
        side counter."""
        return np.concatenate([self.counts, [self.nan]])

    def quantile(self, q: float) -> float:
        """q in [0, 1]; piecewise-uniform estimate from the bucket
        counts (end buckets are clamped to their single known edge)."""
        total = int(self.counts.sum())
        if total <= 0 or len(self.edges) == 0:
            return self.mean
        rank = q * total
        cum = 0
        for i, c in enumerate(self.counts):
            nxt = cum + int(c)
            if nxt >= rank and c > 0:
                lo = self.edges[i - 1] if i > 0 else self.edges[0]
                hi = self.edges[i] if i < len(self.edges) \
                    else self.edges[-1]
                frac = (rank - cum) / c
                return float(lo + (hi - lo) * min(max(frac, 0.0), 1.0))
            cum = nxt
        return float(self.edges[-1])

    # -- snapshot / restore --------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able, MERGEABLE state: integer tallies plus a sparse
        ``{bucket-index: count}`` dict whose keys are the bit-stable
        ``str(i)`` indices (the ladder is fixed at profile-build time,
        so the keys mean the same thing in every process — the same
        guarantee ``LE_STRS`` gives the latency histograms)."""
        return {
            "n": self.count,
            "nan": self.nan,
            "posinf": self.posinf,
            "neginf": self.neginf,
            "below": self.below,
            "above": self.above,
            "mean": self._mean,
            "m2": self._m2,
            "buckets": {str(i): int(c)
                        for i, c in enumerate(self.counts) if c},
        }

    @classmethod
    def from_snapshot(cls, snap: Dict[str, Any],
                      edges: Sequence[float] = (),
                      lo: Optional[float] = None,
                      hi: Optional[float] = None) -> "StreamSketch":
        sk = cls(edges, lo, hi)
        sk.count = int(snap.get("n", 0) or 0)
        sk.nan = int(snap.get("nan", 0) or 0)
        sk.posinf = int(snap.get("posinf", 0) or 0)
        sk.neginf = int(snap.get("neginf", 0) or 0)
        sk.below = int(snap.get("below", 0) or 0)
        sk.above = int(snap.get("above", 0) or 0)
        sk._mean = float(snap.get("mean", 0.0) or 0.0)
        sk._m2 = float(snap.get("m2", 0.0) or 0.0)
        for k, c in (snap.get("buckets") or {}).items():
            i = int(k)
            if 0 <= i < len(sk.counts):
                sk.counts[i] = int(c)
        return sk


def merge_sketch_snapshots(snaps: Sequence[Dict[str, Any]]
                           ) -> Dict[str, Any]:
    """Key-wise sum of sketch snapshots: integer tallies and bucket
    counts sum EXACTLY (the merged buckets equal one sketch over the
    concatenated rows — the satellite guarantee), moments recombine via
    Chan's formula."""
    out: Dict[str, Any] = {"n": 0, "nan": 0, "posinf": 0, "neginf": 0,
                           "below": 0, "above": 0, "mean": 0.0,
                           "m2": 0.0, "buckets": {}}
    for snap in snaps:
        if not isinstance(snap, dict):
            continue
        for k in ("nan", "posinf", "neginf", "below", "above"):
            out[k] += int(snap.get(k, 0) or 0)
        for b, c in (snap.get("buckets") or {}).items():
            out["buckets"][b] = out["buckets"].get(b, 0) + int(c)
        n0, n1 = out["n"], int(snap.get("n", 0) or 0)
        if n1:
            m1 = float(snap.get("mean", 0.0) or 0.0)
            delta = m1 - out["mean"]
            tot = n0 + n1
            out["mean"] += delta * n1 / tot
            out["m2"] += float(snap.get("m2", 0.0) or 0.0) \
                + delta * delta * n0 * n1 / tot
        out["n"] = n0 + n1
    return out


# -- divergences --------------------------------------------------------------


def _smooth_probs(counts: np.ndarray, eps: float = EPS) -> np.ndarray:
    c = np.asarray(counts, np.float64)
    tot = c.sum()
    if tot <= 0:
        return np.full(c.shape, 1.0 / max(1, c.size))
    p = c / tot
    p = np.maximum(p, eps)
    return p / p.sum()


def psi(ref_counts: np.ndarray, live_counts: np.ndarray,
        eps: float = EPS) -> float:
    """Population Stability Index between two count vectors (same
    ladder): ``Σ (q - p) · ln(q / p)`` with epsilon-smoothed
    probabilities.  Conventional reading: <0.1 stable, 0.1–0.25
    moderate, >0.25 a shift worth paging on."""
    p = _smooth_probs(ref_counts, eps)
    q = _smooth_probs(live_counts, eps)
    return float(np.sum((q - p) * np.log(q / p)))


def js_divergence(ref_counts: np.ndarray, live_counts: np.ndarray,
                  eps: float = EPS) -> float:
    """Jensen–Shannon divergence (base 2 — bounded [0, 1]) between two
    count vectors on the same ladder.  Symmetric and bounded where PSI
    is neither; the report carries both."""
    p = _smooth_probs(ref_counts, eps)
    q = _smooth_probs(live_counts, eps)
    m = 0.5 * (p + q)
    kl_pm = np.sum(p * np.log2(p / m))
    kl_qm = np.sum(q * np.log2(q / m))
    return float(0.5 * kl_pm + 0.5 * kl_qm)


# -- matrix sketch ------------------------------------------------------------


class MatrixSketch:
    """One :class:`StreamSketch` per feature column of an ``(n, f)``
    batch.  ``update`` computes the NaN mask once for the whole matrix
    and does one searchsorted+bincount per feature — the vectorized
    form the scoring hot path pays for (behind the monitor's duty-cycle
    gate)."""

    def __init__(self, edges_list: Sequence[Sequence[float]],
                 los: Optional[Sequence[Optional[float]]] = None,
                 his: Optional[Sequence[Optional[float]]] = None):
        f = len(edges_list)
        los = los if los is not None else [None] * f
        his = his if his is not None else [None] * f
        self.features = [StreamSketch(edges_list[j], los[j], his[j])
                         for j in range(f)]

    @property
    def num_features(self) -> int:
        return len(self.features)

    def update(self, X: np.ndarray) -> int:
        X = np.asarray(X)
        if X.ndim != 2 or X.shape[1] != self.num_features:
            raise ValueError(
                f"MatrixSketch.update expects (n, {self.num_features}) "
                f"matrices, got {X.shape}")
        for j, sk in enumerate(self.features):
            sk.update(X[:, j])
        return int(X.shape[0])

    def merge(self, other: "MatrixSketch") -> "MatrixSketch":
        if other.num_features != self.num_features:
            raise ValueError("feature-count mismatch in MatrixSketch "
                             "merge")
        for sk, osk in zip(self.features, other.features):
            sk.merge(osk)
        return self

    def snapshot(self) -> List[Dict[str, Any]]:
        return [sk.snapshot() for sk in self.features]


# -- reference profile --------------------------------------------------------


class ReferenceProfile:
    """The fit-time "what the training data looked like" artifact:
    per-feature edge ladders + sketch snapshots over the training
    matrix, a prediction-margin ladder + sketch, and feature names —
    persisted beside the model (the registry stores it digest-verified
    like the model file) and loaded by every drift monitor as the
    comparison baseline."""

    def __init__(self, feature_edges: Sequence[Sequence[float]],
                 feature_sketches: Sequence[Dict[str, Any]],
                 margin_edges: Sequence[float],
                 margin_sketch: Dict[str, Any],
                 feature_names: Optional[Sequence[str]] = None,
                 meta: Optional[Dict[str, Any]] = None):
        self.feature_edges = [np.asarray(e, np.float64)
                              for e in feature_edges]
        self.feature_sketches = [dict(s) for s in feature_sketches]
        self.margin_edges = np.asarray(margin_edges, np.float64)
        self.margin_sketch = dict(margin_sketch)
        f = len(self.feature_edges)
        self.feature_names = list(feature_names) if feature_names \
            else [f"f{j}" for j in range(f)]
        if len(self.feature_names) != f:
            raise ValueError(
                f"{len(self.feature_names)} names for {f} features")
        self.meta = dict(meta or {})

    @property
    def num_features(self) -> int:
        return len(self.feature_edges)

    def feature_span(self, j: int):
        """(lo, hi) of the binned training support — the
        out-of-training-range bounds live sketches count against."""
        e = self.feature_edges[j]
        if len(e) == 0:
            return None, None
        return float(e[0]), float(e[-1])

    def live_matrix_sketch(self) -> MatrixSketch:
        """A fresh, empty live sketch on this profile's ladders."""
        spans = [self.feature_span(j)
                 for j in range(self.num_features)]
        return MatrixSketch(self.feature_edges,
                            [s[0] for s in spans],
                            [s[1] for s in spans])

    def live_margin_sketch(self) -> StreamSketch:
        return StreamSketch(self.margin_edges)

    def ref_feature(self, j: int) -> StreamSketch:
        lo, hi = self.feature_span(j)
        return StreamSketch.from_snapshot(
            self.feature_sketches[j], self.feature_edges[j], lo, hi)

    def ref_margin(self) -> StreamSketch:
        return StreamSketch.from_snapshot(self.margin_sketch,
                                          self.margin_edges)

    # -- persistence ---------------------------------------------------------

    def to_json(self) -> str:
        return json.dumps({
            "format": PROFILE_FORMAT,
            "feature_names": self.feature_names,
            "feature_edges": [e.tolist() for e in self.feature_edges],
            "feature_sketches": self.feature_sketches,
            "margin_edges": self.margin_edges.tolist(),
            "margin_sketch": self.margin_sketch,
            "meta": self.meta,
        }, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "ReferenceProfile":
        d = json.loads(text)
        if d.get("format") != PROFILE_FORMAT:
            raise ValueError(
                f"reference-profile format {d.get('format')!r} not "
                f"supported (want {PROFILE_FORMAT})")
        return cls(d["feature_edges"], d["feature_sketches"],
                   d["margin_edges"], d["margin_sketch"],
                   feature_names=d.get("feature_names"),
                   meta=d.get("meta"))


def build_reference_profile(bins: np.ndarray, mapper,
                            margins: Optional[np.ndarray] = None,
                            feature_names: Optional[Sequence[str]]
                            = None,
                            max_edges: int = MAX_PROFILE_EDGES,
                            margin_buckets: int = 32,
                            meta: Optional[Dict[str, Any]] = None
                            ) -> ReferenceProfile:
    """Build the fit-time profile from the BINNED training matrix — no
    raw-feature pass needed.

    The bin ladder IS the bucketing rule: ``transform`` assigned fine
    bin ``b`` via ``searchsorted(upper_bounds, v, side="left")``, so
    the count of training values in a coarse bucket (coarse edges a
    SUBSET of the fine bounds) is exactly the sum of its fine-bin
    counts — per-feature ``bincount`` over the uint8 column plus an
    index regroup, and the missing bin maps to the NaN tally.
    Categorical features get an empty ladder (drift for them reads
    through the null-rate/mean channel only).

    ``margins``: the training-set prediction margins (any shape;
    raveled) — the prediction-distribution baseline.  Edges are the
    interior ``margin_buckets``-quantiles of the margins.
    """
    bins = np.asarray(bins)
    n, f = bins.shape
    edges_list: List[np.ndarray] = []
    sketches: List[Dict[str, Any]] = []
    for j in range(f):
        ub = mapper.upper_bounds[j]
        if mapper.is_categorical(j) or len(ub) == 0:
            edges = np.empty(0, np.float64)
        else:
            edges = downsample_edges(ub, max_edges)
        lo, hi = ((float(edges[0]), float(edges[-1]))
                  if len(edges) else (None, None))
        sk = StreamSketch(edges, lo, hi)
        col = np.ascontiguousarray(bins[:, j])
        fine = np.bincount(col, minlength=mapper.num_total_bins
                           ).astype(np.int64)
        sk.nan = int(fine[mapper.missing_bin])
        if mapper.is_categorical(j):
            # category identity occupies the fine bins; the coarse
            # ladder is empty → everything finite in bucket 0
            finite = int(fine[:mapper.missing_bin].sum())
            sk.counts[0] = finite
            sk.count = finite
        else:
            value_bins = fine[:len(ub) + 1]
            if len(edges):
                # fine bin b (first bound >= v is ub[b]) rolls up to
                # the first coarse edge position >= b
                idx = np.searchsorted(ub, edges, side="left")
                coarse_of_fine = np.searchsorted(
                    idx, np.arange(len(ub) + 1), side="left")
                sk.counts += np.bincount(
                    coarse_of_fine, weights=value_bins,
                    minlength=len(sk.counts)).astype(np.int64)
            else:
                sk.counts[0] = int(value_bins.sum())
            sk.count = int(value_bins.sum())
        edges_list.append(edges)
        sketches.append(sk.snapshot())
    if margins is not None and np.asarray(margins).size:
        mg = np.asarray(margins, np.float64).ravel()
        mg = mg[np.isfinite(mg)]
        qs = np.linspace(0.0, 1.0, margin_buckets + 1)[1:-1]
        medges = np.unique(np.quantile(mg, qs)) if mg.size \
            else np.empty(0, np.float64)
        msk = StreamSketch(medges)
        msk.update(mg)
    else:
        medges = np.empty(0, np.float64)
        msk = StreamSketch(medges)
    return ReferenceProfile(
        edges_list, sketches, medges, msk.snapshot(),
        feature_names=feature_names,
        meta={"n_rows": int(n), "created": round(time.time(), 3),
              **(meta or {})})
