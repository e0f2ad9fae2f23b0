"""Exclusive Feature Bundling (EFB) — LightGBM's sparse-feature fusion.

The port's own copy of ``mmlspark_tpu/gbdt/efb.py`` (numpy only): the
same plan, bundled matrix and expansion maps, bit for bit, from the same
inputs (the bundling sample is ``np.random.default_rng(seed).choice``).
The grower expands bundle histograms and decodes split columns with
these maps (``grower.EFBArrays``).

Ke et al. 2017 §4 / LightGBM ``enable_bundle``: features that are (near-)
mutually exclusive — at most one of them non-default per row, the shape
one-hot blocks take — are merged into a single **bundle** column whose
value encodes *which* member is non-default and *its* bin.  Histogram
construction then touches ``G`` bundle columns instead of ``f`` feature
columns; per-feature histograms are recovered exactly by slicing the
bundle histogram and reconstituting each member's default bin from leaf
totals (reference path: LightGBM ``src/io/dataset.cc`` FastFeatureBundling
+ ``FeatureGroup``; expected, UNVERIFIED).  Trees still reference
ORIGINAL features — EFB is a storage/compute optimization, invisible to
split finding, model export, and prediction.

Encoding of a bundle with members ``j`` (widths ``w_j = nb_j + 1``, the
``+1`` slot carrying the member's NaN/missing bin) at offsets ``off_j``
(cumulative, starting at 1):

* all members default        → 0
* member j at value bin b    → off_j + b          (b != default_j)
* member j missing (NaN)     → off_j + nb_j

Rows violating exclusivity (allowed up to ``max_conflict_rate``) keep the
first non-default member — the same information loss LightGBM accepts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass(frozen=True)
class BundleSpec:
    """Static bundling plan.  Per-feature arrays are tuples (the spec is
    hashable and immutable)."""
    bundles: Tuple[Tuple[int, ...], ...]   # bundle -> member feature ids
    bundle_of: Tuple[int, ...]             # feature -> bundle id
    off_of: Tuple[int, ...]                # feature -> offset in bundle
    nb_of: Tuple[int, ...]                 # feature -> value-bin count
    default_of: Tuple[int, ...]            # feature -> default bin

    @property
    def num_bundles(self) -> int:
        return len(self.bundles)

    @property
    def num_features(self) -> int:
        return len(self.bundle_of)

    @property
    def is_trivial(self) -> bool:
        """True when no bundle holds more than one feature."""
        return all(len(b) <= 1 for b in self.bundles)


def find_bundles(bins: np.ndarray, nb_of: List[int], missing_bin: int,
                 max_conflict_rate: float = 0.0,
                 max_bundle_bins: int = 256,
                 sample_cnt: int = 50_000,
                 seed: int = 0) -> BundleSpec:
    """Greedy bundling plan from a binned sample (GreedyBundle analog).

    ``nb_of[j]``: value bins actually used by feature j (excl. missing).
    Features are scanned by non-default density (densest first, LightGBM
    order); one goes into the first bundle where (a) the added pairwise
    conflicts stay within ``max_conflict_rate`` of the sample and (b) the
    bundle's total encoded width stays below ``max_bundle_bins``.
    """
    n, f = bins.shape
    if n > sample_cnt:
        idx = np.random.default_rng(seed).choice(n, sample_cnt,
                                                 replace=False)
        idx.sort()
        sample = bins[idx]
    else:
        sample = bins
    sn = sample.shape[0]
    default_of = []
    for j in range(f):
        col = sample[:, j]
        vals, counts = np.unique(col[col != missing_bin],
                                 return_counts=True)
        default_of.append(int(vals[np.argmax(counts)]) if len(vals)
                          else 0)
    default_arr = np.asarray(default_of)
    nondef = sample != default_arr[None, :]              # (sn, f) bool
    # pairwise conflict counts in one matmul (f x f fits easily for the
    # few-thousand-feature datasets EFB targets)
    nd = nondef.astype(np.float32)
    conflicts = nd.T @ nd                                 # (f, f)
    density = nd.sum(axis=0)

    budget = max_conflict_rate * sn
    order = np.argsort(-density, kind="stable")
    bundles: List[List[int]] = []
    bundle_conflict = []                                   # used budget
    widths = []                                            # encoded bins
    bundle_of = np.zeros(f, np.int64)
    for j in order:
        w_j = nb_of[j] + 1                                 # + missing slot
        placed = False
        for g, members in enumerate(bundles):
            add = float(sum(conflicts[j, m] for m in members))
            if (bundle_conflict[g] + add <= budget
                    and widths[g] + w_j < max_bundle_bins):
                members.append(int(j))
                bundle_conflict[g] += add
                widths[g] += w_j
                bundle_of[j] = g
                placed = True
                break
        if not placed:
            bundles.append([int(j)])
            bundle_conflict.append(0.0)
            widths.append(1 + w_j)        # slot 0 = all-default
            bundle_of[j] = len(bundles) - 1

    off_of = np.zeros(f, np.int64)
    eff_nb = np.asarray(nb_of, np.int64).copy()
    for g, members in enumerate(bundles):
        if len(members) == 1:
            # solo features keep IDENTITY encoding (offset 0, nb spanning
            # the whole bin range so the missing bin passes through) —
            # a dense 255-bin feature re-encoded with an offset would
            # overflow the uint8 bundle range
            eff_nb[members[0]] = max_bundle_bins - 1
            off_of[members[0]] = 0
            continue
        off = 1
        for j in members:
            off_of[j] = off
            off += nb_of[j] + 1
    return BundleSpec(
        bundles=tuple(tuple(m) for m in bundles),
        bundle_of=tuple(int(x) for x in bundle_of),
        off_of=tuple(int(x) for x in off_of),
        nb_of=tuple(int(x) for x in eff_nb),
        default_of=tuple(int(x) for x in default_of))


def bundle_matrix(bins: np.ndarray, spec: BundleSpec,
                  missing_bin: int) -> np.ndarray:
    """(n, f) binned matrix → (n, G) bundled matrix (uint8).

    First non-default member wins on (rare, budgeted) conflict rows.  The
    reference's column loop, run on a feature-major copy (each feature's
    and each bundle's rows contiguous), which gives the same matrix."""
    n = bins.shape[0]
    cols = np.ascontiguousarray(bins.T)
    out = np.zeros((spec.num_bundles, n), np.uint8)
    claimed = np.zeros((spec.num_bundles, n), bool)
    solo = {g for g, m in enumerate(spec.bundles) if len(m) == 1}
    for j in range(spec.num_features):
        g = spec.bundle_of[j]
        col = cols[j]
        if g in solo:
            out[g] = col.astype(np.uint8)
            continue
        default, nb, off = (spec.default_of[j], spec.nb_of[j],
                            spec.off_of[j])
        enc = np.where(col == missing_bin, off + nb,
                       off + col.astype(np.int64))
        nondef = (col != default) & ~claimed[g]
        out[g, nondef] = enc[nondef].astype(np.uint8)
        claimed[g] |= (col != default)
    return np.ascontiguousarray(out.T)


def expansion_arrays(spec: BundleSpec, num_bins: int, missing_bin: int):
    """Static numpy index maps for histogram expansion and split-column
    reconstruction.

    Returns ``(gather_idx, valid, bundle_of, off_of, nb_of, default_of)``
    where ``gather_idx[j, b]`` flat-indexes (bundle, bundle_bin) for
    original feature j's bin b (missing bin included), and ``valid``
    masks bins feature j doesn't use."""
    f, B = spec.num_features, num_bins
    gather_idx = np.zeros((f, B), np.int64)
    valid = np.zeros((f, B), bool)
    solo = {g for g, m in enumerate(spec.bundles) if len(m) == 1}
    for j in range(spec.num_features):
        g, off, nb = spec.bundle_of[j], spec.off_of[j], spec.nb_of[j]
        if g in solo:
            # identity mapping: the bundle column IS the feature column,
            # so every bin (default and missing included) carries its own
            # mass and the deficit correction contributes exactly zero
            gather_idx[j] = g * B + np.arange(B)
            valid[j] = True
            continue
        for b in range(nb):
            gather_idx[j, b] = g * B + off + b
            valid[j, b] = True
        gather_idx[j, missing_bin] = g * B + off + nb
        valid[j, missing_bin] = True
        # the default bin's slot (off + default) never receives rows —
        # its mass is reconstituted from leaf totals by the caller
    return (gather_idx, valid,
            np.asarray(spec.bundle_of, np.int32),
            np.asarray(spec.off_of, np.int32),
            np.asarray(spec.nb_of, np.int32),
            np.asarray(spec.default_of, np.int32))
