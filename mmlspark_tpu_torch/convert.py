"""Carry fitted state across from the JAX package, as numpy arrays.

The tests fit the reference, take its state apart into numpy arrays and
build the port's objects from them here, so the same forest can run
through both packages.  Nothing here imports the reference: its state
arrives as arrays and plain values.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .device import DeviceLike
from .gbdt.binning import BinMapper
from .gbdt.booster import Booster, HostTree
from .gbdt.grower import TreeArrays


def bin_mapper_from_arrays(upper_bounds: Sequence[np.ndarray],
                           has_missing: np.ndarray, num_total_bins: int,
                           missing_bin: int) -> BinMapper:
    """A :class:`BinMapper` from a numeric mapper's bounds and its
    missing-bin layout."""
    return BinMapper(
        upper_bounds=[np.asarray(ub, np.float64) for ub in upper_bounds],
        has_missing=np.asarray(has_missing, bool),
        num_total_bins=int(num_total_bins), missing_bin=int(missing_bin))


def booster_from_arrays(trees: List[Dict[str, np.ndarray]], *,
                        objective: str, init_score: float = 0.0,
                        num_class: int = 1,
                        mapper: Optional[BinMapper] = None,
                        feature_names: Optional[List[str]] = None,
                        feature_infos: Optional[List[str]] = None,
                        max_feature_idx: Optional[int] = None,
                        params: Optional[Dict[str, str]] = None,
                        device: DeviceLike = "cuda") -> Booster:
    """A port :class:`Booster` from the reference's fitted state: one dict
    per tree holding the ``HostTree`` fields, the objective string and
    the init score.  With ``mapper``, the model's ``feature_infos`` and
    feature count come from the bin bounds."""
    if mapper is not None:
        feature_infos = feature_infos or mapper.feature_infos()
        if max_feature_idx is None:
            max_feature_idx = mapper.num_features - 1
    host = [HostTree(**t) for t in trees]
    return Booster(host, num_class=num_class, objective_str=objective,
                   init_score=init_score, feature_names=feature_names,
                   feature_infos=feature_infos,
                   max_feature_idx=max_feature_idx, params=params,
                   device=device)


def tree_arrays_from_numpy(**fields: np.ndarray) -> TreeArrays:
    """A grower :class:`TreeArrays` (host tensors) from the reference's
    ``TreeArrays`` fields as numpy arrays.  The categorical bitset words
    are widened to int64."""
    out = {}
    for name in TreeArrays._fields:
        a = np.asarray(fields[name])
        if a.dtype == np.uint32:
            a = a.astype(np.int64)
        out[name] = torch.from_numpy(np.array(a))
    return TreeArrays(**out)
