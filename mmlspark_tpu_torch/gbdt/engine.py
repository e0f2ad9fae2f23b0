"""Boosting loop — serial ``boosting="gbdt"`` training on one device.

The port's counterpart of the serial branch of
``mmlspark_tpu/gbdt/engine.py`` (``train`` → ``_train_impl`` →
``_boost_scan``): per iteration, (grad, hess) from the objective, one tree
from :func:`..grower.grow_tree`, and the score update.  Bagging and
feature-fraction draws use numpy ``default_rng`` streams seeded as the
reference seeds them, so both packages draw the same rows and features.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .binning import BinMapper
from .booster import Booster, host_tree_from_arrays
from .grower import GrowerConfig, apply_shrinkage, grow_tree
from .objectives import Objective, fma32

log = logging.getLogger("mmlspark_tpu_torch.gbdt")


@dataclass
class TrainParams:
    """Engine-level hyper-parameters (the reference's subset for serial
    gbdt)."""
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_depth: int = -1
    max_bin: int = 255
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    feature_fraction: float = 1.0
    boost_from_average: bool = True
    seed: int = 42
    bagging_seed: int = 3
    boosting: str = "gbdt"
    histogram_method: str = "auto"
    verbosity: int = 1


def _draw_feature_fraction(rng, fi_base: np.ndarray, f: int,
                           feature_fraction: float) -> np.ndarray:
    """One per-iteration featureFraction mask draw (the reference's draw)."""
    k_keep = max(1, int(np.ceil(f * feature_fraction)))
    sel = rng.choice(f, size=k_keep, replace=False)
    fi_it = fi_base.copy()
    fi_it[:, 0] = 0.0
    fi_it[sel, 0] = 1.0
    return fi_it


def train(bins, labels: np.ndarray, weights: Optional[np.ndarray],
          mapper: BinMapper, objective: Objective, params: TrainParams,
          feature_names: Optional[List[str]] = None,
          device: DeviceLike = "cuda") -> Booster:
    """Train a forest.  ``bins``: ``(n, f)`` bin codes — a tensor (the fit
    runs on its device) or a numpy array (moved to ``device``)."""
    if params.boosting != "gbdt":
        raise NotImplementedError(
            f"boostingType={params.boosting!r} is not ported yet; the port "
            "trains 'gbdt' (ROADMAP.md, left out of the first slice)")
    if objective.num_model_per_iteration != 1:
        raise NotImplementedError("multiclass training is not ported yet")
    if isinstance(bins, torch.Tensor):
        dev = resolve_device(bins.device)
    else:
        dev = resolve_device(device)
        bins = torch.as_tensor(np.asarray(bins), dtype=mapper.bin_dtype)
    bins = bins.to(dev).contiguous()
    n, f = bins.shape
    labels = np.asarray(labels)
    rng = np.random.default_rng(params.seed)
    bag_rng = np.random.default_rng(params.bagging_seed)

    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    objective.prepare(labels, w)
    init = objective.init_score(labels, w) if params.boost_from_average \
        else 0.0
    cfg = GrowerConfig(
        num_leaves=params.num_leaves, max_depth=params.max_depth,
        num_bins=mapper.num_total_bins, lambda_l1=params.lambda_l1,
        lambda_l2=params.lambda_l2, min_data_in_leaf=params.min_data_in_leaf,
        min_sum_hessian_in_leaf=params.min_sum_hessian_in_leaf,
        min_gain_to_split=params.min_gain_to_split,
        hist_method=params.histogram_method)
    labels_d = torch.as_tensor(labels, dtype=torch.float32, device=dev)
    weights_d = torch.as_tensor(w, dtype=torch.float32, device=dev)
    scores = torch.full((n,), init, dtype=torch.float32, device=dev)
    fi_base = np.zeros((f, 3), np.float32)
    fi_base[:, 0] = 1.0
    use_bag = params.bagging_freq > 0 and params.bagging_fraction < 1.0
    use_ff = params.feature_fraction < 1.0

    trees = []
    stop_iter = params.num_iterations
    bag = torch.ones(n, dtype=torch.float32, device=dev)
    for it in range(params.num_iterations):
        if use_bag and it % params.bagging_freq == 0:
            bag = torch.as_tensor(
                (bag_rng.random(n) < params.bagging_fraction
                 ).astype(np.float32), device=dev)
        fi = (_draw_feature_fraction(rng, fi_base, f,
                                     params.feature_fraction)
              if use_ff else fi_base)
        g, h = objective.grad_hess(scores, labels_d, weights_d)
        gh = torch.stack([g * bag, h * bag, bag], dim=1)
        tree, row_leaf = grow_tree(bins, gh, fi, cfg)
        # the reference's ``scores + lr * leaf`` compiles to an FMA
        scores = fma32(tree.leaf_value.to(dev)[row_leaf],
                       params.learning_rate, scores)
        trees.append(host_tree_from_arrays(
            apply_shrinkage(tree, params.learning_rate), mapper))
        if int(tree.num_leaves) <= 1:
            # LightGBM stops at the first iteration that cannot split;
            # the reference keeps that stump and records it as the stop
            if params.verbosity > 0:
                log.info("No further splits with positive gain; stopping "
                         "at iteration %d", it)
            stop_iter = it
            break

    if trees and params.boost_from_average and init != 0.0:
        # bake the init score into the first tree, as LightGBM does
        trees[0].leaf_value = trees[0].leaf_value + init
        trees[0].internal_value = trees[0].internal_value + init
    engine_params = {
        "boosting": params.boosting,
        "objective": objective.model_str,
        "num_iterations": str(stop_iter),
        "learning_rate": f"{params.learning_rate:g}",
        "num_leaves": str(params.num_leaves),
        "max_depth": str(params.max_depth),
        "max_bin": str(params.max_bin),
    }
    return Booster(trees, num_class=1, objective_str=objective.model_str,
                   init_score=0.0, feature_names=feature_names,
                   feature_infos=mapper.feature_infos(),
                   max_feature_idx=f - 1, params=engine_params, device=dev)
