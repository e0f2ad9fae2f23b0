"""Boosting loop — ``boosting="gbdt"`` training, serial or on a mesh.

The port's counterpart of ``mmlspark_tpu/gbdt/engine.py`` (``train`` →
``_train_impl`` → ``_boost_scan`` / ``_boost_scan_multi`` serially,
``_train_distributed`` on a mesh): per iteration, (grad, hess) from the
objective, one tree per class from :func:`..grower.grow_tree_sharded`
(iteration-major, class-minor, the model file's order), and the score
updates.  A serial fit is
the one-device case of the mesh loop (:mod:`.distributed`); the mesh's
shape decides between the data (or voting), feature and data+feature
learners.  Bagging and feature-fraction draws use numpy ``default_rng``
streams seeded as the reference seeds them, so both packages draw the
same rows and features: on a mesh the bag draws exactly n randoms and
scatters them into the padded layout, and feature fraction draws over the
original f features, the pad features staying masked, as the reference
does.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from ..core.mesh import Mesh, pad_to_multiple
from ..device import DeviceLike, resolve_device
from ..ops.collectives import resolve_collective
from .binning import BinMapper
from .booster import Booster, host_tree_from_arrays
from .distributed import (boost_iteration, check_parallelism,
                          prepare_arrays, sharded_cfg)
from .grower import GrowerConfig, apply_shrinkage, collective_schedule
from .objectives import Objective

log = logging.getLogger("mmlspark_tpu_torch.gbdt")

#: What the last fit in this process ran: the histogram method, the
#: collective and why a ring request was downgraded, the devices' type,
#: and the per-tree collective schedule.
last_fit_info: Dict[str, str] = {}


@dataclass
class TrainParams:
    """Engine-level hyper-parameters (the reference's subset for gbdt)."""
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
    parallelism: str = "data"
    collective: str = "auto"
    #: PV-Tree voting: features each shard votes per split (LightGBM
    #: top_k); read only when ``parallelism == "voting"``
    top_k: int = 20
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    verbosity: int = 1


def _resolve_collective_cfg(params: TrainParams, mesh: Optional[Mesh]):
    """``params.collective`` → ``(collective, downgrade reason)``.  ``auto``
    and ``psum`` are the shard-order sum; ``ring`` needs more than one data
    shard (else reason ``single_data_shard``) and a mesh without a feature
    axis (else ``feature_axis``), and otherwise keeps psum, as the
    reference does.  Voting rides the ring on a data-only mesh.  There is
    no compile-probe downgrade: on the card a ring kernel that does not
    build or launch raises."""
    shards = 1 if mesh is None else mesh.data
    collective = resolve_collective(params.collective, shards)
    if params.collective != "ring":
        return collective, "none"
    reason = ("single_data_shard" if collective == "psum"
              else "feature_axis" if mesh.feature > 1 else "none")
    if reason != "none":
        log.info("collective='ring' needs a multi-shard data-parallel or "
                 "voting fit; this fit keeps psum (%s)", reason)
        return "psum", reason
    return collective, "none"


def _record_fit_resolution(cfg: GrowerConfig, collective: str,
                           downgrade: str, sched: dict,
                           backend: str) -> None:
    last_fit_info.clear()
    last_fit_info.update(
        histogram_method=cfg.hist_method, collective=collective,
        collective_downgrade=downgrade, backend=backend,
        data_shards=str(cfg.data_axis_size),
        feature_shards=str(cfg.feature_axis_size),
        voting_k=str(cfg.voting_k),
        collective_count_per_tree=str(sched["count"]),
        collective_payload_bytes_per_tree=str(sched["payload_bytes"]),
        collective_payload_vs_dense=(
            f"{sched['payload_bytes'] / max(1, sched['dense_payload_bytes']):.6f}"))


def _feat_info_from_mapper(mapper: BinMapper, f: int) -> np.ndarray:
    """``(f, 3)`` [mask, is_cat, n_value_bins] from the fitted mapper."""
    fi = np.zeros((f, 3), np.float32)
    fi[:, 0] = 1.0
    if mapper.has_categorical:
        fi[:, 1] = mapper.categorical.astype(np.float32)
        fi[:, 2] = [mapper.feature_num_bins(j) for j in range(f)]
    return fi


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
          device: DeviceLike = "cuda", mesh: Optional[Mesh] = None
          ) -> Booster:
    """Train a forest.  ``bins``: ``(n, f)`` bin codes — a tensor or a
    numpy array.  Without a mesh the fit runs on the tensor's device (an
    array moves to ``device``).  With a mesh of more than one device the
    rows are sharded over its data axis and the features over its feature
    axis (``params.parallelism="voting"`` selects PV-Tree voting on the
    data axis); a one-device mesh fits serially on its device."""
    check_parallelism(params.parallelism)
    if params.boosting != "gbdt":
        raise NotImplementedError(
            f"boostingType={params.boosting!r} is not ported yet; the port "
            "trains 'gbdt' (ROADMAP.md, left out of the first slice)")
    if mesh is not None:
        dev = mesh.devices[0]
    elif isinstance(bins, torch.Tensor):
        dev = resolve_device(bins.device)
    else:
        dev = resolve_device(device)
    if not isinstance(bins, torch.Tensor):
        bins = torch.as_tensor(np.asarray(bins), dtype=mapper.bin_dtype)
    use_mesh = mesh is not None and len(mesh) > 1
    devices = mesh.devices if use_mesh else (dev,)
    bins = bins.to(dev).contiguous()
    n, f = bins.shape
    labels = np.asarray(labels)
    rng = np.random.default_rng(params.seed)
    bag_rng = np.random.default_rng(params.bagging_seed)

    w = np.ones(n) if weights is None else np.asarray(weights, np.float64)
    objective.prepare(labels, w)
    init = objective.init_score(labels, w) if params.boost_from_average \
        else 0.0
    shard_mesh = mesh if use_mesh else None
    collective, downgrade = _resolve_collective_cfg(params, shard_mesh)
    cfg = GrowerConfig(
        num_leaves=params.num_leaves, max_depth=params.max_depth,
        num_bins=mapper.num_total_bins, lambda_l1=params.lambda_l1,
        lambda_l2=params.lambda_l2, min_data_in_leaf=params.min_data_in_leaf,
        min_sum_hessian_in_leaf=params.min_sum_hessian_in_leaf,
        min_gain_to_split=params.min_gain_to_split,
        hist_method=params.histogram_method, collective=collective,
        voting_k=params.top_k if params.parallelism == "voting" else 0,
        use_categorical=mapper.has_categorical,
        cat_smooth=params.cat_smooth, cat_l2=params.cat_l2,
        max_cat_threshold=params.max_cat_threshold,
        max_cat_to_onehot=params.max_cat_to_onehot)
    cfg = sharded_cfg(shard_mesh, cfg)
    if cfg.voting_k > 0 and cfg.data_axis_size > 1 \
            and cfg.feature_axis_size > 1:
        raise ValueError("parallelism='voting' runs on a mesh without a "
                         f"feature axis; got {mesh.shape}")
    F = cfg.feature_axis_size
    _record_fit_resolution(
        cfg, collective, downgrade,
        collective_schedule(cfg, f, n_rows_local=-(-n // cfg.data_axis_size)),
        dev.type)
    K = objective.num_model_per_iteration
    arrays = prepare_arrays(bins, labels, w, devices, init, F, K)
    # pad features (to a multiple of the feature axis) stay masked out
    fi_base = np.zeros((pad_to_multiple(f, F), 3), np.float32)
    fi_base[:f] = _feat_info_from_mapper(mapper, f)
    use_bag = params.bagging_freq > 0 and params.bagging_fraction < 1.0
    use_ff = params.feature_fraction < 1.0

    trees = []
    stop_iter = params.num_iterations
    bag = [torch.ones(arrays.rows_per_shard, dtype=torch.float32, device=d)
           for d in devices]
    for it in range(params.num_iterations):
        if use_bag and it % params.bagging_freq == 0:
            # exactly n randoms, scattered into the padded layout (pad
            # rows stay 0), so the stream matches a serial fit's
            row = np.zeros(arrays.n_padded, np.float32)
            row[:n] = bag_rng.random(n) < params.bagging_fraction
            bag = arrays.split(row, devices)
        fi = (_draw_feature_fraction(rng, fi_base, f,
                                     params.feature_fraction)
              if use_ff else fi_base)
        grown = boost_iteration(arrays, bag, fi, objective, cfg,
                                params.learning_rate, shard_mesh)
        trees += [host_tree_from_arrays(
            apply_shrinkage(tree, params.learning_rate), mapper)
            for tree in grown]
        if all(int(tree.num_leaves) <= 1 for tree in grown):
            # LightGBM stops at the first iteration in which no class's
            # tree can split; the reference keeps those stumps and
            # records the iteration as the stop
            if params.verbosity > 0:
                log.info("No further splits with positive gain; stopping "
                         "at iteration %d", it)
            stop_iter = it
            break

    if trees and params.boost_from_average and init != 0.0:
        # bake the init score into the first tree of each class, as
        # LightGBM does
        for t in trees[:K]:
            t.leaf_value = t.leaf_value + init
            t.internal_value = t.internal_value + init
    engine_params = {
        "boosting": params.boosting,
        "objective": objective.model_str,
        "num_iterations": str(stop_iter),
        "learning_rate": f"{params.learning_rate:g}",
        "num_leaves": str(params.num_leaves),
        "max_depth": str(params.max_depth),
        "max_bin": str(params.max_bin),
    }
    return Booster(trees, num_class=K, objective_str=objective.model_str,
                   init_score=0.0, feature_names=feature_names,
                   feature_infos=mapper.feature_infos(),
                   max_feature_idx=f - 1, params=engine_params, device=dev)
