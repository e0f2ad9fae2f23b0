"""Distributed GBDT training over a mesh: the data, voting, feature and
data+feature learners.

The port's counterpart of ``mmlspark_tpu/gbdt/distributed.py``.  The
reference runs the whole boost step under ``shard_map``; the port keeps
its single controller and drives the devices of a
:class:`..core.mesh.Mesh` (a ``data × feature`` grid) in lockstep from one
host loop:

* :func:`prepare_arrays` lays the rows and features out as the reference
  does — rows padded at the end to a multiple of the data axis, data shard
  ``d`` holding rows ``[d·S, (d+1)·S)``, pad rows with zero bins, label
  and weight and ``real = 0``; features padded at the end to a multiple of
  the feature axis with constant-zero columns (masked out of every split),
  feature slice ``j`` holding ``f_local`` consecutive columns — so both
  packages grow the same forests;
* :func:`boost_iteration` is the iteration body of the reference's
  ``make_boost_scan`` (gbdt) and ``make_multiclass_scan``: per device the
  objective's (grad, hess) masked by bag and ``real``, then per class
  one tree grown over the mesh (:func:`.grower.grow_tree_sharded`) and
  each device's score update;
* :func:`goss_iteration` is the iteration body of the reference's
  ``_boost_scan_goss`` (serial) and ``make_goss_scan`` (mesh): each data
  shard samples its own rows (:func:`goss_sample`), the sampled rows
  train the iteration's trees, and every row's score moves by a binned
  walk of each tree.

``parallelism`` maps onto the learner as in the reference: ``data`` and
``voting`` shard rows (voting keeps histograms local and reduces only the
voted columns, ``GrowerConfig.voting_k``), ``feature`` shards features,
``data+feature`` both; the mesh's shape decides which axes a fit has.  A
serial fit is the one-device case of the same code.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.mesh import Mesh, build_mesh, pad_to_multiple
from ..ops.threefry import fold_in, uniform
from .grower import (GrowerConfig, TreeArrays, grow_tree_sharded,
                     leaf_index_binned)
from .objectives import Objective, fma32, sum_last

VALID_PARALLELISM = ("serial", "data", "feature", "data+feature", "voting")


def check_parallelism(parallelism: str) -> None:
    """Raise for an unknown ``parallelism`` value."""
    if parallelism not in VALID_PARALLELISM:
        raise ValueError(f"Unknown parallelism {parallelism!r}; "
                         f"valid: {VALID_PARALLELISM}")


def resolve_mesh(parallelism: str, mesh: Optional[Mesh] = None) -> Mesh:
    """The mesh a ``parallelism`` value implies (the reference's layouts):
    ``mesh`` when given, else the host's n CUDA cards as 1 × n
    (``"feature"``), n/2 × 2 (``"data+feature"``, n even), the first card
    alone (``"serial"``), or n × 1 (``"data"``, ``"voting"``, and the
    feature layouts on one card or an odd count)."""
    check_parallelism(parallelism)
    if mesh is not None:
        return mesh
    full = build_mesh()
    n = len(full)
    if parallelism == "serial":
        return Mesh(full.devices[:1])
    if parallelism == "feature" and n > 1:
        return build_mesh(1, n, full.devices)
    if parallelism == "data+feature" and n > 1 and n % 2 == 0:
        return build_mesh(n // 2, 2, full.devices)
    return full


def sharded_cfg(mesh: Optional[Mesh], cfg: GrowerConfig) -> GrowerConfig:
    """``cfg`` with the mesh's data and feature axis sizes."""
    if mesh is None:
        return replace(cfg, data_axis_size=1, feature_axis_size=1)
    return replace(cfg, data_axis_size=mesh.data,
                   feature_axis_size=mesh.feature)


@dataclass
class ShardArrays:
    """Per-device arrays of one fit: index ``k`` is device ``k`` of the
    mesh, data shard ``k // feature``, feature slice ``k % feature``.
    Every device of a data shard holds that shard's rows, labels and
    weights, and its own scores."""
    bins: List[torch.Tensor]
    labels: List[torch.Tensor]
    weights: List[torch.Tensor]
    real: List[torch.Tensor]
    scores: List[torch.Tensor]
    rows_per_shard: int
    n: int                      # real rows; pad rows follow them
    feature: int = 1            # size of the feature axis

    @property
    def n_padded(self) -> int:
        return self.rows_per_shard * (len(self.bins) // self.feature)

    def split(self, row: np.ndarray, devices) -> List[torch.Tensor]:
        """A host ``(n_padded,)`` row vector cut into per-device tensors
        (device k gets its data shard's rows)."""
        S = self.rows_per_shard
        return [torch.as_tensor(row[k // self.feature * S:
                                    (k // self.feature + 1) * S], device=dev)
                for k, dev in enumerate(devices)]


def prepare_arrays(bins: torch.Tensor, labels: np.ndarray,
                   weights: np.ndarray, devices: Sequence[torch.device],
                   init: float, feature: int = 1,
                   num_class: int = 1) -> ShardArrays:
    """Lay the rows and features out over ``devices``, a ``(D, feature)``
    grid in row-major order: rows padded to a multiple of D and cut into
    D shards, features padded to a multiple of ``feature`` and cut into
    slices, each piece moved to its device.  Pad rows carry zero bins,
    labels and weights and ``real = 0`` (excluded from every histogram
    through the bag mask); pad features are constant bin 0.  Scores are
    ``(S,)``, or ``(S, num_class)`` for a multiclass objective."""
    D = len(devices) // feature
    n, f = bins.shape
    rp = pad_to_multiple(n, D) - n
    fp = pad_to_multiple(f, feature) - f
    S = (n + rp) // D
    f_loc = (f + fp) // feature
    if rp:
        bins = torch.cat([bins, bins.new_zeros((rp, f))])
    if fp:
        bins = torch.cat([bins, bins.new_zeros((n + rp, fp))], dim=1)
    pad = np.zeros(rp)
    lab = np.concatenate([np.asarray(labels, np.float64), pad])
    w = np.concatenate([np.asarray(weights, np.float64), pad])
    real = np.concatenate([np.ones(n), pad])
    arrays = ShardArrays(bins=[], labels=[], weights=[], real=[], scores=[],
                         rows_per_shard=S, n=n, feature=feature)
    for k, dev in enumerate(devices):
        d, j = divmod(k, feature)
        rows = slice(d * S, (d + 1) * S)
        arrays.bins.append(
            bins[rows, j * f_loc:(j + 1) * f_loc].to(dev).contiguous())
        for name, host in (("labels", lab), ("weights", w), ("real", real)):
            getattr(arrays, name).append(torch.as_tensor(
                host[rows], dtype=torch.float32, device=dev))
        arrays.scores.append(torch.full(
            (S,) if num_class == 1 else (S, num_class), init,
            dtype=torch.float32, device=dev))
    return arrays


def boost_iteration(arrays: ShardArrays, bag: Sequence[torch.Tensor],
                    feat_info: np.ndarray, objective: Objective,
                    cfg: GrowerConfig, learning_rate: float,
                    mesh: Optional[Mesh]) -> List[TreeArrays]:
    """One gbdt iteration over every device: the objective's (grad, hess)
    once, then one tree per class (K = ``num_model_per_iteration``,
    LightGBM's softmax semantics: every class's tree fits the gradients of
    the iteration's start), each grown over the mesh
    (:func:`.grower.grow_tree_sharded`) from the masked (grad, hess,
    count) of its class and followed by that class's score update
    (``scores + lr·leaf``, an FMA as in the reference) with the leaf
    values of the device's own learner.  Returns the K unshrunk trees;
    updates ``arrays.scores``."""
    K = objective.num_model_per_iteration
    grads, masks = [], []
    for k in range(len(arrays.bins)):
        masks.append(bag[k] * arrays.real[k])
        grads.append(objective.grad_hess(arrays.scores[k], arrays.labels[k],
                                         arrays.weights[k]))
    trees = []
    for c in range(K):
        gh = [torch.stack([g * b, h * b, b], dim=1) if K == 1 else
              torch.stack([g[:, c] * b, h[:, c] * b, b], dim=1)
              for (g, h), b in zip(grads, masks)]
        tree, row_leaf, values = grow_tree_sharded(arrays.bins, gh,
                                                   feat_info, cfg, mesh)
        for k, (leaf, value) in enumerate(zip(row_leaf, values)):
            _add_leaf_values(arrays, k, c, value, leaf, learning_rate, K)
        trees.append(tree)
    return trees


def _add_leaf_values(arrays: ShardArrays, k: int, c: int,
                     value: torch.Tensor, leaf: torch.Tensor,
                     learning_rate: float, K: int) -> None:
    """Device k's scores (class c's column when K > 1) plus ``lr ·
    value[leaf]`` of every row, rounded once as the reference's FMA."""
    s = arrays.scores[k]
    add = value.to(s.device)[leaf.to(s.device)]
    if K == 1:
        arrays.scores[k] = fma32(add, learning_rate, s)
    else:
        s[:, c] = fma32(add, learning_rate, s[:, c])


def stable_order(x: torch.Tensor, descending: bool = False) -> torch.Tensor:
    """Stable argsort of a float32 vector whose values are >= 0 or NaN,
    NaN last either way: ``jnp.argsort(x)`` (``descending``:
    ``jnp.argsort(-x)``).  It sorts the values' int32 bit patterns, which
    order non-negative floats as the floats do, so the CPU and the card
    break ties alike."""
    key = x.view(torch.int32)
    key = torch.where(torch.isnan(x), -1 if descending else 2 ** 31 - 1,
                      key)
    return torch.sort(key, descending=descending, stable=True).indices


def goss_sample(g: torch.Tensor, h: torch.Tensor, key: torch.Tensor,
                k1: int, k2: int, amp: float):
    """One shard's GOSS sample (the reference's ``_boost_scan_goss`` /
    ``make_goss_scan`` body): the ``k1`` rows of largest influence
    ``|g·h|`` (summed over the classes of an ``(n, K)`` g), in a stable
    descending order, then the first ``k2`` of the rest by a stable
    ascending sort of ``uniform(key, (n − k1,))``.  Returns the ``(k1 +
    k2,)`` row indices and the weights of their gradients (1, then
    ``amp``)."""
    gh = (g * h).abs()
    infl = gh if gh.dim() == 1 else sum_last(gh)[:, 0]
    rank = stable_order(infl, descending=True)
    rest = rank[k1:]
    rk = uniform(key, (rest.shape[0],))
    idx = torch.cat([rank[:k1], rest[stable_order(rk)[:k2]]])
    w = torch.cat([torch.ones(k1, dtype=torch.float32, device=g.device),
                   torch.full((k2,), amp, dtype=torch.float32,
                              device=g.device)])
    return idx, w


def shard_full_bins(arrays: ShardArrays) -> List[torch.Tensor]:
    """Each data shard's bins over every feature, on the shard's first
    device (its feature slices side by side; the slices themselves under
    a mesh without a feature axis)."""
    F = arrays.feature
    if F == 1:
        return arrays.bins
    return [torch.cat([b.to(arrays.bins[d * F].device)
                       for b in arrays.bins[d * F:(d + 1) * F]], dim=1)
            for d in range(len(arrays.bins) // F)]


def goss_iteration(arrays: ShardArrays, key: torch.Tensor,
                   feat_info: np.ndarray, objective: Objective,
                   cfg: GrowerConfig, learning_rate: float,
                   mesh: Optional[Mesh], k1: int, k2: int, amp: float,
                   full_bins: Sequence[torch.Tensor]) -> List[TreeArrays]:
    """One GOSS iteration over every device: per device the objective's
    (grad, hess) masked by ``real``, and the device's sample
    (:func:`goss_sample`, its key ``fold_in(key, data shard)`` on a data
    mesh, so shards draw independent remainders); then per class one tree
    grown over the mesh on the sampled rows (gh = (g·w, h·w, real)), and
    every row's score updated (an FMA, as :func:`boost_iteration` does)
    with the leaf its shard's binned walk of the tree (``full_bins``,
    :func:`shard_full_bins`) reaches.  One sample feeds all K class
    trees.  Returns the K unshrunk trees; updates ``arrays.scores``."""
    K = objective.num_model_per_iteration
    F = arrays.feature
    data = len(arrays.bins) // F
    grads, samples = [], []
    for k, real in enumerate(arrays.real):
        g, h = objective.grad_hess(arrays.scores[k], arrays.labels[k],
                                   arrays.weights[k])
        mask = real if K == 1 else real[:, None]
        g, h = g * mask, h * mask
        kd = key.to(real.device)
        if data > 1:
            kd = fold_in(kd, k // F)
        idx, w = goss_sample(g, h, kd, k1, k2, amp)
        grads.append((g[idx], h[idx]))
        samples.append((idx, w, real[idx]))
    bins = [b[idx] for b, (idx, _, _) in zip(arrays.bins, samples)]
    trees = []
    for c in range(K):
        gh = [torch.stack([(g if K == 1 else g[:, c]) * w,
                           (h if K == 1 else h[:, c]) * w, valid], dim=1)
              for (g, h), (_, w, valid) in zip(grads, samples)]
        tree, _, values = grow_tree_sharded(bins, gh, feat_info, cfg, mesh)
        leaves = [leaf_index_binned(tree, b, cfg.num_leaves)
                  for b in full_bins]
        for k, value in enumerate(values):
            _add_leaf_values(arrays, k, c, value, leaves[k // F],
                             learning_rate, K)
        trees.append(tree)
    return trees
