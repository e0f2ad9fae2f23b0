"""Data-parallel GBDT training over a mesh of data shards.

The port's counterpart of the data-parallel parts of
``mmlspark_tpu/gbdt/distributed.py``.  The reference runs the whole boost
step under ``shard_map``; the port keeps its single controller and drives
the shards of a :class:`..core.mesh.Mesh` in lockstep from one host loop:

* :func:`prepare_arrays` lays the rows out as the reference does — padded
  at the end to a multiple of D, shard ``d`` holding rows ``[d·S,
  (d+1)·S)``, pad rows with zero bins, label and weight and ``real = 0``
  — so both packages grow the same forests;
* :func:`boost_iteration` is the iteration body of the reference's
  ``make_boost_scan`` (gbdt): per shard the objective's (grad, hess)
  masked by bag and ``real``, one tree grown over all shards
  (:func:`.grower.grow_tree_sharded`), and each shard's score update.

A serial fit is the one-shard case of the same code.  Only the data
learner is ported; the voting, feature and data+feature learners raise
``NotImplementedError`` (ROADMAP.md Queue A).  The reference's
``data_only_mesh`` has no counterpart: a port ``Mesh`` has the data axis
alone.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.mesh import Mesh, build_mesh, pad_to_multiple
from .grower import GrowerConfig, TreeArrays, grow_tree_sharded
from .objectives import Objective, fma32

VALID_PARALLELISM = ("serial", "data", "feature", "data+feature", "voting")
PORTED_PARALLELISM = ("serial", "data")


def check_parallelism(parallelism: str) -> None:
    """Raise for a ``parallelism`` value the port does not train."""
    if parallelism not in VALID_PARALLELISM:
        raise ValueError(f"Unknown parallelism {parallelism!r}; "
                         f"valid: {VALID_PARALLELISM}")
    if parallelism not in PORTED_PARALLELISM:
        raise NotImplementedError(
            f"parallelism={parallelism!r} is not ported yet: the port "
            "trains 'data' (and 'serial'); the voting and feature learners "
            "are the next slice (ROADMAP.md Queue A)")


def resolve_mesh(parallelism: str, mesh: Optional[Mesh] = None) -> Mesh:
    """The mesh a ``parallelism`` value implies: ``mesh`` when given, else
    every CUDA card of the host (``"data"``) or the first one
    (``"serial"``)."""
    check_parallelism(parallelism)
    if mesh is not None:
        return mesh
    full = build_mesh()
    return Mesh(full.devices[:1]) if parallelism == "serial" else full


def sharded_cfg(mesh: Optional[Mesh], cfg: GrowerConfig) -> GrowerConfig:
    """``cfg`` with the mesh's shard count."""
    return replace(cfg, data_axis_size=1 if mesh is None else len(mesh))


@dataclass
class ShardArrays:
    """Per-shard device arrays of one fit (index d = shard d)."""
    bins: List[torch.Tensor]
    labels: List[torch.Tensor]
    weights: List[torch.Tensor]
    real: List[torch.Tensor]
    scores: List[torch.Tensor]
    rows_per_shard: int
    n: int                      # real rows; pad rows follow them

    @property
    def n_padded(self) -> int:
        return self.rows_per_shard * len(self.bins)

    def split(self, row: np.ndarray, devices) -> List[torch.Tensor]:
        """A host ``(n_padded,)`` row vector cut into per-shard tensors."""
        S = self.rows_per_shard
        return [torch.as_tensor(row[d * S:(d + 1) * S], device=dev)
                for d, dev in enumerate(devices)]


def prepare_arrays(bins: torch.Tensor, labels: np.ndarray,
                   weights: np.ndarray, devices: Sequence[torch.device],
                   init: float) -> ShardArrays:
    """Pad rows to a multiple of D and cut them into D shards, each moved
    to its device.  Pad rows carry zero bins, labels and weights and
    ``real = 0`` (excluded from every histogram through the bag mask)."""
    D = len(devices)
    n, f = bins.shape
    rp = pad_to_multiple(n, D) - n
    S = (n + rp) // D
    if rp:
        bins = torch.cat([bins, bins.new_zeros((rp, f))])
    pad = np.zeros(rp)
    lab = np.concatenate([np.asarray(labels, np.float64), pad])
    w = np.concatenate([np.asarray(weights, np.float64), pad])
    real = np.concatenate([np.ones(n), pad])
    arrays = ShardArrays(bins=[], labels=[], weights=[], real=[], scores=[],
                         rows_per_shard=S, n=n)
    for d, dev in enumerate(devices):
        rows = slice(d * S, (d + 1) * S)
        arrays.bins.append(bins[rows].to(dev).contiguous())
        for name, host in (("labels", lab), ("weights", w), ("real", real)):
            getattr(arrays, name).append(torch.as_tensor(
                host[rows], dtype=torch.float32, device=dev))
        arrays.scores.append(torch.full((S,), init, dtype=torch.float32,
                                        device=dev))
    return arrays


def boost_iteration(arrays: ShardArrays, bag: Sequence[torch.Tensor],
                    feat_info: np.ndarray, objective: Objective,
                    cfg: GrowerConfig, learning_rate: float,
                    mesh: Optional[Mesh]) -> TreeArrays:
    """One gbdt iteration over every shard: masked (grad, hess, count),
    one tree, and the score update (``scores + lr·leaf``, an FMA as in the
    reference).  Returns the unshrunk tree; updates ``arrays.scores``."""
    gh = []
    for d in range(len(arrays.bins)):
        b = bag[d] * arrays.real[d]
        g, h = objective.grad_hess(arrays.scores[d], arrays.labels[d],
                                   arrays.weights[d])
        gh.append(torch.stack([g * b, h * b, b], dim=1))
    tree, row_leaf = grow_tree_sharded(arrays.bins, gh, feat_info, cfg, mesh)
    for d, leaf in enumerate(row_leaf):
        arrays.scores[d] = fma32(tree.leaf_value.to(leaf.device)[leaf],
                                 learning_rate, arrays.scores[d])
    return tree
