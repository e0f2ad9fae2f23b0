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

Sharded ingestion (:func:`prepare_arrays_from_shards`, the engine's
``train`` given per-shard lists): each data shard's rows come from its
own matrix, padded to the largest shard, and no piece is built from more
than one shard.  On a gang of controllers (a mesh over several
processes) each process lays out only its own shards and passes None in
the others' slots; the host draws (bagging, feature fraction) are made
over the global rows in every process, and each process takes its own
slice (:meth:`ShardArrays.split`).

Under Exclusive Feature Bundling the engine hands :func:`prepare_arrays`
the bundled matrix and its maps: each shard holds its rows' G bundle
columns and its device's :class:`.grower.EFBArrays` (``ShardArrays.efb``),
which the grower expands histograms with and the GOSS and DART walks
decode the bundled rows with.

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

from ..core import debug as _debug
from ..core.mesh import Mesh, build_mesh, pad_to_multiple
from ..ops.threefry import fold_in, uniform
from .grower import (EFBArrays, GrowerConfig, TreeArrays, apply_shrinkage,
                     grow_tree_sharded, leaf_index_binned)
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
    weights, and its own scores.  ``perm`` (a ranking fit's query-packed
    layout, :func:`.ranking.shard_queries`) maps each padded slot to its
    source row, −1 on a pad; without it the ``n`` real rows come first.
    ``efb``: under Exclusive Feature Bundling, each device's EFB maps
    (``bins`` then holds bundle columns); None otherwise.

    ``shards`` (the global data axis; 0: the local shards are all of
    them) and ``shard0`` (the global index of the first local shard): on
    a gang of controllers the lists hold this process's devices only,
    data shards ``shard0 … shard0 + len(bins) // feature − 1``."""
    bins: List[torch.Tensor]
    labels: List[torch.Tensor]
    weights: List[torch.Tensor]
    real: List[torch.Tensor]
    scores: List[torch.Tensor]
    rows_per_shard: int
    n: int                      # real rows
    feature: int = 1            # size of the feature axis
    perm: Optional[np.ndarray] = None
    efb: Optional[List[EFBArrays]] = None
    shards: int = 0
    shard0: int = 0

    @property
    def data_shards(self) -> int:
        """The global data axis."""
        return self.shards or len(self.bins) // self.feature

    @property
    def n_padded(self) -> int:
        return self.rows_per_shard * self.data_shards

    def shard_of(self, k: int) -> int:
        """The global data shard of local device k."""
        return self.shard0 + k // self.feature

    def split(self, row: np.ndarray, devices) -> List[torch.Tensor]:
        """A host ``(n_padded,)`` row vector cut into per-device tensors
        (device k gets its data shard's rows)."""
        S = self.rows_per_shard
        return [torch.as_tensor(row[self.shard_of(k) * S:
                                    (self.shard_of(k) + 1) * S], device=dev)
                for k, dev in enumerate(devices)]

    def scatter(self, values: np.ndarray) -> np.ndarray:
        """An ``(n,)`` vector over the source rows laid into the padded
        layout, pad slots 0."""
        row = np.zeros(self.n_padded, np.float32)
        if self.perm is None:
            row[:self.n] = values
        else:
            valid = self.perm >= 0
            row[valid] = values[self.perm[valid]]
        return row


def prepare_arrays(bins: torch.Tensor, labels: np.ndarray,
                   weights: np.ndarray, devices: Sequence[torch.device],
                   init: float, feature: int = 1,
                   num_class: int = 1,
                   perm: Optional[np.ndarray] = None,
                   efb_maps=None,
                   init_scores: Optional[np.ndarray] = None) -> ShardArrays:
    """Lay the rows and features out over ``devices``, a ``(D, feature)``
    grid in row-major order: rows padded to a multiple of D and cut into
    D shards, features padded to a multiple of ``feature`` and cut into
    slices, each piece moved to its device.  Pad rows carry zero bins,
    labels and weights and ``real = 0`` (excluded from every histogram
    through the bag mask); pad features are constant bin 0.  Scores are
    ``(S,)``, or ``(S, num_class)`` for a multiclass objective.  With
    ``perm`` (``(D·S,)``, source row or −1) the rows take that packed
    layout instead.  ``efb_maps`` (``efb.expansion_arrays``' maps, with
    ``bins`` the bundled matrix): each device gets its
    :class:`.grower.EFBArrays`, built once per device.  ``init_scores``
    (``(n,)`` or ``(n, num_class)``, the source rows' offsets; not with
    ``perm``): each shard's scores start at ``init`` plus its rows'
    offsets in float32, pad rows at the plain ``init``."""
    D = len(devices) // feature
    n, f = bins.shape
    fp = pad_to_multiple(f, feature) - f
    if perm is None:
        rp = pad_to_multiple(n, D) - n
        if rp:
            bins = torch.cat([bins, bins.new_zeros((rp, f))])
        pad = np.zeros(rp)
        lab = np.concatenate([np.asarray(labels, np.float64), pad])
        w = np.concatenate([np.asarray(weights, np.float64), pad])
        real = np.concatenate([np.ones(n), pad])
    else:
        valid = perm >= 0
        src = torch.as_tensor(np.where(valid, perm, 0), device=bins.device)
        bins = bins[src] * torch.as_tensor(
            valid, device=bins.device)[:, None].to(bins.dtype)
        real = valid.astype(np.float64)
        lab = np.where(valid, np.asarray(labels, np.float64)[
            np.where(valid, perm, 0)], 0.0)
        w = np.where(valid, np.asarray(weights, np.float64)[
            np.where(valid, perm, 0)], 0.0)
    rows = bins.shape[0]
    S = rows // D
    f_loc = (f + fp) // feature
    if fp:
        bins = torch.cat([bins, bins.new_zeros((rows, fp))], dim=1)
    scores0 = None
    if init_scores is not None:
        iscores = np.asarray(init_scores, np.float32)
        pad_init = np.concatenate(
            [iscores, np.zeros((rows - n,) + iscores.shape[1:], np.float32)])
        scores0 = np.full((rows,) if num_class == 1 else (rows, num_class),
                          init, np.float32)
        scores0 = scores0 + (pad_init if scores0.ndim == pad_init.ndim
                             else pad_init[:, None])
    arrays = ShardArrays(bins=[], labels=[], weights=[], real=[], scores=[],
                         rows_per_shard=S, n=n, feature=feature, perm=perm)
    for k, dev in enumerate(devices):
        d, j = divmod(k, feature)
        sl = slice(d * S, (d + 1) * S)
        arrays.bins.append(
            bins[sl, j * f_loc:(j + 1) * f_loc].to(dev).contiguous())
        for name, host in (("labels", lab), ("weights", w), ("real", real)):
            getattr(arrays, name).append(torch.as_tensor(
                host[sl], dtype=torch.float32, device=dev))
        arrays.scores.append(
            torch.full((S,) if num_class == 1 else (S, num_class), init,
                       dtype=torch.float32, device=dev)
            if scores0 is None else torch.tensor(scores0[sl], device=dev))
    if efb_maps is not None:
        built = {}
        for d in map(torch.device, devices):
            if d not in built:
                built[d] = EFBArrays.from_maps(efb_maps, d)
        arrays.efb = [built[torch.device(d)] for d in devices]
    return arrays


@dataclass
class ShardedInput:
    """Sharded ingestion's inputs, one slot per data shard in global
    order: its codes (None in the slot of a shard another process of a
    gang holds), labels and weights (complete in every process: 1-D
    metadata), init scores (None: none) and query ids (a ranking fit),
    and every shard's row count."""
    bins: list
    labels: list
    weights: list
    sizes: List[int]
    init_scores: Optional[list] = None
    qids: Optional[list] = None

    @property
    def n(self) -> int:
        return int(sum(self.sizes))

    @property
    def num_features(self) -> int:
        return next(b.shape[1] for b in self.bins if b is not None)


def prepare_arrays_from_shards(bins_shards, label_shards, weight_shards,
                               mesh: Mesh, init: float, num_class: int = 1,
                               shard_rows: Optional[Sequence[int]] = None,
                               init_score_shards=None,
                               perm: Optional[np.ndarray] = None,
                               offsets: Optional[Sequence[int]] = None,
                               piece_spy=None) -> ShardArrays:
    """Sharded ingestion (the reference's ``prepare_arrays_from_shards``):
    lay this process's data shards out on its devices of ``mesh`` from
    per-shard inputs, without ever joining the shards into one matrix.

    ``bins_shards[d]`` (``(n_d, f)`` codes, a numpy array or a tensor),
    ``label_shards[d]`` and ``weight_shards[d]`` are data shard d's; on a
    gang of controllers the slots of other processes' shards are None,
    and ``shard_rows`` (every shard's row count, metadata each process
    knows) sizes them.  Shards are padded at their end to the largest
    shard with zero bins, labels and weights and ``real = 0``; scores
    start at ``init`` (plus ``init_score_shards[d]``, each shard's
    offsets, in float32; pad rows at the plain ``init``).  With ``perm``
    (:func:`.ranking.shard_queries_from_shards`: each padded slot's row
    in shard-concatenation order, −1 on a pad) and ``offsets`` (each
    shard's first row in that order) shard d's slots take its rows in the
    query-packed order instead.  Each device piece is built from its own
    shard alone (``piece_spy(shape)`` sees each piece's shape); the
    returned arrays' ``perm`` maps the padded layout to the
    shard-concatenation rows."""
    D, F = mesh.data, mesh.feature
    if len(bins_shards) != D:
        raise ValueError(
            f"need exactly one shard slot per data-mesh slice: got "
            f"{len(bins_shards)} slots for data={D}")
    local = [d for d in range(D) if bins_shards[d] is not None]
    if not local:
        raise ValueError("no local shards (every slot is None)")
    own = range(mesh.data_offset, mesh.data_offset + mesh.local_data)
    missing = [d for d in own if bins_shards[d] is None]
    if missing:
        raise ValueError(
            f"process {mesh.process_index} holds data shards {own.start}.."
            f"{own.stop - 1} of the mesh, but slots {missing} are None")
    f = bins_shards[local[0]].shape[1]
    for d in local:
        if bins_shards[d].shape[1] != f:
            raise ValueError(
                f"shard {d} has {bins_shards[d].shape[1]} features, "
                f"shard {local[0]} has {f}: all shards must agree")
        nl = len(label_shards[d])
        nw = len(weight_shards[d]) if weight_shards[d] is not None else nl
        if not bins_shards[d].shape[0] == nl == nw:
            raise ValueError(
                f"shard {d}: bins rows {bins_shards[d].shape[0]}, labels "
                f"{nl}, weights {nw} must all match")
    if shard_rows is not None:
        sizes = [int(s) for s in shard_rows]
        if len(sizes) != D:
            raise ValueError(f"shard_rows has {len(sizes)} counts for "
                             f"data={D}")
        for d in local:
            if sizes[d] != bins_shards[d].shape[0]:
                raise ValueError(
                    f"shard_rows[{d}]={sizes[d]} does not match the local "
                    f"shard's {bins_shards[d].shape[0]} rows")
    elif len(local) == D:
        sizes = [b.shape[0] for b in bins_shards]
    else:
        raise ValueError("shard_rows is required when some shard slots "
                         "are None (multi-controller)")
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    if perm is None:
        S = max(sizes)
        perm = np.full((D, S), -1, np.int64)
        for d, s in enumerate(sizes):
            perm[d, :s] = offs[d] + np.arange(s)
        perm = perm.reshape(-1)
    else:
        S = len(perm) // D
        offs = np.asarray(offsets, np.int64)
    f_loc = pad_to_multiple(f, F) // F
    n = int(sum(sizes))
    arrays = ShardArrays(bins=[], labels=[], weights=[], real=[], scores=[],
                         rows_per_shard=S, n=n, feature=F, perm=perm,
                         shards=D, shard0=mesh.data_offset)
    for k, dev in enumerate(mesh.devices):
        d, j = arrays.shard_of(k), k % F
        slot = perm[d * S:(d + 1) * S]
        valid = slot >= 0
        rows = (slot - offs[d])[valid]
        src = torch.as_tensor(bins_shards[d])
        c0, c1 = j * f_loc, min((j + 1) * f_loc, f)
        piece = src.new_zeros((S, f_loc), device=dev)
        if c1 > c0:
            piece[torch.as_tensor(valid, device=dev), :c1 - c0] = \
                src[torch.as_tensor(rows, device=src.device), c0:c1].to(dev)
        arrays.bins.append(piece)
        if piece_spy is not None:
            piece_spy(tuple(piece.shape))
        lab = np.zeros(S, np.float32)
        w = np.zeros(S, np.float32)
        lab[valid] = np.asarray(label_shards[d], np.float32)[rows]
        w[valid] = (1.0 if weight_shards[d] is None else np.asarray(
            weight_shards[d], np.float32)[rows])
        base = np.full(S, init, np.float32)
        if init_score_shards is not None and \
                init_score_shards[d] is not None:
            base[valid] = init + np.asarray(init_score_shards[d],
                                            np.float32)[rows]
        for name, host in (("labels", lab), ("weights", w),
                           ("real", valid.astype(np.float32)),
                           ("scores", base if num_class == 1 else
                            np.repeat(base[:, None], num_class, 1))):
            getattr(arrays, name).append(torch.tensor(host, device=dev))
            if piece_spy is not None:
                piece_spy(host.shape)
    return arrays


def objective_grads(arrays: ShardArrays, bag: Sequence[torch.Tensor],
                    objective: Objective,
                    scores: Optional[Sequence[torch.Tensor]] = None):
    """Per device the objective's (grad, hess) at ``scores`` (default the
    arrays' scores) with its mask and count channel, both bag · real:
    ``(g, h, mask, count)``, the form :func:`grow_trees` takes."""
    scores = arrays.scores if scores is None else scores
    out = []
    for k, s in enumerate(scores):
        m = bag[k] * arrays.real[k]
        g, h = objective.grad_hess(s, arrays.labels[k], arrays.weights[k])
        out.append((g, h, m, m))
    return out


def grow_trees(arrays: ShardArrays, grads, feat_info: np.ndarray,
               cfg: GrowerConfig, mesh: Optional[Mesh], K: int):
    """One tree per class over the mesh from per-device ``(g, h, mask,
    count)`` (``(n, K)`` g and h when K > 1): the grower's channels are
    ``(g·mask, h·mask, count)``.  Returns ``[(tree, row_leaf, values)]``
    per class (:func:`.grower.grow_tree_sharded`)."""
    out = []
    for c in range(K):
        gh = [torch.stack([(g if K == 1 else g[:, c]) * m,
                           (h if K == 1 else h[:, c]) * m, cnt], dim=1)
              for g, h, m, cnt in grads]
        out.append(grow_tree_sharded(arrays.bins, gh, feat_info, cfg, mesh,
                                     arrays.efb))
    return out


def boost_iteration(arrays: ShardArrays, bag: Sequence[torch.Tensor],
                    feat_info: np.ndarray, objective: Objective,
                    cfg: GrowerConfig, learning_rate: float,
                    mesh: Optional[Mesh], rf: bool = False, grads=None,
                    fused: bool = True) -> List[TreeArrays]:
    """One gbdt (or rf) iteration over every device: the gradients once —
    the objective's (:func:`objective_grads`) unless ``grads`` gives
    them — then one tree per class (K = ``num_model_per_iteration``,
    LightGBM's softmax semantics: every class's tree fits the gradients of
    the iteration's start), each grown over the mesh and followed by that
    class's score update with the leaf values of the device's own learner
    (:func:`_add_leaf_values`; ``fused=False`` rounds the product and the
    sum apart, as an eager host loop does).  ``rf`` (random forest) leaves
    the scores at their init.  Returns the K unshrunk trees."""
    K = objective.num_model_per_iteration
    if grads is None:
        grads = objective_grads(arrays, bag, objective)
    trees = []
    for c, (tree, row_leaf, values) in enumerate(
            grow_trees(arrays, grads, feat_info, cfg, mesh, K)):
        if not rf:
            for k, (leaf, value) in enumerate(zip(row_leaf, values)):
                _add_leaf_values(arrays, k, c, value, leaf, learning_rate,
                                 K, fused)
        trees.append(tree)
    return trees


def _add_leaf_values(arrays: ShardArrays, k: int, c: int,
                     value: torch.Tensor, leaf: torch.Tensor,
                     learning_rate: float, K: int,
                     fused: bool = True) -> None:
    """Device k's scores (class c's column when K > 1) plus ``lr ·
    value[leaf]`` of every row, rounded once as the reference's FMA (or,
    ``fused=False``, the product and the sum each rounded)."""
    s = arrays.scores[k]
    add = value.to(s.device)[leaf.to(s.device)]
    col = s if K == 1 else s[:, c]
    new = fma32(add, learning_rate, col) if fused \
        else col + add * learning_rate
    if K == 1:
        arrays.scores[k] = new
    else:
        s[:, c] = new


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


def _walk_maps(arrays: ShardArrays, d: int) -> Optional[EFBArrays]:
    """The EFB maps of data shard d's walk matrix (the bundled training
    rows; a feature axis never bundles), or None."""
    return None if arrays.efb is None else arrays.efb[d * arrays.feature]


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
                   full_bins: Sequence[torch.Tensor], grads=None,
                   fused: bool = True) -> List[TreeArrays]:
    """One GOSS iteration over every device: per device the gradients
    (the objective's masked by ``real``, or ``grads``' ``(g, h, mask,
    count)``) times their mask, and the device's sample
    (:func:`goss_sample`, its key ``fold_in(key, data shard)`` on a data
    mesh, so shards draw independent remainders); then per class one tree
    grown over the mesh on the sampled rows (gh = (g·w, h·w, count)), and
    every row's score updated (as :func:`boost_iteration` does) with the
    leaf its shard's binned walk of the tree (``full_bins``,
    :func:`shard_full_bins`; under EFB the bundled rows, decoded through
    ``arrays.efb``) reaches.  One sample feeds all K class trees.  Returns the K unshrunk trees; updates ``arrays.scores``."""
    K = objective.num_model_per_iteration
    F = arrays.feature
    if grads is None:
        grads = objective_grads(arrays, arrays.real, objective)
    masked, samples = [], []
    for k, (g, h, m, cnt) in enumerate(grads):
        # debug mode: the sample sees only its rows, so the full inputs
        # are checked here (the reference's pre-gather checks)
        _debug.check_bins_in_range(full_bins[k // F], cfg.num_bins)
        _debug.check_finite("gradients/hessians", g, h)
        mask = m if K == 1 else m[:, None]
        g, h = g * mask, h * mask
        kd = key.to(g.device)
        if arrays.data_shards > 1:
            kd = fold_in(kd, arrays.shard_of(k))
        idx, w = goss_sample(g, h, kd, k1, k2, amp)
        masked.append((g[idx], h[idx]))
        samples.append((idx, w, cnt[idx]))
    bins = [b[idx] for b, (idx, _, _) in zip(arrays.bins, samples)]
    trees = []
    for c in range(K):
        gh = [torch.stack([(g if K == 1 else g[:, c]) * w,
                           (h if K == 1 else h[:, c]) * w, valid], dim=1)
              for (g, h), (_, w, valid) in zip(masked, samples)]
        tree, _, values = grow_tree_sharded(bins, gh, feat_info, cfg, mesh,
                                            arrays.efb)
        leaves = [leaf_index_binned(tree, b, cfg.num_leaves,
                                    _walk_maps(arrays, d), cfg.num_bins)
                  for d, b in enumerate(full_bins)]
        for k, value in enumerate(values):
            _add_leaf_values(arrays, k, c, value, leaves[k // F],
                             learning_rate, K, fused)
        trees.append(tree)
    return trees


def dart_grow(arrays: ShardArrays, grads, feat_info: np.ndarray,
              cfg: GrowerConfig, learning_rate: float,
              mesh: Optional[Mesh], K: int):
    """One DART unit (the reference's ``_dart_step`` /
    ``make_dart_step``): K trees grown from ``grads`` at the dropped-out
    scores, each shrunk by the learning rate.  Returns the unit — the
    shrunk trees and, per class, each device's shrunk leaf values (its
    own slice's on a feature axis, as each device of the reference keeps
    them) — and each device's contribution, the shrunk leaf values at its
    rows' leaves, ``(S,)`` or ``(S, K)``."""
    trees, vals, cols = [], [], []
    for tree, row_leaf, values in grow_trees(arrays, grads, feat_info,
                                             cfg, mesh, K):
        trees.append(apply_shrinkage(tree, learning_rate))
        shrunk = [(v * learning_rate).to(b.device)
                  for v, b in zip(values, arrays.bins)]
        vals.append(shrunk)
        cols.append([v[leaf.to(v.device)] for v, leaf in zip(shrunk,
                                                             row_leaf)])
    b_new = [cols[0][k] if K == 1 else torch.stack([c[k] for c in cols], 1)
             for k in range(len(arrays.bins))]
    return (trees, vals), b_new


def unit_margin(unit, full_bins, num_leaves: int, feature: int,
                efb: Optional[Sequence[EFBArrays]] = None,
                num_bins: int = 256):
    """A DART unit's margins on each device, ``(S,)`` or ``(S, K)`` (the
    reference's ``_dart_iter_margin`` / ``make_tree_predict``): each data
    shard walks the trees once over all its features, and each device
    reads its own leaf values.  ``efb`` (``ShardArrays.efb``): the walk
    matrices are bundled, and each level decodes them (the maps must
    match the matrix walked)."""
    trees, vals = unit
    maps = [None if efb is None else efb[d * feature]
            for d in range(len(full_bins))]
    leaves = [[leaf_index_binned(t, b, num_leaves, m, num_bins)
               for b, m in zip(full_bins, maps)] for t in trees]
    out = []
    for k in range(len(vals[0])):
        cols = [v[k][lv[k // feature].to(v[k].device)]
                for v, lv in zip(vals, leaves)]
        out.append(cols[0] if len(cols) == 1 else torch.stack(cols, 1))
    return out
