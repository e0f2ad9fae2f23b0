"""Leaf-wise histogram tree grower.

The port's counterpart of ``mmlspark_tpu/gbdt/grower.py``, on one device
or over a ``data × feature`` mesh.  The reference
grows a tree inside one jitted ``fori_loop`` with static shapes; here
PyTorch runs eagerly, so a Python loop drives the split steps and the host
keeps the small per-leaf state (segment offsets and counts, best splits,
totals), while the binned matrices, the gradients, the row permutations
and the leaf histograms stay on the devices:

* **Partition.**  Each leaf owns the contiguous segment
  ``row_order[start:start+cnt]`` of every shard (LightGBM's
  DataPartition).  A split partitions those segments stably in place, and
  only the globally smaller child's rows are histogrammed
  (:func:`..ops.histogram.segment_histogram`, the ``hist_segment`` kernel
  on CUDA); the sibling comes from subtraction in the reference's exact
  f32 form.  Exact segment counts replace the reference's power-of-two
  bucket ladder.
* **Shards.**  With D > 1 shards (``gbdt/distributed.py``) every local
  histogram is reduced across shards (:func:`_reduce_hist`: the
  shard-order ``psum`` or the ``ring_allreduce`` kernel, per
  ``cfg.collective``), or, under ``hist_method="pallas_ring"`` with the
  ring, gathered, histogrammed and reduced by one
  ``fused_segment_hist_ring`` kernel.  Partition counts are summed on the
  host, and the smaller side is picked from the global counts, so every
  shard histograms the same side.  Totals, best splits and the leaf
  histograms are global and live on the first shard's device, where the
  split search runs once (the reference replicates it on every shard).
* **A gang of controllers** (``mesh.is_gang``: each process holds its own
  data shards).  Every cross-shard read goes through
  :func:`..ops.collectives.gang_gather`: the histogram partials (summed
  by every process in shard order, so the sum is the one-controller
  mesh's), the partition counts behind the smaller-side choice and the
  quantizer's grid peaks.  Every process then makes the same decisions
  from the same totals, and no tree is broadcast.  Voting and the rings
  do not run on a gang (the engine refuses them).
* **Voting** (``cfg.voting_k``, PV-Tree).  Leaf histograms stay local,
  one store per shard, and the sibling is subtracted per shard.  Each
  shard votes its top features on its local histogram and local totals;
  the votes are stacked (the reference's all-gather), the most-voted
  columns are elected, and only those are reduced — the root's ``(k2, B,
  3)`` slab, then one stacked pair per grow step — by
  ``ring_allreduce_select`` under the ring collective.  Leaf totals are
  the shard-order sum of the shards' local totals.
* **Feature axis** (``cfg.feature_axis_size`` F > 1).  Device (d, j)
  holds data shard d's rows of feature slice j.  Each slice's histograms
  are reduced over the data axis alone, each slice finds its best split,
  and the first slice with the largest gain wins; its split column
  partitions every device of the data shard.  Each slice keeps its own
  leaf totals (from its own first feature) and so its own leaf values and
  scores, as every device of the reference does; the tree carries slice
  0's.
* **Categorical splits** (``cfg.use_categorical``): beside the numeric
  scan, LightGBM's sorted-subset search over the categorical features
  (:func:`cat_split_gains`); a winning subset is a bin bitset, which
  partitions the rows, travels with the winning slice on a feature axis
  and scores the feature's vote under voting.
* **Quantized gradients** (``cfg.quantized_bits``, the reference's
  ``_quantize_gh``): each tree's (grad, hess) become integer codes on a
  grid of ``quantized_max_code`` steps, rounded stochastically with the
  reference's threefry stream (:mod:`..ops.threefry`); every histogram
  then runs the kernels' exact int32 mode, the sibling subtraction stays
  in integers, cross-shard sums ride the psum at the wire width or the
  rings as f32 lanes, and the totals and each histogram are dequantized
  (codes · scale) before the split search.
* **Exclusive Feature Bundling** (``efb``, :class:`EFBArrays`; the
  engine's gates as the reference's: serial or a data-only mesh).  The
  binned matrix holds G bundle columns (:mod:`.efb`); each device's
  histogram of them expands to the f original features
  (:func:`efb_expand`) before the cross-shard reduction, or after the
  fused ring, which has reduced already; a split column is decoded from
  its bundle (:func:`efb_feature_column`), and a walk over the bundled
  matrix decodes each level (:func:`leaf_index_binned`).  Trees name
  original features.
* **The CPU's native path** (``hist_method`` "auto" or "native" on a CPU
  device with at most 256 bins, the reference's gates): the histograms,
  the partition and, on a serial fit without categorical features, the
  split scan run the reference's C++ host kernels (:mod:`..native`
  through :mod:`..ops.histogram`); the scan contributes the winner and
  its gain is recomputed in :func:`prefix_sum_bins`' order.
* **Host syncs.**  Two per split: the partition counts of all shards in
  one fetch (launch sizing needs them) and the children's best splits,
  bitsets included, as one int64 tensor (the next leaf choice needs
  them).  ``grow_tree.host_syncs`` counts them.
* **Float order.**  :func:`prefix_sum_bins` and :func:`sum_bins` add in
  the order XLA's CPU backend uses for ``jnp.cumsum`` and ``jnp.sum``
  over the bins axis, so split gains and leaf totals on the CPU match the
  reference bit for bit given the same histograms.

Leaf numbering matches the reference and LightGBM: splitting leaf ``l`` at
step ``i`` creates internal node ``i``; the left child keeps leaf id ``l``
and the right child becomes leaf ``i + 1``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import debug as _debug
from ..ops.collectives import (fused_segment_hist_ring, gang_gather,
                               gather_cand, is_gang, psum_plain,
                               ring_allreduce, ring_allreduce_select)
from ..ops.cuda_ring import FUSED_MAX_BINS
from ..ops.histogram import (accum_mode, compute_histogram, native_applies,
                             native_find_split, native_gh, native_partition,
                             segment_histogram)
from ..ops.threefry import float_bits, fold_in, prng_key, uniform
from .objectives import fma32

EPS_GAIN = 1e-10
#: block widths of XLA's CPU prefix scan and tree reduction over the bins
#: axis (its ReduceWindowRewriter and TreeReductionRewriter)
_SCAN_BLOCK = 16
_SUM_BLOCK = 32


@dataclass(frozen=True)
class GrowerConfig:
    """Hyper-parameters of one tree."""
    num_leaves: int = 31
    max_depth: int = -1
    num_bins: int = 256
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    hist_method: str = "auto"
    #: cross-shard histogram reduction on a mesh: "psum" (the shard-order
    #: sum) or "ring" (the ``ring_allreduce`` kernel).  Resolved by the
    #: engine (``ops.collectives.resolve_collective``).
    collective: str = "psum"
    #: number of data shards (1 = serial).  Set by
    #: ``distributed.sharded_cfg``.
    data_axis_size: int = 1
    #: number of feature slices (1 = every device holds every feature).
    #: Set by ``distributed.sharded_cfg``.
    feature_axis_size: int = 1
    #: PV-Tree voting (``parallelism="voting"``, LightGBM's top_k): with
    #: more than one data shard, leaf histograms stay shard-local, each
    #: shard votes its ``voting_k`` best features, and only the voted
    #: columns are reduced.  0 = off.
    voting_k: int = 0
    #: categorical split search (LightGBM's sorted-subset search) for the
    #: features flagged in ``feat_info[:, 1]``; set by the engine when the
    #: bin mapper has a categorical feature
    use_categorical: bool = False
    #: smoothing of the gradient ratio that orders a feature's bins
    cat_smooth: float = 10.0
    #: extra L2 of a categorical split's gains
    cat_l2: float = 10.0
    #: most categories on the smaller side of a sorted-subset split
    max_cat_threshold: int = 32
    #: at or below this many value bins a feature splits one bin against
    #: the rest
    max_cat_to_onehot: int = 4
    #: quantized-gradient training (set by the engine's
    #: ``_resolve_quantized``): the grid's bits (0 = off), the seed of
    #: its stochastic rounding, the grid's largest |code|, and the dtype a
    #: psum carries integer histograms in ("none", "int8", "int16",
    #: "int32")
    quantized_bits: int = 0
    quantized_seed: int = 0
    quantized_max_code: int = 0
    quantized_wire: str = "none"

    @property
    def cat_words(self) -> int:
        """32-bit words of a node's bin bitset (stored in int64)."""
        return max(1, (self.num_bins + 31) // 32)


class EFBArrays(NamedTuple):
    """One device's EFB maps (``efb.expansion_arrays``): the binned matrix
    holds G bundle columns; histograms and split columns come back per
    original feature through these.  The per-feature scalars are also kept
    on the host (``host``), so a split column is decoded without a host
    sync."""
    gather_idx: torch.Tensor   # (f, B) i64 flat (bundle*B + bundle_bin)
    valid: torch.Tensor        # (f, B) bool bins feature j actually uses
    bundle_of: torch.Tensor    # (f,) i64
    off_of: torch.Tensor       # (f,) i64
    nb_of: torch.Tensor        # (f,) i64
    default_of: torch.Tensor   # (f,) i64
    host: tuple                # (bundle_of, off_of, nb_of, default_of) numpy

    @classmethod
    def from_maps(cls, maps, device) -> "EFBArrays":
        """From ``efb.expansion_arrays``' six numpy maps, on ``device``."""
        gather_idx, valid, *per = maps
        t = [torch.as_tensor(np.asarray(a, np.int64), device=device)
             for a in (gather_idx, *per)]
        return cls(t[0], torch.as_tensor(np.asarray(valid, bool),
                                         device=device), *t[1:],
                   host=tuple(np.asarray(a, np.int64) for a in per))

    @property
    def num_features(self) -> int:
        return self.gather_idx.shape[0]


def efb_expand(hist_b: torch.Tensor, efb: EFBArrays) -> torch.Tensor:
    """``(G, B, 3)`` bundle histogram → the ``(f, B, 3)`` histogram of the
    original features (the reference's ``_efb_expand``), f32 or int32:
    each feature's bins gathered from its bundle and masked to the bins it
    uses, then its default bin given the leaf total (bundle 0's bins
    partition every row) less its explicit bins.  Both sums add over the
    bins in XLA's CPU order (:func:`sum_bins`)."""
    f, B = efb.gather_idx.shape
    C = hist_b.shape[-1]
    hist = hist_b.reshape(-1, C)[efb.gather_idx.reshape(-1)].reshape(f, B, C)
    hist = hist * efb.valid[:, :, None]
    deficit = sum_bins(hist_b[0])[None, :] - sum_bins(hist)
    rows = torch.arange(f, device=hist.device)
    hist[rows, efb.default_of] = hist[rows, efb.default_of] + deficit
    return hist


def _efb_decode(bcol: torch.Tensor, off, nb, default, num_bins: int
                ) -> torch.Tensor:
    """A bundle column's values back to the member feature's bins (the
    last member slot is the missing bin, out-of-range values the default
    bin); ``off``, ``nb`` and ``default`` scalars or per-row tensors."""
    raw = bcol.to(torch.int64) - off
    inr = (raw >= 0) & (raw <= nb)
    return torch.where(inr, torch.where(raw == nb, num_bins - 1, raw),
                       default)


def efb_feature_column(bins: torch.Tensor, feat: int, efb: EFBArrays,
                       num_bins: int) -> torch.Tensor:
    """Original feature ``feat``'s bin column from its bundle column of
    the ``(n, G)`` bundled matrix (the reference's
    ``efb_feature_column``), int64."""
    g, off, nb, default = (int(a[feat]) for a in efb.host)
    return _efb_decode(bins[:, g], off, nb, default, num_bins)


class TreeArrays(NamedTuple):
    """One grown tree (host tensors).  A child value ``c >= 0`` is an
    internal node index, ``c < 0`` is leaf ``~c``.  A categorical node
    (``node_is_cat``) sends a row left when its bin is set in the node's
    bin bitset, 32 bits a word (``node_bin`` is 0 there)."""
    node_feat: torch.Tensor    # (L-1,) i32
    node_bin: torch.Tensor     # (L-1,) i32 threshold bin (<= goes left)
    node_left: torch.Tensor    # (L-1,) i32
    node_right: torch.Tensor   # (L-1,) i32
    node_gain: torch.Tensor    # (L-1,) f32
    node_value: torch.Tensor   # (L-1,) f32 internal output
    node_weight: torch.Tensor  # (L-1,) f32 sum of hessians
    node_count: torch.Tensor   # (L-1,) f32 row count
    node_is_cat: torch.Tensor  # (L-1,) i32 1 = categorical split
    node_cat_bits: torch.Tensor  # (L-1, W) i64 u32 words: bit set -> left
    leaf_value: torch.Tensor   # (L,) f32
    leaf_weight: torch.Tensor  # (L,) f32
    leaf_count: torch.Tensor   # (L,) f32
    num_leaves: torch.Tensor   # () i32 actual leaves grown


def _leaf_gain_l2(g, h, l1, l2):
    t = torch.sign(g) * torch.clamp(torch.abs(g) - l1, min=0.0)
    return torch.square(t) / (h + l2)


def _leaf_gain(g, h, cfg: GrowerConfig):
    return _leaf_gain_l2(g, h, cfg.lambda_l1, cfg.lambda_l2)


def _leaf_output(g, h, cfg: GrowerConfig):
    t = torch.sign(g) * torch.clamp(torch.abs(g) - cfg.lambda_l1, min=0.0)
    return -t / (h + cfg.lambda_l2)


def _pad_bins(x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
    shape = list(x.shape)
    parts = []
    for k in (lo, hi):
        shape[-2] = k
        parts.append(x.new_zeros(shape))
    return torch.cat([parts[0], x, parts[1]], dim=-2)


def _seq_cumsum(x: torch.Tensor) -> torch.Tensor:
    out = x.clone()
    for k in range(1, x.shape[-2]):
        out[..., k, :] += out[..., k - 1, :]
    return out


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    acc = x[..., 0, :].clone()
    for k in range(1, x.shape[-2]):
        acc += x[..., k, :]
    return acc


def prefix_sum_bins(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum of ``(..., B, C)`` over the bins axis, added
    in blocks of 16 (sequential inside a block; block totals scanned the
    same way and added on), the order of ``jnp.cumsum`` on XLA's CPU
    backend."""
    B = x.shape[-2]
    if B <= _SCAN_BLOCK:
        return _seq_cumsum(x)
    pad = (-B) % _SCAN_BLOCK
    xp = _pad_bins(x, 0, pad)
    blocks = xp.unflatten(-2, ((B + pad) // _SCAN_BLOCK, _SCAN_BLOCK))
    inb = _seq_cumsum(blocks)
    pre = prefix_sum_bins(inb[..., -1, :])
    excl = _pad_bins(pre[..., :-1, :], 1, 0)
    return (inb + excl.unsqueeze(-2)).flatten(-3, -2)[..., :B, :]


def sum_bins(x: torch.Tensor) -> torch.Tensor:
    """Sum of ``(..., B, C)`` over the bins axis, as XLA's CPU backend
    reduces it: zero-padded evenly on both ends to blocks of 32, each
    block summed in order, then the block sums reduced the same way."""
    B = x.shape[-2]
    if B <= _SUM_BLOCK:
        return _seq_sum(x)
    pad = (-B) % _SUM_BLOCK
    xp = _pad_bins(x, pad // 2, pad - pad // 2)
    blocks = xp.unflatten(-2, ((B + pad) // _SUM_BLOCK, _SUM_BLOCK))
    return sum_bins(_seq_sum(blocks))


def _parents(hist: torch.Tensor, *totals):
    """Parent totals (each of shape ``(...)``) as ``(..., 1, 1)`` tensors
    on the histogram's device."""
    return [torch.as_tensor(t, device=hist.device)[..., None, None]
            for t in totals]


def split_gains(hist: torch.Tensor, parent_g, parent_h, parent_c,
                feat_info: torch.Tensor, depth_ok: bool,
                cfg: GrowerConfig) -> torch.Tensor:
    """Gain of every numeric split of a ``(..., f, B, 3)`` histogram
    against the parent totals (each of shape ``(...)``), ``-inf`` where
    the split is not allowed; ``feat_info`` is ``(f, 3)`` or ``(..., f,
    3)`` [mask, is_cat, n_value_bins].  Under ``cfg.use_categorical`` the
    categorical features have no numeric split.

    Mirrors the reference (LightGBM's FindBestThreshold): left = bins <=
    b, validity by min_data_in_leaf / min_sum_hessian, the last bin never
    splits, gain = ΔL over the parent leaf.
    """
    B = hist.shape[-2]
    cum = prefix_sum_bins(hist)
    gl, hl, cl = cum.unbind(-1)
    pg, ph, pc = _parents(hist, parent_g, parent_h, parent_c)
    gr, hr, cr = pg - gl, ph - hl, pc - cl
    valid = ((cl >= cfg.min_data_in_leaf) & (cr >= cfg.min_data_in_leaf)
             & (hl >= cfg.min_sum_hessian_in_leaf)
             & (hr >= cfg.min_sum_hessian_in_leaf))
    valid &= torch.arange(B, device=hist.device) < B - 1
    numeric = feat_info[..., 0] > 0
    if cfg.use_categorical:
        numeric &= ~(feat_info[..., 1] > 0)
    valid &= numeric[..., None]
    valid &= bool(depth_ok)
    parent_gain = _leaf_gain(pg, ph, cfg)
    gains = _leaf_gain(gl, hl, cfg) + _leaf_gain(gr, hr, cfg) - parent_gain
    return torch.where(valid, gains, -torch.inf)


def _cat_allowed(feat_info: torch.Tensor, depth_ok: bool) -> torch.Tensor:
    """The features a categorical split may take: flagged categorical and
    not masked out, and none beyond the depth limit."""
    return (feat_info[..., 1] > 0) & (feat_info[..., 0] > 0) & bool(depth_ok)


def cat_split_gains(hist: torch.Tensor, parent_g, parent_h, parent_c,
                    cat_allowed: torch.Tensor, feat_nbins: torch.Tensor,
                    cfg: GrowerConfig):
    """Gain of every categorical split of a ``(..., f, B, 3)`` histogram
    (the reference's ``_cat_split_gains``, LightGBM's sorted-subset
    search): ``(gains (..., f, B), order (..., f, B), use_onehot (...,
    f))``.

    A feature with at most ``max_cat_to_onehot`` value bins
    (``feat_nbins``) splits one bin against the rest: its gain at bin b
    sends bin b left.  Any other feature orders its non-empty bins by
    ``g / (h + cat_smooth)`` (a stable sort; empty bins last) and its
    gain at position p sends the first p + 1 bins of ``order`` left.  The
    missing bin never goes left, so rare, unseen and NaN categories go
    right in training and in prediction.  Gains use ``lambda_l2 +
    cat_l2``; ``-inf`` where the split is not allowed."""
    B = hist.shape[-2]
    dev = hist.device
    g_b, h_b, c_b = hist.unbind(-1)
    pg, ph, pc = _parents(hist, parent_g, parent_h, parent_c)
    nonzero = (c_b > 0) & (torch.arange(B, device=dev) != B - 1)
    l1, l2c = cfg.lambda_l1, cfg.lambda_l2 + cfg.cat_l2
    md, mh = cfg.min_data_in_leaf, cfg.min_sum_hessian_in_leaf
    parent_gain = _leaf_gain_l2(pg, ph, l1, l2c)

    ratio = torch.where(nonzero, g_b / (h_b + cfg.cat_smooth), torch.inf)
    order = torch.sort(ratio, dim=-1, stable=True).indices
    cums = prefix_sum_bins(hist.gather(-2, order[..., None].expand(
        hist.shape)))
    gls, hls, cls = cums.unbind(-1)
    grs, hrs, crs = pg - gls, ph - hls, pc - cls
    nz_cnt = nonzero.sum(-1, dtype=torch.float32)[..., None]
    used_left = torch.arange(1, B + 1, device=dev, dtype=torch.float32)
    used_right = nz_cnt - used_left
    valid_s = ((cls >= md) & (crs >= md) & (hls >= mh) & (hrs >= mh)
               & (used_right >= 1)
               & (torch.minimum(used_left, used_right)
                  <= cfg.max_cat_threshold))
    gains_s = (_leaf_gain_l2(gls, hls, l1, l2c)
               + _leaf_gain_l2(grs, hrs, l1, l2c) - parent_gain)
    gains_s = torch.where(valid_s, gains_s, -torch.inf)

    gr1, hr1, cr1 = pg - g_b, ph - h_b, pc - c_b
    valid_1 = (nonzero & (c_b >= md) & (cr1 >= md) & (h_b >= mh)
               & (hr1 >= mh) & (nz_cnt >= 2))
    gains_1 = (_leaf_gain_l2(g_b, h_b, l1, l2c)
               + _leaf_gain_l2(gr1, hr1, l1, l2c) - parent_gain)
    gains_1 = torch.where(valid_1, gains_1, -torch.inf)

    use_onehot = (feat_nbins <= cfg.max_cat_to_onehot).expand(
        gains_s.shape[:-1])
    gains = torch.where(use_onehot[..., None], gains_1, gains_s)
    return (torch.where(cat_allowed[..., None], gains, -torch.inf), order,
            use_onehot)


def pack_bin_mask(mask: torch.Tensor, words: int) -> torch.Tensor:
    """``(..., B)`` bool bin subset → ``(..., words)`` bitset, 32 bits a
    word (bit ``b % 32`` of word ``b // 32`` is bin b), in int64."""
    B = mask.shape[-1]
    m = torch.nn.functional.pad(mask.to(torch.int64), (0, 32 * words - B))
    return (m.unflatten(-1, (words, 32))
            << torch.arange(32, device=mask.device)).sum(-1)


def bin_in_bitset(bits: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """Whether each bin of ``col`` is set in the ``(W,)`` bitset."""
    col = col.to(torch.int64)
    return ((bits[col >> 5] >> (col & 31)) & 1).to(torch.bool)


def find_best_cat_split(hist: torch.Tensor, parent_g, parent_h, parent_c,
                        cat_allowed: torch.Tensor, feat_nbins: torch.Tensor,
                        cfg: GrowerConfig):
    """Best categorical split over :func:`cat_split_gains` (the
    reference's ``_find_best_cat_split``): ``(gain, feature, position,
    bits)``, the first maximum over the flattened ``(f, B)`` gains, and
    the ``(..., W)`` bitset of the bins it sends left."""
    gains, order, use_onehot = cat_split_gains(
        hist, parent_g, parent_h, parent_c, cat_allowed, feat_nbins, cfg)
    gain, feat, k = _first_max(gains)
    B = hist.shape[-2]
    pos = torch.arange(B, device=hist.device)
    onehot_win = use_onehot.gather(-1, feat[..., None])
    order_f = order.gather(-2, feat[..., None, None].expand(
        feat.shape + (1, B)))[..., 0, :]
    sorted_left = torch.zeros_like(order_f).scatter(
        -1, order_f, (pos <= k[..., None]).to(order_f.dtype)) > 0
    mask = torch.where(onehot_win, pos == k[..., None], sorted_left)
    return gain, feat, k, pack_bin_mask(mask, cfg.cat_words)


def _with_cat(num, cat):
    """Merge the numeric winner ``(gain, feature, bin)`` with the
    categorical one ``(gain, feature, bits)``: the categorical split wins
    only with a strictly larger gain, and stores bin 0.  Returns ``(gain,
    feature, bin, is_cat, bits)``."""
    best, feat, b = num
    cg, cf, cb = cat
    wins = cg > best
    return (torch.maximum(best, cg), torch.where(wins, cf, feat),
            torch.where(wins, 0, b), wins.to(torch.int64),
            torch.where(wins[..., None], cb, 0))


def _no_cat(best, feat, b, cfg: GrowerConfig):
    zero = torch.zeros_like(feat)
    return best, feat, b, zero, zero[..., None].expand(
        feat.shape + (cfg.cat_words,))


def _first_max(gains: torch.Tensor):
    """``(best, feature, bin)`` of ``(..., f, B)`` gains: the first
    occurrence of the maximum over the flattened ``(f, B)``."""
    B = gains.shape[-1]
    flat = gains.flatten(-2)
    idx = flat.argmax(-1)
    return flat.gather(-1, idx[..., None])[..., 0], idx // B, idx % B


def _gain_floor(best: torch.Tensor, cfg: GrowerConfig) -> torch.Tensor:
    return torch.where(best > max(cfg.min_gain_to_split, EPS_GAIN), best,
                       -torch.inf)


def _best_split(hist, parent_g, parent_h, parent_c, feat_info, depth_ok,
                cfg: GrowerConfig):
    """:func:`find_best_split` before the gain floor."""
    num = _first_max(split_gains(hist, parent_g, parent_h, parent_c,
                                 feat_info, depth_ok, cfg))
    if not cfg.use_categorical:
        return _no_cat(*num, cfg)
    cg, cf, _, cb = find_best_cat_split(
        hist, parent_g, parent_h, parent_c,
        _cat_allowed(feat_info, depth_ok), feat_info[..., 2], cfg)
    return _with_cat(num, (cg, cf, cb))


def find_best_split(hist: torch.Tensor, parent_g, parent_h, parent_c,
                    feat_info: torch.Tensor, depth_ok: bool,
                    cfg: GrowerConfig):
    """Best split over a ``(..., f, B, 3)`` histogram: the numeric scan
    (:func:`split_gains`) and, under ``cfg.use_categorical``, the
    categorical search (:func:`find_best_cat_split`).  Returns ``(gain,
    feature, bin, is_cat, bits)``, gain ``-inf`` where no split clears
    the floor, ``bits`` the ``(..., W)`` bitset of a categorical split's
    left bins (zeros for a numeric one); the first-occurrence argmax over
    the flattened ``(f, B)`` gains breaks ties, as in the reference."""
    best, *rest = _best_split(hist, parent_g, parent_h, parent_c,
                              feat_info, depth_ok, cfg)
    return (_gain_floor(best, cfg), *rest)


# -- PV-Tree voting (reference grower.py _voting_* and
# find_best_split_voting / _pair) --------------------------------------------


def _is_voting(cfg: GrowerConfig) -> bool:
    return cfg.voting_k > 0 and cfg.data_axis_size > 1


def top_k_indices(score: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest entries of ``score`` along its last
    axis, largest first and, among equal scores, the lower index first —
    the order of ``jax.lax.top_k`` (a stable descending sort; ``torch.topk``
    promises no order for ties)."""
    return torch.sort(score, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def voting_votes(hist_local: torch.Tensor, feat_info: torch.Tensor,
                 depth_ok: bool, cfg: GrowerConfig) -> torch.Tensor:
    """A shard's vote: the ``min(voting_k, f)`` features with the best local
    split gain of its ``(..., f, B, 3)`` local histogram, scored against
    the shard's local leaf totals; a categorical feature scores its best
    categorical split."""
    f = hist_local.shape[-3]
    tot = sum_bins(hist_local[..., 0, :, :])
    score = split_gains(hist_local, tot[..., 0], tot[..., 1], tot[..., 2],
                        feat_info, depth_ok, cfg).amax(-1)
    if cfg.use_categorical:
        cat, _, _ = cat_split_gains(
            hist_local, tot[..., 0], tot[..., 1], tot[..., 2],
            _cat_allowed(feat_info, depth_ok), feat_info[..., 2], cfg)
        score = torch.maximum(score, cat.amax(-1))
    return top_k_indices(score, min(cfg.voting_k, f))


def voting_candidates(votes: torch.Tensor, f: int,
                      cfg: GrowerConfig) -> torch.Tensor:
    """The global candidates from every shard's votes (any shape): the
    ``min(2·voting_k, f)`` most-voted features, the lower id first among
    equal counts (the key ``counts·f + (f−1−i)`` has no ties).  int32."""
    counts = torch.bincount(votes.reshape(-1), minlength=f)
    k2 = min(2 * min(cfg.voting_k, f), f)
    key = counts * f + (f - 1 - torch.arange(f, device=votes.device))
    return top_k_indices(key, k2).to(torch.int32)


def voting_decide(slab: torch.Tensor, cand: torch.Tensor, parent_g,
                  parent_h, parent_c, feat_info: torch.Tensor,
                  depth_ok: bool, cfg: GrowerConfig):
    """The exact split over the reduced ``(..., k2, B, 3)`` candidate slab
    (``cand`` of shape ``(..., k2)``); features map back through
    ``cand``.  Returns ``(gain, feature, bin, is_cat, bits)`` as
    :func:`find_best_split`."""
    idx = cand.to(slab.device, torch.int64)
    best, j, b, is_cat, bits = _best_split(slab, parent_g, parent_h,
                                           parent_c, feat_info[idx],
                                           depth_ok, cfg)
    return (_gain_floor(best, cfg), idx.gather(-1, j[..., None])[..., 0], b,
            is_cat, bits)


def find_best_split_voting(hists: Sequence[torch.Tensor], tot: torch.Tensor,
                           feat_info: Sequence[torch.Tensor], depth_ok: bool,
                           cfg: GrowerConfig, mesh, scales=None):
    """PV-Tree split finding over the shards' local histograms ``hists[d]``
    (``(f, B, 3)``, or ``(m, f, B, 3)`` for the m children of one grow
    step; ``feat_info[d]`` on shard d's device) against the global totals
    ``tot`` (``(3,)`` or ``(m, 3)``): each shard votes locally, the votes
    are gathered (a stack: one controller drives every shard), the
    candidates are elected per child, and only the voted columns are
    reduced — by one ``ring_allreduce_select`` under the ring collective,
    else gathered and summed in shard order (the reference's psum) — for
    the exact decision on the first shard's device.  The m children ride
    one reduction of their stacked ``(m, k2, B, 3)`` slab.  Quantized
    (``scales[d]``, shard d's grid scale): the votes and the decision run
    on dequantized histograms, and the slab crosses as integer codes and
    is dequantized after the reduction."""
    dev = hists[0].device
    f = hists[0].shape[-3]
    scales = scales or [None] * len(hists)
    votes = torch.stack([voting_votes(dequantize(h, s), fi, depth_ok,
                                      cfg).to(dev)
                         for h, fi, s in zip(hists, feat_info, scales)])
    if votes.dim() == 2:
        cand = voting_candidates(votes, f, cfg)
    else:
        cand = torch.stack([voting_candidates(votes[:, c], f, cfg)
                            for c in range(votes.shape[1])])
    if cfg.collective == "ring":
        slab = ring_allreduce_select(hists, cand, mesh)[0]
    else:
        slab = wire_psum([gather_cand(h, cand) for h in hists], cfg)
    return voting_decide(dequantize(slab, scales[0]), cand, tot[..., 0],
                         tot[..., 1], tot[..., 2], feat_info[0], depth_ok,
                         cfg)


# -- quantized gradients (reference grower.py _quantize_gh, _wire_cast_psum)


def is_quantized(cfg: GrowerConfig) -> bool:
    return cfg.quantized_bits > 0 and cfg.quantized_max_code > 0


def quantize_gh(gh: Sequence[torch.Tensor], cfg: GrowerConfig, mesh=None
                ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Each device's ``(n, 3)`` float gh → ``(codes (n, 3) int32, scale
    (3,) f32)``, with ``codes · scale`` the dequantization (the
    reference's ``_quantize_gh``).  The grid scale of (grad, hess) is the
    largest |value| over the data shards of the device's feature slice
    (the reference's ``pmax`` over the data axis, every process's
    shards on a gang) times ``1 / max_code``;
    stochastic rounding ``floor(x) + (u < frac(x))`` draws ``u =
    uniform(fold_in(PRNGKey(seed), bits(g-max)), (n, 2))``, the same key
    on every shard; codes clip to ±``max_code``; the count channel (the
    0/1 mask) casts exactly."""
    F = cfg.feature_axis_size
    mc = cfg.quantized_max_code
    peak = [torch.stack([torch.stack([p[:, 0].abs().amax(),
                                      p[:, 1].abs().amax()]).to(gh[j].device)
                         for p in gh[j::F]]).amax(0)
            for j in range(F)]
    if is_gang(mesh):
        # the peaks of every process's shards: a max, in any order
        peak = [torch.stack(gang_gather([p], mesh)).amax(0) for p in peak]
    codes, scales = [], []
    for k, x in enumerate(gh):
        dev = x.device
        gmax, hmax = peak[k % F].to(dev).unbind()
        # the reference's compiled form of ``max / max_code``: XLA turns
        # the division by a constant into a product with its f32 inverse
        step = torch.stack([gmax, hmax]).clamp(min=1e-30) * torch.full(
            (2,), 1.0 / mc, dtype=torch.float32, device=dev)
        key = fold_in(prng_key(cfg.quantized_seed, dev), float_bits(gmax))
        u = uniform(key, (x.shape[0], 2))
        q = x[:, :2] / step
        lo = torch.floor(q)
        code = (lo + (u < q - lo).to(torch.float32)).clamp(-mc, mc)
        codes.append(torch.cat([code.to(torch.int32),
                                x[:, 2:3].to(torch.int32)], dim=1))
        scales.append(torch.cat([step, step.new_ones(1)]))
    return codes, scales


def dequantize(h: torch.Tensor, scale: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """Integer histogram cells or totals (last axis (g, h, count)) →
    float32 ``codes · scale``; ``h`` itself when ``scale`` is None."""
    if scale is None:
        return h
    return h.to(torch.float32) * scale.to(h.device)


def wire_psum(parts: Sequence[torch.Tensor], cfg: GrowerConfig
              ) -> torch.Tensor:
    """The shard-order sum (:func:`psum_plain`), integer slabs cast to the
    fit's int8 / int16 wire dtype and back (the reference's
    ``_wire_cast_psum``): the engine's headroom rule keeps every sum
    inside the wire dtype, so the result is the exact int32 sum."""
    wire = {"int8": torch.int8, "int16": torch.int16}.get(cfg.quantized_wire)
    if wire is None or parts[0].dtype.is_floating_point:
        return psum_plain(parts)
    return psum_plain([p.to(wire) for p in parts]).to(parts[0].dtype)


def _partition_left(row_order: torch.Tensor, col: torch.Tensor, thr: int,
                    off: int, cnt: int,
                    bits: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stable in-place partition of ``row_order[off:off+cnt]`` into the
    rows that go left — ``col[row] <= thr``, or with a categorical split's
    ``(W,)`` bin bitset ``bits`` (on the device), the rows whose bin is in
    it — followed by the rest (LightGBM's ``DataPartition::Split``;
    ``col`` is the split feature's bin column).  Returns the left count as
    a one-element tensor on the device (no host sync)."""
    if cnt == 0:
        return torch.zeros(1, dtype=torch.int64, device=row_order.device)
    seg = row_order[off:off + cnt]
    c = col[seg.to(torch.int64)]
    go_l = c <= thr if bits is None else bin_in_bitset(bits, c)
    csum_l = torch.cumsum(go_l, 0)
    n_l = csum_l[-1:]
    tgt = torch.where(go_l, csum_l - 1, n_l + torch.cumsum(~go_l, 0) - 1)
    out = torch.empty_like(seg)
    out[tgt] = seg
    seg.copy_(out)
    return n_l


def partition(row_order: torch.Tensor, bins: torch.Tensor, feat: int,
              thr: int, off: int, cnt: int,
              bits: Optional[torch.Tensor] = None) -> int:
    """:func:`_partition_left` on ``bins[:, feat]``, returning the left
    count (one host sync)."""
    if cnt == 0:
        return 0
    return int(_fetch(_partition_left(row_order, bins[:, feat], thr, off,
                                      cnt, bits))[0])


def _fetch(t: torch.Tensor) -> np.ndarray:
    grow_tree.host_syncs += 1
    return t.detach().cpu().numpy()


def _reduce_hist(parts: Sequence[torch.Tensor], cfg: GrowerConfig,
                 mesh) -> torch.Tensor:
    """Cross-shard sum of local histograms, on the first shard's device:
    the ``ring_allreduce`` kernel under ``collective="ring"``, else the
    shard-order sum (the reference's ``psum``; integer slabs at the wire
    width, :func:`wire_psum`).  On a gang: the shard-order sum of every
    process's parts (:func:`..ops.collectives.gang_gather`)."""
    if is_gang(mesh):
        return wire_psum(gang_gather(parts, mesh), cfg)
    if len(parts) == 1:
        return parts[0]
    if cfg.collective == "ring":
        return ring_allreduce(parts, mesh)[0]
    return wire_psum(parts, cfg)


def collective_schedule(cfg: GrowerConfig, f: int, *,
                        n_rows_local: int = 0) -> dict:
    """Per-tree accounting of the grower's cross-device collectives,
    computed from shapes as the reference's ``collective_schedule`` does:
    ``count`` payload-bearing collectives and ``payload_bytes`` handed to
    every collective of one tree (small ones included), against
    ``dense_payload_bytes``, the L dense ``(f, B, 3)`` f32 reductions of
    a data-parallel tree.

    * data axis: L histogram reductions (root + L-1 children) and the
      (L-1) partition-count pairs, which the port sums on the host but
      prices as the reference does;
    * voting: L reductions of the voted ``(k2, B, 3)`` slab (the root's,
      then one stacked pair per grow step), plus the vote gathers and the
      leaf-total sums;
    * feature axis (``n_rows_local`` rows per data shard): L-1 split-
      column broadcasts and the 2L-1 gathers of each slice's best split.

    Histogram slabs and partition counts are priced at the quantized
    wire's itemsize (1 or 2 bytes for int8 / int16; the rings carry f32
    lanes, 4); ``dense_payload_bytes`` stays f32.  A quantized data-axis
    fit also reports ``quantized_scale_bytes``, its grid-scale max pair.
    Serial fits return zeros."""
    B, L, W = cfg.num_bins, cfg.num_leaves, cfg.cat_words
    dense = L * f * B * 3 * 4
    wire = {"int8": 1, "int16": 2}.get(cfg.quantized_wire, 4)
    item = 4 if cfg.collective == "ring" else wire
    count = payload = scale_bytes = 0
    if cfg.data_axis_size > 1:
        if _is_voting(cfg):
            k = min(cfg.voting_k, f)
            slab = min(2 * k, f) * B * 3 * item
            count += L
            payload += slab + (L - 1) * 2 * slab   # root + stacked pairs
            payload += 4 * (k + (L - 1) * 2 * k)   # vote gathers (i32)
            payload += L * 3 * 4                   # leaf-total sums
        else:
            count += L
            payload += L * f * B * 3 * item
        if is_quantized(cfg):
            scale_bytes = 2 * 4                    # grid-scale max pair
        payload += (L - 1) * 2 * wire              # partition counts
    if cfg.feature_axis_size > 1:
        count += L - 1                             # split-column broadcasts
        payload += (L - 1) * n_rows_local * 4
        payload += (2 * L - 1) * (16 + W * 4)      # best-split gathers
    return {"count": count, "payload_bytes": payload,
            "dense_payload_bytes": dense,
            "quantized_scale_bytes": scale_bytes}


def grow_tree(bins: torch.Tensor, gh: torch.Tensor, feat_info,
              cfg: GrowerConfig, efb: Optional[EFBArrays] = None
              ) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree on ``bins``' device.  ``bins``: ``(n, f)`` bin codes
    (``(n, G)`` bundle columns with ``efb``, the maps on its device);
    ``gh``: ``(n, 3)`` masked (grad, hess, count); ``feat_info``: ``(f,
    3)`` [mask, is_cat, n_value_bins].  Returns
    the tree (host tensors) and the ``(n,)`` leaf of every row (on the
    device)."""
    tree, row_leaf, _ = grow_tree_sharded(
        [bins], [gh], feat_info, cfg, efb=None if efb is None else [efb])
    return tree, row_leaf[0]


def grow_tree_sharded(bins: Sequence[torch.Tensor],
                      gh: Sequence[torch.Tensor], feat_info,
                      cfg: GrowerConfig, mesh=None,
                      efb: Optional[Sequence[EFBArrays]] = None
                      ) -> Tuple[TreeArrays, List[torch.Tensor],
                                 List[torch.Tensor]]:
    """Grow one tree over the devices of ``mesh`` (one device and no mesh
    for a serial tree).  Device ``k`` (data shard ``d = k // F``, feature
    slice ``j = k % F``, with ``F = cfg.feature_axis_size``) holds
    ``bins[k]``, its shard's rows of its slice's ``f_local`` features, and
    ``gh[k]``; ``feat_info`` covers all ``F · f_local`` features.

    With ``efb`` (``efb[k]``: device k's :class:`EFBArrays`; no feature
    axis and no voting, the engine's gates) ``bins[k]`` holds G bundle
    columns and ``feat_info`` the f original features.

    Returns the tree (host tensors; features are global indices), the leaf
    of every row on each device, and the ``(L,)`` leaf values each device
    updates its scores with.  Those are the tree's, except on a feature
    axis: there each slice keeps its own leaf totals, taken from its own
    first feature, as every device of the reference does, and the tree
    carries slice 0's."""
    K = len(bins)
    F = cfg.feature_axis_size
    procs = mesh.process_count if is_gang(mesh) else 1
    # this process's data shards (all of them off a gang)
    Dd = K // F
    if K % F or Dd * procs != cfg.data_axis_size:
        raise ValueError(f"{K} devices for a {cfg.data_axis_size} x {F} "
                         "(data x feature) grid"
                         + (f" over {procs} processes" if procs > 1
                            else ""))
    if K > 1 and (mesh is None or len(mesh) != K):
        raise ValueError(f"{K} devices need a mesh of {K}")
    voting = _is_voting(cfg)
    if voting and F > 1:
        raise ValueError("voting parallelism runs on a mesh without a "
                         "feature axis")
    if efb is not None and (F > 1 or voting):
        raise ValueError("EFB runs serially or on a data-only mesh without "
                         "voting")
    # debug mode: every training path grows through here, so corrupt
    # codes and non-finite gradients are caught whatever the entry
    for b, g in zip(bins, gh):
        _debug.check_bins_in_range(b, cfg.num_bins)
        _debug.check_finite("gradients/hessians", g)
    devs = [b.device for b in bins]
    dev = devs[0]
    f_loc = bins[0].shape[1] if efb is None else efb[0].num_features
    n = np.asarray([bins[d * F].shape[0] for d in range(Dd)], np.int64)
    L, B = cfg.num_leaves, cfg.num_bins
    fi_all = torch.as_tensor(feat_info, dtype=torch.float32)
    fi = [fi_all[(k % F) * f_loc:(k % F + 1) * f_loc].to(devs[k])
          for k in range(K)]
    # histogram holders: under voting each shard keeps its local
    # histograms; otherwise each feature slice keeps its histograms
    # reduced over the data axis (on device (0, j)).  Value learners
    # (leaf totals): one global under voting, else one per slice.
    H = Dd if voting else F
    V = 1 if voting else F
    # quantized: integer codes, and the grid scale each histogram holder
    # (device k < H) dequantizes its histograms and totals with
    scale = [None] * H
    if is_quantized(cfg):
        gh, scales = quantize_gh(gh, cfg, mesh)
        scale = scales[:H]
    # the native host kernels (a CPU device under "auto" / "native", at
    # most 256 bins) read f32 or int16 codes: converted once a tree
    native = [native_applies(cfg.hist_method, B, d) for d in devs]
    gh = [native_gh(g) if nat else g for g, nat in zip(gh, native)]
    # the native split scan: a serial fit without categorical features,
    # and not the degenerate min_sum_hessian = lambda_l2 = 0, whose
    # empty-side gains go NaN (the reference's gate)
    native_split = (native[0] and K * procs == 1
                    and not cfg.use_categorical
                    and (cfg.min_sum_hessian_in_leaf > 0
                         or cfg.lambda_l2 > 0))

    def depth_ok(d):
        return cfg.max_depth <= 0 or d < cfg.max_depth

    def holders(local):
        if voting:
            return list(local)
        return [_reduce_hist(local[j::F], cfg, mesh) for j in range(F)]

    def totals(hists):
        if voting:
            return [psum_plain([dequantize(sum_bins(h[0]), s)
                                for h, s in zip(hists, scale)])]
        return [dequantize(sum_bins(h[..., 0, :, :]), s)
                for h, s in zip(hists, scale)]

    def left_totals(parent, hists_r, tots_r):
        """``parent − right`` of each value learner; quantized outside
        voting, the reference's compiled form of ``parent − codes ·
        scale``: one fused multiply-add, except where the native split
        scan reads the totals (the reference's custom call takes them from
        a fusion that rounds the product first)."""
        out = []
        for v, (t, s) in enumerate(zip(tots_r, scale)):
            p = torch.as_tensor(parent[v], device=t.device)
            if s is None or voting:
                out.append(p - t)
            else:
                codes = sum_bins(hists_r[v][..., 0, :, :]).to(torch.float32)
                out.append(p - codes * s if native_split
                           else fma32(-codes, s, p))
        return out

    def best_splits(hists, tots, depth):
        """(gain, feature, bin, is_cat, bits) on ``dev`` for the (m, ...)
        children."""
        ok = depth_ok(depth)
        if voting:
            return find_best_split_voting(hists, tots[0], fi, ok, cfg, mesh,
                                          scale)
        if native_split:
            return _native_best_split(dequantize(hists[0], scale[0]),
                                      tots[0], fi[0], ok, cfg)
        per = [_best_split(dequantize(h, s), t[..., 0], t[..., 1],
                           t[..., 2], fi[j], ok, cfg)
               for j, (h, t, s) in enumerate(zip(hists, tots, scale))]
        if F == 1:
            best, *rest = per[0]
            return (_gain_floor(best, cfg), *rest)
        # the first slice with the largest gain wins; its local feature
        # index becomes global, and its bitset travels with it
        stk = [torch.stack([p[i].to(dev) for p in per]) for i in range(5)]
        stk[1] = stk[1] + torch.arange(F, device=dev).reshape(
            (F,) + (1,) * (stk[1].dim() - 1)) * f_loc
        s = stk[0].argmax(0)[None]

        def pick(x):
            i = s.reshape(s.shape + (1,) * (x.dim() - s.dim()))
            return x.gather(0, i.expand((1,) + x.shape[1:]))[0]

        best, *rest = (pick(x) for x in stk)
        return (_gain_floor(best, cfg), *rest)

    W = cfg.cat_words

    def fetch(tots, gain, feat, b, is_cat, bits):
        """One host sync: the m children's totals and gains (float32
        bits) with their features, bins, categorical flags and bitsets,
        as one int64 tensor.  Returns ``(tots (V, m, 3), gain (m,), feat,
        bin, is_cat (m,), bits (m, W))`` in numpy."""
        fl = torch.cat([t.to(dev).reshape(-1) for t in tots]
                       + [gain.reshape(-1)])
        a = _fetch(torch.cat([fl.view(torch.int32).to(torch.int64)]
                             + [x.reshape(-1).to(torch.int64)
                                for x in (feat, b, is_cat, bits)]))
        m = gain.numel()
        fh = a[:fl.numel()].astype(np.int32).view(np.float32)
        ints = a[fl.numel():]
        return (fh[:-m].reshape(V, m, 3), fh[-m:], ints[:m],
                ints[m:2 * m], ints[2 * m:3 * m], ints[3 * m:].reshape(m, W))

    def expand(k, h):
        """Device k's histogram of its bins, per original feature."""
        return h if efb is None else efb_expand(h, efb[k])

    hist0 = holders([expand(k, compute_histogram(b, g, B, cfg.hist_method,
                                                 cfg.quantized_max_code))
                     for k, (b, g) in enumerate(zip(bins, gh))])
    tot0 = totals(hist0)
    res = fetch(tot0, *best_splits(hist0, tot0, 0))

    leaf_hist = [h.new_zeros((L,) + tuple(h.shape)) for h in hist0]
    for store, h in zip(leaf_hist, hist0):
        store[0] = h
    leaf_tot = np.zeros((V, L, 3), np.float32)
    best_gain = np.full(L, -np.inf, np.float32)
    best_feat = np.zeros(L, np.int64)
    best_bin = np.zeros(L, np.int64)
    best_is_cat = np.zeros(L, np.int64)
    best_bits = np.zeros((L, W), np.int64)
    leaf_tot[:, 0] = res[0][:, 0]
    (best_gain[0], best_feat[0], best_bin[0], best_is_cat[0],
     best_bits[0]) = (r[0] for r in res[1:])
    # per-data-shard segment of every leaf
    leaf_start = np.zeros((Dd, L), np.int64)
    leaf_cnt = np.zeros((Dd, L), np.int64)
    leaf_cnt[:, 0] = n
    leaf_depth = np.zeros(L, np.int64)
    leaf_parent = np.full(L, -1, np.int64)
    leaf_is_right = np.zeros(L, bool)
    m = L - 1
    node_feat = np.zeros(m, np.int32)
    node_bin = np.zeros(m, np.int32)
    node_left = np.zeros(m, np.int32)
    node_right = np.zeros(m, np.int32)
    node_gain = np.zeros(m, np.float32)
    node_tot = np.zeros((m, 3), np.float32)
    node_is_cat = np.zeros(m, np.int32)
    node_bits = np.zeros((m, W), np.int64)
    # one row permutation per device; the devices of a data shard
    # partition theirs alike
    row_order = [torch.arange(int(n[k // F]), dtype=torch.int32, device=d)
                 for k, d in enumerate(devs)]

    num_leaves = 1
    for i in range(m):
        l = int(np.argmax(best_gain))
        if best_gain[l] == -np.inf:
            break
        new = i + 1
        feat, thr = int(best_feat[l]), int(best_bin[l])
        off, cnt = leaf_start[:, l], leaf_cnt[:, l]
        # the owner slice's split column (and a categorical split's
        # bitset) partitions every device of its data shard
        owner, lidx = divmod(feat, f_loc)
        bits = ({d: torch.as_tensor(best_bits[l], device=d)
                 for d in set(devs)} if best_is_cat[l] else {})
        n_l = []
        for k in range(K):
            d = k // F
            if efb is None:
                col = bins[d * F + owner][:, lidx].to(devs[k])
            else:
                col = efb_feature_column(bins[k], feat, efb[k], B)
            if native[k]:
                n_l.append(native_partition(
                    row_order[k], col, int(off[d]), int(cnt[d]), thr,
                    best_bits[l] if best_is_cat[l] else None, W))
            else:
                n_l.append(_partition_left(row_order[k], col, thr,
                                           int(off[d]), int(cnt[d]),
                                           bits.get(devs[k])))
        cnt_l = _fetch(torch.cat([c.to(dev) for c in n_l[::F]])
                       ).astype(np.int64)
        cnt_r = cnt - cnt_l
        sides = np.asarray([cnt_l.sum(), cnt_r.sum()])
        if procs > 1:
            # the gang's sides: every process picks the same one
            sides = torch.stack(gang_gather(
                [torch.as_tensor(sides, device=dev)], mesh)).sum(0).cpu(
                ).numpy()
        use_right = sides[1] <= sides[0]
        small = _segment_hists(
            bins, gh, row_order, off + cnt_l if use_right else off,
            cnt_r if use_right else cnt_l, cfg, mesh, holders, expand)
        hist_r = [s if use_right else store[l] - s
                  for s, store in zip(small, leaf_hist)]
        hist_l = [store[l] - r for r, store in zip(hist_r, leaf_hist)]
        tot_r = totals(hist_r)
        tot_l = left_totals(leaf_tot[:, l], hist_r, tot_r)

        tots = [torch.stack([a, b]) for a, b in zip(tot_l, tot_r)]
        d_child = int(leaf_depth[l]) + 1
        res = fetch(tots, *best_splits(
            [torch.stack([a, b]) for a, b in zip(hist_l, hist_r)], tots,
            d_child))
        for store, a, b in zip(leaf_hist, hist_l, hist_r):
            store[l] = a
            store[new] = b

        p = leaf_parent[l]
        if p >= 0:
            if leaf_is_right[l]:
                node_right[p] = i
            else:
                node_left[p] = i
        node_feat[i], node_bin[i] = feat, thr
        node_left[i], node_right[i] = ~l, ~new
        node_gain[i] = best_gain[l]
        node_tot[i] = leaf_tot[0, l]
        node_is_cat[i], node_bits[i] = best_is_cat[l], best_bits[l]
        leaf_tot[:, [l, new]] = res[0]
        for arr, r in zip((best_gain, best_feat, best_bin, best_is_cat,
                           best_bits), res[1:]):
            arr[[l, new]] = r
        leaf_start[:, new] = off + cnt_l
        leaf_cnt[:, l], leaf_cnt[:, new] = cnt_l, cnt_r
        leaf_depth[[l, new]] = d_child
        leaf_parent[[l, new]] = i
        leaf_is_right[l], leaf_is_right[new] = False, True
        num_leaves += 1

    live = torch.arange(L) < num_leaves
    zero = torch.zeros(())
    values = [torch.where(live, _leaf_output(lt[:, 0], lt[:, 1], cfg), zero)
              for lt in torch.from_numpy(leaf_tot)]
    lt = torch.from_numpy(leaf_tot[0])
    nt = torch.from_numpy(node_tot)
    tree = TreeArrays(
        node_feat=torch.from_numpy(node_feat),
        node_bin=torch.from_numpy(node_bin),
        node_left=torch.from_numpy(node_left),
        node_right=torch.from_numpy(node_right),
        node_gain=torch.from_numpy(node_gain),
        node_value=torch.where(torch.arange(m) < num_leaves - 1,
                               _leaf_output(nt[:, 0], nt[:, 1], cfg), zero),
        node_weight=nt[:, 1].clone(),
        node_count=nt[:, 2].clone(),
        node_is_cat=torch.from_numpy(node_is_cat),
        node_cat_bits=torch.from_numpy(node_bits),
        leaf_value=values[0],
        leaf_weight=lt[:, 1].clone(),
        leaf_count=lt[:, 2].clone(),
        num_leaves=torch.tensor(num_leaves, dtype=torch.int32),
    )
    row_leaf = [_row_leaf(o, leaf_start[k // F, :num_leaves],
                          leaf_cnt[k // F, :num_leaves])
                for k, o in enumerate(row_order)]
    return tree, row_leaf, [values[0 if voting else k % F]
                            for k in range(K)]


def _segment_hists(bins, gh, row_order, offs, cnts, cfg: GrowerConfig,
                   mesh, holders, expand) -> List[torch.Tensor]:
    """Each histogram holder's histogram of the segments
    ``row_order[k][offs[d]:offs[d] + cnts[d]]`` (``d = k //
    cfg.feature_axis_size``), per original feature (``expand(k, h)``:
    device k's histogram of its bins expanded, the identity without EFB).
    On a data-only mesh under ``hist_method="pallas_ring"`` with the ring
    collective, no voting and at most ``FUSED_MAX_BINS`` bins, one
    ``fused_segment_hist_ring`` kernel gathers, histograms and reduces
    (the reduction happens in-kernel; the reduced histogram is expanded
    after it); otherwise each device's segment histogram is expanded and
    goes to ``holders`` (reduced over the data axis, or kept local under
    voting)."""
    B, F = cfg.num_bins, cfg.feature_axis_size
    if (len(bins) > 1 and F == 1 and cfg.collective == "ring"
            and cfg.hist_method == "pallas_ring" and not _is_voting(cfg)
            and B <= FUSED_MAX_BINS):
        return [expand(0, fused_segment_hist_ring(
            [(b, g, o, int(off), int(cnt)) for b, g, o, off, cnt
             in zip(bins, gh, row_order, offs, cnts)], B, mesh,
            accum_mode(cfg.hist_method, gh[0]))[0])]
    return holders([
        expand(k, segment_histogram(b, g, o, int(offs[k // F]),
                                    int(cnts[k // F]), B, cfg.hist_method,
                                    cfg.quantized_max_code))
        for k, (b, g, o) in enumerate(zip(bins, gh, row_order))])


def _native_best_split(hist: torch.Tensor, tot: torch.Tensor,
                       feat_info: torch.Tensor, depth_ok: bool,
                       cfg: GrowerConfig):
    """:func:`find_best_split` of a serial fit through the native split
    scan (:func:`..ops.histogram.native_find_split`) over each of the
    ``(..., f, B, 3)`` CPU histograms against its ``(..., 3)`` totals:
    ``(gain, feature, bin, is_cat, bits)`` with no categorical split."""
    flat_h = hist.reshape((-1,) + tuple(hist.shape[-3:]))
    flat_t = tot.reshape(-1, 3).tolist()
    res = [native_find_split(h, *t, feat_info[:, 0], depth_ok,
                             cfg.min_data_in_leaf,
                             cfg.min_sum_hessian_in_leaf, cfg.lambda_l1,
                             cfg.lambda_l2,
                             max(cfg.min_gain_to_split, EPS_GAIN))
           for h, t in zip(flat_h, flat_t)]
    shape = hist.shape[:-3]
    gain = torch.stack([r[0] for r in res]).reshape(shape)
    feat, b = (torch.tensor([r[i] for r in res]).reshape(shape)
               for i in (1, 2))
    return _no_cat(gain, feat, b, cfg)


def _row_leaf(row_order: torch.Tensor, start: np.ndarray,
              cnt: np.ndarray) -> torch.Tensor:
    """Leaf of every row of a shard: each leaf's rows are its contiguous
    ``row_order`` segment."""
    dev = row_order.device
    n = row_order.shape[0]
    order = np.argsort(start, kind="stable")
    leaf_of_pos = torch.repeat_interleave(
        torch.as_tensor(order, device=dev),
        torch.as_tensor(cnt[order], device=dev), output_size=n)
    row_leaf = torch.empty(n, dtype=torch.int64, device=dev)
    row_leaf[row_order.to(torch.int64)] = leaf_of_pos
    return row_leaf


grow_tree.host_syncs = 0


def apply_shrinkage(tree: TreeArrays, learning_rate: float) -> TreeArrays:
    return tree._replace(leaf_value=tree.leaf_value * learning_rate,
                         node_value=tree.node_value * learning_rate)


def predict_tree_binned(tree: TreeArrays, bins: torch.Tensor,
                        max_steps: int, efb: Optional[EFBArrays] = None,
                        num_bins: int = 256) -> torch.Tensor:
    """Leaf value of every row of ``bins`` through one tree
    (:func:`leaf_index_binned`; ``efb``: the maps of the bundled matrix
    ``bins``, the reference's ``predict_tree_binned_any``)."""
    return tree.leaf_value.to(bins.device)[
        leaf_index_binned(tree, bins, max_steps, efb, num_bins)]


def tree_depth(tree: TreeArrays) -> int:
    """Internal nodes on the tree's longest root-to-leaf path, from its
    host arrays (a node's children are created after it)."""
    m = int(tree.num_leaves) - 1
    depth = np.zeros(max(m, 1), np.int64)
    depth[0] = 1
    for i, (a, b) in enumerate(zip(tree.node_left[:m].tolist(),
                                   tree.node_right[:m].tolist())):
        for c in (a, b):
            if c >= 0:
                depth[c] = depth[i] + 1
    return int(depth[:m].max()) if m > 0 else 0


def leaf_index_binned(tree: TreeArrays, bins: torch.Tensor,
                      max_steps: int, efb: Optional[EFBArrays] = None,
                      num_bins: int = 256) -> torch.Tensor:
    """Leaf of every row of ``bins`` through one tree, walked with binned
    thresholds (``bin <= node_bin`` goes left; at a categorical node, a
    bin set in the node's bitset): as many steps as the tree is deep (at
    most ``max_steps``), with no host sync.  ``efb``: ``bins`` is the
    bundled matrix these maps describe, and each level decodes the row's
    bundle column back to the node's feature (the reference's
    ``predict_tree_binned_efb``; pass it only with the matrix it
    describes — a validation matrix is never bundled)."""
    dev = bins.device
    n = bins.shape[0]
    feat = tree.node_feat.to(dev, torch.int64)
    thr = tree.node_bin.to(dev)
    is_cat = tree.node_is_cat.to(dev) > 0
    cat_bits = tree.node_cat_bits.to(dev, torch.int64)
    has_cat = bool(tree.node_is_cat.any())
    left = tree.node_left.to(dev, torch.int64)
    right = tree.node_right.to(dev, torch.int64)
    node = torch.full((n,), 0 if int(tree.num_leaves) > 1 else -1,
                      dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    for _ in range(min(max_steps, tree_depth(tree))):
        inner = node >= 0
        safe = node.clamp(min=0)
        f_node = feat[safe]
        if efb is None:
            val = bins[rows, f_node].to(torch.int64)
        else:
            val = _efb_decode(bins[rows, efb.bundle_of[f_node]],
                              efb.off_of[f_node], efb.nb_of[f_node],
                              efb.default_of[f_node], num_bins)
        go_left = val <= thr[safe]
        if has_cat:
            word = cat_bits[safe].gather(1, (val >> 5)[:, None])[:, 0]
            go_left = torch.where(is_cat[safe], ((word >> (val & 31)) & 1)
                                  .to(torch.bool), go_left)
        node = torch.where(inner, torch.where(go_left, left[safe],
                                              right[safe]), node)
    return ~node
