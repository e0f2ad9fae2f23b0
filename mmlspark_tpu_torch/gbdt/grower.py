"""Leaf-wise histogram tree grower.

The port's counterpart of ``mmlspark_tpu/gbdt/grower.py`` for numeric
splits on one device.  The reference grows a tree inside one jitted
``fori_loop`` with static shapes; here PyTorch runs eagerly, so a Python
loop drives the split steps and the host keeps the small per-leaf state
(segment offsets and counts, best splits, totals), while the binned
matrix, the gradients, the row permutation and the leaf histograms stay
on the device:

* **Partition.**  Each leaf owns the contiguous segment
  ``row_order[start:start+cnt]`` (LightGBM's DataPartition).  A split
  partitions that segment stably in place, and only the smaller child's
  rows are histogrammed (:func:`..ops.histogram.segment_histogram`, the
  ``hist_segment`` kernel on CUDA); the sibling comes from subtraction in
  the reference's exact f32 form.  Exact segment counts replace the
  reference's power-of-two bucket ladder.
* **Host syncs.**  Two per split: the partition count (launch sizing
  needs it) and the children's best splits (the next leaf choice needs
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
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..ops.histogram import compute_histogram, segment_histogram

EPS_GAIN = 1e-10
#: block widths of XLA's CPU prefix scan and tree reduction over the bins
#: axis (its ReduceWindowRewriter and TreeReductionRewriter)
_SCAN_BLOCK = 16
_SUM_BLOCK = 32


@dataclass(frozen=True)
class GrowerConfig:
    """Hyper-parameters of one tree (numeric splits)."""
    num_leaves: int = 31
    max_depth: int = -1
    num_bins: int = 256
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    hist_method: str = "auto"

    @property
    def cat_words(self) -> int:
        """Words per node of the (unused, zero) categorical bitset."""
        return max(1, (self.num_bins + 31) // 32)


class TreeArrays(NamedTuple):
    """One grown tree (host tensors).  A child value ``c >= 0`` is an
    internal node index, ``c < 0`` is leaf ``~c``.  The categorical fields
    are kept, and zero, so the layout matches the reference's."""
    node_feat: torch.Tensor    # (L-1,) i32
    node_bin: torch.Tensor     # (L-1,) i32 threshold bin (<= goes left)
    node_left: torch.Tensor    # (L-1,) i32
    node_right: torch.Tensor   # (L-1,) i32
    node_gain: torch.Tensor    # (L-1,) f32
    node_value: torch.Tensor   # (L-1,) f32 internal output
    node_weight: torch.Tensor  # (L-1,) f32 sum of hessians
    node_count: torch.Tensor   # (L-1,) f32 row count
    node_is_cat: torch.Tensor  # (L-1,) i32, zero
    node_cat_bits: torch.Tensor  # (L-1, W) i64, zero
    leaf_value: torch.Tensor   # (L,) f32
    leaf_weight: torch.Tensor  # (L,) f32
    leaf_count: torch.Tensor   # (L,) f32
    num_leaves: torch.Tensor   # () i32 actual leaves grown


def _leaf_gain(g, h, cfg: GrowerConfig):
    t = torch.sign(g) * torch.clamp(torch.abs(g) - cfg.lambda_l1, min=0.0)
    return torch.square(t) / (h + cfg.lambda_l2)


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


def find_best_split(hist: torch.Tensor, parent_g, parent_h, parent_c,
                    feat_info: torch.Tensor, depth_ok: bool,
                    cfg: GrowerConfig
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best numeric split over a ``(..., f, B, 3)`` histogram against the
    parent totals (each of shape ``(...)``).  Returns ``(gain, feature,
    bin)``, gain ``-inf`` where no split clears the floor.

    Mirrors the reference (LightGBM's FindBestThreshold): left = bins <=
    b, validity by min_data_in_leaf / min_sum_hessian, the last bin never
    splits, gain = ΔL over the parent leaf, and the first-occurrence
    argmax over the flattened ``(f, B)`` gains breaks ties.
    """
    B = hist.shape[-2]
    cum = prefix_sum_bins(hist)
    gl, hl, cl = cum.unbind(-1)
    pg = torch.as_tensor(parent_g)[..., None, None]
    ph = torch.as_tensor(parent_h)[..., None, None]
    pc = torch.as_tensor(parent_c)[..., None, None]
    gr, hr, cr = pg - gl, ph - hl, pc - cl
    valid = ((cl >= cfg.min_data_in_leaf) & (cr >= cfg.min_data_in_leaf)
             & (hl >= cfg.min_sum_hessian_in_leaf)
             & (hr >= cfg.min_sum_hessian_in_leaf))
    valid &= torch.arange(B, device=hist.device) < B - 1
    valid &= (feat_info[:, 0] > 0)[:, None]
    valid &= bool(depth_ok)
    parent_gain = _leaf_gain(pg, ph, cfg)
    gains = _leaf_gain(gl, hl, cfg) + _leaf_gain(gr, hr, cfg) - parent_gain
    gains = torch.where(valid, gains, -torch.inf)
    flat = gains.flatten(-2)
    idx = flat.argmax(-1)
    best = flat.gather(-1, idx[..., None])[..., 0]
    gain = torch.where(best > max(cfg.min_gain_to_split, EPS_GAIN), best,
                       -torch.inf)
    return gain, idx // B, idx % B


def partition(row_order: torch.Tensor, bins: torch.Tensor, feat: int,
              thr: int, off: int, cnt: int) -> int:
    """Stable in-place partition of ``row_order[off:off+cnt]`` into the
    rows with ``bins[row, feat] <= thr`` followed by the rest (LightGBM's
    ``DataPartition::Split``).  Returns the left count (one host sync)."""
    if cnt == 0:
        return 0
    seg = row_order[off:off + cnt]
    go_l = bins[seg.to(torch.int64), feat] <= thr
    csum_l = torch.cumsum(go_l, 0)
    n_l = csum_l[-1:]
    tgt = torch.where(go_l, csum_l - 1, n_l + torch.cumsum(~go_l, 0) - 1)
    out = torch.empty_like(seg)
    out[tgt] = seg
    seg.copy_(out)
    return int(_fetch(n_l)[0])


def _fetch(t: torch.Tensor) -> np.ndarray:
    grow_tree.host_syncs += 1
    return t.detach().cpu().numpy()


def grow_tree(bins: torch.Tensor, gh: torch.Tensor, feat_info,
              cfg: GrowerConfig) -> Tuple[TreeArrays, torch.Tensor]:
    """Grow one tree on ``bins``' device.  ``bins``: ``(n, f)`` bin codes;
    ``gh``: ``(n, 3)`` masked (grad, hess, count); ``feat_info``: ``(f,
    3)`` [mask, is_cat, n_value_bins] (only the mask is read).  Returns
    the tree (host tensors) and the ``(n,)`` leaf of every row (on the
    device)."""
    dev = bins.device
    n, f = bins.shape
    L, B = cfg.num_leaves, cfg.num_bins
    fi = torch.as_tensor(feat_info, dtype=torch.float32, device=dev)

    def depth_ok(d):
        return cfg.max_depth <= 0 or d < cfg.max_depth

    hist0 = compute_histogram(bins, gh, B, cfg.hist_method)
    tot0 = sum_bins(hist0[0])
    gain0, feat0, bin0 = find_best_split(hist0, tot0[0], tot0[1], tot0[2],
                                         fi, depth_ok(0), cfg)
    res = _fetch(torch.cat([tot0, torch.stack([gain0, feat0.float(),
                                               bin0.float()])]))

    leaf_hist = hist0.new_zeros((L, f, B, 3))
    leaf_hist[0] = hist0
    leaf_tot = np.zeros((L, 3), np.float32)
    leaf_tot[0] = res[:3]
    best_gain = np.full(L, -np.inf, np.float32)
    best_feat = np.zeros(L, np.int64)
    best_bin = np.zeros(L, np.int64)
    best_gain[0], best_feat[0], best_bin[0] = res[3], res[4], res[5]
    leaf_start = np.zeros(L, np.int64)
    leaf_cnt = np.zeros(L, np.int64)
    leaf_cnt[0] = n
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
    row_order = torch.arange(n, dtype=torch.int32, device=dev)

    num_leaves = 1
    for i in range(m):
        l = int(np.argmax(best_gain))
        if best_gain[l] == -np.inf:
            break
        new = i + 1
        feat, thr = int(best_feat[l]), int(best_bin[l])
        off, cnt = int(leaf_start[l]), int(leaf_cnt[l])
        cnt_l = partition(row_order, bins, feat, thr, off, cnt)
        cnt_r = cnt - cnt_l
        use_right = cnt_r <= cnt_l
        small = segment_histogram(
            bins, gh, row_order, off + cnt_l if use_right else off,
            cnt_r if use_right else cnt_l, B, cfg.hist_method)
        parent = leaf_hist[l]
        hist_r = small if use_right else parent - small
        hist_l = parent - hist_r
        tot_r = sum_bins(hist_r[0])
        tot_l = torch.as_tensor(leaf_tot[l], device=dev) - tot_r
        tots = torch.stack([tot_l, tot_r])
        d = int(leaf_depth[l]) + 1
        g2, f2, b2 = find_best_split(torch.stack([hist_l, hist_r]),
                                     tots[:, 0], tots[:, 1], tots[:, 2],
                                     fi, depth_ok(d), cfg)
        leaf_hist[l] = hist_l
        leaf_hist[new] = hist_r
        res = _fetch(torch.cat([tots.reshape(-1), g2, f2.float(),
                                b2.float()]))

        p = leaf_parent[l]
        if p >= 0:
            if leaf_is_right[l]:
                node_right[p] = i
            else:
                node_left[p] = i
        node_feat[i], node_bin[i] = feat, thr
        node_left[i], node_right[i] = ~l, ~new
        node_gain[i] = best_gain[l]
        node_tot[i] = leaf_tot[l]
        leaf_tot[l], leaf_tot[new] = res[0:3], res[3:6]
        best_gain[[l, new]] = res[6:8]
        best_feat[[l, new]] = res[8:10]
        best_bin[[l, new]] = res[10:12]
        leaf_start[new] = off + cnt_l
        leaf_cnt[l], leaf_cnt[new] = cnt_l, cnt_r
        leaf_depth[[l, new]] = d
        leaf_parent[[l, new]] = i
        leaf_is_right[l], leaf_is_right[new] = False, True
        num_leaves += 1

    lt = torch.from_numpy(leaf_tot)
    nt = torch.from_numpy(node_tot)
    live = torch.arange(L) < num_leaves
    zero = torch.zeros(())
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
        node_is_cat=torch.zeros(m, dtype=torch.int32),
        node_cat_bits=torch.zeros(m, cfg.cat_words, dtype=torch.int64),
        leaf_value=torch.where(live, _leaf_output(lt[:, 0], lt[:, 1], cfg),
                               zero),
        leaf_weight=lt[:, 1].clone(),
        leaf_count=lt[:, 2].clone(),
        num_leaves=torch.tensor(num_leaves, dtype=torch.int32),
    )
    # per-row leaf: each leaf's rows are its contiguous row_order segment
    order = np.argsort(leaf_start[:num_leaves], kind="stable")
    leaf_of_pos = torch.repeat_interleave(
        torch.as_tensor(order, device=dev),
        torch.as_tensor(leaf_cnt[:num_leaves][order], device=dev),
        output_size=n)
    row_leaf = torch.empty(n, dtype=torch.int64, device=dev)
    row_leaf[row_order.to(torch.int64)] = leaf_of_pos
    return tree, row_leaf


grow_tree.host_syncs = 0


def apply_shrinkage(tree: TreeArrays, learning_rate: float) -> TreeArrays:
    return tree._replace(leaf_value=tree.leaf_value * learning_rate,
                         node_value=tree.node_value * learning_rate)


def predict_tree_binned(tree: TreeArrays, bins: torch.Tensor,
                        max_steps: int) -> torch.Tensor:
    """Leaf value of every row of ``bins`` through one tree, walked with
    binned thresholds (``bin <= node_bin`` goes left)."""
    dev = bins.device
    n = bins.shape[0]
    feat = tree.node_feat.to(dev, torch.int64)
    thr = tree.node_bin.to(dev)
    left = tree.node_left.to(dev, torch.int64)
    right = tree.node_right.to(dev, torch.int64)
    node = torch.full((n,), 0 if int(tree.num_leaves) > 1 else -1,
                      dtype=torch.int64, device=dev)
    rows = torch.arange(n, device=dev)
    for _ in range(max_steps):
        inner = node >= 0
        if not bool(inner.any()):
            break
        safe = node.clamp(min=0)
        go_left = bins[rows, feat[safe]].to(torch.int32) <= thr[safe]
        node = torch.where(inner, torch.where(go_left, left[safe],
                                              right[safe]), node)
    return tree.leaf_value.to(dev)[~node]
