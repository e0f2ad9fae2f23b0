"""The port's grower against the JAX reference's, on the CPU.

The reference runs with ``hist_method="segment"``, the formulation whose
float path the port follows (the CPU default ``auto`` would take its split
winners from the native C++ scan).  Split winners, partitions, tree
structure and per-row leaves are compared exactly; leaf values within
1e-5 (they agree bit for bit today, because the port adds over the bins
axis in XLA's CPU order).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.gbdt import grower as ref
from mmlspark_tpu_torch.convert import tree_arrays_from_numpy
from mmlspark_tpu_torch.gbdt import grower as port
from mmlspark_tpu_torch.ops.cuda_histogram import histogram_plain
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

_ref_split = jax.jit(ref.find_best_split, static_argnames=("cfg",))

CFGS = [dict(min_data_in_leaf=5),
        dict(min_data_in_leaf=3, lambda_l1=0.5, lambda_l2=1.0,
             min_sum_hessian_in_leaf=0.5, min_gain_to_split=0.01)]


def _hist(rng, n, f, B):
    bins = rng.integers(0, B, size=(n, f))
    # a skewed column and an empty-bin run make ties and invalid cells
    bins[:, 0] = np.minimum(bins[:, 0], B // 3)
    gh = np.stack([rng.normal(size=n), rng.uniform(0.01, 0.25, size=n),
                   np.ones(n)], axis=1).astype(np.float32)
    return histogram_plain(torch.from_numpy(bins), torch.from_numpy(gh), B)


@pytest.mark.parametrize("B", [16, 63, 256])
@pytest.mark.parametrize("which", range(len(CFGS)))
def test_find_best_split_winner_identity(B, which):
    """~200 fuzzed histograms over the parametrisation: the same winner
    and the same gain bits."""
    kw = CFGS[which]
    rcfg = ref.GrowerConfig(num_bins=B, hist_method="segment", **kw)
    pcfg = port.GrowerConfig(num_bins=B, hist_method="segment", **kw)
    rng = np.random.default_rng(B * 10 + which)
    f = 6
    fi = np.ones((f, 3), np.float32)
    for trial in range(35):
        n = int(rng.integers(20, 400))
        h = _hist(rng, n, f, B)
        fi[:, 0] = (rng.random(f) < 0.8) if trial % 5 == 4 else 1.0
        tot = port.sum_bins(h[0])
        depth_ok = trial % 11 != 10
        pg, pf, pb, _, _ = port.find_best_split(
            h, tot[0], tot[1], tot[2], torch.from_numpy(fi), depth_ok, pcfg)
        rg, rf, rb, _, _ = _ref_split(jnp.asarray(h.numpy()), tot[0].item(),
                                      tot[1].item(), tot[2].item(),
                                      jnp.asarray(fi), depth_ok, cfg=rcfg)
        msg = f"trial {trial}"
        if np.isfinite(float(rg)) or np.isfinite(float(pg)):
            assert (int(pf), int(pb)) == (int(rf), int(rb)), msg
        np.testing.assert_array_equal(np.float32(pg), np.float32(rg),
                                      err_msg=msg)


@pytest.mark.parametrize("B", [1, 7, 16, 17, 63, 64, 100, 256, 257])
def test_bin_axis_sums_follow_xla_cpu_order(B):
    x = np.random.default_rng(B).normal(size=(4, 3, B, 3)).astype(
        np.float32) * 100
    np.testing.assert_array_equal(
        port.prefix_sum_bins(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(lambda v: jnp.cumsum(v, axis=2))(x)))
    np.testing.assert_array_equal(
        port.sum_bins(torch.from_numpy(x)).numpy(),
        np.asarray(jax.jit(lambda v: jnp.sum(v, axis=2))(x)))


@pytest.mark.parametrize("thr", [0, 9, 31])
def test_partition_matches_reference(thr):
    n, B = 1500, 32
    rng = np.random.default_rng(thr)
    bins = rng.integers(0, B, size=(n, 3)).astype(np.uint8)
    order = rng.permutation(n).astype(np.int32)
    off, cnt, feat = 211, 900, 1
    cfg = ref.GrowerConfig(num_bins=B, hist_method="segment")
    sizes = ref._bucket_sizes(n, cfg)
    ro = jnp.concatenate([jnp.asarray(order),
                          jnp.full(sizes[-1], n, jnp.int32)])
    want, wl, wr = ref._partition_switch(
        ro, jnp.asarray(bins[:, feat]), jnp.int32(off), jnp.int32(cnt),
        jnp.int32(thr), jnp.asarray(False), jnp.zeros(1, jnp.uint32), n,
        sizes, cfg)
    got = torch.from_numpy(order.copy())
    n_l = port.partition(got, torch.from_numpy(bins), feat, thr, off, cnt)
    assert (n_l, cnt - n_l) == (int(wl), int(wr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n])


GROW_CASES = [
    dict(B=256, leaves=31, cfg=dict(min_data_in_leaf=20)),
    dict(B=64, leaves=15, cfg=dict(min_data_in_leaf=5, lambda_l2=1.0,
                                   max_depth=4)),
    dict(B=16, leaves=7, cfg=dict(min_data_in_leaf=10, lambda_l1=0.2,
                                  min_gain_to_split=0.05)),
]


def _grow_inputs(B, seed=0, n=2500, f=9):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    bins = np.clip(((X + 3) / 6 * B).astype(np.int64), 0, B - 1)
    y = X[:, 0] * 2 + np.sin(3 * X[:, 1]) + X[:, 2] * X[:, 3] \
        + rng.normal(size=n) * 0.3
    g = (0.3 - y).astype(np.float32)
    h = rng.uniform(0.5, 1.5, size=n).astype(np.float32)
    bag = (rng.random(n) < 0.8).astype(np.float32)
    gh = np.stack([g * bag, h * bag, bag], axis=1)
    return bins.astype(np.uint8), gh


@pytest.mark.parametrize("case", range(len(GROW_CASES)))
def test_grow_tree_matches_reference(case):
    c = GROW_CASES[case]
    bins, gh = _grow_inputs(c["B"], seed=case)
    f = bins.shape[1]
    fi = np.ones((f, 3), np.float32)
    fi[3, 0] = 0.0                       # a feature-fraction mask
    rcfg = ref.GrowerConfig(num_leaves=c["leaves"], num_bins=c["B"],
                            hist_method="segment", **c["cfg"])
    pcfg = port.GrowerConfig(num_leaves=c["leaves"], num_bins=c["B"],
                             hist_method="segment", **c["cfg"])
    rtree, rleaf = ref.grow_tree(jnp.asarray(bins), jnp.asarray(gh),
                                 jnp.asarray(fi), rcfg)
    ptree, pleaf = port.grow_tree(torch.from_numpy(bins),
                                  torch.from_numpy(gh), fi, pcfg)
    assert int(ptree.num_leaves) == int(rtree.num_leaves) > 2
    for name in ("node_feat", "node_bin", "node_left", "node_right",
                 "node_is_cat", "node_count", "leaf_count"):
        np.testing.assert_array_equal(getattr(ptree, name).numpy(),
                                      np.asarray(getattr(rtree, name)),
                                      err_msg=name)
    for name in ("node_gain", "node_value", "node_weight", "leaf_value",
                 "leaf_weight"):
        np.testing.assert_allclose(getattr(ptree, name).numpy(),
                                   np.asarray(getattr(rtree, name)),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(pleaf.numpy(), np.asarray(rleaf))

    # the binned walk of the converted reference tree lands every row in
    # the leaf the grower put it in
    conv = tree_arrays_from_numpy(**{k: np.asarray(v) for k, v
                                     in rtree._asdict().items()})
    walked = port.predict_tree_binned(conv, torch.from_numpy(bins),
                                      c["leaves"])
    np.testing.assert_array_equal(
        walked.numpy(), np.asarray(ref.predict_tree_binned(
            rtree, jnp.asarray(bins), c["leaves"])))
    np.testing.assert_array_equal(
        walked.numpy(), ptree.leaf_value.numpy()[pleaf.numpy()])


def test_apply_shrinkage_matches_reference():
    bins, gh = _grow_inputs(64, seed=9, n=600)
    cfg = port.GrowerConfig(num_leaves=7, num_bins=64)
    tree, _ = port.grow_tree(torch.from_numpy(bins), torch.from_numpy(gh),
                             np.ones((bins.shape[1], 3), np.float32), cfg)
    shrunk = port.apply_shrinkage(tree, 0.1)
    want = ref.apply_shrinkage(ref.TreeArrays(**{
        k: jnp.asarray(v.numpy()) for k, v in tree._asdict().items()}), 0.1)
    np.testing.assert_array_equal(shrunk.leaf_value.numpy(),
                                  np.asarray(want.leaf_value))
    np.testing.assert_array_equal(shrunk.node_value.numpy(),
                                  np.asarray(want.node_value))
