"""Categorical features in the port against the JAX reference, on the CPU.

The reference is pinned to ``histogram_method="segment"`` (its ``auto``
takes the native C++ partition on the CPU), and its grower's pieces run
jitted, as ``tests/test_torch_grower.py`` runs them.  Inputs come from
numpy seeds at small sizes.

* Binning: ``cat_values``, bin codes (NaN, unseen, negative and
  fractional values, categories beyond ``max_bin − 1``), ``feature_infos``
  and the JSON round trip equal the reference's exactly; negative and
  non-integer categories raise.
* Split search: the categorical gains, the sorted order, the winner and
  its bitset, and the merged numeric/categorical winner equal the
  reference's (``assert_array_equal``) on seeded histograms with ratio
  ties, ``maxCatToOnehot`` at and above the cardinality, a binding
  ``maxCatThreshold``, empty bins, a heavy missing bin and a
  numeric/categorical tie (the numeric split wins).
* Partition, grower, voting helpers: equal to the reference's.
* Fits: model text byte for byte — serial classifier and regressor
  (``categoricalSlotIndexes`` and ``categoricalSlotNames``), bagging with
  feature fraction, the data learner with psum and ring at D = 2 and 4,
  voting with psum and ring at D = 4, feature 1 × 2 and data+feature
  2 × 2; a ``pallas_ring`` fit holds the structure and leaves within
  rtol 1e-5.  ``Booster.predict`` and the estimator's columns equal the
  reference's on raw values with NaN, unseen, negative and fractional
  categories.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from mmlspark_tpu.core.mesh import build_mesh as ref_build_mesh
from mmlspark_tpu.gbdt import LightGBMClassifier as RefClassifier
from mmlspark_tpu.gbdt import LightGBMRegressor as RefRegressor
from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit
from mmlspark_tpu.gbdt import grower as ref
from mmlspark_tpu.gbdt.binning import BinMapper as RefBinMapper
from mmlspark_tpu.gbdt.engine import TrainParams as RefParams
from mmlspark_tpu.gbdt.engine import train as ref_train
from mmlspark_tpu.gbdt.objectives import get_objective as ref_objective
from mmlspark_tpu_torch import LightGBMClassifier, LightGBMRegressor
from mmlspark_tpu_torch.convert import tree_arrays_from_numpy
from mmlspark_tpu_torch.core.mesh import build_mesh
from mmlspark_tpu_torch.gbdt import engine, fit_bin_mapper, get_objective
from mmlspark_tpu_torch.gbdt import grower as port
from mmlspark_tpu_torch.gbdt.binning import BinMapper
from mmlspark_tpu_torch.gbdt.engine import TrainParams, train
from test_categorical import _interleaved_cat_data
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# -- binning -------------------------------------------------------------------

CARDINALITIES = (2, 4, 5, 24, 300)


def _cat_matrix(seed=0, n=3000):
    """One categorical column per cardinality (Zipf-like counts, so the
    most-frequent order matters), NaN in two of them, and a numeric
    column."""
    rng = np.random.default_rng(seed)
    cols = []
    for card in CARDINALITIES:
        p = 1.0 / np.arange(1, card + 1)
        cols.append(rng.choice(card, size=n, p=p / p.sum())
                    .astype(np.float64))
    X = np.stack(cols + [rng.normal(size=n)], axis=1)
    X[rng.random(n) < 0.05, 2] = np.nan
    X[rng.random(n) < 0.02, 4] = np.nan
    return X


def _queries(X):
    """Raw rows with NaN, unseen, negative, fractional, huge and infinite
    category values."""
    Q = X[:40].copy()
    odd = [np.nan, 1e4, -1.0, 2.5, -0.5, 1e30, np.inf, -np.inf, 23.0, 299.9]
    for j in range(len(CARDINALITIES)):
        Q[:len(odd), j] = odd
    return Q


@pytest.mark.parametrize("max_bin", [15, 63, 255])
def test_categorical_binning_equals_reference(max_bin):
    X = _cat_matrix(max_bin)
    cats = list(range(len(CARDINALITIES)))
    want = ref_fit(X, max_bin=max_bin, categorical_features=cats)
    got = fit_bin_mapper(X, max_bin=max_bin, categorical_features=cats)
    np.testing.assert_array_equal(got.categorical, want.categorical)
    for a, b in zip(got.cat_values, want.cat_values):
        if b is None:
            assert a is None
        else:
            np.testing.assert_array_equal(a, b)
    assert [got.feature_num_bins(j) for j in range(X.shape[1])] == \
        [want.feature_num_bins(j) for j in range(X.shape[1])]
    assert got.feature_infos() == want.feature_infos()
    Q = np.concatenate([X, _queries(X)])
    with np.errstate(invalid="ignore"):
        codes = want.transform(Q)
    np.testing.assert_array_equal(got.transform(Q, "cpu").numpy(), codes)
    # the JSON format is shared: each package reads the other's mapper
    assert got.to_json() == want.to_json()
    back = BinMapper.from_json(want.to_json())
    ref_back = RefBinMapper.from_json(got.to_json())
    for a, b in zip(back.cat_values, ref_back.cat_values):
        if b is not None:
            np.testing.assert_array_equal(a, b)
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(back.transform(Q, "cpu").numpy(),
                                      ref_back.transform(Q))


@pytest.mark.parametrize("values,match", [
    ([-1.0, 2.0, 3.0, 1.0], "non-negative"),
    ([0.0, 1.5, 2.0, 1.0], "non-integer")])
def test_invalid_categories_raise_as_in_the_reference(values, match):
    X = np.stack([np.asarray(values * 10), np.arange(40.0)], axis=1)
    for fit in (ref_fit, fit_bin_mapper):
        with pytest.raises(ValueError, match=match):
            fit(X, categorical_features=[0])


# -- split search ----------------------------------------------------------------

B = 32


def _split_case(name):
    """(histogram rows → (f, B, 3) histogram, feat_info, config kwargs).
    Features 0–2 categorical, 3 numeric."""
    rng = np.random.default_rng(sum(map(ord, name)))
    n, f = 600, 4
    bins = np.stack([rng.integers(0, 12, n), rng.integers(0, 4, n),
                     rng.integers(0, 20, n), rng.integers(0, B - 1, n)], 1)
    g = rng.normal(size=n)
    h = rng.uniform(0.05, 0.3, size=n)
    nbins = [12, 4, 20, 0]
    kw = dict(min_data_in_leaf=5, cat_smooth=10.0, cat_l2=10.0,
              max_cat_threshold=32, max_cat_to_onehot=4)
    if name == "ratio_ties":
        g = np.round(g) * 0.5         # few gradient values, one hessian
        h = np.full(n, 0.25)
    elif name == "onehot_at_cardinality":
        kw["max_cat_to_onehot"] = 12
    elif name == "onehot_above_cardinality":
        kw["max_cat_to_onehot"] = 11
    elif name == "max_cat_threshold_binds":
        kw["max_cat_threshold"] = 2
    elif name == "empty_bins":
        bins[:, 0] = rng.choice([0, 3, 7, 11], n)
        bins[:, 2] = rng.choice([1, 5, 19], n)
    elif name == "heavy_missing_bin":
        heavy = rng.random(n) < 0.8
        bins[heavy, 0] = B - 1
        bins[heavy[::-1], 2] = B - 1
    elif name == "numeric_categorical_tie":
        # feature 3 is feature 1's copy read as numeric, with two value
        # bins: the one-vs-rest split and the threshold tie exactly (the
        # other categorical features masked out)
        bins[:, 1] = rng.integers(0, 2, n)
        bins[:, 3] = bins[:, 1]
        nbins[1] = 2
        kw["cat_l2"] = 0.0
    out = np.zeros((f, B, 3), np.float32)
    for j in range(f):
        np.add.at(out[j], bins[:, j], np.stack([g, h, np.ones(n)], 1))
    fi = np.ones((f, 3), np.float32)
    fi[:, 1] = [1, 1, 1, 0]
    fi[:, 2] = nbins
    if name == "numeric_categorical_tie":
        fi[[0, 2], 0] = 0.0
    return out, fi, kw


SPLIT_CASES = ["random", "ratio_ties", "onehot_at_cardinality",
               "onehot_above_cardinality", "max_cat_threshold_binds",
               "empty_bins", "heavy_missing_bin", "numeric_categorical_tie"]

def _equal(got, want):
    """Port tensors equal to the reference's arrays (the reference's u32
    bitset words and i32 indices widened to the port's dtypes)."""
    for a, b in zip(got, want):
        a = a.numpy()
        np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))


_ref_cat_gains = jax.jit(ref._cat_split_gains, static_argnames=("cfg",))
_ref_cat_split = jax.jit(ref._find_best_cat_split, static_argnames=("cfg",))
_ref_split = jax.jit(ref.find_best_split, static_argnames=("cfg",))


@pytest.mark.parametrize("depth_ok", [True, False])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_categorical_split_search_equals_reference(case, depth_ok):
    hist, fi, kw = _split_case(case)
    rcfg = ref.GrowerConfig(num_bins=B, hist_method="segment",
                            use_categorical=True, **kw)
    pcfg = port.GrowerConfig(num_bins=B, hist_method="segment",
                             use_categorical=True, **kw)
    h = torch.from_numpy(hist)
    tot = port.sum_bins(h[0])
    pt, rt = tot.unbind(), [jnp.float32(t.item()) for t in tot]
    allowed = (fi[:, 1] > 0) & (fi[:, 0] > 0) & depth_ok
    want = _ref_cat_gains(jnp.asarray(hist), *rt, jnp.asarray(allowed),
                          jnp.asarray(fi[:, 2]), cfg=rcfg)
    got = port.cat_split_gains(h, *pt, torch.from_numpy(allowed),
                               torch.from_numpy(fi[:, 2]), pcfg)
    _equal(got, want)
    want = _ref_cat_split(jnp.asarray(hist), *rt, jnp.asarray(allowed),
                          jnp.asarray(fi[:, 2]), cfg=rcfg)
    got = port.find_best_cat_split(h, *pt, torch.from_numpy(allowed),
                                   torch.from_numpy(fi[:, 2]), pcfg)
    _equal(got, want)
    want = _ref_split(jnp.asarray(hist), *rt, jnp.asarray(fi),
                      jnp.asarray(depth_ok), cfg=rcfg)
    got = port.find_best_split(h, *pt, torch.from_numpy(fi), depth_ok, pcfg)
    _equal(got, want)
    if case == "numeric_categorical_tie" and depth_ok:
        assert [int(x) for x in got[1:4]] == [3, 0, 0]   # numeric wins


def test_categorical_searches_stacked_children_as_each_alone():
    """A grow step's (2, f, B, 3) pair gives each child's own winner."""
    pair = [_split_case(c) for c in ("random", "empty_bins")]
    fi, kw = pair[0][1], pair[0][2]
    cfg = port.GrowerConfig(num_bins=B, use_categorical=True, **kw)
    hists = torch.stack([torch.from_numpy(p[0]) for p in pair])
    tots = port.sum_bins(hists[:, 0])
    both = port.find_best_split(hists, *tots.unbind(-1),
                                torch.from_numpy(fi), True, cfg)
    for c in range(2):
        one = port.find_best_split(hists[c], *tots[c].unbind(),
                                   torch.from_numpy(fi), True, cfg)
        for a, b in zip(both, one):
            np.testing.assert_array_equal(a[c].numpy(), b.numpy())


# -- partition, grower, voting helpers --------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_bitset_partition_equals_reference(seed):
    n = 1500
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(n, 3)).astype(np.uint8)
    order = rng.permutation(n).astype(np.int32)
    off, cnt, feat = 211, 900, 1
    left = rng.random(B) < 0.4
    bits = port.pack_bin_mask(torch.from_numpy(left), 1)
    cfg = ref.GrowerConfig(num_bins=B, hist_method="segment",
                           use_categorical=True)
    sizes = ref._bucket_sizes(n, cfg)
    ro = jnp.concatenate([jnp.asarray(order),
                          jnp.full(sizes[-1], n, jnp.int32)])
    want, wl, wr = ref._partition_switch(
        ro, jnp.asarray(bins[:, feat]), jnp.int32(off), jnp.int32(cnt),
        jnp.int32(0), jnp.asarray(True),
        jnp.asarray(bits.numpy().astype(np.uint32)), n, sizes, cfg)
    got = torch.from_numpy(order.copy())
    n_l = port.partition(got, torch.from_numpy(bins), feat, 0, off, cnt,
                         bits)
    assert (n_l, cnt - n_l) == (int(wl), int(wr))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:n])


@pytest.mark.parametrize("case", range(2))
def test_categorical_grow_tree_matches_reference(case):
    rng = np.random.default_rng(case)
    n, f, Bg = 2500, 5, 64
    cat = rng.integers(0, 30, size=n)
    X = rng.normal(size=(n, f))
    bins = np.clip(((X + 3) / 6 * Bg).astype(np.int64), 0, Bg - 1)
    bins[:, 0] = cat
    bins[:, 1] = rng.integers(0, 3, size=n)
    bins[rng.random(n) < 0.1, 0] = Bg - 1             # missing
    y = np.isin(cat, [1, 4, 9, 16, 25]) * 2.0 + X[:, 2] \
        + (bins[:, 1] == 1) + rng.normal(size=n) * 0.3
    gh = np.stack([(0.3 - y).astype(np.float32),
                   rng.uniform(0.5, 1.5, size=n).astype(np.float32),
                   np.ones(n, np.float32)], axis=1)
    fi = np.ones((f, 3), np.float32)
    fi[:, 1] = [1, 1, 0, 0, 0]
    fi[:, 2] = [30, 3, 0, 0, 0]
    kw = dict(num_leaves=15, num_bins=Bg, hist_method="segment",
              use_categorical=True, min_data_in_leaf=10 + 10 * case,
              max_cat_threshold=8 if case else 32)
    rtree, rleaf = ref.grow_tree(jnp.asarray(bins.astype(np.uint8)),
                                 jnp.asarray(gh), jnp.asarray(fi),
                                 ref.GrowerConfig(**kw))
    ptree, pleaf = port.grow_tree(torch.from_numpy(bins.astype(np.uint8)),
                                  torch.from_numpy(gh), fi,
                                  port.GrowerConfig(**kw))
    assert int(ptree.num_leaves) == int(rtree.num_leaves) > 2
    assert int(ptree.node_is_cat.sum()) >= 1
    _equal(ptree, rtree)
    np.testing.assert_array_equal(pleaf.numpy(), np.asarray(rleaf))
    conv = tree_arrays_from_numpy(**{k: np.asarray(v) for k, v
                                     in rtree._asdict().items()})
    walked = port.predict_tree_binned(conv, torch.from_numpy(bins), 15)
    np.testing.assert_array_equal(walked.numpy(), np.asarray(
        ref.predict_tree_binned(rtree, jnp.asarray(bins), 15)))


def _vote_inputs(seed, f=10, Bv=16, n=400):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, Bv, size=(n, f))
    bins[:, 1] = bins[:, 0]
    g, h = rng.normal(size=n), rng.uniform(0.1, 1.0, size=n)
    hist = np.zeros((f, Bv, 3), np.float32)
    for j in range(f):
        np.add.at(hist[j], bins[:, j], np.stack([g, h, np.ones(n)], 1))
    fi = np.ones((f, 3), np.float32)
    fi[[0, 3, 6], 1] = 1.0
    fi[[0, 3, 6], 2] = [15, 4, 9]
    fi[4, 0] = 0.0
    common = dict(num_bins=Bv, min_data_in_leaf=5, voting_k=3,
                  use_categorical=True)
    return hist, fi, ref.GrowerConfig(**common), port.GrowerConfig(**common)


@pytest.mark.parametrize("seed,depth_ok", [(0, True), (1, True), (2, False)])
def test_categorical_votes_and_decision_equal_reference(seed, depth_ok):
    hist, fi, rcfg, pcfg = _vote_inputs(seed)
    num_mask, cat_allowed = ref._voting_masks(jnp.asarray(fi), depth_ok,
                                              rcfg)
    want = ref._voting_votes(jnp.asarray(hist), jnp.asarray(fi),
                             jnp.asarray(depth_ok), num_mask, cat_allowed,
                             rcfg)
    got = port.voting_votes(torch.from_numpy(hist), torch.from_numpy(fi),
                            depth_ok, pcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    cand = np.asarray([6, 0, 2, 3, 9, 1], np.int32)
    tot = port.sum_bins(torch.from_numpy(hist[0])).numpy()
    want = ref._voting_decide(jnp.asarray(hist[cand]), jnp.asarray(cand),
                              *map(jnp.float32, tot), jnp.asarray(fi),
                              jnp.asarray(depth_ok), num_mask, cat_allowed,
                              rcfg)
    got = port.voting_decide(torch.from_numpy(hist[cand]),
                             torch.from_numpy(cand), *map(np.float32, tot),
                             torch.from_numpy(fi), depth_ok, pcfg)
    _equal(got, want)


# -- fits ------------------------------------------------------------------------


def _mixed_data(n=1200, seed=9):
    """``_interleaved_cat_data``'s scattered-subset column (24 categories)
    and numeric column, plus a 5-category column with NaN that moves the
    label and a second numeric column: columns 0 and 2 categorical."""
    X2, y, _ = _interleaved_cat_data(n=n, seed=seed)
    rng = np.random.default_rng(seed + 1)
    c5 = rng.integers(0, 5, size=n).astype(np.float64)
    y = np.where(np.isin(c5, [1, 3]) & (rng.random(n) < 0.3), 1.0 - y, y)
    c5[rng.random(n) < 0.05] = np.nan
    X = np.stack([X2[:, 0], X2[:, 1], c5, rng.normal(size=n)], axis=1)
    return X, y


SMALL = dict(num_iterations=4, num_leaves=7, min_data_in_leaf=10,
             max_bin=63, verbosity=0)
CATS = [0, 2]


def _fit_ref(X, y, d=1, feature=1, objective="binary", **kw):
    mapper = ref_fit(X, max_bin=SMALL["max_bin"], categorical_features=CATS)
    mesh = None if d * feature == 1 else ref_build_mesh(
        data=d, feature=feature, devices=jax.devices()[:d * feature])
    return ref_train(mapper.transform_packed(X), y, None, mapper,
                     ref_objective(objective),
                     RefParams(histogram_method=kw.pop("method", "segment"),
                               **SMALL, **kw), mesh=mesh)


def _fit_port(X, y, d=1, feature=1, objective="binary", **kw):
    mapper = fit_bin_mapper(X, max_bin=SMALL["max_bin"],
                            categorical_features=CATS)
    mesh = None if d * feature == 1 else build_mesh(
        d, feature, devices=["cpu"] * (d * feature))
    return train(mapper.transform(X, "cpu"), y, None, mapper,
                 get_objective(objective),
                 TrainParams(histogram_method=kw.pop("method", "segment"),
                             **SMALL, **kw), device="cpu", mesh=mesh)


def _cat_nodes(booster):
    return sum(t.num_cat for t in booster.trees)


def test_estimators_fit_categorical_columns_as_the_reference():
    """Serial classifier and regressor through the estimators, with
    ``categoricalSlotIndexes`` and with ``categoricalSlotNames``."""
    X, y, _ = _interleaved_cat_data()
    kw = dict(numIterations=8, numLeaves=4, minDataInLeaf=20, verbosity=0)
    t = {"features": X, "label": y}
    want = RefClassifier(histogramMethod="segment",
                         categoricalSlotIndexes=[0], **kw).fit(t)
    got = LightGBMClassifier(device="cpu", categoricalSlotIndexes=[0],
                             **kw).fit(t)
    assert got.getNativeModel() == want.getNativeModel()
    assert _cat_nodes(got.getModel()) >= 8
    # a vector column of the public table types has no column names, so
    # the names reach ``_fit`` through a features column that is a
    # DataFrame, in both packages
    named = {"features": pd.DataFrame(X, columns=["city", "x"]), "label": y}
    got = LightGBMClassifier(device="cpu", categoricalSlotNames=["city"],
                             **kw)._fit(named)
    assert got.getNativeModel() == RefClassifier(
        histogramMethod="segment", categoricalSlotNames=["city"],
        **kw)._fit(named).getNativeModel()
    assert "feature_names=city x" in got.getNativeModel()
    with pytest.raises(ValueError, match="not found"):
        LightGBMClassifier(device="cpu", categoricalSlotNames=["nope"],
                           **kw)._fit(named)

    rng = np.random.default_rng(3)
    n = 3000
    cat = rng.integers(0, 12, size=n)
    means = rng.normal(size=12) * 3
    yr = means[cat] + rng.normal(size=n) * 0.1
    Xr = np.stack([cat.astype(np.float64), rng.normal(size=n)], axis=1)
    kw = dict(numIterations=40, numLeaves=12, minDataInLeaf=20, verbosity=0,
              categoricalSlotIndexes=[0])
    t = {"features": Xr, "label": yr}
    assert LightGBMRegressor(device="cpu", **kw).fit(t).getNativeModel() \
        == RefRegressor(histogramMethod="segment", **kw).fit(t) \
        .getNativeModel()


@pytest.mark.parametrize("objective", ["binary", "regression"])
def test_bagging_and_feature_fraction_keep_the_categorical_flags(objective):
    X, y = _mixed_data()
    if objective == "regression":
        y = y + X[:, 1]
    kw = dict(bagging_fraction=0.7, bagging_freq=2, feature_fraction=0.6,
              seed=5, bagging_seed=6)
    want = _fit_ref(X, y, objective=objective, **kw)
    got = _fit_port(X, y, objective=objective, **kw)
    assert got.save_native_model_string() == want.save_native_model_string()
    assert _cat_nodes(got) >= 1


MESH_CASES = [
    (2, 1, dict(collective="psum")), (2, 1, dict(collective="ring")),
    (4, 1, dict(collective="psum")), (4, 1, dict(collective="ring")),
    (4, 1, dict(collective="psum", parallelism="voting", top_k=1)),
    (4, 1, dict(collective="ring", parallelism="voting", top_k=1)),
    (1, 2, dict(parallelism="feature")),
    (2, 2, dict(parallelism="data+feature")),
]


@pytest.mark.parametrize("d,feature,kw", MESH_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_categorical_mesh_forest_text_equals_reference(d, feature, kw):
    """Every learner; ``top_k=1`` leaves two candidates a split, so the
    categorical votes decide which columns are reduced."""
    X, y = _mixed_data()
    want = _fit_ref(X, y, d, feature, **kw)
    got = _fit_port(X, y, d, feature, **kw)
    assert got.save_native_model_string() == want.save_native_model_string()
    assert _cat_nodes(got) >= 1
    assert engine.last_fit_info["data_shards"] == str(d)


@pytest.mark.parametrize("d", [2, 4])
def test_categorical_pallas_ring_matches_reference(d):
    X, y = _mixed_data()
    want = _fit_ref(X, y, d, collective="ring", method="pallas_ring")
    got = _fit_port(X, y, d, collective="ring", method="pallas_ring")
    assert len(got.trees) == len(want.trees)
    for a, b in zip(want.trees, got.trees):
        for k in ("split_feature", "threshold", "decision_type",
                  "left_child", "right_child", "leaf_count",
                  "internal_count", "cat_boundaries", "cat_threshold"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-6)


def test_categorical_predictions_equal_the_reference():
    """Raw values the training data never had: NaN, unseen, negative and
    fractional categories, through ``Booster.predict`` and the
    estimator's columns."""
    X, y = _mixed_data()
    kw = dict(numIterations=6, numLeaves=7, minDataInLeaf=10, verbosity=0,
              categoricalSlotIndexes=CATS)
    t = {"features": X, "label": y}
    want = RefClassifier(histogramMethod="segment", **kw).fit(t)
    got = LightGBMClassifier(device="cpu", **kw).fit(t)
    assert got.getNativeModel() == want.getNativeModel()
    Q = X[:60].copy()
    odd = [np.nan, 99.0, -1.0, 2.5, -0.5, 3.999, 1e9, 4.0]
    Q[:len(odd), 0] = odd
    Q[len(odd):2 * len(odd), 2] = odd
    np.testing.assert_array_equal(
        got.getModel().predict(Q, device="cpu").numpy(),
        np.asarray(want.getModel().predict(Q)))
    a, b = got.transform({"features": Q}), want.transform({"features": Q})
    for col in ("rawPrediction", "probability", "prediction"):
        np.testing.assert_array_equal(np.asarray(a[col]), np.asarray(b[col]))
