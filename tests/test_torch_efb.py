"""Exclusive Feature Bundling in the port against the JAX reference, on
the CPU.

* The plan, the bundled matrix and the expansion maps of
  ``mmlspark_tpu_torch/gbdt/efb.py`` equal the reference's
  (``assert_array_equal``) on one-hot blocks with dense columns, with
  NaNs, and at ``maxConflictRate`` 0 and 0.05.
* ``grower.efb_expand`` equals the reference's ``_efb_expand`` on f32
  and int32 histograms, bit for bit, and ``efb_feature_column`` and the
  bundled walk equal theirs.
* Bundled fits write the reference's model text byte for byte: serial
  gbdt, GOSS, DART, rf, multiclass and quantized; data psum and ring at
  D = 2 and 4.  Under ``pallas_ring`` (D = 4) the reference's fused kernel
  sums each cell through an MXU-shaped contraction and the port's twin
  in row order, so the forests have the same structure and leaf values
  within rtol 1e-5, atol 1e-6 (as ``tests/test_torch_mesh.py`` states).
* Each gate disengages as the reference's: a categorical feature,
  lambdarank, more than 256 bins, voting, a feature axis and GOSS on a
  mesh each fit unbundled, with the reference's model text and the
  unbundled fit's.
* The reference's own EFB tests (``tests/test_efb.py``) run on the port,
  each fit also held to the reference's model text.

The reference pins ``histogram_method="segment"``, and so does the port
in ``fit_pair`` and ``_fit_both`` (its CPU default, the native split
scan, can part a near-tie; ``tests/test_torch_native_hist.py`` holds
``_fit_both``'s fits on ``"auto"`` in both packages).  The fits several
cases share are made once a module (:func:`mesh_bundled_12`: the D = 4
bundled classifier of the two mesh-against-serial cases), and the module
runs on one torch thread (``torch_parity.one_torch_thread``).
"""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.mesh import build_mesh as ref_build_mesh
from mmlspark_tpu.gbdt import LightGBMClassifier as RefClassifier
from mmlspark_tpu.gbdt import efb as ref_efb
from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit
from mmlspark_tpu.gbdt import grower as ref_grower
from mmlspark_tpu_torch import LightGBMClassifier, build_mesh
from mmlspark_tpu_torch.gbdt import efb, engine, fit_bin_mapper, grower

from torch_parity import fit_pair, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _sparse_table(rng, n=4000, groups=3, group_size=8, dense=2,
                  conflict_rate=0.0):
    """One-hot blocks (mutually exclusive within a group) + dense columns
    (the reference's ``tests/test_efb.py`` table)."""
    cols = []
    for _ in range(groups):
        onehot = np.zeros((n, group_size), np.float32)
        owner = rng.integers(0, group_size + 1, n)  # +1 -> all-zero rows
        mask = owner < group_size
        onehot[np.arange(n)[mask], owner[mask]] = 1.0
        if conflict_rate > 0:
            extra = rng.random(n) < conflict_rate
            onehot[np.arange(n)[extra],
                   rng.integers(0, group_size, extra.sum())] = 1.0
        cols.append(onehot)
    cols.append(rng.normal(size=(n, dense)).astype(np.float32))
    X = np.concatenate(cols, axis=1)
    y = ((X[:, 0] + X[:, group_size] * 2 + X[:, -1]) > 0.5).astype(
        np.float64)
    return X, y


def _table(kind):
    rng = np.random.default_rng(11)
    if kind == "conflicts":
        return _sparse_table(rng, n=3000, conflict_rate=0.01)
    X, y = _sparse_table(rng, n=3000)
    if kind == "nan":
        X[::97, 3] = np.nan
        X[::41, -1] = np.nan
    return X, y


def _plans(kind, rate, sample_cnt=1000):
    X, _ = _table(kind)
    ref_map, port_map = ref_fit(X, max_bin=255), fit_bin_mapper(X, max_bin=255)
    bins = ref_map.transform(X)
    np.testing.assert_array_equal(port_map.transform(X, "cpu").numpy(), bins)
    nb = [ref_map.feature_num_bins(j) for j in range(X.shape[1])]
    assert nb == [port_map.feature_num_bins(j) for j in range(X.shape[1])]
    ref = ref_efb.find_bundles(bins, nb, ref_map.missing_bin, rate,
                               sample_cnt=sample_cnt, seed=3)
    port = efb.find_bundles(bins, nb, port_map.missing_bin, rate,
                            sample_cnt=sample_cnt, seed=3)
    return bins, ref_map.missing_bin, ref, port


@pytest.mark.parametrize("kind,rate", [("onehot", 0.0), ("nan", 0.0),
                                       ("conflicts", 0.0),
                                       ("conflicts", 0.05)])
def test_plan_matrix_and_maps_equal_the_reference(kind, rate):
    bins, missing, ref, port = _plans(kind, rate)
    assert not port.is_trivial
    assert (port.bundles, port.bundle_of, port.off_of, port.nb_of,
            port.default_of) == (ref.bundles, ref.bundle_of, ref.off_of,
                                 ref.nb_of, ref.default_of)
    np.testing.assert_array_equal(efb.bundle_matrix(bins, port, missing),
                                  ref_efb.bundle_matrix(bins, ref, missing))
    for a, b in zip(efb.expansion_arrays(port, 256, missing),
                    ref_efb.expansion_arrays(ref, 256, missing)):
        np.testing.assert_array_equal(a, b)


def _maps(kind="nan"):
    """A plan over every row (so no row breaks exclusivity), its bundled
    matrix and both packages' maps."""
    bins, missing, ref, port = _plans(kind, 0.0, sample_cnt=50_000)
    host = ref_efb.expansion_arrays(ref, 256, missing)
    ref_arr = ref_grower.EFBArrays(*(jax.numpy.asarray(a) for a in host))
    return (bins, efb.bundle_matrix(bins, port, missing), ref_arr,
            grower.EFBArrays.from_maps(
                efb.expansion_arrays(port, 256, missing), "cpu"))


@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_efb_expand_equals_the_reference(dtype):
    bins, bundled, ref_arr, port_arr = _maps()
    rng = np.random.default_rng(5)
    n = bundled.shape[0]
    if dtype == "int32":
        gh = rng.integers(-500, 500, size=(n, 3)).astype(np.int32)
    else:
        gh = rng.normal(size=(n, 3)).astype(np.float32)
    hist_b = grower.compute_histogram(torch.from_numpy(bundled),
                                      torch.from_numpy(gh), 256, "segment")
    want = np.asarray(jax.jit(ref_grower._efb_expand)(
        jax.numpy.asarray(hist_b.numpy()), ref_arr))
    got = grower.efb_expand(hist_b, port_arr).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # the expanded histogram is the unbundled one (exactly in int32)
    direct = grower.compute_histogram(torch.from_numpy(bins),
                                      torch.from_numpy(gh), 256, "segment")
    if dtype == "int32":
        np.testing.assert_array_equal(got, direct.numpy())
    else:
        np.testing.assert_allclose(got, direct.numpy(), rtol=1e-5,
                                   atol=1e-3)


def test_feature_columns_and_the_bundled_walk_equal_the_reference():
    bins, bundled, ref_arr, port_arr = _maps()
    binsT = jax.numpy.asarray(bundled.T)
    bt = torch.from_numpy(bundled)
    for j in range(bins.shape[1]):
        want = np.asarray(ref_grower.efb_feature_column(binsT, j, ref_arr,
                                                        256))
        got = grower.efb_feature_column(bt, j, port_arr, 256).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, bins[:, j])
    # a walk over the bundled rows reaches each row's leaf of the plain walk
    rng = np.random.default_rng(2)
    gh = np.stack([rng.normal(size=len(bins)), np.ones(len(bins)),
                   np.ones(len(bins))], 1).astype(np.float32)
    cfg = grower.GrowerConfig(num_leaves=15, num_bins=256,
                              min_data_in_leaf=5, hist_method="segment")
    fi = np.ones((bins.shape[1], 3), np.float32)
    tree, row_leaf = grower.grow_tree(bt, torch.from_numpy(gh), fi, cfg,
                                      port_arr)
    plain, _ = grower.grow_tree(torch.from_numpy(bins), torch.from_numpy(gh),
                                fi, cfg)
    assert torch.equal(tree.node_feat, plain.node_feat)
    assert torch.equal(tree.node_bin, plain.node_bin)
    walked = grower.leaf_index_binned(tree, bt, 15, port_arr, 256)
    assert torch.equal(walked, row_leaf)
    assert torch.equal(walked, grower.leaf_index_binned(
        tree, torch.from_numpy(bins), 15))


#: bundled fits held to the reference's model text byte for byte
FITS = {
    "serial": (1, "binary", {}),
    "goss": (1, "binary", dict(boosting="goss")),
    "dart": (1, "binary", dict(boosting="dart", drop_rate=0.5)),
    "rf": (1, "binary", dict(boosting="rf", bagging_fraction=0.7,
                             bagging_freq=1)),
    "multiclass": (1, "multiclass", {}),
    "quantized": (1, "binary", dict(quantized_grad="16")),
    "validation": (1, "binary", dict(early_stopping_round=2)),
    "data_psum_2": (2, "binary", dict(collective="psum")),
    "data_ring_2": (2, "binary", dict(collective="ring")),
    "data_psum_4": (4, "binary", dict(collective="psum")),
    "data_ring_4": (4, "binary", dict(collective="ring")),
    "multiclass_ring_2": (2, "multiclass", dict(collective="ring")),
    "rf_ring_4": (4, "binary", dict(collective="ring", boosting="rf",
                                    bagging_fraction=0.7, bagging_freq=1)),
}


def _labels(objective, X, y):
    if objective == "binary":
        return y
    return ((np.abs(np.nan_to_num(X[:, -1])) * 2 + (X[:, 0] > 0))
            .astype(np.int64) % 3).astype(np.float64)


def _bundled_pair(name, table="nan", **extra):
    d, objective, kw = FITS[name]
    X, y = _table(table)
    val = None
    if "early_stopping_round" in kw:
        val = np.zeros(len(y), bool)
        val[::5] = True
    return fit_pair(X, _labels(objective, X, y), objective, d=d, val=val,
                    max_bin=255, num_iterations=5, num_leaves=7,
                    min_data_in_leaf=5, enable_bundle=True,
                    **{**kw, **extra})


@pytest.mark.parametrize("name", list(FITS))
def test_bundled_fit_writes_the_reference_model_text(name):
    ref, port = _bundled_pair(name)
    assert engine.last_fit_info["efb_gate"] == "none"
    assert 0 < int(engine.last_fit_info["efb_bundles"]) < 26
    assert port.save_native_model_string() == ref.save_native_model_string()


def test_bundled_pallas_ring_keeps_the_reference_forest():
    ref, port = _bundled_pair("data_ring_4", method="pallas_ring")
    assert engine.last_fit_info["histogram_method"] == "pallas_ring"
    assert engine.last_fit_info["efb_gate"] == "none"
    assert len(port.trees) == len(ref.trees)
    for a, b in zip(ref.trees, port.trees):
        for k in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-6)


#: what closes each gate: (data shards, feature slices, fit params,
#: fit_pair keywords, the port's recorded reason)
GATES = {
    "categorical": (1, 1, {}, dict(categorical=(0,)), "categorical"),
    "wide_bins": (1, 1, {}, dict(max_bin=511), "wide_bins"),
    "voting": (4, 1, dict(collective="ring", parallelism="voting",
                          top_k=3), {}, "voting"),
    "feature_axis": (1, 2, dict(parallelism="feature"), {},
                     "feature_axis"),
    "data_feature": (2, 2, dict(parallelism="data+feature"), {},
                     "feature_axis"),
    "goss_mesh": (2, 1, dict(boosting="goss"), {}, "goss"),
    "dart_mesh": (2, 1, dict(boosting="dart", drop_rate=0.5), {}, "dart"),
}


@pytest.mark.parametrize("name", list(GATES))
def test_each_gate_fits_unbundled_as_the_reference(name):
    d, feature, kw, pair_kw, reason = GATES[name]
    X, y = _table("onehot")
    if name == "categorical":
        X = X.copy()
        X[:, 0] = np.random.default_rng(1).integers(0, 5, len(y))
    pair_kw = {"max_bin": 255, **pair_kw}
    common = dict(num_iterations=4, num_leaves=7, min_data_in_leaf=5, **kw)
    ref, port = fit_pair(X, y, "binary", d=d, feature=feature,
                         enable_bundle=True, **common, **pair_kw)
    assert engine.last_fit_info["efb_gate"] == reason
    assert engine.last_fit_info["efb_bundles"] == "0"
    text = port.save_native_model_string()
    assert text == ref.save_native_model_string()
    _, plain = fit_pair(X, y, "binary", d=d, feature=feature, **common,
                        **pair_kw)
    assert plain.save_native_model_string() == text


def test_ranking_gate_fits_unbundled():
    """Lambdarank never bundles (the reference's serial gate: no gradient
    override), so asking for EFB writes the unbundled ranker's text."""
    from mmlspark_tpu_torch import LightGBMRanker
    rng = np.random.default_rng(3)
    X, y = _sparse_table(rng, n=600)
    q = np.repeat(np.arange(30), 20)
    table = {"features": X, "label": (y * 2 + (X[:, -1] > 1)), "query": q}
    kw = dict(numIterations=3, numLeaves=7, minDataInLeaf=5, device="cpu",
              verbosity=0, groupCol="query")
    on = LightGBMRanker(enableBundle=True, **kw).fit(table)
    assert engine.last_fit_info["efb_gate"] == "ranking"
    off = LightGBMRanker(**kw).fit(table)
    assert on.getNativeModel() == off.getNativeModel()


def test_max_conflict_rate_reaches_the_plan(monkeypatch):
    """``maxConflictRate`` on the estimator is the budget ``find_bundles``
    plans with."""
    seen = []
    real = efb.find_bundles

    def spy(*args, **kw):
        seen.append(args[3])
        return real(*args, **kw)

    monkeypatch.setattr(engine, "find_bundles", spy)
    X, y = _table("conflicts")
    LightGBMClassifier(enableBundle=True, maxConflictRate=0.05,
                       numIterations=2, device="cpu", verbosity=0).fit(
        {"features": X, "label": y})
    assert seen == [0.05]


# -- the reference's own EFB tests (tests/test_efb.py), on the port ----------

def _fit_both(table, **kw):
    """The port's and the reference's classifiers of one fit, both pinned
    to "segment"; their model texts must agree byte for byte."""
    port = LightGBMClassifier(device="cpu", histogramMethod="segment",
                              **kw).fit(table)
    ref = RefClassifier(histogramMethod="segment", **kw).fit(table)
    assert port.getNativeModel() == ref.getNativeModel()
    return port


def _prob(model, table):
    return np.asarray(model.transform(table)["probability"])


def test_port_one_hot_groups_bundle():
    X, _ = _sparse_table(np.random.default_rng(0))
    m = fit_bin_mapper(X, max_bin=255)
    bins = m.transform(X, "cpu").numpy()
    nb = [m.feature_num_bins(j) for j in range(X.shape[1])]
    spec = efb.find_bundles(bins, nb, m.missing_bin)
    assert spec.num_bundles < X.shape[1]
    assert [b for b in spec.bundles if len(b) > 1]
    assert not spec.is_trivial
    ref = ref_efb.find_bundles(bins, nb, m.missing_bin)
    assert (spec.bundles, spec.off_of, spec.default_of) == (
        ref.bundles, ref.off_of, ref.default_of)


def test_port_dense_features_stay_solo_identity():
    X = np.random.default_rng(0).normal(size=(3000, 4)).astype(np.float32)
    m = fit_bin_mapper(X, max_bin=255)
    bins = m.transform(X, "cpu").numpy()
    nb = [m.feature_num_bins(j) for j in range(4)]
    spec = efb.find_bundles(bins, nb, m.missing_bin)
    assert spec.is_trivial
    bm = efb.bundle_matrix(bins, spec, m.missing_bin)
    perm = [b[0] for b in spec.bundles]
    assert (bm == bins[:, perm].astype(np.uint8)).all()


def test_port_bundle_decode_roundtrip():
    X, _ = _sparse_table(np.random.default_rng(0))
    X[::97, 3] = np.nan
    m = fit_bin_mapper(X, max_bin=255)
    bins = m.transform(X, "cpu").numpy()
    f = X.shape[1]
    spec = efb.find_bundles(bins, [m.feature_num_bins(j) for j in range(f)],
                            m.missing_bin)
    arr = grower.EFBArrays.from_maps(
        efb.expansion_arrays(spec, 256, m.missing_bin), "cpu")
    bm = torch.from_numpy(efb.bundle_matrix(bins, spec, m.missing_bin))
    for j in range(f):
        np.testing.assert_array_equal(
            grower.efb_feature_column(bm, j, arr, 256).numpy(), bins[:, j],
            err_msg=f"feature {j} decode drift")


def _parity(p_on, p_off):
    assert np.median(np.abs(p_on - p_off)) < 1e-5
    assert np.quantile(np.abs(p_on - p_off), 0.99) < 0.05


@pytest.mark.parametrize("kind", ["gbdt", "goss", "dart"])
def test_port_prediction_parity_on_exclusive_features(kind):
    X, y = _sparse_table(np.random.default_rng(0), n=2000)
    t = {"features": X, "label": y}
    kw = dict(numIterations=10, numLeaves=15, verbosity=0,
              minDataInLeaf=5, boostingType=kind)
    if kind == "dart":
        kw.update(numIterations=8, numLeaves=7, dropRate=0.5)
    m_off = _fit_both(t, **kw)
    m_on = _fit_both(t, enableBundle=True, **kw)
    assert len(m_off.getModel().trees) == len(m_on.getModel().trees)
    _parity(_prob(m_on, t)[:, 1], _prob(m_off, t)[:, 1])


def test_port_multiclass_prediction_parity():
    X, _ = _sparse_table(np.random.default_rng(0), n=2000)
    y3 = (np.abs(X[:, -1]) * 2 + (X[:, 0] > 0)).astype(np.int64) % 3
    t = {"features": X, "label": y3.astype(np.float64)}
    kw = dict(numIterations=6, numLeaves=7, verbosity=0,
              objective="multiclass", minDataInLeaf=5)
    _parity(_prob(_fit_both(t, enableBundle=True, **kw), t),
            _prob(_fit_both(t, **kw), t))


def test_port_conflict_budget_trains_close():
    from sklearn.metrics import roc_auc_score
    X, y = _sparse_table(np.random.default_rng(0), n=2000,
                         conflict_rate=0.01)
    t = {"features": X, "label": y}
    kw = dict(numIterations=20, numLeaves=15, verbosity=0, minDataInLeaf=5)
    auc_off = roc_auc_score(y, _prob(_fit_both(t, **kw), t)[:, 1])
    auc_on = roc_auc_score(y, _prob(_fit_both(
        t, enableBundle=True, maxConflictRate=0.05, **kw), t)[:, 1])
    assert auc_on > auc_off - 0.02, (auc_on, auc_off)


def test_port_dart_bundled_validation_metrics_sane():
    """DART + EFB + a validation set: the validation matrix is never
    bundled, so its margins come from the plain walk."""
    rng = np.random.default_rng(0)
    X, y = _sparse_table(rng, n=2000)
    val = np.zeros(len(y), bool)
    val[rng.choice(len(y), len(y) // 5, replace=False)] = True
    t = {"features": X, "label": y, "is_val": val.astype(float)}
    kw = dict(numIterations=6, numLeaves=7, verbosity=0, minDataInLeaf=5,
              boostingType="dart", dropRate=0.5,
              validationIndicatorCol="is_val")
    p_off = _prob(_fit_both(t, **kw), t)[:, 1]
    p_on = _prob(_fit_both(t, enableBundle=True, **kw), t)[:, 1]
    assert np.median(np.abs(p_on - p_off)) < 1e-5


def test_port_dart_multiclass_bundled_trains():
    X, _ = _sparse_table(np.random.default_rng(0), n=2000)
    y3 = (np.abs(X[:, -1]) * 2 + (X[:, 0] > 0)).astype(np.int64) % 3
    t = {"features": X, "label": y3.astype(np.float64)}
    m = _fit_both(t, enableBundle=True, boostingType="dart",
                  objective="multiclass", numIterations=4, numLeaves=7,
                  verbosity=0)
    assert len(m.getModel().trees) == 12


def _mesh_fit(table, d, feature=1, **kw):
    """The port's fit on ``devices=["cpu"] * (d·feature)`` and the
    reference's on as many host devices, model text byte for byte."""
    port = LightGBMClassifier(device="cpu", **kw).setMesh(
        build_mesh(d, feature, devices=["cpu"] * (d * feature))).fit(table)
    ref = RefClassifier(histogramMethod="segment", **kw).setMesh(
        ref_build_mesh(data=d, feature=feature,
                       devices=jax.devices()[:d * feature])).fit(table)
    assert port.getNativeModel() == ref.getNativeModel()
    return port


#: the 12-iteration fits of the two mesh-against-serial cases
MESH_12 = dict(numIterations=12, numLeaves=15, verbosity=0, minDataInLeaf=5)


@pytest.fixture(scope="module")
def mesh_bundled_12():
    """``(table, the D = 4 bundled classifier of MESH_12)``, held to the
    reference's model text once for both cases that compare with it."""
    X, y = _sparse_table(np.random.default_rng(0), n=2000)
    t = {"features": X, "label": y}
    return t, _mesh_fit(t, 4, enableBundle=True, **MESH_12)


def test_port_mesh_matches_serial_with_bundling(mesh_bundled_12):
    t, mesh = mesh_bundled_12
    p_serial = _prob(_fit_both(t, enableBundle=True, **MESH_12), t)[:, 1]
    _parity(_prob(mesh, t)[:, 1], p_serial)


def test_port_mesh_bundle_matches_mesh_plain(mesh_bundled_12):
    t, mesh = mesh_bundled_12
    _parity(_prob(mesh, t)[:, 1], _prob(_mesh_fit(t, 4, **MESH_12), t)[:, 1])


def test_port_mesh_multiclass_bundled():
    X, _ = _sparse_table(np.random.default_rng(0), n=2000)
    y3 = ((X[:, 0] > 0) + (X[:, 8] > 0) * 1).astype(np.float64)
    m = _mesh_fit({"features": X, "label": y3}, 4, numIterations=5,
                  numLeaves=7, verbosity=0, objective="multiclass",
                  enableBundle=True)
    assert np.isfinite(_prob(m, {"features": X})).all()


def test_port_feature_mesh_skips_bundling():
    """A feature-sharded mesh would split bundles across shards; EFB
    disengages."""
    X, y = _sparse_table(np.random.default_rng(0), n=2000)
    m = _mesh_fit({"features": X, "label": y}, 2, 2, numIterations=5,
                  numLeaves=7, verbosity=0, enableBundle=True,
                  parallelism="data+feature")
    assert engine.last_fit_info["efb_gate"] == "feature_axis"
    assert m is not None

