"""The port's mesh training against the JAX reference, on the CPU.

A port mesh of ``devices=["cpu"] * D`` runs the same shard layout and the
same cross-shard reductions as the reference's ``train(..., mesh=...)``
over D devices of the forced 8-device host platform (``tests/conftest.py``).
The reference is pinned to ``histogram_method="segment"``.

* ``collective`` psum and ring, D = 2 and 4: the LightGBM model texts are
  equal byte for byte (the port's twins add in the reference's orders, see
  ``tests/test_torch_collectives.py``).
* The feature (1 × 2, 1 × 4) and data+feature (2 × 2) learners, with f
  not divisible by the feature axis: model text byte for byte.  Each
  feature slice keeps its own leaf totals and scores, as every device of
  the reference does.  (Voting: ``tests/test_torch_voting.py``.)
* ``histogram_method="pallas_ring"``: the reference's fused kernel sums
  each cell through an MXU-shaped ``dot_general``, the port's twin in row
  order, so the forests have the same structure and leaf values within
  rtol 1e-5, atol 1e-6 (a few ulp of the leaf outputs).
"""

import gzip
import os

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.mesh import DATA_AXIS
from mmlspark_tpu.core.mesh import build_mesh as ref_build_mesh
from mmlspark_tpu.gbdt import LightGBMClassifier as RefClassifier
from mmlspark_tpu.gbdt.classifier import \
    LightGBMClassificationModel as RefModel
from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit
from mmlspark_tpu.gbdt.distributed import prepare_arrays as ref_prepare
from mmlspark_tpu.gbdt.engine import TrainParams as RefParams
from mmlspark_tpu.gbdt.engine import train as ref_train
from mmlspark_tpu.gbdt.objectives import get_objective as ref_objective
from mmlspark_tpu_torch import LightGBMClassifier
from mmlspark_tpu_torch.core.mesh import build_mesh
from mmlspark_tpu_torch.gbdt import base, distributed, engine
from mmlspark_tpu_torch.gbdt import fit_bin_mapper, get_objective
from mmlspark_tpu_torch.gbdt.classifier import LightGBMClassificationModel
from mmlspark_tpu_torch.gbdt.engine import TrainParams, train
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA_DIR = os.path.join(REPO, "tests", "benchmarks", "data")
#: the reference's own small mesh fit (tests/test_collectives.py)
SMALL = dict(num_iterations=3, num_leaves=7, min_data_in_leaf=5, max_bin=63,
             verbosity=0)


def _small_data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(640, 9))
    return X, (X[:, 0] - X[:, 2] + 0.3 * X[:, 4] > 0).astype(np.float64)


def _breast_cancer():
    with gzip.open(os.path.join(DATA_DIR, "breast_cancer.csv.gz"), "rt") as fh:
        fh.readline()
        rows = np.asarray([[float(v) for v in line.split(",")]
                           for line in fh])
    return rows[:, :-1].astype(np.float32), rows[:, -1]


def _ref_mesh(d, feature=1):
    return ref_build_mesh(data=d, feature=feature,
                          devices=jax.devices()[:d * feature])


def _fit_ref(X, y, d, collective, method="segment", feature=1, **kw):
    mapper = ref_fit(X, max_bin=SMALL["max_bin"])
    return ref_train(mapper.transform_packed(X), y, None, mapper,
                     ref_objective("binary"),
                     RefParams(histogram_method=method,
                               collective=collective, **SMALL, **kw),
                     mesh=_ref_mesh(d, feature))


def _fit_port(X, y, d, collective, method="segment", feature=1, **kw):
    mapper = fit_bin_mapper(X, max_bin=SMALL["max_bin"])
    return train(mapper.transform(X, "cpu"), y, None, mapper,
                 get_objective("binary"),
                 TrainParams(histogram_method=method, collective=collective,
                             **SMALL, **kw),
                 mesh=build_mesh(d, feature, devices=["cpu"] * (d * feature)))


@pytest.mark.parametrize("collective", ["psum", "ring"])
@pytest.mark.parametrize("d", [2, 4])
def test_mesh_forest_text_equals_reference(d, collective):
    X, y = _small_data()
    ref = _fit_ref(X, y, d, collective)
    port = _fit_port(X, y, d, collective)
    assert port.save_native_model_string() == ref.save_native_model_string()
    assert engine.last_fit_info["collective"] == collective
    assert engine.last_fit_info["data_shards"] == str(d)


SAMPLING = {"bagging": dict(bagging_fraction=0.8, bagging_freq=2),
            "feature_fraction": dict(feature_fraction=0.7)}


@pytest.mark.parametrize("d,collective,sampling", [
    (4, "ring", "bagging"), (2, "psum", "feature_fraction")])
def test_breast_cancer_mesh_fit_equals_reference(d, collective, sampling):
    X, y = _breast_cancer()
    kw = SAMPLING[sampling]
    ref = _fit_ref(X, y, d, collective, **kw)
    port = _fit_port(X, y, d, collective, **kw)
    assert port.save_native_model_string() == ref.save_native_model_string()


@pytest.mark.parametrize("d", [2, 4])
def test_pallas_ring_forest_matches_reference(d):
    X, y = _small_data()
    ref = _fit_ref(X, y, d, "ring", "pallas_ring")
    port = _fit_port(X, y, d, "ring", "pallas_ring")
    assert len(port.trees) == len(ref.trees)
    for a, b in zip(ref.trees, port.trees):
        for k in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-6)
    assert engine.last_fit_info["histogram_method"] == "pallas_ring"


def test_estimator_mesh_fit_and_model_text_cross_load():
    """setMesh on both estimators grows the same forest, and each
    package's mesh-trained model text loads in the other and scores the
    same margins."""
    X, y = _breast_cancer()
    table = {"features": X, "label": y}
    kw = dict(numIterations=4, numLeaves=7, minDataInLeaf=10, verbosity=0,
              collective="ring")
    ref = RefClassifier(histogramMethod="segment", **kw) \
        .setMesh(_ref_mesh(2)).fit(table)
    port = LightGBMClassifier(device="cpu", **kw) \
        .setMesh(build_mesh(devices=["cpu"] * 2)).fit(table)
    text = port.getNativeModel()
    assert text == ref.getNativeModel()
    into_ref = RefModel.loadNativeModelFromString(text)
    into_port = LightGBMClassificationModel.loadNativeModelFromString(
        ref.getNativeModel(), device="cpu")
    # a loaded model keeps the forest; the training parameters are not
    # part of what it reads back
    forest = text.split("parameters:")[0]
    assert into_port.getNativeModel().split("parameters:")[0] == forest
    want = np.asarray(ref.transform({"features": X})["rawPrediction"])
    for m in (into_ref, into_port, port):
        np.testing.assert_allclose(
            np.asarray(m.transform({"features": X})["rawPrediction"]), want,
            rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("d,feature,parallelism,collective", [
    (1, 2, "feature", "psum"), (1, 4, "feature", "ring"),
    (2, 2, "data+feature", "ring"), (2, 2, "data+feature", "psum")])
def test_feature_forest_text_equals_reference(d, feature, parallelism,
                                              collective):
    """f = 9 features over 2 or 4 slices (one or three pad features); a
    ring request keeps psum on a feature mesh."""
    X, y = _small_data()
    kw = dict(parallelism=parallelism, feature=feature)
    ref = _fit_ref(X, y, d, collective, **kw)
    port = _fit_port(X, y, d, collective, **kw)
    assert port.save_native_model_string() == ref.save_native_model_string()
    info = engine.last_fit_info
    assert (info["collective"], info["data_shards"],
            info["feature_shards"]) == ("psum", str(d), str(feature))


@pytest.mark.parametrize("d,feature,sampling", [
    (1, 4, "feature_fraction"), (2, 2, "bagging")])
def test_breast_cancer_feature_fit_equals_reference(d, feature, sampling):
    """30 features over 4 slices (two pad features): feature-fraction draws
    stay over the original 30, the pads masked, as in the reference."""
    X, y = _breast_cancer()
    kw = dict(SAMPLING[sampling], parallelism="feature", feature=feature)
    ref = _fit_ref(X, y, d, "psum", **kw)
    port = _fit_port(X, y, d, "psum", **kw)
    assert port.save_native_model_string() == ref.save_native_model_string()


@pytest.mark.parametrize("n,d", [(10, 4), (12, 4), (7, 3), (5, 8)])
def test_padded_row_layout_equals_reference(n, d):
    """Rows padded at the end to a multiple of D; shard d holds rows
    [d·S, (d+1)·S); pad rows carry zero bins, label, weight and real."""
    rng = np.random.default_rng(n)
    bins = rng.integers(0, 63, size=(n, 3)).astype(np.uint8)
    labels = rng.integers(0, 2, size=n).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=n)
    rb, rl, rw, rr, rs, rp, _ = ref_prepare(bins, labels, w, _ref_mesh(d),
                                            1, 0.25)
    arrays = distributed.prepare_arrays(torch.from_numpy(bins), labels, w,
                                        [torch.device("cpu")] * d, 0.25)
    assert arrays.n == n and arrays.n_padded == n + rp
    assert all(b.shape[0] == arrays.rows_per_shard for b in arrays.bins)
    for mine, theirs in ((arrays.bins, rb), (arrays.labels, rl),
                         (arrays.weights, rw), (arrays.real, rr),
                         (arrays.scores, rs)):
        np.testing.assert_array_equal(torch.cat(mine).numpy(),
                                      np.asarray(theirs))


@pytest.mark.parametrize("n,f,d,feature", [(10, 9, 2, 2), (7, 5, 1, 4),
                                            (9, 8, 2, 2)])
def test_padded_feature_layout_equals_reference(n, f, d, feature):
    """Features padded at the end to a multiple of the feature axis with
    constant-zero columns; device (s, j) holds shard s's rows of slice
    j's columns."""
    rng = np.random.default_rng(n * f)
    bins = rng.integers(1, 63, size=(n, f)).astype(np.uint8)
    labels = rng.integers(0, 2, size=n).astype(np.float64)
    w = np.ones(n)
    rb, _, _, _, _, rp, fp = ref_prepare(bins, labels, w,
                                         _ref_mesh(d, feature), 1, 0.0)
    arrays = distributed.prepare_arrays(
        torch.from_numpy(bins), labels, w,
        [torch.device("cpu")] * (d * feature), 0.0, feature)
    want = np.asarray(rb)
    S, f_loc = (n + rp) // d, (f + fp) // feature
    assert want.shape == (n + rp, f + fp)
    for k, b in enumerate(arrays.bins):
        s, j = divmod(k, feature)
        np.testing.assert_array_equal(
            b.numpy(), want[s * S:(s + 1) * S, j * f_loc:(j + 1) * f_loc])


def test_bagging_draws_n_randoms_scattered_into_the_padded_layout(
        monkeypatch):
    """A mesh fit's bag is the serial fit's draw of exactly n randoms,
    with the pad rows held at zero."""
    rng = np.random.default_rng(3)
    X = rng.normal(size=(641, 4))
    y = (X[:, 0] > 0).astype(np.float64)
    seen = []
    real_iteration = distributed.boost_iteration

    def spy(arrays, bag, *args):
        seen.append(torch.cat(bag).numpy().copy())
        return real_iteration(arrays, bag, *args)

    monkeypatch.setattr(engine, "boost_iteration", spy)
    _fit_port(X, y, 4, "ring", bagging_fraction=0.6, bagging_freq=2,
              bagging_seed=11)
    rng = np.random.default_rng(11)
    for it, bag in enumerate(seen):
        if it % 2 == 0:
            draw = (rng.random(641) < 0.6).astype(np.float32)
        assert bag.shape == (644,)
        np.testing.assert_array_equal(bag[:641], draw)
        assert not bag[641:].any()


def test_last_fit_info_records_the_collective_and_its_downgrade():
    X, y = _small_data()
    table = {"features": X[:200], "label": y[:200]}
    kw = dict(numIterations=1, numLeaves=4, verbosity=0, device="cpu")
    LightGBMClassifier(collective="ring", **kw).fit(table)
    info = dict(engine.last_fit_info)
    assert (info["collective"], info["collective_downgrade"]) == \
        ("psum", "single_data_shard")
    assert (info["data_shards"], info["backend"]) == ("1", "cpu")
    assert info["collective_count_per_tree"] == "0"
    LightGBMClassifier(collective="ring", **kw).setMesh(
        build_mesh(devices=["cpu"])).fit(table)
    assert engine.last_fit_info["collective_downgrade"] == "single_data_shard"
    LightGBMClassifier(collective="ring", **kw).setMesh(
        build_mesh(devices=["cpu"] * 2)).fit(table)
    info = dict(engine.last_fit_info)
    assert (info["collective"], info["collective_downgrade"]) == \
        ("ring", "none")
    assert info["collective_count_per_tree"] == "4"
    assert int(info["collective_payload_bytes_per_tree"]) > 0
    LightGBMClassifier(**kw).setMesh(build_mesh(devices=["cpu"] * 2)) \
        .fit(table)
    assert (engine.last_fit_info["collective"],
            engine.last_fit_info["collective_downgrade"]) == ("psum", "none")
    with pytest.raises(ValueError, match="Unknown collective"):
        LightGBMClassifier(collective="tree", **kw).setMesh(
            build_mesh(devices=["cpu"] * 2)).fit(table)
    # a feature axis keeps psum, after the data axis's own check (the
    # reference's order of reasons)
    for d, feature, reason in ((2, 2, "feature_axis"),
                               (1, 2, "single_data_shard")):
        LightGBMClassifier(collective="ring", parallelism="data+feature",
                           **kw).setMesh(build_mesh(
                               d, feature, devices=["cpu"] * (d * feature))
                                         ).fit(table)
        info = dict(engine.last_fit_info)
        assert (info["collective"], info["collective_downgrade"]) == \
            ("psum", reason)
        assert info["feature_shards"] == str(feature)


@pytest.mark.parametrize("parallelism,d,feature", [
    ("voting", 2, 1), ("feature", 1, 2), ("data+feature", 2, 2)])
def test_every_learner_trains_through_the_estimator(parallelism, d,
                                                    feature):
    """Each learner fits through ``setMesh`` and grows the reference
    estimator's forest; an unknown ``parallelism`` still raises."""
    X, y = _small_data()
    table = {"features": X[:300], "label": y[:300]}
    kw = dict(numIterations=2, numLeaves=5, minDataInLeaf=5, verbosity=0,
              collective="ring", parallelism=parallelism, topK=3)
    port = LightGBMClassifier(device="cpu", **kw).setMesh(
        build_mesh(d, feature, devices=["cpu"] * (d * feature))).fit(table)
    ref = RefClassifier(histogramMethod="segment", **kw) \
        .setMesh(_ref_mesh(d, feature)).fit(table)
    assert port.getNativeModel() == ref.getNativeModel()
    prob = np.asarray(port.transform(table)["probability"])
    assert prob.shape == (300, 2) and np.isfinite(prob).all()
    with pytest.raises(ValueError, match="Unknown parallelism"):
        LightGBMClassifier(device="cpu", parallelism="model").fit(table)


def test_voting_refuses_a_feature_axis():
    X, y = _small_data()
    with pytest.raises(ValueError, match="without a feature axis"):
        LightGBMClassifier(numIterations=1, device="cpu",
                           parallelism="voting").setMesh(
            build_mesh(2, 2, devices=["cpu"] * 4)).fit(
            {"features": X[:100], "label": y[:100]})


@pytest.mark.parametrize("parallelism,cards,shape", [
    ("data", 4, (4, 1)), ("voting", 4, (4, 1)), ("serial", 4, (1, 1)),
    ("feature", 4, (1, 4)), ("feature", 1, (1, 1)),
    ("data+feature", 4, (2, 2)), ("data+feature", 3, (3, 1))])
def test_resolve_mesh_lays_out_the_host_as_the_reference(
        monkeypatch, parallelism, cards, shape):
    """A host of ``cards`` devices: the port's CUDA cards (CPU stand-ins),
    the reference's first ``cards`` host devices."""
    from mmlspark_tpu.gbdt.distributed import resolve_mesh as ref_resolve
    host = jax.devices()[:cards]
    monkeypatch.setattr(jax, "devices", lambda *a: host)
    want = tuple(ref_resolve(parallelism).devices.shape)
    monkeypatch.setattr(
        distributed, "build_mesh",
        lambda *a, **k: build_mesh(*a, **k) if k or a
        else build_mesh(devices=["cpu"] * cards))
    mesh = distributed.resolve_mesh(parallelism)
    assert (mesh.data, mesh.feature) == want == shape


def test_no_auto_mesh_on_a_cpu_or_one_card_host(monkeypatch):
    """Auto-sharding needs a CUDA device, more than one card and at least
    autoMeshMinRows rows; anything less trains serially."""
    made = []
    monkeypatch.setattr(base, "resolve_mesh",
                        lambda p: made.append(p) or "mesh")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    est = LightGBMClassifier(device="cpu", autoMeshMinRows=0)
    assert est._fit_mesh(10 ** 6) is None            # a CPU fit
    monkeypatch.setattr(base, "resolve_device",
                        lambda d: torch.device("cuda", 0))
    est = LightGBMClassifier(autoMeshMinRows=1000)
    assert est._fit_mesh(999) is None                # too few rows
    assert est._fit_mesh(1000) == "mesh" and made == ["data"]
    assert LightGBMClassifier(parallelism="serial")._fit_mesh(10 ** 6) \
        is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert est._fit_mesh(10 ** 6) is None            # one card
    assert made == ["data"]


def test_mesh_decides_the_device():
    X, y = _small_data()
    table = {"features": X[:100], "label": y[:100]}
    est = LightGBMClassifier(numIterations=1, device="cuda")
    with pytest.raises(ValueError, match="mesh decides"):
        est.setMesh(build_mesh(devices=["cpu"] * 2)).fit(table)


def test_mesh_helpers_follow_the_reference():
    from mmlspark_tpu.core.mesh import shard_rows as ref_shard_rows
    from mmlspark_tpu_torch.core import mesh as pm
    x = np.arange(21, dtype=np.float32).reshape(7, 3)
    for d in (1, 2, 4, 8):
        want, n0 = ref_shard_rows(x, _ref_mesh(d), pad_value=-1)
        got, n1 = pm.shard_rows(x, build_mesh(devices=["cpu"] * d),
                                pad_value=-1)
        assert n0 == n1 == 7
        np.testing.assert_array_equal(got, want)
    mesh = build_mesh(devices=["cpu"] * 3)
    assert mesh.shape == {pm.DATA_AXIS: 3, pm.FEATURE_AXIS: 1} \
        and mesh.device_type == "cpu"
    with pm.use_mesh(mesh):
        assert pm.get_mesh() is mesh and pm.num_workers() == 3
    with pytest.raises(ValueError, match="needs 2 devices"):
        build_mesh(data=2, devices=["cpu"] * 3)
    # the feature axis: shapes and refusals as the reference's build_mesh
    from mmlspark_tpu.core.mesh import build_mesh as ref_bm
    for data, feature, n in ((None, 2, 4), (2, 2, 4), (1, 4, 4),
                             (None, 3, 4), (3, 2, 4)):
        devs = jax.devices()[:n]
        try:
            want = dict(ref_bm(data, feature, devs).shape)
        except ValueError:
            with pytest.raises(ValueError):
                build_mesh(data, feature, ["cpu"] * n)
            continue
        got = build_mesh(data, feature, ["cpu"] * n)
        assert got.shape == want and len(got) == n
        assert pm.num_workers(got) == want[pm.DATA_AXIS]
        assert pm.shard_rows(x, got)[0].shape[0] == \
            ref_shard_rows(x, ref_bm(data, feature, devs))[0].shape[0]


@pytest.mark.parametrize("d,feature", [(1, 2), (1, 4), (2, 2)])
def test_feature_schedule_equals_reference(d, feature):
    """The feature branch of the per-tree collective schedule, from
    shapes: split-column broadcasts and best-split gathers, plus the data
    axis's reductions on a 2-D mesh."""
    from mmlspark_tpu.core.mesh import FEATURE_AXIS
    from mmlspark_tpu.gbdt import grower as ref_grower
    from mmlspark_tpu_torch.gbdt import grower as port_grower
    f, L, B, n_local = 2000, 31, 256, 8192 // d
    common = dict(num_leaves=L, num_bins=B, data_axis_size=d)
    want = ref_grower.collective_schedule(
        ref_grower.GrowerConfig(
            axis_name=DATA_AXIS if d > 1 else None,
            feature_axis_name=FEATURE_AXIS, **common), f,
        n_rows_local=n_local, feature_shards=feature)
    got = port_grower.collective_schedule(
        port_grower.GrowerConfig(feature_axis_size=feature, **common), f,
        n_rows_local=n_local)
    for key in got:
        assert got[key] == want[key], key
