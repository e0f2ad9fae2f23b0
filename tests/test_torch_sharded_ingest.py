"""Sharded ingestion: ``engine.train`` given per-shard lists, held to the
reference's sharded fit (``mmlspark_tpu.gbdt.engine.train`` with lists,
JAX on the CPU over ``build_mesh(data=D)``).

The same unequal shards go to both packages, both pinned to
``histogram_method="segment"``, and the model text must match byte for
byte: gbdt at D = 2 and 4, bagging with feature fraction, validation with
early stopping, per-shard init scores, GOSS, rf, DART, and lambdarank
(queries pinned to their shards) with bagging and with validation, and
the multiclass GOSS quantized case the gang tests run.  Lambdarank with
DART at every query width from 11 to 33 documents
(:func:`test_sharded_ranking_dart_equals_reference`).  The reference
forests are fitted once per module (DART's other widths once a test).  Then the
reference's refusals (no mesh, a query spanning shards, mismatched rows,
a custom gradient) and a spy on the layout: no device piece is larger
than one shard.
"""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.mesh import build_mesh as ref_build_mesh
from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit
from mmlspark_tpu.gbdt import ndcg_at_k as ref_ndcg
from mmlspark_tpu.gbdt.engine import TrainParams as RefParams
from mmlspark_tpu.gbdt.engine import train as ref_train
from mmlspark_tpu.gbdt.objectives import get_objective as ref_objective
from mmlspark_tpu_torch.core.mesh import build_mesh
from mmlspark_tpu_torch.gbdt import elastic, fit_bin_mapper, get_objective
from mmlspark_tpu_torch.gbdt.distributed import prepare_arrays_from_shards
from mmlspark_tpu_torch.gbdt.engine import TrainParams, last_fit_info, train
from mmlspark_tpu_torch.gbdt.ranking import ndcg_at_k
from test_torch_multicontroller import GANGS
from torch_parity import one_torch_thread  # noqa: F401 - fixture

pytestmark = pytest.mark.usefixtures("one_torch_thread")

BASE = dict(num_iterations=6, num_leaves=7, min_data_in_leaf=5, max_bin=31,
            verbosity=0, histogram_method="segment")


def _logloss(margins, labels, weights):
    p = np.clip(1.0 / (1.0 + np.exp(-np.asarray(margins))), 1e-12,
                1 - 1e-12)
    return float(-np.mean(labels * np.log(p) + (1 - labels) * np.log(1 - p)))


def _table(n=720, f=6, seed=13):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f)).astype(np.float32)
    y = (X[:, 0] + 0.5 * X[:, 1] * X[:, 2] + rng.normal(size=n) > 0)
    return X, y.astype(np.float64)


def _cut(n, D, seed=0):
    """Unequal shards, as per-host readers would deliver them."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.choice(np.arange(40, n - 40), D - 1, replace=False))
    return np.split(np.arange(n), cuts)


@pytest.fixture(scope="module")
def binary():
    X, y = _table()
    rmap, pmap = ref_fit(X, max_bin=31), fit_bin_mapper(X, max_bin=31)
    n_val = 120
    val = dict(X=X[-n_val:], y=y[-n_val:])
    X, y = X[:-n_val], y[:-n_val]
    return dict(X=X, y=y, rmap=rmap, pmap=pmap, val=val,
                idx={D: _cut(len(y), D) for D in (2, 4)})


#: case -> (data shards, params, extras); extras: "val" (a validation set
#: with its metric), "init" (per-shard init scores)
BINARY_CASES = {
    "gbdt_d2": (2, {}, ()),
    "gbdt_d4": (4, {}, ()),
    "bagging": (4, dict(bagging_fraction=0.6, bagging_freq=2,
                        feature_fraction=0.8), ()),
    "validation_early_stopping": (4, dict(num_iterations=30,
                                          early_stopping_round=2,
                                          learning_rate=0.5), ("val",)),
    "init_scores": (2, {}, ("init",)),
    "goss": (4, dict(boosting="goss", top_rate=0.3, other_rate=0.2), ()),
    "rf": (4, dict(boosting="rf", bagging_fraction=0.7, bagging_freq=1),
           ()),
    "dart": (4, dict(boosting="dart", drop_rate=0.5, skip_drop=0.0), ()),
}


def _binary_inputs(b, D, extras, ref):
    mapper = b["rmap"] if ref else b["pmap"]
    idx = b["idx"][D]
    kw = {}
    if "val" in extras:
        kw = dict(val_bins=mapper.transform_packed(b["val"]["X"]),
                  val_labels=b["val"]["y"], val_metric=_logloss)
    if "init" in extras:
        kw["init_scores"] = [np.linspace(-0.5, 0.5, len(i)) for i in idx]
    return ([mapper.transform_packed(b["X"][i]) for i in idx],
            [b["y"][i] for i in idx], [np.ones(len(i)) for i in idx],
            mapper, kw)


@pytest.fixture(scope="module")
def reference_binary(binary):
    """The reference's sharded model text of every binary case."""
    out = {}
    for case, (D, params, extras) in BINARY_CASES.items():
        bs, ls, ws, mapper, kw = _binary_inputs(binary, D, extras, ref=True)
        out[case] = ref_train(
            bs, ls, ws, mapper, ref_objective("binary"),
            RefParams(**{**BASE, **params}),
            mesh=ref_build_mesh(data=D, feature=1,
                                devices=jax.devices()[:D]),
            **kw).save_native_model_string()
    return out


@pytest.mark.parametrize("case", list(BINARY_CASES))
def test_sharded_fit_equals_reference(case, binary, reference_binary):
    D, params, extras = BINARY_CASES[case]
    bs, ls, ws, mapper, kw = _binary_inputs(binary, D, extras, ref=False)
    port = train(bs, ls, ws, mapper, get_objective("binary"),
                 TrainParams(**{**BASE, **params}),
                 mesh=build_mesh(D, devices=["cpu"] * D), **kw)
    assert port.save_native_model_string() == reference_binary[case]
    assert last_fit_info["sharded_input"] == "true"


# -- lambdarank: each query's rows on one shard ------------------------------

RANK_D, RANK_Q, RANK_G = 4, 24, 12


def _rank_table(seed, G=RANK_G):
    rng = np.random.default_rng(seed)
    n = RANK_Q * G
    X = rng.normal(size=(n, 5)).astype(np.float32)
    util = X @ rng.normal(size=5) + rng.normal(size=n) * 0.5
    q = np.repeat(np.arange(RANK_Q), G)
    y = np.zeros(n)
    for qq in range(RANK_Q):
        m = q == qq
        y[m] = np.digitize(util[m], np.quantile(util[m], [0.5, 0.75, 0.9]))
    return X, y, q


RANK_CASES = {
    "bagging": (11, dict(bagging_fraction=0.7, bagging_freq=2)),
    "validation": (3, dict(num_iterations=20, early_stopping_round=2,
                           learning_rate=0.5)),
    "dart_bagging": (21, dict(boosting="dart", drop_rate=0.4,
                              bagging_fraction=0.7, bagging_freq=2)),
}
#: the cases whose model text equals the reference's byte for byte
RANK_EXACT = ("bagging", "validation")


def _rank_inputs(seed, ref, G=RANK_G):
    X, y, q = _rank_table(seed, G)
    mapper = (ref_fit if ref else fit_bin_mapper)(X, max_bin=31)
    # shard d holds queries d, d + D, ...: whole queries, unequal rows
    idx = [np.nonzero(np.isin(q, np.arange(d, RANK_Q, RANK_D)))[0]
           for d in range(RANK_D)]
    idx[0] = idx[0][q[idx[0]] != 0]      # one shard a query short
    Xv, yv, qv = _rank_table(seed + 1, G)
    ndcg = ref_ndcg if ref else ndcg_at_k

    def neg_ndcg(scores, labels, weights):
        return -float(np.mean(ndcg(np.asarray(scores), np.asarray(labels),
                                   qv, 5)))

    return ([mapper.transform_packed(X[i]) for i in idx],
            [y[i] for i in idx], [np.ones(len(i)) for i in idx],
            [q[i] for i in idx], mapper,
            dict(val_bins=mapper.transform_packed(Xv), val_labels=yv,
                 val_metric=neg_ndcg))


def _rinfo(qids):
    return {"query_ids": qids, "sigma": 1.0, "truncation_level": 30}


@pytest.fixture(scope="module")
def reference_ranking():
    return {case: _ref_ranking(case, RANK_G) for case in RANK_CASES}


def _ref_ranking(case, G):
    seed, params = RANK_CASES[case]
    bs, ls, ws, qs, mapper, val = _rank_inputs(seed, True, G)
    return ref_train(
        bs, ls, ws, mapper, ref_objective("lambdarank"),
        RefParams(**{**BASE, **params}),
        mesh=ref_build_mesh(data=RANK_D, feature=1,
                            devices=jax.devices()[:RANK_D]),
        ranking_info=_rinfo(qs),
        **(val if case == "validation" else {})
    ).save_native_model_string()


def _port_ranking(case, G=RANK_G):
    seed, params = RANK_CASES[case]
    bs, ls, ws, qs, mapper, val = _rank_inputs(seed, False, G)
    return train(bs, ls, ws, mapper, get_objective("lambdarank"),
                 TrainParams(**{**BASE, **params}),
                 mesh=build_mesh(RANK_D, devices=["cpu"] * RANK_D),
                 ranking_info=_rinfo(qs),
                 **(val if case == "validation" else {}))


@pytest.mark.parametrize("case", RANK_EXACT)
def test_sharded_ranking_equals_reference(case, reference_ranking):
    assert _port_ranking(case).save_native_model_string() \
        == reference_ranking[case]


#: the query widths of the DART case: from 12 to 32 documents the
#: reference's compiled mesh DART step adds the lambda sums in an order
#: chosen by the width (``ranking.DART_ORDERS``); 11 and 33 bound it
DART_WIDTHS = tuple(range(11, 34))


@pytest.mark.parametrize("G", DART_WIDTHS)
def test_sharded_ranking_dart_equals_reference(G, reference_ranking):
    """DART × lambdarank on the mesh, sharded, equals the reference byte
    for byte at every query width.  The mesh DART step is another
    compiled program than the ranking scan: its sums over a query's
    documents follow the vectorised, FMA-folded orders of
    ``ranking.DART_ORDERS`` (read from the reference's XLA CPU program;
    ROADMAP.md, Queue C 3).  Iterations 2 and 4 drop tree 0
    (``drop_seed`` 4, ``skip_drop`` 0.5), so the text holds both
    renormalisations and trees grown at dropped-out scores."""
    from mmlspark_tpu_torch.gbdt.engine import _dart_draw_drops
    seed, params = RANK_CASES["dart_bagging"]
    full = TrainParams(**{**BASE, **params})
    rng = np.random.default_rng(full.drop_seed)
    drops = [list(_dart_draw_drops(rng, it, full))
             for it in range(full.num_iterations)]
    assert [it for it, d in enumerate(drops) if 0 in d] == [2, 4]
    want = reference_ranking["dart_bagging"] if G == RANK_G \
        else _ref_ranking("dart_bagging", G)
    assert _port_ranking("dart_bagging", G).save_native_model_string() \
        == want


def test_global_qid_array_equals_per_shard_lists():
    """Query ids as one array in shard order split into the per-shard
    lists."""
    bs, ls, ws, qs, mapper, _ = _rank_inputs(5, ref=False)
    mesh = build_mesh(RANK_D, devices=["cpu"] * RANK_D)
    fits = [train(bs, ls, ws, mapper, get_objective("lambdarank"),
                  TrainParams(**BASE), mesh=mesh, ranking_info=_rinfo(q))
            .save_native_model_string() for q in (qs, np.concatenate(qs))]
    assert fits[0] == fits[1]


# -- the gang's multiclass case ---------------------------------------------

def test_gang_multiclass_case_equals_reference():
    """The multiclass GOSS quantized fit over four unequal shards that
    ``tests/test_torch_multicontroller.py`` runs as a gang of two
    controllers, fitted here by one controller
    (:func:`elastic.sharded_fit`, the text the gang must write), equals
    the reference's sharded fit of the same shards.  Both packages on
    their default histogram method ("auto": the native kernels on the
    CPU in both)."""
    args = elastic.parse_args(["--heartbeat-dir", "unused", "--device",
                               "cpu", "--num-processes", "2",
                               *GANGS["2x2_goss_multiclass_quantized"]])
    port = elastic.sharded_fit(args, None, torch.device("cpu"))[0]
    X, y = elastic._demo_table(args.data_seed, args.rows, args.features,
                               args.num_class)
    idx = elastic._shard_cuts(args, args.rows)
    assert len(idx) == 4 and len({len(i) for i in idx}) == 4
    mapper = ref_fit(X, max_bin=args.max_bin)
    ref = ref_train(
        [mapper.transform_packed(X[i]) for i in idx], [y[i] for i in idx],
        [np.ones(len(i)) for i in idx], mapper,
        ref_objective("multiclass", num_class=args.num_class),
        RefParams(num_iterations=args.iterations,
                  num_leaves=args.num_leaves,
                  learning_rate=args.learning_rate, max_bin=args.max_bin,
                  bagging_fraction=args.bagging_fraction,
                  bagging_freq=args.bagging_freq,
                  feature_fraction=args.feature_fraction,
                  boosting=args.boosting, quantized_grad=args.quantized,
                  verbosity=0),
        mesh=ref_build_mesh(data=4, feature=1, devices=jax.devices()[:4]))
    assert port.save_native_model_string() == ref.save_native_model_string()
    assert last_fit_info["quantized_bits"] == "16"


# -- the reference's refusals ------------------------------------------------

def _small(binary, D=2):
    return _binary_inputs(binary, D, (), ref=False)[:4]


def test_sharded_input_requires_a_mesh(binary):
    bs, ls, ws, mapper = _small(binary)
    with pytest.raises(ValueError, match="requires a mesh"):
        train(bs, ls, ws, mapper, get_objective("binary"),
              TrainParams(**BASE))


def test_custom_gradient_is_refused(binary):
    bs, ls, ws, mapper = _small(binary)
    with pytest.raises(NotImplementedError, match="custom gradient"):
        train(bs, ls, ws, mapper, get_objective("binary"),
              TrainParams(**BASE), mesh=build_mesh(2, devices=["cpu"] * 2),
              grad_fn_override=lambda s: (s, s))


def test_query_spanning_shards_raises():
    bs, ls, ws, qs, mapper, _ = _rank_inputs(7, ref=False)
    qs[1] = qs[1].copy()
    qs[1][0] = qs[0][0]                  # one query now on shards 0 and 1
    with pytest.raises(ValueError, match="spans shards"):
        train(bs, ls, ws, mapper, get_objective("lambdarank"),
              TrainParams(**BASE),
              mesh=build_mesh(RANK_D, devices=["cpu"] * RANK_D),
              ranking_info=_rinfo(qs))


@pytest.mark.parametrize("bad", ["labels", "shard_rows", "slots"])
def test_mismatched_rows_raise(binary, bad):
    bs, ls, ws, mapper = _small(binary)
    kw = {}
    if bad == "labels":
        ls = [ls[0][:-1], ls[1]]
        match = "labels"
    elif bad == "shard_rows":
        kw["shard_rows"] = [len(ls[0]) + 1, len(ls[1])]
        match = "shard_rows|labels"
    else:
        bs = bs + [bs[0]]
        ls, ws = ls + [ls[0]], ws + [ws[0]]
        match = "one shard slot per data-mesh slice"
    with pytest.raises(ValueError, match=match):
        train(bs, ls, ws, mapper, get_objective("binary"),
              TrainParams(**BASE), mesh=build_mesh(2, devices=["cpu"] * 2),
              **kw)


def test_none_slots_need_shard_rows(binary):
    bs, ls, ws, mapper = _small(binary)
    with pytest.raises(ValueError, match="requires shard_rows"):
        train([bs[0], None], ls, ws, mapper, get_objective("binary"),
              TrainParams(**BASE), mesh=build_mesh(2, devices=["cpu"] * 2))


def test_no_device_piece_exceeds_one_shard(binary):
    """Every piece the layout builds holds at most one shard's rows, and
    the pieces pad to the largest shard."""
    bs, ls, ws, mapper = _small(binary, D=4)
    S = max(len(y) for y in ls)
    pieces = []
    arrays = prepare_arrays_from_shards(
        bs, ls, ws, build_mesh(4, devices=["cpu"] * 4), 0.0,
        piece_spy=pieces.append)
    assert pieces
    assert all(shape[0] == S < sum(len(y) for y in ls) for shape in pieces)
    assert [tuple(b.shape) for b in arrays.bins] == [(S, bs[0].shape[1])] * 4
    # the real rows of shard d are its own rows, in order
    for d, b in enumerate(bs):
        np.testing.assert_array_equal(arrays.bins[d][:len(b)].numpy(), b)
        assert float(arrays.real[d].sum()) == len(b)
