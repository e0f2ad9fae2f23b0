"""Lambdarank and ``LightGBMRanker`` in the port against the JAX reference,
on the CPU.

* The discount ``1 / log2(2 + rank)`` at every rank 0 … 4,095 and the log
  behind it, bit for bit against the reference's compiled program.
* The lambda gradient (:func:`..ranking.lambda_grad_sorted`) against the
  reference's jitted one at G = 7, 33 and 230, with tied scores, padded
  queries and several chunks: bit for bit (both pairwise sums are added in
  XLA's CPU order); the serial closure in the rows' own order, with and
  without weights.
* The host helpers (``pack_queries``, ``query_tensors``,
  ``shard_queries``, ``ndcg_at_k``) equal the reference's.
* ``LightGBMRanker`` fits (40 queries of 2–39 documents, 6 features, 5
  iterations): model text byte for byte serially, with goss, rf and dart,
  with NDCG early stopping, and on the data psum at D = 2 and 4 and a
  2 × 2 data+feature mesh (each query on one data shard), plus dart, goss
  and rf on the D = 2 mesh; a ring request keeps psum with the reason
  ``"ranking"``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.mesh import build_mesh as ref_build_mesh
from mmlspark_tpu.gbdt import LightGBMRanker as RefRanker
from mmlspark_tpu.gbdt import ranking as ref_ranking
from mmlspark_tpu_torch import LightGBMRanker, build_mesh, ndcg_at_k
from mmlspark_tpu_torch.gbdt import engine, ranking
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_discount_equals_compiled_reference_at_every_rank():
    r = np.arange(4096, dtype=np.float32)
    want = np.asarray(jax.jit(lambda r: 1.0 / jnp.log2(2.0 + r))(r))
    got = ranking.dcg_discount(torch.from_numpy(r)).numpy()
    np.testing.assert_array_equal(got, want)
    x = r + 2.0
    np.testing.assert_array_equal(ranking.log32(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax.jit(jnp.log)(x)))


def _query_block(G, n_queries, rng, ties=True):
    """``(s_sorted, qidx, qmask, gains, labq, invmax)`` for queries of at
    most G documents, row positions in query order, with pads."""
    sizes = np.concatenate([[G], rng.integers(1, G + 1, n_queries - 1)])
    qid = np.repeat(np.arange(n_queries), sizes)
    order, qidx, qmask = ranking.pack_queries(qid)
    labels = rng.integers(0, 5, len(qid)).astype(np.float32)
    gains, labq, invmax = ranking.query_tensors(labels[order], qidx, qmask,
                                                30)
    s = (rng.normal(size=len(qid)) * 2).astype(np.float32)
    if ties:
        s[::3] = 0.5
        s[1::7] = 0.0
    return s, qidx, qmask, gains, labq, invmax


@pytest.mark.parametrize("G", [7, 33, 230])
@pytest.mark.parametrize("sigma,trunc", [(1.0, 30), (0.7, 5)])
def test_lambda_grad_equals_reference(G, sigma, trunc):
    rng = np.random.default_rng(G)
    s, qidx, qmask, gains, labq, invmax = _query_block(G, 9, rng)
    n = len(s)
    chunk = 3
    pad = (-len(qidx)) % chunk
    if pad:
        qidx = np.concatenate([qidx, np.zeros((pad, G), np.int32)])
        qmask = np.concatenate([qmask, np.zeros((pad, G), np.float32)])
        gains = np.concatenate([gains, np.zeros((pad, G), np.float32)])
        labq = np.concatenate([labq, -np.ones((pad, G), np.float32)])
        invmax = np.concatenate([invmax, np.zeros(pad, np.float32)])
    shaped = [a.reshape((-1, chunk) + a.shape[1:])
              for a in (qidx, qmask, gains, labq, invmax)]
    rg, rh = jax.jit(lambda s, *q: ref_ranking.lambda_grad_sorted(
        s, *q, sigma, trunc, n))(s, *shaped)
    qt = ranking._chunked(qidx, qmask, gains, labq, invmax, chunk, "cpu")
    pg, ph = ranking.lambda_grad_sorted(torch.from_numpy(s), qt, sigma,
                                        trunc, n)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(rg))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(rh))


@pytest.mark.parametrize("weighted", [False, True])
def test_serial_gradient_equals_reference_closure(weighted):
    rng = np.random.default_rng(1)
    qid = rng.integers(0, 25, size=700)
    labels = rng.integers(0, 5, size=700).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=700) if weighted else None
    scores = (rng.normal(size=700)).astype(np.float32)
    ref = ref_ranking.make_lambdarank_grad_fn(labels, qid, sigma=1.3,
                                              truncation_level=10,
                                              weights=w)
    port = ranking.LambdarankGradient.serial(labels, qid, 1.3, 10, "cpu", w)
    rg, rh = ref(jnp.asarray(scores))
    pg, ph = port.grad_hess(0, torch.from_numpy(scores))
    np.testing.assert_array_equal(pg.numpy(), np.asarray(rg))
    np.testing.assert_array_equal(ph.numpy(), np.asarray(rh))


def test_host_helpers_equal_reference():
    rng = np.random.default_rng(2)
    qid = rng.integers(0, 30, size=500)
    labels = rng.integers(0, 5, size=500).astype(np.float64)
    for a, b in zip(ranking.pack_queries(qid), ref_ranking.pack_queries(qid)):
        np.testing.assert_array_equal(a, b)
    for d in (1, 2, 4):
        mine = ranking.shard_queries(labels, qid, d, 30,
                                     query_chunk_pairs=2000)
        theirs = ref_ranking.shard_queries(labels, qid, d, 30,
                                           query_chunk_pairs=2000)
        np.testing.assert_array_equal(mine[0], theirs[0])
        np.testing.assert_array_equal(mine[1], theirs[1])
        for a, b in zip(mine[2], theirs[2]):
            np.testing.assert_array_equal(a, b)
    scores = rng.normal(size=500)
    for k in (1, 3, 10):
        assert ndcg_at_k(scores, labels, qid, k) == \
            ref_ranking.ndcg_at_k(scores, labels, qid, k)


def _rank_data(nq=40, f=6, seed=0):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(2, 40, size=nq)
    q = np.repeat(np.arange(nq), sizes)
    rng.shuffle(q)
    X = rng.normal(size=(len(q), f))
    s = X[:, 0] + 0.5 * X[:, 1] + rng.normal(size=len(q)) * 0.5
    y = np.digitize(s, np.quantile(s, [0.5, 0.8, 0.95])).astype(np.float64)
    return {"features": X, "label": y, "query": q,
            "val": np.isin(q, np.arange(0, nq, 5))}


def _fit_both(table, mesh=None, **kw):
    kw = {**dict(numIterations=5, numLeaves=7, minDataInLeaf=10, maxBin=63,
                 verbosity=0), **kw}
    ref = RefRanker(histogramMethod="segment", **kw)
    port = LightGBMRanker(device="cpu", **kw)
    if mesh is not None:
        d, f = mesh
        ref.setMesh(ref_build_mesh(data=d, feature=f,
                                   devices=jax.devices()[:d * f]))
        port.setMesh(build_mesh(d, f, devices=["cpu"] * (d * f)))
    return ref.fit(table), port.fit(table)


CASES = {
    "serial": (None, {}),
    "goss": (None, dict(boostingType="goss")),
    "rf": (None, dict(boostingType="rf", baggingFraction=0.7,
                      baggingFreq=1)),
    "dart": (None, dict(boostingType="dart", skipDrop=0.0, dropRate=0.5)),
    "bagging": (None, dict(baggingFraction=0.7, baggingFreq=2,
                           featureFraction=0.8)),
    "data_2": ((2, 1), {}),
    "data_4": ((4, 1), {}),
    "data_feature_2x2": ((2, 2), dict(parallelism="data+feature")),
    "data_2_dart": ((2, 1), dict(boostingType="dart", skipDrop=0.0,
                                 dropRate=0.5)),
    "data_2_goss": ((2, 1), dict(boostingType="goss")),
    "data_2_rf": ((2, 1), dict(boostingType="rf", baggingFraction=0.7,
                               baggingFreq=1)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_ranker_model_text_equals_reference(case):
    mesh, kw = CASES[case]
    table = _rank_data()
    ref, port = _fit_both(table, mesh, **kw)
    assert port.getNativeModel() == ref.getNativeModel()
    assert port.getModel().objective_str == "lambdarank"
    pred = port.transform(table)["prediction"]
    np.testing.assert_array_equal(
        pred, port.getModel().predict_margin(table["features"],
                                             device="cpu").numpy())
    np.testing.assert_array_equal(pred, ref.transform(table)["prediction"])


@pytest.mark.parametrize("mesh", [None, (2, 1)])
def test_ranker_ndcg_early_stopping_equals_reference(mesh):
    table = _rank_data()
    ref, port = _fit_both(table, mesh, numIterations=30, learningRate=0.3,
                          validationIndicatorCol="val",
                          earlyStoppingRound=2)
    assert port.getNativeModel() == ref.getNativeModel()
    info = engine.last_validation
    stop = int(port.getModel().params["num_iterations"])
    assert stop < 30 and stop == info["best_iteration"] + 1
    # the metric is the negative NDCG at max(evalAt) of the held-out
    # queries
    val = table["val"]
    margins = ref.getModel().predict_margin(table["features"][val])
    assert info["best_metric"] == pytest.approx(-ref_ranking.ndcg_at_k(
        np.asarray(margins), table["label"][val], table["query"][val], 10),
        rel=1e-6)


def test_ranker_ring_keeps_psum_with_reason_ranking():
    table = _rank_data()
    ref, port = _fit_both(table, (2, 1), collective="ring",
                          quantizedGrad="16")
    assert port.getNativeModel() == ref.getNativeModel()
    info = engine.last_fit_info
    assert (info["collective"], info["collective_downgrade"]) == \
        ("psum", "ranking")
    assert info["quantized_downgrade"] == "quantized_unsupported"


def test_ranker_learns():
    table = _rank_data(seed=3)
    model = LightGBMRanker(device="cpu", numIterations=20, numLeaves=7,
                           minDataInLeaf=10, verbosity=0).fit(table)
    s = model.transform(table)["prediction"]
    base = ndcg_at_k(np.zeros_like(s), table["label"], table["query"], 10)
    assert ndcg_at_k(s, table["label"], table["query"], 10) > base + 0.1
