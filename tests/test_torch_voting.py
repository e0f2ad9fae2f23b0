"""The port's PV-Tree voting learner against the JAX reference, on the CPU.

The reference's voting protocol (``mmlspark_tpu/gbdt/grower.py``:
``_voting_votes``, ``_voting_candidates``, ``_voting_decide``,
``find_best_split_voting_pair``) runs as its own tests run it: the helpers
directly, the pair under ``shard_map`` over the forced 8-device host
platform of ``tests/conftest.py`` (the ring in interpret mode), and whole
fits pinned to ``histogram_method="segment"``.  The port runs its plain
twins on ``devices=["cpu"] * D``.  Inputs come from numpy seeds.

* ``top_k_indices`` orders ties as ``jax.lax.top_k`` does (lower index
  first), which ``torch.topk`` does not promise.
* Votes, candidates and decisions are equal: indices exactly, gains bit
  for bit (the port adds over the bins axis in XLA's CPU order).
* Voting fits give the reference's LightGBM model text byte for byte
  (psum and ring, D = 2 and 4, ``top_k`` small and at least f).
* With ``top_k ≥ f`` every feature is voted, so voting grows the port's
  own data-parallel forest: the same structure, and leaf values within
  rtol 1e-5, atol 1e-7 — voting sums each shard's local leaf totals,
  the data learner sums the reduced histogram, so the f32 totals differ
  in their last bits.
"""

import gzip
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as RefMesh
from jax.sharding import NamedSharding, PartitionSpec as P

from mmlspark_tpu.core.mesh import DATA_AXIS, shard_map_compat
from mmlspark_tpu.core.mesh import build_mesh as ref_build_mesh
from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit
from mmlspark_tpu.gbdt import grower as ref
from mmlspark_tpu.gbdt.engine import TrainParams as RefParams
from mmlspark_tpu.gbdt.engine import train as ref_train
from mmlspark_tpu.gbdt.objectives import get_objective as ref_objective
from mmlspark_tpu_torch.core.mesh import build_mesh
from mmlspark_tpu_torch.gbdt import engine, fit_bin_mapper, get_objective
from mmlspark_tpu_torch.gbdt import grower as port
from mmlspark_tpu_torch.gbdt.engine import TrainParams, train
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(num_iterations=3, num_leaves=7, min_data_in_leaf=5, max_bin=63,
             verbosity=0)


def _small_data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(640, 9))
    return X, (X[:, 0] - X[:, 2] + 0.3 * X[:, 4] > 0).astype(np.float64)


# -- top-k order ---------------------------------------------------------------

TOP_K_CASES = {
    "ties": (np.array([3., 1., 3., 2., 3., 1., 2., 0.]), 5),
    "all_neg_inf": (np.full(7, -np.inf), 3),
    "some_neg_inf": (np.array([-np.inf, 0.5, -np.inf, 0.5, -np.inf]), 4),
    "k_at_least_f": (np.array([0.1, -np.inf, 0.1, 7.0]), 9),
}


@pytest.mark.parametrize("case", sorted(TOP_K_CASES))
def test_top_k_indices_order_equals_jax_top_k(case):
    score, k = TOP_K_CASES[case]
    score = score.astype(np.float32)
    _, want = jax.lax.top_k(jnp.asarray(score), min(k, score.shape[0]))
    got = port.top_k_indices(torch.from_numpy(score), k)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- the protocol's pieces -------------------------------------------------------


def _hist(rng, f, B, n=400, dup=True):
    """A histogram of n rows: counts, gradients and hessians per cell.
    Features 1 and 3 copy feature 0 (tied votes), feature f-1 is empty
    but for one bin (no valid split: its score is -inf)."""
    bins = rng.integers(0, B, size=(n, f))
    g = rng.normal(size=n)
    h = rng.uniform(0.1, 1.0, size=n)
    if dup:
        bins[:, 1] = bins[:, 0]
        bins[:, 3] = bins[:, 0]
    bins[:, f - 1] = 0
    out = np.zeros((f, B, 3), np.float32)
    for j in range(f):
        np.add.at(out[j], bins[:, j], np.stack([g, h, np.ones(n)], 1))
    return out


def _cfgs(k, min_data=5, **kw):
    common = dict(num_bins=16, min_data_in_leaf=min_data, voting_k=k, **kw)
    return ref.GrowerConfig(**common), port.GrowerConfig(**common)


def _feat_info(f, masked=()):
    fi = np.zeros((f, 3), np.float32)
    fi[:, 0] = 1.0
    fi[list(masked), 0] = 0.0
    return fi


@pytest.mark.parametrize("k,min_data,masked,depth_ok", [
    (3, 5, (), True), (4, 5, (2,), True), (12, 5, (), True),
    (3, 10_000, (), True), (3, 5, (), False)])
def test_voting_votes_equal_reference(k, min_data, masked, depth_ok):
    """Local votes, including tied scores, masked features, every score
    -inf (min_data_in_leaf above the leaf, or depth exhausted) and k ≥ f."""
    f, B = 10, 16
    hist = _hist(np.random.default_rng(k + min_data), f, B)
    fi = _feat_info(f, masked)
    rcfg, pcfg = _cfgs(k, min_data)
    num_mask, cat_allowed = ref._voting_masks(jnp.asarray(fi), depth_ok,
                                              rcfg)
    want = ref._voting_votes(jnp.asarray(hist), jnp.asarray(fi),
                             jnp.asarray(depth_ok), num_mask, cat_allowed,
                             rcfg)
    got = port.voting_votes(torch.from_numpy(hist), torch.from_numpy(fi),
                            depth_ok, pcfg)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", range(4))
def test_voting_candidates_equal_reference(seed):
    """The global election from D shards' votes, with many equal counts."""
    rng = np.random.default_rng(seed)
    f, k, D = 13, 3 + seed, 4
    votes = np.stack([rng.choice(min(f, 6 + seed), size=k, replace=False)
                      for _ in range(D)]).astype(np.int32)
    rcfg, pcfg = _cfgs(k)
    want = ref._voting_candidates(jnp.asarray(votes.reshape(-1)), f, rcfg)
    got = port.voting_candidates(torch.from_numpy(votes).long(), f, pcfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,min_data", [(0, 5), (1, 5), (2, 10_000)])
def test_voting_decide_equals_reference(seed, min_data):
    """The exact split over a reduced candidate slab: gain bit for bit,
    feature and bin exactly (all -inf when min_data_in_leaf bites)."""
    rng = np.random.default_rng(seed)
    f, B = 10, 16
    hist = _hist(rng, f, B)
    cand = rng.choice(f, size=6, replace=False).astype(np.int32)
    slab = hist[cand]
    tot = hist[0].sum(0)
    fi = _feat_info(f, (int(cand[1]),))
    rcfg, pcfg = _cfgs(3, min_data)
    num_mask, cat_allowed = ref._voting_masks(jnp.asarray(fi), True, rcfg)
    want = ref._voting_decide(jnp.asarray(slab), jnp.asarray(cand),
                              *map(jnp.float32, tot), jnp.asarray(fi),
                              jnp.asarray(True), num_mask, cat_allowed, rcfg)
    got = port.voting_decide(torch.from_numpy(slab), torch.from_numpy(cand),
                             *map(np.float32, tot), torch.from_numpy(fi),
                             True, pcfg)
    for a, b in zip(got, want[:3]):
        np.testing.assert_array_equal(np.asarray(a.numpy(), np.float32),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("collective", ["psum", "ring"])
@pytest.mark.parametrize("d", [2, 4])
def test_voting_pair_equals_reference_on_a_mesh(d, collective):
    """One grow step's pair (both children's votes, one election per child,
    one stacked slab reduction, two decisions) against the reference's
    ``find_best_split_voting_pair`` under ``shard_map``."""
    rng = np.random.default_rng(10 * d + len(collective))
    f, B, k = 12, 16, 2
    hl = np.stack([_hist(rng, f, B, n=150) for _ in range(d)])
    hr = np.stack([_hist(rng, f, B, n=110, dup=False) for _ in range(d)])
    tl, tr = hl[:, 0].sum((0, 1)), hr[:, 0].sum((0, 1))
    fi = _feat_info(f, (5,))
    rcfg, pcfg = _cfgs(k, 5, collective=collective, data_axis_size=d)
    rcfg = ref.GrowerConfig(**{**rcfg.__dict__, "axis_name": DATA_AXIS})
    mesh = RefMesh(np.asarray(jax.devices()[:d]), (DATA_AXIS,))

    def step(a, b):
        (gl, fl, bl, _, _), (gr, fr, br, _, _) = \
            ref.find_best_split_voting_pair(
                a[0], b[0], tuple(map(jnp.float32, tl)),
                tuple(map(jnp.float32, tr)), jnp.asarray(fi),
                jnp.asarray(True), rcfg)
        return jnp.stack([gl, gr])[None], jnp.stack([fl, fr, bl, br])[None]

    spec = P(DATA_AXIS, None, None, None)
    args = [jax.device_put(jnp.asarray(x), NamedSharding(mesh, spec))
            for x in (hl, hr)]
    gains, fb = jax.jit(shard_map_compat(
        step, mesh, (spec, spec), (P(DATA_AXIS, None), P(DATA_AXIS, None))
    ))(*args)
    hists = [torch.stack([torch.from_numpy(a), torch.from_numpy(b)])
             for a, b in zip(hl, hr)]
    tot = torch.from_numpy(np.stack([tl, tr]))
    fis = [torch.from_numpy(fi)] * d
    g, feat, b, _, _ = port.find_best_split_voting(
        hists, tot, fis, True, pcfg, build_mesh(devices=["cpu"] * d))
    np.testing.assert_array_equal(g.numpy(), np.asarray(gains)[0])
    np.testing.assert_array_equal(torch.cat([feat, b]).numpy(),
                                  np.asarray(fb)[0])


# -- fits --------------------------------------------------------------------------


def _fit_ref(X, y, d, collective, **kw):
    mapper = ref_fit(X, max_bin=SMALL["max_bin"])
    return ref_train(mapper.transform_packed(X), y, None, mapper,
                     ref_objective("binary"),
                     RefParams(histogram_method="segment",
                               collective=collective, parallelism="voting",
                               **{**SMALL, **kw}),
                     mesh=ref_build_mesh(data=d,
                                         devices=jax.devices()[:d]))


def _fit_port(X, y, d, collective, parallelism="voting", **kw):
    mapper = fit_bin_mapper(X, max_bin=SMALL["max_bin"])
    return train(mapper.transform(X, "cpu"), y, None, mapper,
                 get_objective("binary"),
                 TrainParams(histogram_method="segment",
                             collective=collective, parallelism=parallelism,
                             **{**SMALL, **kw}),
                 mesh=build_mesh(devices=["cpu"] * d))


@pytest.mark.parametrize("top_k", [2, 20])
@pytest.mark.parametrize("collective", ["psum", "ring"])
@pytest.mark.parametrize("d", [2, 4])
def test_voting_forest_text_equals_reference(d, collective, top_k):
    X, y = _small_data()
    ref_model = _fit_ref(X, y, d, collective, top_k=top_k)
    got = _fit_port(X, y, d, collective, top_k=top_k)
    assert got.save_native_model_string() == \
        ref_model.save_native_model_string()
    info = engine.last_fit_info
    assert (info["collective"], info["voting_k"], info["data_shards"]) == \
        (collective, str(top_k), str(d))


def test_breast_cancer_voting_fit_with_bagging_equals_reference():
    with gzip.open(os.path.join(REPO, "tests", "benchmarks", "data",
                                "breast_cancer.csv.gz"), "rt") as fh:
        fh.readline()
        rows = np.asarray([[float(v) for v in line.split(",")]
                           for line in fh])
    X, y = rows[:, :-1].astype(np.float32), rows[:, -1]
    kw = dict(top_k=4, bagging_fraction=0.8, bagging_freq=2,
              feature_fraction=0.7)
    assert _fit_port(X, y, 4, "ring", **kw).save_native_model_string() == \
        _fit_ref(X, y, 4, "ring", **kw).save_native_model_string()


def test_full_k_voting_grows_the_data_parallel_forest():
    X, y = _small_data()
    vote = _fit_port(X, y, 4, "ring", top_k=9)
    data = _fit_port(X, y, 4, "ring", parallelism="data")
    assert len(vote.trees) == len(data.trees)
    for a, b in zip(data.trees, vote.trees):
        for k in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-7)


def test_voting_launches_one_select_reduction_per_tree_and_split(
        monkeypatch):
    """The root and every grow step each reduce one voted slab, through
    ``ring_allreduce_select`` under the ring; no dense reduction runs."""
    from mmlspark_tpu_torch.ops import collectives as co
    calls = {"select": [], "dense": 0}
    real_select = co.ring_allreduce_select

    def select(parts, cand, mesh):
        calls["select"].append(tuple(cand.shape))
        return real_select(parts, cand, mesh)

    def dense(*a, **k):
        calls["dense"] += 1
        raise AssertionError("voting reduced a dense histogram")

    monkeypatch.setattr(port, "ring_allreduce_select", select)
    monkeypatch.setattr(port, "ring_allreduce", dense)
    X, y = _small_data()
    model = _fit_port(X, y, 4, "ring", top_k=2)
    splits = sum(t.num_leaves - 1 for t in model.trees)
    assert len(calls["select"]) == len(model.trees) + splits
    assert calls["select"].count((4,)) == len(model.trees)
    assert calls["select"].count((2, 4)) == splits
    assert calls["dense"] == 0


# -- the schedule ------------------------------------------------------------------


def test_wide_voting_schedule_equals_reference():
    """artifacts/bench_wide_r16.json's configuration (8192 × 2000, D = 4,
    31 leaves, 255 bins, topK 32), from shapes alone."""
    f, L, B = 2000, 31, 256
    common = dict(num_leaves=L, num_bins=B, voting_k=32, collective="ring",
                  data_axis_size=4)
    want = ref.collective_schedule(
        ref.GrowerConfig(axis_name=DATA_AXIS, **common), f,
        n_rows_local=2048)
    got = port.collective_schedule(port.GrowerConfig(**common), f,
                                   n_rows_local=2048)
    assert (got["count"], got["payload_bytes"],
            got["dense_payload_bytes"]) == (31, 12_001_508, 190_464_000)
    for key in got:
        assert got[key] == want[key], key
    assert round(got["payload_bytes"] / got["dense_payload_bytes"], 6) \
        == 0.063012
