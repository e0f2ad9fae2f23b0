"""Wide bins (``maxBin`` above 255: int32 bin codes) in the port against
the JAX reference, on the CPU.

* The bin mapper and the binned matrix equal the reference's at
  ``max_bin`` 511, 1023 and 4095, int32 codes.
* Fits at 511 and 1023 write the reference's model text byte for byte:
  serial, data psum and ring at D = 2 and 4, feature 1 × 2 and voting D =
  4.  Under ``pallas_ring`` (D = 4) the reference sends its Pallas
  methods above 256 bins to an XLA contraction and the port adds in row
  order, so the forests keep the same structure with leaf values within
  rtol 1e-5, atol 1e-6.
* Above 256 bins the grower never calls ``fused_segment_hist_ring`` (the
  reference's gate of its fused kernel): each shard's segment histogram
  is reduced apart.
* The plain twins equal the one-hot oracle at B = 257, 1,024 and 4,096 in
  all three accumulation modes, and the order the wide kernels state
  (``histogram_segment_ordered``) sums the same cells.

The reference pins ``histogram_method="segment"``.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.gbdt import fit_bin_mapper as ref_fit
from mmlspark_tpu_torch.gbdt import engine, fit_bin_mapper, grower
from mmlspark_tpu_torch.ops import cuda_histogram as ch
from mmlspark_tpu_torch.ops.histogram import _hist_onehot

from torch_parity import data, fit_pair, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("max_bin", [511, 1023, 4095])
def test_mapper_and_bins_equal_the_reference(max_bin):
    rng = np.random.default_rng(max_bin)
    X = rng.normal(size=(6000, 4))
    X[::13, 1] = np.nan
    X[:, 3] = np.round(X[:, 3] * 100)          # few distinct values
    ref, port = ref_fit(X, max_bin=max_bin), fit_bin_mapper(X,
                                                            max_bin=max_bin)
    assert port.num_total_bins == ref.num_total_bins > 256
    assert port.missing_bin == ref.missing_bin
    for a, b in zip(port.upper_bounds, ref.upper_bounds):
        np.testing.assert_array_equal(a, b)
    assert port.feature_infos() == ref.feature_infos()
    got = port.transform(X, "cpu")
    assert got.dtype == port.bin_dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref.transform(X))
    np.testing.assert_array_equal(got.numpy(), ref.transform_packed(X))


#: the learners of the wide-bin parity grid: (data shards, feature
#: slices, params)
LEARNERS = {
    "serial": (1, 1, {}),
    "data_psum_2": (2, 1, dict(collective="psum")),
    "data_ring_2": (2, 1, dict(collective="ring")),
    "data_psum_4": (4, 1, dict(collective="psum")),
    "data_ring_4": (4, 1, dict(collective="ring")),
    "feature_1x2": (1, 2, dict(parallelism="feature")),
    "voting_ring_4": (4, 1, dict(collective="ring", parallelism="voting",
                                 top_k=2)),
}


def _wide_pair(max_bin, d, feature, **kw):
    X, y = data("binary", n=3000, f=5, seed=3)
    return fit_pair(X, y, "binary", d=d, feature=feature, max_bin=max_bin,
                    num_iterations=4, num_leaves=7, min_data_in_leaf=5,
                    **kw)


@pytest.mark.parametrize("learner", list(LEARNERS))
@pytest.mark.parametrize("max_bin", [511, 1023])
def test_wide_fit_writes_the_reference_model_text(max_bin, learner):
    d, feature, kw = LEARNERS[learner]
    ref, port = _wide_pair(max_bin, d, feature, **kw)
    assert int(engine.last_fit_info["data_shards"]) == d
    assert port.save_native_model_string() == ref.save_native_model_string()


@pytest.mark.parametrize("max_bin", [511, 1023])
def test_wide_pallas_ring_keeps_the_reference_forest(max_bin):
    ref, port = _wide_pair(max_bin, 4, 1, collective="ring",
                           method="pallas_ring")
    assert engine.last_fit_info["histogram_method"] == "pallas_ring"
    assert len(port.trees) == len(ref.trees)
    for a, b in zip(ref.trees, port.trees):
        for k in ("split_feature", "threshold", "left_child", "right_child",
                  "leaf_count", "internal_count"):
            np.testing.assert_array_equal(getattr(b, k), getattr(a, k))
        np.testing.assert_allclose(b.leaf_value, a.leaf_value, rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("max_bin,fused", [(255, True), (511, False),
                                           (1023, False)])
def test_fused_ring_only_up_to_256_bins(monkeypatch, max_bin, fused):
    """Under ``pallas_ring`` on a data ring, ``_segment_hists`` calls
    ``fused_segment_hist_ring`` at 256 bins and never above; there each
    shard's ``hist_segment`` runs and the ring reduces."""
    calls = {"fused": 0, "ring": 0, "segment": 0}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    for name, attr in (("fused", "fused_segment_hist_ring"),
                       ("ring", "ring_allreduce"),
                       ("segment", "segment_histogram")):
        monkeypatch.setattr(grower, attr,
                            counting(name, getattr(grower, attr)))
    _wide_pair(max_bin, 4, 1, collective="ring", method="pallas_ring")
    if fused:
        assert calls["fused"] > 0 and calls["segment"] == 0
    else:
        assert calls["fused"] == 0
        assert calls["segment"] > 0 and calls["ring"] > 0


@pytest.mark.parametrize("accum", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("B", [257, 1024, 4096])
def test_twins_equal_the_onehot_oracle(B, accum):
    """The plain twins and the wide kernels' stated order against the
    one-hot oracle (f64 sums): int32 exactly, f32 and bf16 within rtol
    1e-5, atol 1e-5 (900 rows of unit normals: a cell's sum in another
    order differs by a few ulp).  Codes of B .. B + 4 are dropped."""
    rng = np.random.default_rng(B)
    n, f = 900, 3
    bins = torch.from_numpy(rng.integers(0, B + 5, size=(n, f),
                                         dtype=np.int32))
    if accum == "int32":
        gh = torch.from_numpy(rng.integers(-300, 300, size=(n, 3),
                                           dtype=np.int32))
    else:
        gh = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    order = torch.from_numpy(rng.permutation(n).astype(np.int32))
    rows = order[100:700].long()
    want = _hist_onehot(bins, gh, B, accum)
    want_seg = _hist_onehot(bins[rows], gh[rows], B, accum)
    pairs = [
        (ch.histogram_plain(bins, gh, B, accum), want),
        (ch.histogram_segment_ordered(bins, gh, None, 0, n, B, accum,
                                      ch.SegGeometry(2, 2, 2, 2, 2)), want),
        (ch.histogram_fused_plain(bins, gh, order, 100, 600, B, accum),
         want_seg),
        (ch.histogram_segment_ordered(bins, gh, order, 100, 600, B, accum,
                                      ch.SegGeometry(3, 1, 4, 1, 3)),
         want_seg)]
    for got, ref in pairs:
        if accum == "int32":
            assert torch.equal(got, ref)
        else:
            torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
