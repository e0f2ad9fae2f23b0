"""The port's native CPU fit path (``native/fasthist.cc`` through
``ops/histogram.py``'s ``"native"`` method, which ``"auto"`` takes on a
CPU tensor) against the JAX reference's native XLA FFI calls, on the CPU.

* Each of the six entries equals the reference's FFI call on the same
  inputs bit for bit, and its plain twin: the full and the segment
  histogram in f32; the quantized full and segment histograms on both
  sides of ``packed_accum_ok`` (rows outside the packed contract among
  them); the partition (row order and counts, numeric and bitset); the
  split scan (winner and gain, and the case where the scan's own gain
  clears the floor and the recomputed one does not: −inf on both sides).
* ``"native"`` is a CPU method: ``check_method`` refuses it on a card,
  and ``"auto"`` keeps the CUDA kernels there.
* Port fits under ``"auto"`` write the reference's ``"auto"`` model text
  byte for byte: serial binary, regression, quantized, categorical, a
  D = 2 data-psum mesh; and the estimator fits of tests that pin both
  packages to ``"segment"`` (the breast-cancer classifier of
  ``tests/test_torch_gbdt.py``, the quantized estimator of
  ``tests/test_torch_quantized.py``, the bundled and unbundled fits of
  ``tests/test_torch_efb.py``'s ``_fit_both``), here on both defaults.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.gbdt import LightGBMClassifier as RefClassifier
from mmlspark_tpu.ops import histogram as ref_hist
from mmlspark_tpu_torch import LightGBMClassifier, native
from mmlspark_tpu_torch.gbdt import engine, grower
from mmlspark_tpu_torch.ops import histogram as hist
from test_torch_efb import _sparse_table
from test_torch_gbdt import _load_csv_gz
from torch_parity import (data, fit_pair, one_torch_thread,
                          reference_native)  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread",
                                     "reference_native")


def _bins(n, f, B, seed=0):
    return np.random.default_rng(seed).integers(0, B, size=(n, f),
                                                dtype=np.uint8)


def _gh(n, seed=1):
    rng = np.random.default_rng(seed)
    gh = np.stack([rng.normal(size=n), rng.random(n) + 0.1,
                   (rng.random(n) < 0.9).astype(np.float64)], 1)
    gh[:, :2] *= gh[:, 2:]                     # bagged-out rows are zero
    return gh.astype(np.float32)


def _codes(n, mc, seed=2, off_contract=False):
    rng = np.random.default_rng(seed)
    gh = np.stack([rng.integers(-mc, mc + 1, n), rng.integers(0, mc + 1, n),
                   (rng.random(n) < 0.9).astype(np.int64)], 1)
    gh[:, :2] *= gh[:, 2:]
    if off_contract:                           # rows the packed mode skips
        gh[::37, 2] = 2
        gh[5::41, 0] = mc + 3
    return gh.astype(np.int16)


def test_the_reference_native_path_is_on():
    assert ref_hist._native_available() and jax.default_backend() == "cpu"


@pytest.mark.parametrize("B", [64, 256])
def test_histogram_equals_the_reference_and_the_twin(B):
    bins, gh = _bins(3000, 7, B), _gh(3000)
    calls = native.hist.calls
    got = hist.compute_histogram(torch.from_numpy(bins),
                                 torch.from_numpy(gh), B, "auto")
    assert native.hist.calls == calls + 1
    want = np.asarray(ref_hist._hist_native(jnp.asarray(bins),
                                            jnp.asarray(gh), B))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, hist.compute_histogram(
        torch.from_numpy(bins), torch.from_numpy(gh), B, "segment"))


@pytest.mark.parametrize("off,cnt", [(0, 3000), (123, 777), (2999, 1),
                                     (40, 0)])
def test_segment_histogram_equals_the_reference_and_the_twin(off, cnt):
    B = 256
    bins, gh = _bins(3000, 7, B), _gh(3000)
    ro = np.random.default_rng(3).permutation(3000).astype(np.int32)
    args = (torch.from_numpy(bins), torch.from_numpy(gh),
            torch.from_numpy(ro), off, cnt, B)
    calls = native.seg_hist.calls
    got = hist.segment_histogram(*args, "native")
    assert native.seg_hist.calls == calls + 1
    want = np.asarray(ref_hist.native_segment_hist(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(ro),
        jnp.int32(off), jnp.int32(cnt), B))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, hist.segment_histogram(*args, "segment"))


@pytest.mark.parametrize("mc,packed", [(127, True), (5000, False)])
@pytest.mark.parametrize("off_contract", [False, True])
def test_quantized_histograms_equal_the_reference(mc, packed, off_contract):
    B, n = 256, 3000
    assert hist.packed_accum_ok(n, mc) == packed
    assert ref_hist.packed_accum_ok(n, mc) == packed
    bins, gh = _bins(n, 7, B), _codes(n, mc, off_contract=off_contract)
    ro = np.random.default_rng(4).permutation(n).astype(np.int32)
    tb, tg = torch.from_numpy(bins), torch.from_numpy(gh.astype(np.int32))
    calls = (native.qhist.calls, native.seg_qhist.calls)
    full = hist.compute_histogram(tb, tg, B, "auto", mc)
    seg = hist.segment_histogram(tb, tg, torch.from_numpy(ro), 100, 1500,
                                 B, "auto", mc)
    assert (native.qhist.calls, native.seg_qhist.calls) == (
        calls[0] + 1, calls[1] + 1)
    assert full.dtype == seg.dtype == torch.int32
    np.testing.assert_array_equal(full.numpy(), np.asarray(
        ref_hist._hist_native_q(jnp.asarray(bins), jnp.asarray(gh), B, mc)))
    np.testing.assert_array_equal(seg.numpy(), np.asarray(
        ref_hist.native_segment_hist(
            jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(ro),
            jnp.int32(100), jnp.int32(1500), B, max_code=mc)))
    assert torch.equal(full, hist.compute_histogram(tb, tg, B, "segment"))
    assert torch.equal(seg, hist.segment_histogram(
        tb, tg, torch.from_numpy(ro), 100, 1500, B, "segment"))


@pytest.mark.parametrize("categorical", [False, True])
def test_partition_equals_the_reference_and_the_twin(categorical):
    B, n, W = 256, 4000, 8
    col = _bins(n, 1, B, seed=5)[:, 0]
    ro = np.random.default_rng(6).permutation(n).astype(np.int32)
    bits = None
    if categorical:
        bits = np.random.default_rng(7).integers(0, 2**32, W,
                                                 dtype=np.int64)
    off, cnt, thr = 250, 3100, 101
    got = torch.from_numpy(ro.copy())
    calls = native.partition.calls
    n_l = hist.native_partition(got, torch.from_numpy(col), off, cnt, thr,
                                bits, W)
    assert native.partition.calls == calls + 1
    ref_bits = np.zeros(W, np.uint32) if bits is None else \
        bits.astype(np.uint32)
    want, cl, cr = ref_hist.native_partition(
        jnp.asarray(ro), jnp.asarray(col), jnp.int32(off), jnp.int32(cnt),
        jnp.int32(thr), jnp.asarray(categorical), jnp.asarray(ref_bits), B)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (int(n_l[0]), cnt - int(n_l[0])) == (int(cl), int(cr))
    plain = torch.from_numpy(ro.copy())
    n_p = grower._partition_left(
        plain, torch.from_numpy(col), thr, off, cnt,
        None if bits is None else torch.from_numpy(bits))
    assert torch.equal(plain, got) and int(n_p[0]) == int(n_l[0])


def _split_case(seed, floor=1e-10, l2=0.0, depth_ok=True):
    rng = np.random.default_rng(seed)
    f, B = 6, 64
    h = np.stack([rng.normal(size=(f, B)), rng.random((f, B)) * 2,
                  rng.integers(0, 40, (f, B))], -1).astype(np.float32)
    tot = h[0].sum(0).astype(np.float32)
    fmask = (rng.random(f) < 0.85).astype(np.float32)
    conf = dict(min_data_in_leaf=20.0, min_sum_hessian=1e-3, lambda_l1=0.1,
                lambda_l2=l2, gain_floor=floor)
    port = hist.native_find_split(torch.from_numpy(h), *tot,
                                  torch.from_numpy(fmask), depth_ok,
                                  *conf.values())
    ref = ref_hist.native_find_split(
        jnp.asarray(h), *map(jnp.float32, tot), jnp.asarray(fmask),
        jnp.asarray(depth_ok), *conf.values(), B)
    return port, ref, (h, tot, fmask, conf)


@pytest.mark.parametrize("seed,l2,depth_ok", [(0, 0.0, True), (1, 1.0, True),
                                              (2, 0.0, False)])
def test_split_scan_equals_the_reference(seed, l2, depth_ok):
    calls = native.split.calls
    (gain, feat, b), ref, (h, tot, fmask, conf) = _split_case(
        seed, l2=l2, depth_ok=depth_ok)
    assert native.split.calls == calls + 1
    assert (np.float32(gain), feat, b) == tuple(
        np.asarray(x)[()] for x in ref)
    if depth_ok:
        # the winner and its recorded gain are the plain scan's
        cfg = grower.GrowerConfig(num_bins=64, min_data_in_leaf=20,
                                  lambda_l1=0.1, lambda_l2=l2)
        fi = torch.zeros(len(fmask), 3)
        fi[:, 0] = torch.from_numpy(fmask)
        plain = grower.find_best_split(torch.from_numpy(h), *tot, fi, True,
                                       cfg)
        assert (float(plain[0]), int(plain[1]), int(plain[2])) == (
            float(gain), feat, b)
    else:
        assert gain == -np.inf


def test_split_scan_floors_the_recomputed_gain():
    """At seed 0 the scan's sequential prefix sums give the winner a gain
    above the recomputed (plain-order) one; with the floor at the
    recomputed gain the scan clears it and the recomputed gain does not,
    so both packages return −inf."""
    (gain, feat, b), _, (h, tot, fmask, conf) = _split_case(
        0, floor=-np.inf)
    raw, f_raw, b_raw = native.split(
        torch.from_numpy(h), tot, torch.from_numpy(fmask),
        np.asarray(list(conf.values())[:4] + [-np.inf, 1.0], np.float32))
    assert (f_raw, b_raw) == (feat, b) and raw > float(gain)
    (g2, _, _), ref, _ = _split_case(0, floor=float(gain))
    assert g2 == -np.inf and float(ref[0]) == -np.inf


def test_native_is_a_cpu_method():
    with pytest.raises(ValueError, match="CPU"):
        hist.check_method("native", torch.device("cuda"))
    assert not hist.native_applies("auto", 256, torch.device("cuda"))
    assert hist.native_applies("auto", 256, torch.device("cpu"))
    assert not hist.native_applies("auto", 257, torch.device("cpu"))
    assert not hist.native_applies("segment", 256, torch.device("cpu"))


#: CPU "auto" fits held to the reference's "auto" model text
AUTO_FITS = {
    "serial_binary": ("binary", {}),
    "regression": ("regression", {}),
    "quantized": ("binary", dict(quantized_grad="16")),
    "categorical": ("binary", dict(categorical=(4, 5))),
    "data_psum_2": ("binary", dict(d=2, collective="psum")),
}


@pytest.mark.parametrize("name", list(AUTO_FITS))
def test_auto_fit_writes_the_reference_auto_model_text(name):
    objective, kw = AUTO_FITS[name]
    X, y = data(objective, categorical="categorical" in kw)
    before = native.split.calls + native.seg_hist.calls \
        + native.seg_qhist.calls
    ref, port = fit_pair(X, y, objective, method="auto", num_iterations=6,
                         num_leaves=15, **kw)
    assert engine.last_fit_info["histogram_method"] == "auto"
    assert native.split.calls + native.seg_hist.calls \
        + native.seg_qhist.calls > before
    assert port.save_native_model_string() == ref.save_native_model_string()


def test_breast_cancer_auto_classifier_matches_reference_auto():
    """``tests/test_torch_gbdt.py``'s breast-cancer classifier, both
    packages on their CPU default."""
    X, y = _load_csv_gz("breast_cancer.csv.gz")
    tr = np.random.default_rng(7).permutation(len(y))[:400]
    kw = dict(numIterations=80, numLeaves=15, learningRate=0.1,
              minDataInLeaf=10, verbosity=0, seed=42)
    table = {"features": X[tr], "label": y[tr]}
    ref = RefClassifier(**kw).fit(table)
    port = LightGBMClassifier(device="cpu", **kw).fit(table)
    assert port.getNativeModel() == ref.getNativeModel()


def _auto_pair(table, **kw):
    """The port's and the reference's classifiers of one fit, both on
    their CPU default; their model texts must agree byte for byte."""
    ref = RefClassifier(**kw).fit(table)
    port = LightGBMClassifier(device="cpu", **kw).fit(table)
    assert port.getNativeModel() == ref.getNativeModel()


def test_quantized_auto_estimator_matches_reference_auto():
    X, y = data("binary")
    _auto_pair({"features": X, "label": y}, numIterations=5, numLeaves=7,
               minDataInLeaf=10, verbosity=0, quantizedGrad="8")


#: tests/test_torch_efb.py's _fit_both fits: name -> (conflict rate of
#: the table, iterations, extra params)
EFB_FITS = {"gbdt": (0.0, 10, {}),
            "goss": (0.0, 10, dict(boostingType="goss")),
            "conflicts": (0.01, 20, dict(maxConflictRate=0.05)),
            "serial_12": (0.0, 12, {})}


@pytest.mark.parametrize("name,bundle", [
    ("gbdt", False), ("gbdt", True), ("goss", False), ("goss", True),
    ("conflicts", False), ("conflicts", True), ("serial_12", True)])
def test_efb_auto_estimator_matches_reference_auto(name, bundle):
    rate, iterations, extra = EFB_FITS[name]
    X, y = _sparse_table(np.random.default_rng(0), n=2000,
                         conflict_rate=rate)
    if not bundle:
        extra = {k: v for k, v in extra.items() if k != "maxConflictRate"}
    _auto_pair({"features": X, "label": y}, numIterations=iterations,
               numLeaves=15, verbosity=0, minDataInLeaf=5,
               enableBundle=bundle, **extra)
