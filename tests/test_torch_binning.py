"""The port's BinMapper against the JAX reference's: bounds and bin codes
identical, NaN included, on random data and the vendored datasets."""

import gzip
import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.gbdt.binning import fit_bin_mapper as ref_fit
from mmlspark_tpu_torch.gbdt.binning import fit_bin_mapper

DATA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "benchmarks", "data")


def _load_csv_gz(name):
    with gzip.open(os.path.join(DATA_DIR, name), "rt") as fh:
        fh.readline()
        rows = np.asarray([[float(v) for v in line.split(",")]
                           for line in fh])
    return rows[:, :-1].astype(np.float32)


def _random(kind):
    rng = np.random.default_rng(11)
    if kind == "normal_f32":
        return rng.normal(size=(3000, 6)).astype(np.float32)
    if kind == "with_nan":
        X = rng.normal(size=(2000, 5))
        X[rng.random(X.shape) < 0.1] = np.nan
        X[:, 4] = np.nan                    # an all-missing column
        return X
    if kind == "few_distinct":
        X = rng.integers(0, 7, size=(1500, 4)).astype(np.float64)
        X[:, 1] = 3.0                       # a constant column
        return X
    if kind == "sampled":                   # n > sample_cnt draws a sample
        return rng.normal(size=(5000, 3))
    raise ValueError(kind)


def _same_mapper(X, max_bin, **kw):
    ref = ref_fit(X, max_bin=max_bin, **kw)
    port = fit_bin_mapper(X, max_bin=max_bin, **kw)
    assert port.num_total_bins == ref.num_total_bins
    assert port.missing_bin == ref.missing_bin
    np.testing.assert_array_equal(port.has_missing, ref.has_missing)
    for a, b in zip(port.upper_bounds, ref.upper_bounds):
        np.testing.assert_array_equal(a, b)
    assert port.feature_infos() == ref.feature_infos()
    got = port.transform(X, "cpu")
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref.transform(X))
    np.testing.assert_array_equal(got.numpy(), ref.transform_packed(X))


@pytest.mark.parametrize("max_bin", [15, 63, 255])
@pytest.mark.parametrize("kind", ["normal_f32", "with_nan", "few_distinct"])
def test_bins_match_reference_on_random_data(kind, max_bin):
    _same_mapper(_random(kind), max_bin)


def test_bins_match_reference_when_sampling():
    _same_mapper(_random("sampled"), 255, sample_cnt=1000, seed=5)


@pytest.mark.parametrize("name", ["breast_cancer.csv.gz",
                                  "diabetes.csv.gz"])
def test_bins_match_reference_on_vendored_data(name):
    X = _load_csv_gz(name)
    X[::17, 2] = np.nan
    _same_mapper(X, 255)


def test_threshold_values_match_reference():
    X = _random("with_nan")
    ref, port = ref_fit(X, max_bin=31), fit_bin_mapper(X, max_bin=31)
    for j in range(X.shape[1]):
        for b in (0, 5, 30, 31):
            assert port.bin_threshold_value(j, b) == \
                ref.bin_threshold_value(j, b)


def test_transform_on_cuda_raises_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    m = fit_bin_mapper(_random("normal_f32"), max_bin=15)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        m.transform(_random("normal_f32"))
