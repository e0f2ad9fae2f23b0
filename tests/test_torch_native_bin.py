"""The port's native host binning (``native/fastbin.cc``,
``BinMapper.transform_packed``) against the JAX reference's, on the CPU.

* ``transform_packed`` equals the reference's ``transform_packed`` and the
  port's own ``transform`` bit for bit, for float32 and float64 input,
  NaNs and a categorical column, at ``maxBin`` 15, 63 and 255; its codes
  are uint8 and it calls the native kernel once.
* At 511 bins (int32 codes) it takes the device route: the port's
  ``transform`` on the CPU, without the native kernel, as the reference
  hands those to its torch path; so does an integer ``X``.
* The estimator's fit bins with it (``base.fit_codes``: host codes copied
  to the fit's device up to 256 bins, the device transform above).
* The build: every source builds with the reference's flags into a file
  named by a hash of the source and the flags, and a build whose compiler
  is missing raises ``RuntimeError`` (there is no fallback).
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu.gbdt.binning import fit_bin_mapper as ref_fit
from mmlspark_tpu_torch import native
from mmlspark_tpu_torch.gbdt import base
from mmlspark_tpu_torch.gbdt.binning import fit_bin_mapper
from torch_parity import reference_native  # noqa: F401

pytestmark = pytest.mark.usefixtures("reference_native")


def _table(dtype, nan=False, categorical=False):
    rng = np.random.default_rng(21)
    X = rng.normal(size=(2500, 7))
    X[:, 5] = np.round(X[:, 5] * 4)             # few distinct values
    X[:, 6] = rng.integers(0, 40, size=len(X))  # category ids
    if nan:
        X[rng.random(X.shape) < 0.08] = np.nan
    X = X.astype(dtype)
    return X, [6] if categorical else None


CASES = {"f32": (np.float32, False, False), "f64": (np.float64, False, False),
         "f32_nan": (np.float32, True, False),
         "f64_nan": (np.float64, True, False),
         "f32_categorical_nan": (np.float32, True, True)}


@pytest.mark.parametrize("max_bin", [15, 63, 255])
@pytest.mark.parametrize("case", list(CASES))
def test_transform_packed_equals_the_reference_and_transform(case, max_bin):
    X, cats = _table(*CASES[case])
    ref = ref_fit(X, max_bin=max_bin, categorical_features=cats)
    port = fit_bin_mapper(X, max_bin=max_bin, categorical_features=cats)
    calls = native.bin_columns.calls
    got = port.transform_packed(X)
    assert native.bin_columns.calls == calls + 1
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    want = ref.transform_packed(X)
    assert want.dtype == np.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(got, port.transform(X, "cpu"))


@pytest.mark.parametrize("dtype", [np.float32, np.int64])
def test_wide_bins_and_integer_input_take_the_device_route(dtype):
    X, _ = _table(np.float64)
    X = (X * 50).astype(dtype) if dtype == np.int64 else X.astype(dtype)
    max_bin = 511 if dtype == np.float32 else 63
    ref = ref_fit(X, max_bin=max_bin)
    port = fit_bin_mapper(X, max_bin=max_bin)
    calls = native.bin_columns.calls
    got = port.transform_packed(X)
    assert native.bin_columns.calls == calls
    assert got.dtype == port.bin_dtype
    assert torch.equal(got, port.transform(X, "cpu"))
    np.testing.assert_array_equal(got.numpy(), ref.transform_packed(X))


@pytest.mark.parametrize("max_bin", [255, 511])
def test_the_fit_bins_with_transform_packed_up_to_256_bins(max_bin):
    X, _ = _table(np.float32, nan=True)
    mapper = fit_bin_mapper(X, max_bin=max_bin)
    calls = native.bin_columns.calls
    codes = base.fit_codes(mapper, X, torch.device("cpu"))
    assert native.bin_columns.calls == calls + (max_bin <= 255)
    assert torch.equal(codes, mapper.transform(X, "cpu"))


def test_sources_build_with_the_reference_flags():
    assert native.CXX_FLAGS == ("-O2", "-std=c++17", "-shared", "-fPIC",
                                "-pthread")
    built = native.build_all()
    assert set(built) == set(native.SOURCES)
    for name, (path, _) in built.items():
        assert path == native.lib_path(name) and path.exists()
        assert path.parent == native.BUILD_DIR


def test_a_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native, "CXX", "no-such-compiler-g++")
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        native.build_all(["fastbin"])
    assert not list(tmp_path.iterdir())


def test_a_failing_build_raises_with_the_log(monkeypatch, tmp_path):
    bad = tmp_path / "src"
    bad.mkdir()
    (bad / "fastbin.cc").write_text("this is not C++\n")
    monkeypatch.setattr(native, "NATIVE_DIR", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fastbin.cc"):
        native.build_all(["fastbin"])
