"""The port's histogram ops against the JAX reference (CPU).

The plain twins of the CUDA kernels are held against the reference's
Pallas kernels, run in interpret mode as tests/test_histogram.py runs
them.  Tolerance for f32 / bf16: rtol 1e-5, atol 1e-4 — the twin adds each
cell's rows in row order, the interpreted MXU contraction in its own
blocked order, so the sums may differ in the last bits.  int32 is exact.
The CUDA kernels themselves are held against the twins on the card
(chip_smoke.py phase 3, and tests/test_torch_cuda.py).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.ops.histogram import compute_histogram as ref_hist
from mmlspark_tpu.ops.pallas_histogram import (histogram_pallas,
                                               histogram_pallas_fused)
from mmlspark_tpu_torch.ops import cuda_histogram as ch
from mmlspark_tpu_torch.ops.histogram import (compute_histogram,
                                              segment_histogram)

ACCUMS = ("float32", "bfloat16", "int32")
F_MAX = 13


def _inputs(n, f, B, accum, seed=0):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(n, f)).astype(np.int32)
    if accum == "int32":
        gh = rng.integers(-300, 300, size=(n, 3)).astype(np.int32)
    else:
        gh = rng.normal(size=(n, 3)).astype(np.float32)
    return bins, gh


@functools.lru_cache(maxsize=None)
def _pallas_full(n, B, accum):
    """The reference histogram of F_MAX features; a feature's histogram
    does not depend on the others, so narrower cases slice it."""
    bins, gh = _inputs(n, F_MAX, B, accum)
    return np.asarray(histogram_pallas(jnp.asarray(bins), jnp.asarray(gh),
                                       B, accum=accum, interpret=True))


def _check(got, want, accum):
    if accum == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("B", [16, 63, 256])
@pytest.mark.parametrize("f", [1, 5, 8, 13])
@pytest.mark.parametrize("n", [1, 127, 1000])
def test_plain_twin_matches_histogram_pallas(n, f, B, accum):
    bins, gh = _inputs(n, F_MAX, B, accum)
    got = ch.histogram_cuda(torch.from_numpy(bins[:, :f]),
                            torch.from_numpy(gh), B, accum).numpy()
    assert got.shape == (f, B, 3)
    assert got.dtype == (np.int32 if accum == "int32" else np.float32)
    _check(got, _pallas_full(n, B, accum)[:f], accum)


@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("cnt", [0, 1, 700])
def test_fused_twin_matches_histogram_pallas_fused(cnt, accum):
    """A partitioned row_order segment: the twin reads
    row_order[off:off+cnt]; the reference gets the same rows with the
    zero-weight padding of its bucket."""
    n, f, B, size = 3000, 11, 64, 1024
    bins, gh = _inputs(n, f, B, accum, seed=1)
    rng = np.random.default_rng(2)
    row_order = rng.permutation(n).astype(np.int32)
    off = 901
    rows = row_order[off:off + size]
    valid = (np.arange(size) < cnt).astype(gh.dtype)[:, None]
    want = np.asarray(histogram_pallas_fused(
        jnp.asarray(bins.T), jnp.asarray(gh[rows] * valid),
        jnp.asarray(rows), B, size, accum=accum, interpret=True))[:f]
    got = ch.histogram_cuda_fused(torch.from_numpy(bins),
                                  torch.from_numpy(gh),
                                  torch.from_numpy(row_order), off, cnt, B,
                                  accum).numpy()
    _check(got, want, accum)


@pytest.mark.parametrize("integer", [False, True])
def test_compute_histogram_segment_parity(integer):
    """method='segment' against the reference's segment method: the same
    rows added in the same order, so f32 agrees bit for bit."""
    n, f, B = 2000, 7, 256
    bins, gh = _inputs(n, f, B, "int32" if integer else "float32", seed=3)
    want = np.asarray(ref_hist(jnp.asarray(bins), jnp.asarray(gh), B,
                               method="segment"))
    for method in ("segment", "auto"):
        got = compute_histogram(torch.from_numpy(bins),
                                torch.from_numpy(gh), B, method).numpy()
        np.testing.assert_array_equal(got, want, err_msg=method)
    # the oracle sums in float64 and rounds once
    got = compute_histogram(torch.from_numpy(bins), torch.from_numpy(gh), B,
                            "onehot").numpy()
    _check(got, want, "int32" if integer else "float32")


def test_segment_histogram_gathers_the_segment():
    n, f, B = 500, 4, 32
    bins, gh = _inputs(n, f, B, "float32", seed=4)
    order = np.random.default_rng(5).permutation(n).astype(np.int32)
    rows = order[100:260]
    want = np.asarray(ref_hist(jnp.asarray(bins[rows]),
                               jnp.asarray(gh[rows]), B, method="segment"))
    got = segment_histogram(torch.from_numpy(bins), torch.from_numpy(gh),
                            torch.from_numpy(order), 100, 160, B,
                            "segment").numpy()
    np.testing.assert_array_equal(got, want)


def test_methods_and_devices_are_checked():
    """TPU-only formulations raise; ``pallas_ring`` is a kernel method
    whose full-matrix call is the plain histogram, as in the reference."""
    bins = torch.zeros(4, 2, dtype=torch.uint8)
    gh = torch.ones(4, 3)
    got = compute_histogram(bins, gh, 16, "pallas_ring")
    torch.testing.assert_close(got, compute_histogram(bins, gh, 16,
                                                      "segment"))
    with pytest.raises(ValueError):
        compute_histogram(bins, gh, 16, "dot16")


@pytest.mark.parametrize("cnt,f,num_sms", [(1, 50, 132), (777, 50, 132),
                                           (400_000, 50, 132),
                                           (200_000, 3, 132)])
def test_launch_shape_covers_every_row_once(cnt, f, num_sms):
    groups, tiles, rows = ch.launch_shape(cnt, f, 8, num_sms)
    assert groups * 8 >= f > (groups - 1) * 8
    assert tiles * rows >= cnt > (tiles - 1) * rows
    assert rows >= min(cnt, 256)
