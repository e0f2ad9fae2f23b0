"""The port's CUDA kernels against their plain twins, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode).  The file imports nothing of JAX, so it also runs on a
GPU machine without it; there, skip the repository's conftest (which sets
up JAX):

    python -m pytest --noconftest -q tests/test_torch_cuda.py

Tolerance for f32 / bf16: rtol 1e-5, atol 1e-4 at 20,000 rows (both sides
add each cell's rows in another order, with atomics); int32 is exact.
"""

import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import cuda_histogram as ch

ACCUMS = ("float32", "bfloat16", "int32")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(n, f, B, accum, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, B, size=(n, f)).astype(np.uint8)
    if accum == "int32":
        gh = rng.integers(-300, 300, size=(n, 3)).astype(np.int32)
    else:
        gh = rng.normal(size=(n, 3)).astype(np.float32)
    return bins, gh


def _check(got, want, accum):
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if accum == "int32":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("B", [16, 63, 256])
def test_hist_full_matches_twin(cuda_device, B, accum):
    bins, gh = _inputs(20_000, 13, B, accum, seed=B)
    b, g = (torch.from_numpy(a).to(cuda_device) for a in (bins, gh))
    before = ch.histogram_cuda.launches
    _check(ch.histogram_cuda(b, g, B, accum),
           ch.histogram_plain(b, g, B, accum), accum)
    assert ch.histogram_cuda.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("accum", ACCUMS)
@pytest.mark.parametrize("cnt", [0, 1, 777, 15_000])
def test_hist_segment_matches_twin(cuda_device, cnt, accum):
    n, B = 20_000, 256
    bins, gh = _inputs(n, 13, B, accum, seed=cnt)
    order = np.random.default_rng(7).permutation(n).astype(np.int32)
    b, g, o = (torch.from_numpy(a).to(cuda_device)
               for a in (bins, gh, order))
    before = ch.histogram_cuda_fused.launches
    _check(ch.histogram_cuda_fused(b, g, o, 333, cnt, B, accum),
           ch.histogram_fused_plain(b, g, o, 333, cnt, B, accum), accum)
    assert ch.histogram_cuda_fused.launches == before + (cnt > 0)


@pytest.mark.cuda
def test_bad_inputs_raise_on_the_card(cuda_device):
    b = torch.zeros(8, 2, dtype=torch.uint8, device=cuda_device)
    g = torch.zeros(8, 3, device=cuda_device)
    with pytest.raises(ValueError):
        ch.histogram_cuda(b, g, 257)
    with pytest.raises(ValueError):
        ch.histogram_cuda_fused(b, g, torch.zeros(8, dtype=torch.int32,
                                                  device=cuda_device),
                                4, 5, 16)


@pytest.mark.cuda
def test_fit_on_the_card_grows_the_cpu_tree(cuda_device):
    from mmlspark_tpu_torch import LightGBMClassifier
    rng = np.random.default_rng(0)
    X = rng.normal(size=(5000, 8)).astype(np.float32)
    y = (X[:, 0] + X[:, 1] * X[:, 2] > 0).astype(np.float64)
    table = {"features": X, "label": y}
    trees = [LightGBMClassifier(numIterations=1, numLeaves=15, device=d)
             .fit(table).getModel().trees[0] for d in ("cuda", "cpu")]
    for k in ("split_feature", "threshold", "left_child", "right_child"):
        np.testing.assert_array_equal(getattr(trees[0], k),
                                      getattr(trees[1], k))
