"""The port's threefry PRNG (``mmlspark_tpu_torch/ops/threefry.py``)
against ``jax.random`` (jax 0.9.0, ``jax_threefry_partitionable=True``),
bit for bit, on the CPU.

The reference draws GOSS's remainder sample and the stochastic rounding
of quantized gradients with ``jax.random``; these tests hold ``PRNGKey``,
``split``, ``fold_in`` (with data from g-max bit patterns, as
``_quantize_gh`` folds them) and float32 ``uniform`` to it with
``assert_array_equal`` at seeds 0, 42 and 2**31 − 1 and shapes (1,),
(7,), (65,537,) and (1,000, 2).
"""

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.ops import threefry
from torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEEDS = [0, 42, 2 ** 31 - 1]
SHAPES = [(1,), (7,), (65_537,), (1_000, 2)]
#: g-max values whose float32 bit patterns the quantizer folds in
GMAX = [0.0, 1e-30, 0.37, 0.5, 1.0, 3.8995044, 7.25e5, 3.4028235e38]


def _words(x):
    return np.asarray(x).astype(np.int64)


def test_partitionable_threefry_is_the_installed_default():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS + [-1, 2 ** 33 + 7])
def test_prng_key_equals_jax(seed):
    np.testing.assert_array_equal(threefry.prng_key(seed).numpy(),
                                  _words(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [1, 2, 7, 50])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_equals_jax(seed, num):
    got = threefry.split(threefry.prng_key(seed), num)
    np.testing.assert_array_equal(
        got.numpy(), _words(jax.random.split(jax.random.PRNGKey(seed), num)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in_of_gmax_bits_equals_jax(seed):
    key = jax.random.PRNGKey(seed)
    for g in GMAX:
        bits = int(np.float32(g).view(np.int32))
        np.testing.assert_array_equal(
            threefry.fold_in(threefry.prng_key(seed), bits).numpy(),
            _words(jax.random.fold_in(key, bits)))
    # the tensor form the quantizer uses on the device
    g = torch.tensor(0.37, dtype=torch.float32)
    np.testing.assert_array_equal(
        threefry.fold_in(threefry.prng_key(seed),
                         threefry.float_bits(g)).numpy(),
        _words(jax.random.fold_in(
            key, np.float32(0.37).view(np.int32))))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_equals_jax(seed, shape):
    got = threefry.uniform(threefry.prng_key(seed), shape)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(7,), (65_537,)], ids=str)
def test_bits_equal_jax(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(42), 3)
    got = threefry.random_bits(threefry.fold_in(threefry.prng_key(42), 3),
                               shape)
    np.testing.assert_array_equal(
        got.numpy(), _words(jax.random.bits(key, shape)))


def test_goss_keys_and_the_quantizer_stream_equal_jax():
    """The two streams of the training loop: GOSS's per-iteration keys
    ``split(PRNGKey(bagging_seed), T)`` and their remainder draws, and
    the quantizer's ``uniform(fold_in(PRNGKey(seed), bits(gmax)), (n,
    2))``."""
    keys = threefry.split(threefry.prng_key(3), 20)
    jkeys = jax.random.split(jax.random.PRNGKey(3), 20)
    for it in (0, 7, 19):
        np.testing.assert_array_equal(
            threefry.uniform(keys[it], (960,)).numpy(),
            np.asarray(jax.random.uniform(jkeys[it], (960,))))
    bits = int(np.float32(0.4999).view(np.int32))
    np.testing.assert_array_equal(
        threefry.uniform(threefry.fold_in(threefry.prng_key(42), bits),
                         (1_200, 2)).numpy(),
        np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.PRNGKey(42), bits), (1_200, 2))))
