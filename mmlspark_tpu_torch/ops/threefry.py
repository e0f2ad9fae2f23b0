"""Threefry-2x32 counter-based PRNG, equal to ``jax.random`` bit for bit.

The reference draws its training-loop randomness with ``jax.random``
(threefry2x32, ``jax_threefry_partitionable=True``): GOSS's remainder
sample (``gbdt/engine.py``, ``split(PRNGKey(bagging_seed), T)`` and
``uniform``) and the stochastic rounding of quantized gradients
(``gbdt/grower.py::_quantize_gh``, ``fold_in`` of the g-max's bits and
``uniform``).  This module computes the same words with plain torch
integer ops, so a draw is the same on the CPU and on the card and equal
to the reference's.

A key is a ``(2,)`` int64 tensor holding two uint32 words.  Every word
lives in int64 and is masked to 32 bits after each add and shift, since
torch has no uint32 arithmetic on every device.  The draws under the
partitionable scheme:

* the counters of a draw of ``shape`` are the flat index ``i`` of each
  element as a 64-bit pair ``(hi, lo) = (i >> 32, i & 0xFFFFFFFF)``;
* ``split(key, num)[i]`` is the pair ``threefry2x32(key, (hi, lo))`` of
  ``i``;
* ``uniform`` takes ``w1 ^ w2`` of that pair, keeps its top 23 bits as
  the mantissa of a float in [1, 2) and subtracts 1;
* ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``, ``d`` as uint32;
* ``prng_key(seed)`` is ``(0, seed mod 2**32)`` (the reference's 32-bit
  seeds).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(key: torch.Tensor, x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0,
    x1)`` (int64 tensors of uint32 values, one shape) under ``key``."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def prng_key(seed: int, device: Union[str, torch.device] = "cpu"
             ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``(0, seed mod 2**32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _counters(shape: Sequence[int], device) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
    n = 1
    for s in shape:
        n *= int(s)
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: ``(num, 2)`` keys."""
    hi, lo = _counters((num,), key.device)
    return torch.stack(threefry2x32(key, hi, lo), dim=1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: ``data`` an integer (or a
    0-d integer tensor on the key's device) taken as uint32."""
    d = torch.as_tensor(data, dtype=torch.int64, device=key.device) & MASK
    w0, w1 = threefry2x32(key, torch.zeros_like(d), d)
    return torch.stack([w0, w1])


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.bits(key, shape)`` (32 bits): int64 tensor of uint32
    values of ``shape``."""
    hi, lo = _counters(shape, key.device)
    w0, w1 = threefry2x32(key, hi, lo)
    return (w0 ^ w1).reshape(tuple(shape))


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32: [0, 1)."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def float_bits(x: torch.Tensor) -> torch.Tensor:
    """The bit pattern of a float32 tensor as int64 (its int32 value, as
    ``lax.bitcast_convert_type(x, int32)`` gives it)."""
    return x.to(torch.float32).view(torch.int32).to(torch.int64)
