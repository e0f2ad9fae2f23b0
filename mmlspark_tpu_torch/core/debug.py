"""Debug / sanitizer mode.

The port's counterpart of ``mmlspark_tpu/core/debug.py``, where
``jax.experimental.checkify`` compiles invariants into the training
program.  Here they are torch checks on the tensors the grower takes:
finite gradients and hessians, and bin codes inside the histogram range
(a histogram kernel indexes its shared-memory bins by the code, so an
out-of-range code would corrupt memory silently — the class of fault a
sanitizer exists to make loud).  A failed check raises
:class:`DebugCheckError`.

Enable with ``MMLSPARK_TPU_DEBUG=1`` or :func:`debug_mode`.  With debug
mode off every check is one flag test, so the hot path pays nothing; on,
each check reduces its tensor on its device and reads one flag back (a
card synchronize).  Blanket NaN checks stay off, as in the reference:
the split scan masks empty-bin gains with ``-inf``.
"""

from __future__ import annotations

import os
from typing import Callable

import torch

_STATE = {"enabled": None}


class DebugCheckError(RuntimeError):
    """A debug-mode invariant failed (the reference raises checkify's
    ``JaxRuntimeError``)."""


def debug_enabled() -> bool:
    if _STATE["enabled"] is None:
        _STATE["enabled"] = os.environ.get(
            "MMLSPARK_TPU_DEBUG", "") not in ("", "0")
    return bool(_STATE["enabled"])


def debug_mode(on: bool) -> None:
    """Programmatic override of the MMLSPARK_TPU_DEBUG env switch."""
    _STATE["enabled"] = bool(on)


def checked(fn: Callable) -> Callable:
    """``fn`` itself: the checks below run eagerly wherever they are
    placed, so there is no program to instrument (the reference wraps a
    jitted callable with checkify).  Kept so call sites read alike."""
    return fn


def check_finite(name: str, *tensors) -> None:
    """Raise :class:`DebugCheckError` when a tensor holds a NaN or an
    infinity (debug mode only)."""
    if not debug_enabled():
        return
    for t in tensors:
        if not bool(torch.isfinite(torch.as_tensor(t)).all()):
            raise DebugCheckError("non-finite values in " + name)


def check_bins_in_range(bins, num_bins: int) -> None:
    """Raise :class:`DebugCheckError` when a bin code is negative or not
    below ``num_bins`` (debug mode only).  Both ends: the int32 codes of
    wide bins can hold negative values."""
    if not debug_enabled():
        return
    b = torch.as_tensor(bins)
    if b.numel() and not bool(((b.amin() >= 0)
                               & (b.amax().to(torch.int64) < num_bins))):
        raise DebugCheckError(
            "bin index out of range (negative or >= num_bins): corrupt "
            "binned matrix")
