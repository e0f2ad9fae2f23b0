"""Gradient-histogram dispatch — the GBDT hot loop.

The port's counterpart of ``mmlspark_tpu/ops/histogram.py``.  Methods:

``auto``, ``pallas``, ``pallas_bf16``, ``pallas_fused``
    The hand-written CUDA kernels of :mod:`.cuda_histogram` on a CUDA
    tensor (``pallas_bf16`` in the bf16 accumulation mode), their plain
    twins on a CPU tensor.  ``pallas_fused`` is the fused segment gather
    of the grower; a full-matrix call runs the plain kernel, as in the
    reference.
``segment``
    The plain ``index_add_`` histogram (the kernels' twin): the CPU path.
``onehot``
    A naive one-hot contraction, kept as the test oracle.

Every method takes already masked gradient triples ``gh = (grad, hess,
count)`` (rows outside the active leaf or bagged out carry zeros).  An
integer ``gh`` selects the exact int32 mode.
"""

from __future__ import annotations

import torch

from .cuda_histogram import histogram_cuda, histogram_cuda_fused

KERNEL_METHODS = ("auto", "pallas", "pallas_bf16", "pallas_fused")
CPU_METHODS = ("segment", "onehot")


def check_method(method: str, device: torch.device) -> None:
    """Raise for a histogram method the port does not run on ``device``:
    the plain formulations run only on CPU tensors, and the TPU-only and
    multi-device names are not ported."""
    if method in KERNEL_METHODS:
        return
    if method in CPU_METHODS:
        if device.type == "cuda":
            raise ValueError(
                f"histogram method {method!r} is a plain CPU formulation; "
                f"on CUDA use one of {KERNEL_METHODS}")
        return
    if method == "pallas_ring":
        raise NotImplementedError(
            "histogram method 'pallas_ring' belongs to mesh training, "
            "which is not ported yet (ROADMAP.md Queue B items 3-5)")
    raise ValueError(f"Unknown histogram method {method!r}; the port runs "
                     f"{KERNEL_METHODS + CPU_METHODS}")


def accum_mode(method: str, gh: torch.Tensor) -> str:
    """Accumulation mode of a histogram call."""
    if not gh.dtype.is_floating_point:
        return "int32"
    return "bfloat16" if method == "pallas_bf16" else "float32"


def compute_histogram(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                      method: str = "auto") -> torch.Tensor:
    """``(n, f)`` bins, ``(n, 3)`` gh → ``(f, num_bins, 3)`` histogram
    (float32, or int32 for an integer ``gh``)."""
    check_method(method, bins.device)
    accum = accum_mode(method, gh)
    if method == "onehot":
        return _hist_onehot(bins, gh, num_bins, accum)
    # on a CPU tensor this is the plain twin, i.e. ``segment``
    return histogram_cuda(bins, gh, num_bins, accum)


def segment_histogram(bins: torch.Tensor, gh: torch.Tensor,
                      row_order: torch.Tensor, off: int, cnt: int,
                      num_bins: int, method: str = "auto") -> torch.Tensor:
    """Histogram of the DataPartition segment ``row_order[off:off+cnt]``
    (the grower's smaller child)."""
    check_method(method, bins.device)
    accum = accum_mode(method, gh)
    if method == "onehot":
        rows = row_order[off:off + cnt].to(torch.int64)
        return _hist_onehot(bins[rows], gh[rows], num_bins, accum)
    return histogram_cuda_fused(bins, gh, row_order, off, cnt, num_bins,
                                accum)


def _hist_onehot(bins, gh, num_bins, accum):
    """Naive one-hot einsum: the oracle the other methods are tested
    against."""
    dtype = torch.int64 if accum == "int32" else torch.float64
    onehot = (bins.to(torch.int64)[:, :, None]
              == torch.arange(num_bins, device=bins.device)).to(dtype)
    gh = gh.to(dtype)
    if accum == "bfloat16":
        gh = gh.to(torch.float32).to(torch.bfloat16).to(dtype)
    out = torch.einsum("nfb,nc->fbc", onehot, gh)
    return out.to(torch.int32 if accum == "int32" else torch.float32)
