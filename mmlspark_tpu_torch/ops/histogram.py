"""Gradient-histogram dispatch — the GBDT hot loop.

The port's counterpart of ``mmlspark_tpu/ops/histogram.py``.  Methods:

``auto``, ``pallas``, ``pallas_bf16``, ``pallas_fused``, ``pallas_ring``
    The hand-written CUDA kernels of :mod:`.cuda_histogram` on a CUDA
    tensor (``pallas_bf16`` in the bf16 accumulation mode), their plain
    twins on a CPU tensor.  ``pallas_fused`` is the fused segment gather
    of the grower, and ``pallas_ring`` additionally fuses the cross-shard
    ring reduction on a mesh (the grower calls
    :func:`.collectives.fused_segment_hist_ring` for it); a full-matrix
    call of either runs the plain kernel, as in the reference.
``native``, and ``auto`` on a CPU tensor
    The reference's native host kernels (``native/fasthist.cc``,
    :mod:`..native`): one C++ pass over the rows, f32 or, on quantized
    codes, exact int32 (the packed-int64 single-add mode where
    :func:`packed_accum_ok` holds).  At most 256 bins; above, the plain
    twin, as the reference's ``"native"`` falls back to ``"segment"``
    there.  The grower also takes the native DataPartition split
    (:func:`native_partition`) and, on a serial fit, the native split scan
    (:func:`native_find_split`) under the same method.
``segment``
    The plain ``index_add_`` histogram (the kernels' twin).
``onehot``
    A naive one-hot contraction, kept as the test oracle.

Every method takes already masked gradient triples ``gh = (grad, hess,
count)`` (rows outside the active leaf or bagged out carry zeros).  An
integer ``gh`` selects the exact int32 mode.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .. import native
from .cuda_histogram import histogram_cuda, histogram_cuda_fused

KERNEL_METHODS = ("auto", "pallas", "pallas_bf16", "pallas_fused",
                  "pallas_ring")
CPU_METHODS = ("segment", "onehot", "native")
#: most bins the native kernels take (one-byte codes)
NATIVE_MAX_BINS = 256


def check_method(method: str, device: torch.device) -> None:
    """Raise for a histogram method the port does not run on ``device``:
    the plain formulations and the native host kernels run only on CPU
    tensors, and the TPU-only names are not ported."""
    if method in KERNEL_METHODS:
        return
    if method in CPU_METHODS:
        if device.type == "cuda":
            raise ValueError(
                f"histogram method {method!r} runs on the CPU only; "
                f"on CUDA use one of {KERNEL_METHODS}")
        return
    raise ValueError(f"Unknown histogram method {method!r}; the port runs "
                     f"{KERNEL_METHODS + CPU_METHODS}")


def accum_mode(method: str, gh: torch.Tensor) -> str:
    """Accumulation mode of a histogram call."""
    if not gh.dtype.is_floating_point:
        return "int32"
    return "bfloat16" if method == "pallas_bf16" else "float32"


def native_applies(method: str, num_bins: int,
                   device: torch.device) -> bool:
    """Whether the native host kernels run a call: ``"auto"`` or
    ``"native"`` on a CPU tensor with at most 256 bins (the reference's
    ``_native_applies``, which gates on the CPU backend)."""
    return (method in ("auto", "native") and device.type == "cpu"
            and num_bins <= NATIVE_MAX_BINS)


def packed_accum_ok(n_rows: int, max_code: int) -> bool:
    """Whether the packed-int64 single-add native accumulation is exact
    for ``n_rows`` quantized rows on a ``max_code`` grid: the 16-bit
    count field needs every cell's row count < 2^16 and the two biased
    24-bit g/h fields need ``n * 2*max_code < 2^24`` (each row adds at
    most ``2*max_code`` to a biased field).  Beyond the bound the C++
    kernel runs its unpacked int32x3 mode instead."""
    return (max_code > 0 and n_rows < (1 << 16)
            and n_rows * 2 * max_code < (1 << 24))


def native_gh(gh: torch.Tensor) -> torch.Tensor:
    """``gh`` as the native kernels read it: float32, or int16 grid codes
    for an integer ``gh`` (the quantizer clips them to ±max_code, at most
    2^15 − 1), C-contiguous.  The grower converts a tree's codes once."""
    dtype = torch.float32 if gh.dtype.is_floating_point else torch.int16
    return gh.to(dtype).contiguous()


def _native_bins(bins: torch.Tensor) -> torch.Tensor:
    return bins.to(torch.uint8).contiguous()


def native_histogram(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                     max_code: int = 0) -> torch.Tensor:
    """The full-matrix histogram through ``fasthist.cc`` (the reference's
    ``_hist_native`` / ``_hist_native_q``): float32, or exact int32 on
    integer codes, packed where :func:`packed_accum_ok` holds for the
    matrix's rows."""
    bins, gh = _native_bins(bins), native_gh(gh)
    if gh.dtype == torch.int16:
        return native.qhist(bins, gh, num_bins,
                            packed_accum_ok(bins.shape[0], max_code),
                            max_code)
    return native.hist(bins, gh, num_bins)


def native_segment_hist(bins: torch.Tensor, gh: torch.Tensor,
                        row_order: torch.Tensor, off: int, cnt: int,
                        num_bins: int, max_code: int = 0) -> torch.Tensor:
    """The fused gather + histogram of the DataPartition segment
    ``row_order[off:off+cnt]`` through ``fasthist.cc`` (the reference's
    ``native_segment_hist``): the C++ loop runs exactly ``cnt`` rows, in
    segment order.  On integer codes the packed gate uses the whole
    matrix's rows, as the reference's static gate does."""
    bins, gh = _native_bins(bins), native_gh(gh)
    ro = row_order.to(torch.int32).contiguous()
    if gh.dtype == torch.int16:
        return native.seg_qhist(bins, gh, ro, off, cnt, num_bins,
                                packed_accum_ok(bins.shape[0], max_code),
                                max_code)
    return native.seg_hist(bins, gh, ro, off, cnt, num_bins)


def native_partition(row_order: torch.Tensor, col: torch.Tensor, off: int,
                     cnt: int, thr: int, bits: Optional[np.ndarray],
                     cat_words: int) -> torch.Tensor:
    """LightGBM's ``DataPartition::Split`` as one stable in-place C++ pass
    over ``row_order[off:off+cnt]`` (int32, a CPU tensor; the reference's
    ``native_partition``): the rows whose bin in ``col`` is at most
    ``thr`` — or, given the ``(cat_words,)`` bitset ``bits`` of a
    categorical split, whose bin is in it — then the rest.  Returns the
    left count as a one-element int64 tensor, as the plain
    ``grower._partition_left`` does."""
    use_cat = bits is not None
    words = (np.asarray(bits, np.int64).astype(np.uint32) if use_cat
             else np.zeros(cat_words, np.uint32))
    n_l, _ = native.partition(row_order, _native_bins(col), off, cnt, thr,
                              use_cat, words)
    return torch.tensor([n_l], dtype=torch.int64)


def native_find_split(hist: torch.Tensor, parent_g: float, parent_h: float,
                      parent_c: float, feature_mask: torch.Tensor,
                      depth_ok: bool, min_data_in_leaf: float,
                      min_sum_hessian: float, lambda_l1: float,
                      lambda_l2: float, gain_floor: float
                      ) -> Tuple[torch.Tensor, int, int]:
    """The numeric FindBestThreshold of a ``(f, B, 3)`` float32 CPU
    histogram as one C++ pass (the reference's ``native_find_split``, the
    serial CPU path).  Returns ``(gain, feature, bin)``, the gain a
    float32 scalar tensor.

    The C++ scan picks the winning (feature, bin) with the same validity
    rules and first-occurrence flat order as ``grower.split_gains``, but
    its sequential f32 prefix sums round differently from the plain
    path's blocked prefix sum (``grower.prefix_sum_bins``, XLA's CPU
    order), so the WINNER is what it contributes: the recorded gain is
    recomputed here in the plain path's float order on the winning
    feature's row.  That keeps the best-first leaf priority and the
    exported split gain on the plain trajectory; the forests can differ
    from the plain path's only where two candidates tie within prefix-sum
    rounding.  The recomputed gain must also clear the floor: where the
    C++ gain clears it and the recomputed one does not, the plain path
    would reject the split, so the gain is −inf."""
    from ..gbdt.grower import _leaf_gain_l2, prefix_sum_bins
    hist = hist.to(torch.float32).contiguous()
    parent = np.asarray([parent_g, parent_h, parent_c], np.float32)
    conf = np.asarray([min_data_in_leaf, min_sum_hessian, lambda_l1,
                       lambda_l2, gain_floor, float(bool(depth_ok))],
                      np.float32)
    gain_n, feat, b = native.split(
        hist, parent, feature_mask.to(torch.float32).contiguous(), conf)
    cell = prefix_sum_bins(hist[feat])[b]
    gl, hl = cell[0], cell[1]
    pg, ph = torch.from_numpy(parent[:2])
    gain_x = (_leaf_gain_l2(gl, hl, lambda_l1, lambda_l2)
              + _leaf_gain_l2(pg - gl, ph - hl, lambda_l1, lambda_l2)
              - _leaf_gain_l2(pg, ph, lambda_l1, lambda_l2))
    if not (np.isfinite(gain_n) and bool(gain_x > gain_floor)):
        gain_x = torch.tensor(-np.inf, dtype=torch.float32)
    return gain_x, feat, b


def compute_histogram(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                      method: str = "auto", max_code: int = 0
                      ) -> torch.Tensor:
    """``(n, f)`` bins, ``(n, 3)`` gh → ``(f, num_bins, 3)`` histogram
    (float32, or int32 for an integer ``gh``).  ``max_code``: the
    quantized grid's largest |code|, which gates the native packed
    mode."""
    check_method(method, bins.device)
    if native_applies(method, num_bins, bins.device):
        return native_histogram(bins, gh, num_bins, max_code)
    accum = accum_mode(method, gh)
    if method == "onehot":
        return _hist_onehot(bins, gh, num_bins, accum)
    # on a CPU tensor this is the plain twin, i.e. ``segment``
    return histogram_cuda(bins, gh, num_bins, accum)


def segment_histogram(bins: torch.Tensor, gh: torch.Tensor,
                      row_order: torch.Tensor, off: int, cnt: int,
                      num_bins: int, method: str = "auto",
                      max_code: int = 0) -> torch.Tensor:
    """Histogram of the DataPartition segment ``row_order[off:off+cnt]``
    (the grower's smaller child)."""
    check_method(method, bins.device)
    if native_applies(method, num_bins, bins.device):
        return native_segment_hist(bins, gh, row_order, off, cnt, num_bins,
                                   max_code)
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
