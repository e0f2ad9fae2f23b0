"""Gradient-histogram kernels for Hopper and their plain PyTorch twins.

The port's counterpart of ``mmlspark_tpu/ops/pallas_histogram.py``:

* :func:`histogram_cuda` replaces ``histogram_pallas`` (TPU body
  ``_hist_kernel``): the histogram of the whole binned matrix.
* :func:`histogram_cuda_fused` replaces ``histogram_pallas_fused`` (TPU
  body ``_fused_kernel``): the histogram of the DataPartition segment
  ``row_order[off:off+cnt]``, rows gathered in-kernel.  ``cnt`` is exact:
  no bucket padding and no row cap.

Both kernels live in ``csrc/histogram.cu``; the note there gives their
design and their bound at the main-path shapes.  On a CUDA tensor a
wrapper launches its kernel or raises; on a CPU tensor it runs its plain
twin (:func:`histogram_plain`, :func:`histogram_fused_plain`), the same
function in ``index_add_`` form.  ``launches`` on each wrapper counts the
kernel launches and nothing else.

``accum``: ``"float32"``; ``"bfloat16"`` (gh rounded to bf16, summed in
f32, as the TPU kernel does); ``"int32"`` (integer gh codes, exact).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

ACCUM_MODES = {"float32": 0, "bfloat16": 1, "int32": 2}
#: largest bin count the kernels accept (the reference's ``BMAX``)
BMAX = 256
#: blocks the launch aims for per streaming multiprocessor
BLOCKS_PER_SM = 4


def _out_dtype(accum: str) -> torch.dtype:
    if accum not in ACCUM_MODES:
        raise ValueError(f"accum must be one of {sorted(ACCUM_MODES)}, "
                         f"got {accum!r}")
    return torch.int32 if accum == "int32" else torch.float32


def _gh_values(gh: torch.Tensor, accum: str) -> torch.Tensor:
    """gh as the kernel reads it: bf16-rounded in bfloat16 mode."""
    if accum == "int32":
        return gh.to(torch.int32)
    gh = gh.to(torch.float32)
    if accum == "bfloat16":
        gh = gh.to(torch.bfloat16).to(torch.float32)
    return gh


def histogram_plain(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                    accum: str = "float32") -> torch.Tensor:
    """Plain twin of :func:`histogram_cuda`: ``(n, f)`` bins, ``(n, 3)``
    gh → ``(f, num_bins, 3)``, one ``index_add_`` over the flattened
    (row, feature) cells in row order."""
    n, f = bins.shape
    out = torch.zeros(f * num_bins, 3, dtype=_out_dtype(accum),
                      device=bins.device)
    flat = (bins.to(torch.int64)
            + torch.arange(f, device=bins.device) * num_bins).reshape(-1)
    out.index_add_(0, flat, _gh_values(gh, accum).repeat_interleave(f, 0))
    return out.view(f, num_bins, 3)


def histogram_fused_plain(bins: torch.Tensor, gh: torch.Tensor,
                          row_order: torch.Tensor, off: int, cnt: int,
                          num_bins: int, accum: str = "float32"
                          ) -> torch.Tensor:
    """Plain twin of :func:`histogram_cuda_fused`: the segment's rows are
    gathered, then histogrammed by :func:`histogram_plain`."""
    rows = row_order[off:off + cnt].to(torch.int64)
    return histogram_plain(bins[rows], gh[rows], num_bins, accum)


def launch_shape(cnt: int, f: int, group: int, num_sms: int
                 ) -> Tuple[int, int, int]:
    """Grid of a histogram launch over ``cnt`` rows: ``(feature groups,
    row tiles, rows per tile)``.  Tiles are sized so the grid holds about
    ``BLOCKS_PER_SM`` blocks per SM, and no tile is shorter than one row
    per thread (256 rows); every block flushes its whole shared
    histogram, so more blocks than that only add global atomics."""
    groups = -(-f // group)
    want = max(1, -(-BLOCKS_PER_SM * num_sms // groups))
    tiles = max(1, min(want, cnt // 256))
    rows = -(-cnt // tiles)
    return groups, -(-cnt // rows), rows


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ._build import load
    lib = load("histogram")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.hist_full.argtypes = [p, p, i64, i32, i32, i32, i32, i32, i64, p, p]
    lib.hist_full.restype = i32
    lib.hist_segment.argtypes = [p, p, p, i64, i64, i32, i32, i32, i32, i32,
                                 i64, p, p]
    lib.hist_segment.restype = i32
    lib.hist_group_size.argtypes = []
    lib.hist_group_size.restype = i32
    return lib


def _check_inputs(bins, gh, num_bins, accum):
    if num_bins > BMAX or num_bins < 1:
        raise ValueError(f"the CUDA histogram kernels take 1..{BMAX} bins, "
                         f"got {num_bins}")
    if bins.dim() != 2 or gh.dim() != 2 or gh.shape[1] != 3 \
            or gh.shape[0] != bins.shape[0]:
        raise ValueError(f"bins must be (n, f) and gh (n, 3); got "
                         f"{tuple(bins.shape)} and {tuple(gh.shape)}")
    if gh.device != bins.device:
        raise ValueError("bins and gh must lie on the same device")
    out_dtype = _out_dtype(accum)
    bins = bins.to(torch.uint8).contiguous()
    gh = gh.to(torch.int32 if out_dtype == torch.int32
               else torch.float32).contiguous()
    return bins, gh, out_dtype


def _launch_args(bins, cnt, dev):
    lib = _lib()
    num_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return lib, launch_shape(cnt, bins.shape[1], lib.hist_group_size(),
                             num_sms)


def _raise_if_failed(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {rc}")


def histogram_cuda(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                   accum: str = "float32") -> torch.Tensor:
    """``(n, f)`` bins (< ``num_bins`` ≤ 256), ``(n, 3)`` pre-masked gh →
    ``(f, num_bins, 3)`` histogram (int32 when ``accum="int32"``).  On a
    CUDA tensor this launches the ``hist_full`` kernel; on a CPU tensor it
    runs :func:`histogram_plain`."""
    if not bins.is_cuda:
        return histogram_plain(bins, gh, num_bins, accum)
    bins, gh, out_dtype = _check_inputs(bins, gh, num_bins, accum)
    n, f = bins.shape
    out = torch.zeros(f, num_bins, 3, dtype=out_dtype, device=bins.device)
    if n == 0:
        return out
    lib, (groups, tiles, rows) = _launch_args(bins, n, bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    with torch.cuda.device(bins.device):
        rc = lib.hist_full(bins.data_ptr(), gh.data_ptr(), n, f, num_bins,
                           ACCUM_MODES[accum], groups, tiles, rows,
                           out.data_ptr(), stream)
    _raise_if_failed(rc, "hist_full")
    histogram_cuda.launches += 1
    return out


histogram_cuda.launches = 0


def histogram_cuda_fused(bins: torch.Tensor, gh: torch.Tensor,
                         row_order: torch.Tensor, off: int, cnt: int,
                         num_bins: int, accum: str = "float32"
                         ) -> torch.Tensor:
    """Histogram of the rows ``row_order[off:off+cnt]`` of ``bins`` /
    ``gh`` (both gathered in-kernel by row id).  On a CUDA tensor this
    launches the ``hist_segment`` kernel (no launch when ``cnt == 0``);
    on a CPU tensor it runs :func:`histogram_fused_plain`."""
    if not bins.is_cuda:
        return histogram_fused_plain(bins, gh, row_order, off, cnt,
                                     num_bins, accum)
    bins, gh, out_dtype = _check_inputs(bins, gh, num_bins, accum)
    if row_order.dtype != torch.int32 or row_order.device != bins.device:
        raise ValueError("row_order must be an int32 tensor on the device "
                         "of bins")
    if off < 0 or cnt < 0 or off + cnt > row_order.shape[0]:
        raise ValueError(f"segment [{off}, {off + cnt}) lies outside "
                         f"row_order of length {row_order.shape[0]}")
    row_order = row_order.contiguous()
    n, f = bins.shape
    out = torch.zeros(f, num_bins, 3, dtype=out_dtype, device=bins.device)
    if cnt == 0:
        return out
    lib, (groups, tiles, rows) = _launch_args(bins, cnt, bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    with torch.cuda.device(bins.device):
        rc = lib.hist_segment(bins.data_ptr(), gh.data_ptr(),
                              row_order.data_ptr(), off, cnt, f, num_bins,
                              ACCUM_MODES[accum], groups, tiles, rows,
                              out.data_ptr(), stream)
    _raise_if_failed(rc, "hist_segment")
    histogram_cuda_fused.launches += 1
    return out


histogram_cuda_fused.launches = 0
