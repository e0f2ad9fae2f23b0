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

The segment kernel's geometry is plain Python (:func:`seg_widest`,
:func:`seg_grid`, :func:`seg_smem`), so the CPU tests hold it; per card
the wrapper asks the library once for the shared-memory budget and what
the card holds at once, and keeps that, and the merge workspace of each
stream (:class:`_SegCard`).
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
#: hist_segment (csrc/seg_hist.cuh): words of padding after each feature's
#: B·3 cells in shared memory, the most features a block holds, the rows
#: a warp stages at once, the threads of a block, the largest cluster, the
#: rows that justify one more block, and the fewest features a group of a
#: small segment gets
SEG_PAD = 1
SEG_MAX_GROUP = 64
SEG_WARP_ROWS = 8
SEG_THREADS = 1024
SEG_CLUSTER = 8
SEG_ROWS_PER_BLOCK = 256
SEG_MIN_GROUP = 4
#: opt-in shared memory of a block on the H100 (227 KB), less the kernel's
#: own 4 bytes; the wrapper asks each card for its own figure
SEG_SMEM_BUDGET = 232_448 - 4


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


def seg_words(num_bins: int) -> int:
    """Shared-memory words of one feature in the segment kernel."""
    return num_bins * 3 + SEG_PAD


def seg_smem(group: int, replicas: int, num_bins: int,
             warps: int = SEG_THREADS // 32) -> int:
    """Shared-memory bytes of a segment block of ``warps`` warps
    (``seg_hist.cuh``): the staging tile (gh, and each row's bin bytes
    padded to an odd number of words), two tag rows of ``num_bins`` bytes
    per warp, then ``replicas`` copies of the group's histogram."""
    row_bytes = 4 * (-(-group // 4) | 1)
    return (SEG_WARP_ROWS * warps * (12 + row_bytes)
            + warps * 2 * (-(-num_bins // 4) * 4)
            + replicas * group * seg_words(num_bins) * 4)


def seg_widest(limit: int, num_bins: int,
               smem_budget: int = SEG_SMEM_BUDGET,
               warps: int = SEG_THREADS // 32) -> int:
    """The most features (at most ``limit`` and ``SEG_MAX_GROUP``) whose
    block of ``warps`` warps fits ``smem_budget`` bytes; raises when not
    one does."""
    widest = min(limit, SEG_MAX_GROUP)
    while widest >= 1 and seg_smem(widest, 1, num_bins,
                                   warps) > smem_budget:
        widest -= 1
    if widest < 1:
        raise ValueError(f"one feature of {num_bins} bins needs "
                         f"{seg_smem(1, 1, num_bins, warps)} bytes of "
                         f"shared memory; the card gives {smem_budget}")
    return widest


def seg_replicas(group: int, num_bins: int, warps: int,
                 smem_budget: int = SEG_SMEM_BUDGET) -> int:
    """Histogram copies of a segment block: one per warp beyond the
    group's features (each warp owns whole (copy, feature) units), as far
    as the shared memory holds them."""
    reps = max(1, warps // group)
    while reps > 1 and seg_smem(group, reps, num_bins, warps) > smem_budget:
        reps -= 1
    return reps


def seg_grid(cnt: int, f: int, widest: int, resident: int, clusters: int
             ) -> Tuple[int, int, int, int]:
    """``(features per group, groups, cluster size, clusters per group)``
    of a segment launch over ``cnt`` rows of ``f`` features, on a card
    that holds ``resident`` blocks and ``clusters`` full clusters at once,
    with at most ``widest`` features a block (:func:`seg_widest`).

    Rows first: ``ceil(cnt / SEG_ROWS_PER_BLOCK)`` blocks a group, no more
    than the card holds.  The card's other blocks then take narrower
    feature groups (at least ``SEG_MIN_GROUP`` features): a small segment
    runs on many SMs, one block a group, while a large one keeps the
    widest group, so each of its rows is gathered once (on the H100 one
    group of 50 features beats two of 25 at 200,000 rows; PERF.md).  A
    group's blocks form clusters of at most ``SEG_CLUSTER``."""
    blocks = max(1, min(-(-cnt // SEG_ROWS_PER_BLOCK), resident))
    narrowest = -(-f // min(f, SEG_MIN_GROUP))
    fewest = -(-f // widest)
    groups = max(fewest, min(resident // blocks, narrowest))
    group = -(-f // groups)
    groups = -(-f // group)
    per_group = max(1, min(blocks, resident // groups))
    if per_group < SEG_CLUSTER:
        return group, groups, 1 << (per_group.bit_length() - 1), 1
    return group, groups, SEG_CLUSTER, max(1, min(per_group // SEG_CLUSTER,
                                                  clusters // groups))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ._build import load
    lib = load("histogram")
    p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    lib.hist_full.argtypes = [p, p, i64, i32, i32, i32, i32, i32, i64, p, p]
    lib.hist_full.restype = i32
    lib.hist_segment.argtypes = [p, p, p, i64, i64, i32, i32, i32, i32, i32,
                                 i32, i32, p, p, p, p]
    lib.hist_segment_smem.argtypes = [i32, i32, i32]
    lib.hist_segment_smem.restype = i64
    lib.hist_segment.restype = i32
    lib.hist_segment_capacity.argtypes = [i32, i32, ip, ip]
    lib.hist_segment_capacity.restype = i32
    for name in ("hist_group_size", "hist_segment_setup",
                 "hist_segment_pad", "hist_segment_max_group",
                 "hist_segment_cluster", "hist_segment_warp_rows",
                 "hist_segment_threads"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    if (lib.hist_segment_pad(), lib.hist_segment_max_group(),
            lib.hist_segment_cluster(), lib.hist_segment_warp_rows(),
            lib.hist_segment_threads()) != (SEG_PAD, SEG_MAX_GROUP,
                                            SEG_CLUSTER, SEG_WARP_ROWS,
                                            SEG_THREADS) or any(
            lib.hist_segment_smem(g, r, b) != seg_smem(g, r, b)
            for g, r, b in ((50, 1, 256), (13, 2, 17), (1, 32, 2))):
        raise RuntimeError("csrc/seg_hist.cuh and ops/cuda_histogram.py "
                           "disagree on the segment kernel's geometry")
    return lib


class _SegCard:
    """What the segment wrapper keeps per card: the library's entry, the
    shared-memory budget, for each ``(f, B, mode)`` the widest group and
    the blocks and clusters of it the card holds at once, the copies of
    each group width, and the merge workspace of each ``(stream, f, B,
    dtype)``."""

    def __init__(self, dev: torch.device):
        lib = _lib()
        with torch.cuda.device(dev):
            budget = lib.hist_segment_setup()
        if budget <= 0:
            _raise_if_failed(-budget, "hist_segment_setup")
        self.dev = dev
        self.launch = lib.hist_segment
        self.budget = budget
        self.capacity = {}
        self.copies = {}
        self.workspace = {}

    def geom(self, f, num_bins, mode):
        """``(widest group, resident blocks, resident clusters)``."""
        key = (f, num_bins, mode)
        g = self.capacity.get(key)
        if g is None:
            widest = seg_widest(f, num_bins, self.budget)
            smem = seg_smem(widest, self.replicas(widest, num_bins),
                            num_bins)
            blocks, clusters = ctypes.c_int(), ctypes.c_int()
            with torch.cuda.device(self.dev):
                rc = _lib().hist_segment_capacity(mode, smem,
                                                  ctypes.byref(blocks),
                                                  ctypes.byref(clusters))
            _raise_if_failed(rc, "hist_segment_capacity")
            if blocks.value < 1:
                raise RuntimeError(f"{self.dev} cannot hold one hist_segment "
                                   f"block of {smem} bytes")
            g = self.capacity[key] = (widest, blocks.value, clusters.value)
        return g

    def replicas(self, group, num_bins):
        key = (group, num_bins)
        r = self.copies.get(key)
        if r is None:
            r = self.copies[key] = seg_replicas(group, num_bins,
                                                SEG_THREADS // 32,
                                                self.budget)
        return r

    def merge_space(self, stream, f, num_bins, dtype, clusters, groups):
        """Partials (``clusters`` planes of ``(f, B, 3)``) and zeroed
        tickets of a multi-cluster launch on ``stream``; each grows to the
        most any launch has asked for, so launches of other shapes in turn
        reuse it."""
        key = (stream, f, num_bins, dtype)
        ws = self.workspace.get(key)
        if ws is None or ws[0].shape[0] < clusters \
                or ws[1].shape[0] < groups * SEG_CLUSTER:
            if ws is not None:
                clusters = max(clusters, ws[0].shape[0])
                groups = max(groups, ws[1].shape[0] // SEG_CLUSTER)
            ws = self.workspace[key] = (
                torch.empty(clusters, f * num_bins * 3, dtype=dtype,
                            device=self.dev),
                torch.zeros(groups * SEG_CLUSTER, dtype=torch.int32,
                            device=self.dev))
        return ws

_seg_cards = {}


def _seg_card(dev: torch.device) -> _SegCard:
    card = _seg_cards.get(dev.index)
    if card is None:
        card = _seg_cards[dev.index] = _SegCard(dev)
    return card


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
    if bins.dtype != torch.uint8:
        bins = bins.to(torch.uint8)
    if gh.dtype != out_dtype:   # int32 codes, or f32 (rounded in-kernel)
        gh = gh.to(out_dtype)
    return bins.contiguous(), gh.contiguous(), out_dtype


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
    dev = bins.device
    n, f = bins.shape
    if cnt == 0:
        return torch.zeros(f, num_bins, 3, dtype=out_dtype, device=dev)
    card = _seg_card(dev)
    mode = ACCUM_MODES[accum]
    widest, resident, most = card.geom(f, num_bins, mode)
    group, groups, cs, clusters = seg_grid(cnt, f, widest, resident, most)
    reps = card.replicas(group, num_bins)
    out = torch.empty(f, num_bins, 3, dtype=out_dtype, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    partial = tickets = None
    if clusters > 1:
        partial, tickets = card.merge_space(stream, f, num_bins, out_dtype,
                                            clusters, groups)
        partial, tickets = partial.data_ptr(), tickets.data_ptr()
    args = (bins.data_ptr(), gh.data_ptr(), row_order.data_ptr(), off, cnt,
            f, num_bins, mode, group, reps, clusters, cs, out.data_ptr(),
            partial, tickets, stream)
    if torch.cuda.current_device() == dev.index:
        rc = card.launch(*args)
    else:
        with torch.cuda.device(dev):
            rc = card.launch(*args)
    _raise_if_failed(rc, "hist_segment")
    histogram_cuda_fused.launches += 1
    return out


histogram_cuda_fused.launches = 0
