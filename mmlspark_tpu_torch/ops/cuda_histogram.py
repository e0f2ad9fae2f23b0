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

Both kernels' geometry is plain Python (:func:`full_slots`,
:func:`full_grid`, :func:`full_smem`; :func:`seg_widest`,
:func:`seg_grid`, :func:`seg_smem`), so the CPU tests hold it; per card
each wrapper asks the library once for the shared-memory budget and what
the card holds at once, and keeps that, its geometry per shape and the
merge workspace of each stream (:class:`_FullCard`, :class:`_SegCard`).
``hist_full`` adds every cell in an order that its geometry fixes, and
:func:`histogram_ordered` states that order, so its f32 and bf16 results
are the same bits on every call.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Sequence, Tuple

import torch

ACCUM_MODES = {"float32": 0, "bfloat16": 1, "int32": 2}
#: largest bin count the kernels accept (the reference's ``BMAX``)
BMAX = 256
#: hist_full (csrc/full_hist.cuh): threads a block, the multiple its
#: feature slots come in (two threads each, at most FULL_THREADS / 2), the
#: staged tiles and their bytes, the multiple a block's rows come in, the
#: rows that justify one more block, and the largest cluster
FULL_THREADS = 512
FULL_SLOT_ALIGN = 32
FULL_STAGES = 3
FULL_STAGE_BYTES = 8192
FULL_ROW_ALIGN = 16
FULL_MIN_ROWS = 512
FULL_CLUSTER = 16
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
SMEM_BUDGET = 232_448 - 4


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
    (row, feature) cells in row order.  Bins of ``num_bins`` or more are
    dropped, as the kernels drop them."""
    n, f = bins.shape
    out = torch.zeros(f * num_bins + 1, 3, dtype=_out_dtype(accum),
                      device=bins.device)
    b = bins.to(torch.int64)
    flat = torch.where(b < num_bins,
                       b + torch.arange(f, device=bins.device) * num_bins,
                       f * num_bins).reshape(-1)
    out.index_add_(0, flat, _gh_values(gh, accum).repeat_interleave(f, 0))
    return out[:-1].view(f, num_bins, 3)


def histogram_fused_plain(bins: torch.Tensor, gh: torch.Tensor,
                          row_order: torch.Tensor, off: int, cnt: int,
                          num_bins: int, accum: str = "float32"
                          ) -> torch.Tensor:
    """Plain twin of :func:`histogram_cuda_fused`: the segment's rows are
    gathered, then histogrammed by :func:`histogram_plain`."""
    rows = row_order[off:off + cnt].to(torch.int64)
    return histogram_plain(bins[rows], gh[rows], num_bins, accum)


class FullGeometry(NamedTuple):
    """A ``hist_full`` launch: ``groups`` groups of ``slots`` features
    (grid y), each of ``clusters`` clusters of ``cs`` blocks, block ``x``
    of a group adding rows ``[x * rows, (x + 1) * rows)``."""
    slots: int
    groups: int
    cs: int
    clusters: int
    rows: int


def full_smem(slots: int, num_bins: int) -> int:
    """Shared-memory bytes of a ``hist_full`` block (``full_hist.cuh``):
    the ``(B + 1, slots, 3)`` histogram (bin B: where the rows of a
    tile's tail and out-of-range bins add), then the staging ring."""
    return (num_bins + 1) * 3 * slots * 4 + FULL_STAGES * FULL_STAGE_BYTES


def full_slots(f: int, num_bins: int,
               smem_budget: int = SMEM_BUDGET) -> int:
    """Features a ``hist_full`` block holds: a multiple of
    ``FULL_SLOT_ALIGN``, as many as ``smem_budget`` bytes allow (at most
    ``FULL_THREADS / 2``: two threads a feature), and no more than ``f``
    needs; raises when not one warp's fits."""
    most = (smem_budget - full_smem(0, num_bins)) // ((num_bins + 1) * 12)
    most = min(most, FULL_THREADS // 2) // FULL_SLOT_ALIGN * FULL_SLOT_ALIGN
    if most < FULL_SLOT_ALIGN:
        raise ValueError(f"{FULL_SLOT_ALIGN} features of {num_bins} bins "
                         f"need {full_smem(FULL_SLOT_ALIGN, num_bins)} "
                         f"bytes of shared memory; the card gives "
                         f"{smem_budget}")
    return min(most, -(-f // FULL_SLOT_ALIGN) * FULL_SLOT_ALIGN)


def full_grid(n: int, f: int, num_bins: int, slots: int, resident: int,
              fits: Sequence[int]) -> FullGeometry:
    """The launch over ``n`` rows of ``f`` features in groups of
    ``slots``, on a card that holds ``resident`` blocks and ``fits[k]``
    clusters of ``2**k`` blocks at once.

    A group takes as many blocks as its rows justify
    (``FULL_MIN_ROWS`` each) and the card holds beside the other groups.
    Of the cluster sizes whose clusters of every group fit at once, it
    takes the one of least estimated cost in cycles: the adds of a
    block's rows (a scheduler issues about 4 shared-memory instructions
    a row for each of its warps, one per 4 cycles; 64 slots put one warp
    on each of an SM's 4 schedulers) and, with several clusters, the
    partials the last cluster adds (64 bytes a cycle an SM).  Fewer,
    larger clusters merge less, more blocks add fewer rows each."""
    groups = -(-f // slots)
    per_group = max(1, min(-(-n // FULL_MIN_ROWS), resident // groups))
    merge_bytes = min(slots, f) * num_bins * 12
    best = None
    for k in range(FULL_CLUSTER.bit_length() - 1, -1, -1):
        cs = 1 << k
        clusters = min(per_group // cs, fits[k] // groups)
        if clusters < 1:
            continue
        rows = _row_block(n, cs * clusters)
        cost = rows * 16 * max(1, slots // 64)
        if clusters > 1:
            cost += clusters * merge_bytes // (cs * 64)
        if best is None or cost < best[0]:
            best = (cost, cs, clusters, rows)
    if best is None:                  # more groups than the card holds
        best = (0, 1, 1, _row_block(n, 1))
    return FullGeometry(slots, groups, *best[1:])


def _row_block(n: int, blocks: int) -> int:
    """Rows a block when ``blocks`` blocks share ``n`` rows: a multiple
    of ``FULL_ROW_ALIGN``."""
    rows = -(-max(n, 1) // blocks)
    return -(-rows // FULL_ROW_ALIGN) * FULL_ROW_ALIGN


def histogram_ordered(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                      accum: str, geom: FullGeometry) -> torch.Tensor:
    """:func:`histogram_plain` added in ``hist_full``'s order under the
    launch ``geom``: each block's rows in row order from zero (block
    ``x`` of a group holds rows ``[x * rows, (x + 1) * rows)``); then in
    each cluster of ``cs`` blocks, cell ``(j, b, c)`` lies in slice ``r``,
    the bins from ``B * r // cs`` on, and its sum is block
    ``r``'s value plus those of blocks ``r + 1, r + 2, ...`` (mod
    ``cs``), in that order; with several clusters, zero plus the
    clusters' sums in cluster order.  Computed on the CPU, where
    ``index_add_`` adds in index order; the kernel's result is this one,
    bit for bit."""
    bins, gh = bins.cpu(), gh.cpu()      # index_add_ adds in order here
    n, f = bins.shape
    slots, groups, cs, clusters, rows = geom
    b = torch.arange(num_bins)
    rank = torch.div((b + 1) * cs - 1, num_bins, rounding_mode="floor")
    rank = rank[None, :, None].expand(slots, num_bins, 3)
    out = torch.empty(f, num_bins, 3, dtype=_out_dtype(accum))
    for g in range(groups):
        f0 = g * slots
        fg = min(slots, f - f0)
        parts = [histogram_plain(bins[x * rows:(x + 1) * rows, f0:f0 + fg],
                                 gh[x * rows:(x + 1) * rows], num_bins,
                                 accum)
                 for x in range(cs * clusters)]
        total = torch.zeros(fg, num_bins, 3, dtype=out.dtype)
        for q in range(clusters):
            mine = parts[q * cs:(q + 1) * cs]
            v = torch.empty_like(total)
            for r in range(cs):
                m = rank[:fg] == r
                s = mine[r][m]
                for p in range(cs - 1):
                    s = s + mine[(r + 1 + p) % cs][m]
                v[m] = s
            total = v if clusters == 1 else total + v
        out[f0:f0 + fg] = total
    return out


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
               smem_budget: int = SMEM_BUDGET,
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
                 smem_budget: int = SMEM_BUDGET) -> int:
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
    lib.hist_full.argtypes = [p, p, i64, i32, i32, i32, i32, i32, i32, i64,
                              p, p, p, p]
    lib.hist_full.restype = i32
    lib.hist_full_smem.argtypes = [i32, i32]
    lib.hist_full_smem.restype = i64
    lib.hist_full_capacity.argtypes = [i32, i32, i32, ip, ip]
    lib.hist_full_capacity.restype = i32
    lib.hist_segment.argtypes = [p, p, p, i64, i64, i32, i32, i32, i32, i32,
                                 i32, i32, p, p, p, p]
    lib.hist_segment_smem.argtypes = [i32, i32, i32]
    lib.hist_segment_smem.restype = i64
    lib.hist_segment.restype = i32
    lib.hist_segment_capacity.argtypes = [i32, i32, ip, ip]
    lib.hist_segment_capacity.restype = i32
    for name in ("hist_full_setup", "hist_full_threads",
                 "hist_full_slot_align", "hist_full_row_align",
                 "hist_full_stages", "hist_full_stage_bytes",
                 "hist_full_cluster",
                 "hist_segment_setup",
                 "hist_segment_pad", "hist_segment_max_group",
                 "hist_segment_cluster", "hist_segment_warp_rows",
                 "hist_segment_threads"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    if (lib.hist_full_threads(), lib.hist_full_slot_align(),
            lib.hist_full_row_align(), lib.hist_full_stages(),
            lib.hist_full_stage_bytes(), lib.hist_full_cluster()) != (
                FULL_THREADS, FULL_SLOT_ALIGN, FULL_ROW_ALIGN, FULL_STAGES,
                FULL_STAGE_BYTES, FULL_CLUSTER) or any(
            lib.hist_full_smem(s, b) != full_smem(s, b)
            for s, b in ((64, 256), (256, 63), (256, 2))):
        raise RuntimeError("csrc/full_hist.cuh and ops/cuda_histogram.py "
                           "disagree on the full kernel's geometry")
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


def _stream(dev: torch.device) -> int:
    """The raw handle of ``torch.cuda.current_stream(dev)``, without making
    its Python object (a few µs a call on the host)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def _on_card(dev: torch.device, launch, *args) -> int:
    """``launch(*args)`` with ``dev`` the current device, switching to it
    only when it is not."""
    if dev.index == torch.cuda.current_device():
        return launch(*args)
    with torch.cuda.device(dev):
        return launch(*args)


class _FullCard:
    """What the full-histogram wrapper keeps per card: the library's
    entry, the shared-memory budget, for each ``(f, B, mode)`` the slots
    and what the card holds at once, for each ``(n, f, B, mode)`` the
    launch's :class:`FullGeometry`, and the merge workspace (partials and
    tickets) of each stream."""

    def __init__(self, dev: torch.device):
        lib = _lib()
        budget = _on_card(dev, lib.hist_full_setup)
        if budget <= 0:
            _raise_if_failed(-budget, "hist_full_setup")
        self.dev = dev
        self.launch = lib.hist_full
        self.budget = budget
        self.capacity = {}
        self.geoms = {}
        self.workspace = {}

    def geometry(self, n, f, num_bins, mode) -> FullGeometry:
        key = (n, f, num_bins, mode)
        g = self.geoms.get(key)
        if g is None:
            slots, resident, fits = self.holds(f, num_bins, mode)
            g = self.geoms[key] = full_grid(n, f, num_bins, slots, resident,
                                            fits)
        return g

    def holds(self, f, num_bins, mode):
        """``(slots, resident blocks, clusters of 1, 2, 4, 8, 16 that
        fit)``."""
        key = (f, num_bins, mode)
        h = self.capacity.get(key)
        if h is None:
            slots = full_slots(f, num_bins, self.budget)
            blocks = ctypes.c_int()
            fits = (ctypes.c_int * FULL_CLUSTER.bit_length())()
            rc = _on_card(self.dev, _lib().hist_full_capacity, mode, slots,
                          num_bins, ctypes.byref(blocks), fits)
            _raise_if_failed(rc, "hist_full_capacity")
            if blocks.value < 1:
                raise RuntimeError(f"{self.dev} cannot hold one hist_full "
                                   f"block of {full_smem(slots, num_bins)} "
                                   f"bytes")
            h = self.capacity[key] = (slots, blocks.value, tuple(fits))
        return h

    def merge_space(self, stream, words, groups):
        """Partials of ``words`` words and zeroed tickets of ``groups``
        groups for a multi-cluster launch on ``stream``; each grows to the
        most any launch has asked for."""
        ws = self.workspace.get(stream)
        if ws is None or ws[0].numel() < words \
                or ws[1].numel() < groups * FULL_CLUSTER:
            if ws is not None:
                words = max(words, ws[0].numel())
                groups = max(groups, ws[1].numel() // FULL_CLUSTER)
            ws = self.workspace[stream] = (
                torch.empty(words, dtype=torch.int32, device=self.dev),
                torch.zeros(groups * FULL_CLUSTER, dtype=torch.int32,
                            device=self.dev))
        return ws


_full_cards = {}


def _full_card(dev: torch.device) -> _FullCard:
    card = _full_cards.get(dev.index)
    if card is None:
        card = _full_cards[dev.index] = _FullCard(dev)
    return card


def full_launch_geometry(n: int, f: int, num_bins: int, accum: str,
                         dev: torch.device) -> FullGeometry:
    """The geometry :func:`histogram_cuda` launches ``hist_full`` with on
    the card ``dev`` for ``n`` rows of ``f`` features."""
    dev = torch.device(dev)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    return _full_card(dev).geometry(n, f, num_bins, ACCUM_MODES[accum])


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


def _raise_if_failed(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} launch failed with cudaError {rc}")


def histogram_cuda(bins: torch.Tensor, gh: torch.Tensor, num_bins: int,
                   accum: str = "float32") -> torch.Tensor:
    """``(n, f)`` bins (< ``num_bins`` ≤ 256), ``(n, 3)`` pre-masked gh →
    ``(f, num_bins, 3)`` histogram (int32 when ``accum="int32"``).  On a
    CUDA tensor this launches the ``hist_full`` kernel, which writes every
    cell (no fill) in the order of :func:`histogram_ordered`; on a CPU
    tensor it runs :func:`histogram_plain`."""
    if not bins.is_cuda:
        return histogram_plain(bins, gh, num_bins, accum)
    bins, gh, out_dtype = _check_inputs(bins, gh, num_bins, accum)
    dev = bins.device
    n, f = bins.shape
    out = torch.empty(f, num_bins, 3, dtype=out_dtype, device=dev)
    if f == 0:
        return out
    card = _full_card(dev)
    mode = ACCUM_MODES[accum]
    slots, groups, cs, clusters, rows = card.geometry(n, f, num_bins, mode)
    stream = _stream(dev)
    partial = tickets = None
    if clusters > 1:
        partial, tickets = card.merge_space(
            stream, clusters * groups * (num_bins + 1) * 3 * slots, groups)
        partial, tickets = partial.data_ptr(), tickets.data_ptr()
    rc = _on_card(dev, card.launch, bins.data_ptr(), gh.data_ptr(), n, f,
                  num_bins, mode, slots, cs, clusters, rows, out.data_ptr(),
                  partial, tickets, stream)
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
