"""Ring collectives for Hopper: the wrappers of ``csrc/ring.cu``.

* :func:`ring_allreduce_cuda` replaces ``ring_allreduce`` of
  ``mmlspark_tpu/ops/pallas_collectives.py`` (TPU body
  ``_ring_allreduce_kernel``).
* :func:`ring_allreduce_select_cuda` replaces ``ring_allreduce_select``
  (the same TPU body under its own collective id, after ``_gather_cand``).
* :func:`fused_segment_hist_ring_cuda` replaces ``fused_segment_hist_ring``
  (TPU body ``_fused_hist_ring_kernel``).

The note at the top of ``csrc/ring.cu`` gives the order, the kernels and
the bound.  The wrappers take CUDA tensors only: the entries in
:mod:`.collectives` route CPU tensors to the plain twins.  One call is one
reduction, however many cards it spans: ``launches`` on each wrapper
counts reductions (calls that launched their kernel on every card of the
mesh), not per-card launches.

Routes.  The dense and select reductions take one of two kernels, chosen
by the mesh's layout alone (:func:`ring_route`): ``"direct"`` when every
rank lies on one card (one ordinary launch that adds each element in the
ring's order, with no handshake), ``"ring"`` when the mesh spans cards
(the ring with system-scope handshakes).  A launch that fails raises on
either route; neither falls back on the other.  The fused kernel always
runs its ring.  The ring kernels also run on one card (:func:`_allreduce`
and :func:`_allreduce_select` with ``route="ring"``), which is how a
host with one card holds them against their twins.

Workspace.  Per (mesh, kind, payload, dtype), kept in ``mesh.scratch``:
on the ring route the comm slots (``2(D-1)`` chunks per rank) and the
flag words, and for the fused kernel the per-rank histogram buffers and
per-chunk readiness words; a direct workspace holds no device buffer.
The dense, select and fused rings each have their own (the counterpart
of the TPU kernels' separate collective ids), so they never share a flag;
flags carry a launch sequence number, so nothing is reset between calls.
Peer access between neighbouring cards is enabled when a ring workspace
is made, and raises where the cards cannot reach each other.  The number
of ring blocks per rank is one for the whole mesh (:func:`mesh_blocks`),
chosen once per workspace and passed to every card's launch.

Host path.  The fused workspace keeps the ctypes pointer arrays of the
shard tensors it has launched on, keyed by every tensor's data pointer,
shape, strides, dtype and device, so a call on tensors seen before skips
its checks, conversions and arrays.  The stream is read as its raw
handle, and a device context is entered only for a card other than the
current one.  On the direct route the D outputs are one ``(D, *shape)``
allocation, returned as its D views.  The fused kernel's phase 1 is cut along the ring's
chunks (:func:`fused_chunk_features`), with at most :func:`fused_group`
features an item.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Sequence, Tuple

import torch

from .cuda_histogram import (NARROW_BINS, SMEM_BUDGET, _on_card, _out_dtype,
                             _raise_if_failed, _stream, seg_replicas,
                             seg_smem, seg_widest)

#: most bins the fused kernel takes: it reads one-byte codes (a wider
#: pallas_ring fit reduces each shard's hist_segment apart, as the
#: reference gates its fused kernel)
FUSED_MAX_BINS = NARROW_BINS

_MODES = {"float32": 0, "int32": 2}
_SEQ_MAX = 0xFFFFFFFF
#: lanes per row of the reference's ring layout (``_ring_flat``)
LANES = 128
#: fused_hist_ring threads per block, and the rows that justify one more
#: phase-1 tile
FUSED_THREADS = 512
FUSED_ROWS_PER_TILE = 256
#: shard-tensor sets whose pointer arrays a fused workspace keeps
_POINTER_CACHE = 16


def ring_chunk(total: int, num_shards: int) -> int:
    """Elements per ring chunk: ``cb·128`` with ``cb = ceil(ceil(total /
    128) / D)`` (the reference's ``_ring_flat`` padding)."""
    rows = -(-total // LANES)
    return -(-rows // num_shards) * LANES


def fused_chunk_features(f: int, num_bins: int, chunk: int, num_shards: int
                         ) -> List[Tuple[int, int]]:
    """``[(fa, fb)]`` per ring chunk: the features whose cells hold the
    chunk's flattened elements ``[c·chunk, (c+1)·chunk)`` of the ``(f, B,
    3)`` payload (``(0, 0)`` for a chunk wholly past it).  A feature that
    straddles a chunk boundary is in both chunks' ranges."""
    inner = num_bins * 3
    total = f * inner
    out = []
    for c in range(num_shards):
        lo, hi = c * chunk, min((c + 1) * chunk, total)
        out.append((lo // inner, -(-hi // inner)) if lo < hi else (0, 0))
    return out


def fused_group(f: int, num_bins: int, chunk: int, num_shards: int,
                smem_budget: int = SMEM_BUDGET) -> int:
    """Features per phase-1 item of the fused kernel: a chunk's whole
    feature range where the shared memory holds it beside the staging
    tile, else the most it holds.  Raises when not one feature fits."""
    span = max(fb - fa for fa, fb in fused_chunk_features(
        f, num_bins, chunk, num_shards))
    return seg_widest(max(1, span), num_bins, smem_budget,
                      FUSED_THREADS // 32)


def fused_grid(counts: Sequence[int], sub_items: int, nb_cap: int,
               nb_ring: int) -> Tuple[List[int], int]:
    """``(tiles per rank, blocks per rank)`` of one fused launch: a rank's
    segment of ``cnt`` rows gets ``ceil(cnt / FUSED_ROWS_PER_TILE)`` row
    tiles (0 for an empty one), no more than the ``nb_cap`` resident
    blocks hold of its ``sub_items × tiles`` phase-1 items; the launch
    takes the larger of the ``nb_ring`` ring blocks and the largest
    rank's items (the items go to the last blocks, so the ring blocks get
    them last)."""
    cap = max(1, nb_cap // sub_items)
    tiles = [min(-(-c // FUSED_ROWS_PER_TILE), cap) for c in counts]
    return tiles, min(nb_cap, max(nb_ring, max(tiles) * sub_items))


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from ._build import load
    lib = load("ring")
    p, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_uint32)
    pp = ctypes.POINTER(ctypes.c_void_p)
    ip = ctypes.POINTER(ctypes.c_int)
    lp = ctypes.POINTER(ctypes.c_int64)
    lib.ring_allreduce_launch.argtypes = [i32, i32, ip, pp, pp, pp, pp, i64,
                                          i64, u32, i32, p]
    lib.ring_allreduce_launch.restype = i32
    lib.fused_hist_ring_launch.argtypes = [i32, i32, ip, pp, pp, pp, lp, pp,
                                           pp, pp, pp, pp, i32, i32, i32, i32,
                                           i32, i32, i64, u32, i32, i32, p]
    lib.fused_hist_ring_launch.restype = i32
    lib.ring_allreduce_select_launch.argtypes = [i32, i32, ip, pp, pp, pp,
                                                 pp, pp, i32, i64, i64, i64,
                                                 i64, u32, i32, p]
    lib.ring_allreduce_select_launch.restype = i32
    lib.direct_ring_allreduce_launch.argtypes = [i32, pp, p, i64, i64, p]
    lib.direct_ring_allreduce_launch.restype = i32
    lib.direct_ring_select_launch.argtypes = [i32, pp, p, p, i32, i64, i64,
                                              i64, i64, p]
    lib.direct_ring_select_launch.restype = i32
    for name in ("ring_allreduce_blocks", "ring_allreduce_select_blocks"):
        getattr(lib, name).argtypes = [i32, i64]
        getattr(lib, name).restype = i32
    lib.fused_hist_ring_blocks.argtypes = [i32, i32, i32, i32]
    lib.fused_hist_ring_blocks.restype = i32
    lib.ring_enable_peer.argtypes = [i32, i32]
    lib.ring_enable_peer.restype = i32
    for name in ("ring_max_blocks", "ring_max_ranks", "fused_hist_ring_setup",
                 "fused_hist_ring_threads"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i32
    if lib.fused_hist_ring_threads() != FUSED_THREADS:
        raise RuntimeError("csrc/ring.cu and ops/cuda_ring.py disagree on "
                           "the fused kernel's block size")
    return lib


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def ring_route(devices: Sequence[torch.device]) -> str:
    """The dense and select reductions' kernel for a mesh of ``devices``
    (one per rank), by its layout alone: ``"direct"`` when every rank lies
    on one device, ``"ring"`` when the ranks span devices."""
    return "direct" if len(set(devices)) == 1 else "ring"


class _Workspace:
    """Device buffers and host caches of one (mesh, payload, dtype)
    reduction."""

    def __init__(self, mesh, total: int, chunk: int, dtype: torch.dtype,
                 route: str, fused: bool):
        lib = _lib()
        D = len(mesh)
        if not 2 <= D <= lib.ring_max_ranks():
            raise ValueError(f"the ring kernels take 2..{lib.ring_max_ranks()}"
                             f" shards, got {D}")
        self.route = route
        ring = route == "ring"
        if ring:
            for d, nxt in zip(mesh.devices,
                              mesh.devices[1:] + mesh.devices[:1]):
                if d != nxt:
                    _raise_if_failed(lib.ring_enable_peer(d.index, nxt.index),
                                     f"peer access {d} -> {nxt}")
        steps = 2 * (D - 1)
        self.slots = [torch.empty(steps * chunk, dtype=dtype, device=d)
                      for d in mesh.devices] if ring else []
        self.flags = [torch.zeros(steps * lib.ring_max_blocks(),
                                  dtype=torch.int32, device=d)
                      for d in mesh.devices] if ring else []
        self.work = [torch.zeros(total, dtype=dtype, device=d)
                     for d in mesh.devices] if fused else []
        # per chunk: the items counted so far, then the chunk's flag
        self.ready = [torch.zeros(2 * lib.ring_max_ranks(), dtype=torch.int32,
                                  device=d)
                      for d in mesh.devices] if fused else []
        self.seq = 0
        # the ranks of each card, in rank order: one launch per card
        self.cards = {}
        for r, d in enumerate(mesh.devices):
            self.cards.setdefault(d, []).append(r)
        self.local = {d: (ctypes.c_int * len(r))(*r)
                      for d, r in self.cards.items()}
        self.slots_p, self.flags_p = _ptrs(self.slots), _ptrs(self.flags)
        self.work_p, self.ready_p = _ptrs(self.work), _ptrs(self.ready)
        self._blocks = {}
        self.pointers = {}   # fused: the shards' key -> pointer arrays
        self.fused_geometry = {}
        self.smem_budget = None

    def next_seq(self) -> int:
        self.seq = self.seq % _SEQ_MAX + 1
        return self.seq

    def blocks(self, key, per_card) -> int:
        """The mesh's block count per rank for launches of kind ``key``
        (cached): ``per_card(n_local)`` asks the current card what it
        wants and holds, under each card of the mesh in turn."""
        nb = self._blocks.get(key)
        if nb is None:
            counts = []
            for dev, ranks in self.cards.items():
                with torch.cuda.device(dev):
                    counts.append(per_card(len(ranks)))
            nb = self._blocks[key] = mesh_blocks(counts)
        return nb

    def fused_smem_budget(self, lib) -> int:
        """The shared memory a fused block may use on every card of the
        mesh (the least of them), after letting the kernel use it."""
        if self.smem_budget is None:
            budgets = []
            for dev in self.cards:
                with torch.cuda.device(dev):
                    budgets.append(lib.fused_hist_ring_setup())
            if min(budgets) <= 0:
                _raise_if_failed(-min(budgets), "fused_hist_ring_setup")
            self.smem_budget = min(budgets)
        return self.smem_budget


def mesh_blocks(per_card: Sequence[int]) -> int:
    """One block count per rank for every card of a mesh: the fewest that
    any card asks for or can hold (``per_card``, one entry per card).
    Block b of every rank covers the same slice of each ring chunk and
    waits on flag (slot, b), so all cards must launch the same count; a
    card with more ranks or fewer SMs than another would choose fewer
    blocks on its own, and the slices would not line up.  Raises when a
    card cannot hold one block per rank."""
    nb = min(per_card)
    if nb < 1:
        raise RuntimeError(f"a card of the mesh cannot hold one ring block "
                           f"per rank at once (blocks per card: "
                           f"{list(per_card)})")
    return nb


def _workspace(mesh, kind: str, total: int, chunk: int,
               dtype: torch.dtype, route: str = "ring") -> _Workspace:
    key = ("ring", kind, total, chunk, dtype, route)
    ws = mesh.scratch.get(key)
    if ws is None:
        ws = mesh.scratch[key] = _Workspace(mesh, total, chunk, dtype, route,
                                            kind == "fused")
    return ws


def _check_mesh(tensors: Sequence[torch.Tensor], mesh, what: str) -> None:
    if len(tensors) != len(mesh):
        raise ValueError(f"{len(tensors)} {what} for a mesh of {len(mesh)}")
    for t, d in zip(tensors, mesh.devices):
        if not t.is_cuda or t.device != d:
            raise ValueError(f"{what} must lie on the mesh's CUDA devices "
                             f"in order; got {t.device} for {d}")


def _check_parts(parts: Sequence[torch.Tensor], mesh, what: str) -> None:
    """``parts[d]``: float32 on ``mesh.devices[d]``, all of one shape."""
    if len(parts) != len(mesh):
        raise ValueError(f"{len(parts)} parts for a mesh of {len(mesh)}")
    shape = parts[0].shape
    for p, d in zip(parts, mesh.devices):
        if not p.is_cuda or p.device != d:
            raise ValueError(f"parts must lie on the mesh's CUDA devices "
                             f"in order; got {p.device} for {d}")
        if p.shape != shape:
            raise ValueError(f"{what} parts must share one shape")
        if p.dtype != torch.float32:
            raise ValueError(f"{what} reduces float32 parts")


def ring_allreduce_cuda(parts: Sequence[torch.Tensor], mesh
                        ) -> List[torch.Tensor]:
    """Sum of the float32 ``parts`` (``parts[d]`` on ``mesh.devices[d]``,
    all of one shape), delivered to every shard: one direct launch where
    the mesh lies on one card, else one ``ring_allreduce`` launch per card
    (:func:`ring_route`).  Raises on tensors that are not on the mesh's
    CUDA devices, and when a launch fails."""
    return _allreduce(parts, mesh, ring_route(mesh.devices))


def _allreduce(parts, mesh, route: str) -> List[torch.Tensor]:
    """:func:`ring_allreduce_cuda` on the kernel of ``route``; the ring
    route also runs on a one-card mesh."""
    _check_parts(parts, mesh, "ring_allreduce")
    shape = parts[0].shape
    lib = _lib()
    D = len(mesh)
    total = parts[0].numel()
    if total == 0:
        return [torch.empty_like(p) for p in parts]
    chunk = ring_chunk(total, D)
    ws = _workspace(mesh, "dense", total, chunk, torch.float32, route)
    x = [p.contiguous() for p in parts]   # alive through the launch
    x_p = _ptrs(x)
    if route == "direct":
        dev = mesh.devices[0]
        out = torch.empty((D,) + tuple(shape), dtype=torch.float32, device=dev)
        rc = _on_card(dev, lib.direct_ring_allreduce_launch, D, x_p,
                      out.data_ptr(), total, chunk, _stream(dev))
        _raise_if_failed(rc, "ring_allreduce")
        ring_allreduce_cuda.launches += 1
        return list(out.unbind(0))
    nb = ws.blocks("dense", lambda n_local: lib.ring_allreduce_blocks(
        n_local, chunk))
    out = [torch.empty(shape, dtype=torch.float32, device=d)
           for d in mesh.devices]
    args = (x_p, _ptrs(out), ws.slots_p, ws.flags_p, total, chunk,
            ws.next_seq(), nb)
    for dev, ranks in ws.cards.items():
        rc = _on_card(dev, lib.ring_allreduce_launch, D, len(ranks),
                      ws.local[dev], *args, _stream(dev))
        _raise_if_failed(rc, "ring_allreduce")
    ring_allreduce_cuda.launches += 1
    return out


ring_allreduce_cuda.launches = 0


def ring_allreduce_select_cuda(parts: Sequence[torch.Tensor],
                               cand: torch.Tensor, mesh
                               ) -> List[torch.Tensor]:
    """Voted-column all-reduce: the sum over the shards of ``parts[d][cand]``
    (``parts[d]`` on ``mesh.devices[d]``), delivered to every shard, in one
    direct launch where the mesh lies on one card, else one ``ring_select``
    launch per card (:func:`ring_route`).  ``parts``: float32 local
    histograms of one shape, ``(f, B, 3)`` with ``cand`` of shape
    ``(k2,)``, or the stacked ``(m, f, B, 3)`` with ``cand`` of shape
    ``(m, k2)``; ``cand`` int32 in ``[0, f)``, the same for every shard
    (copied only to cards where it does not lie).  Returns the ``(k2, B,
    3)`` or ``(m, k2, B, 3)`` sum on every shard's device.  Raises on
    tensors off the mesh's CUDA devices and on a failed launch; a ``cand``
    on the host is range-checked here, one on a card by the kernel, which
    traps on an index outside ``[0, f)``."""
    return _allreduce_select(parts, cand, mesh, ring_route(mesh.devices))


def _allreduce_select(parts, cand, mesh, route: str) -> List[torch.Tensor]:
    """:func:`ring_allreduce_select_cuda` on the kernel of ``route``; the
    ring route also runs on a one-card mesh."""
    _check_parts(parts, mesh, "ring_allreduce_select")
    shape = parts[0].shape
    if cand.dtype != torch.int32 or cand.dim() not in (1, 2):
        raise ValueError(f"cand must be int32 of shape (k2,) or (m, k2); got "
                         f"{cand.dtype} {tuple(cand.shape)}")
    lead = cand.dim() - 1          # 0: one slab, 1: m stacked children
    if len(shape) < lead + 2 or tuple(shape[:lead]) != tuple(cand.shape[:lead]):
        raise ValueError(f"cand {tuple(cand.shape)} does not match parts of "
                         f"shape {tuple(shape)}")
    f = shape[lead]
    if not cand.is_cuda and cand.numel() and (
            int(cand.min()) < 0 or int(cand.max()) >= f):
        raise ValueError(f"candidate columns must lie in [0, {f})")
    lib = _lib()
    D = len(mesh)
    k2 = cand.shape[-1]
    inner = 1
    for s in shape[lead + 1:]:
        inner *= s
    out_shape = tuple(cand.shape) + tuple(shape[lead + 1:])
    total = cand.numel() * inner
    if total == 0:
        return [torch.empty(out_shape, dtype=torch.float32, device=d)
                for d in mesh.devices]
    chunk = ring_chunk(total, D)
    ws = _workspace(mesh, "select", total, chunk, torch.float32, route)
    x = [p.contiguous() for p in parts]   # alive through the launch
    x_p = _ptrs(x)
    flat = cand.reshape(-1).contiguous()
    if route == "direct":
        dev = mesh.devices[0]
        if flat.device != dev:
            flat = flat.to(dev)
        out = torch.empty((D,) + out_shape, dtype=torch.float32, device=dev)
        rc = _on_card(dev, lib.direct_ring_select_launch, D, x_p,
                      flat.data_ptr(), out.data_ptr(), f, k2, inner, total,
                      chunk, _stream(dev))
        _raise_if_failed(rc, "ring_allreduce_select")
        ring_allreduce_select_cuda.launches += 1
        return list(out.unbind(0))
    copies = {dev: flat if flat.device == dev else flat.to(dev)
              for dev in ws.cards}
    nb = ws.blocks("select", lambda n_local:
                   lib.ring_allreduce_select_blocks(n_local, chunk))
    out = [torch.empty(out_shape, dtype=torch.float32, device=d)
           for d in mesh.devices]
    args = (x_p, _ptrs([copies[d] for d in mesh.devices]), _ptrs(out),
            ws.slots_p, ws.flags_p, f, k2, inner, total, chunk,
            ws.next_seq(), nb)
    for dev, ranks in ws.cards.items():
        rc = _on_card(dev, lib.ring_allreduce_select_launch, D, len(ranks),
                      ws.local[dev], *args, _stream(dev))
        _raise_if_failed(rc, "ring_allreduce_select")
    ring_allreduce_select_cuda.launches += 1
    return out


ring_allreduce_select_cuda.launches = 0


def _shards_key(shards) -> tuple:
    return tuple((t.data_ptr(), t.shape, t.stride(), t.dtype, t.device)
                 for s in shards for t in s[:3])


def _fused_pointers(shards, mesh, out_dtype):
    """Checks and converts the shards' tensors; returns ``((bins ptrs, gh
    ptrs, row_order ptrs, row_order lengths), the tensors pointed to,
    whether any of them is a converted copy)``."""
    _check_mesh([s[0] for s in shards], mesh, "bins")
    f = shards[0][0].shape[1]
    bins, gh, order = [], [], []
    for b, g, o, _, _ in shards:
        if b.dim() != 2 or b.shape[1] != f or g.shape != (b.shape[0], 3):
            raise ValueError(f"each shard needs (n, {f}) bins and (n, 3) gh; "
                             f"got {tuple(b.shape)} and {tuple(g.shape)}")
        if g.device != b.device or o.device != b.device \
                or o.dtype != torch.int32:
            raise ValueError("gh and an int32 row_order must lie on the "
                             "device of their shard's bins")
        bins.append(b.to(torch.uint8).contiguous())
        gh.append(g.to(out_dtype).contiguous())
        order.append(o.contiguous())
    kept = all(x is y for s, b, g, o in zip(shards, bins, gh, order)
               for x, y in zip(s[:3], (b, g, o)))
    return ((_ptrs(bins), _ptrs(gh), _ptrs(order),
             [o.shape[0] for o in order]), (bins, gh, order), not kept)


def _fused_geometry(ws, lib, f, num_bins, chunk, mode) -> tuple:
    """``(group, copies, sys, blocks per rank the mesh holds, ring blocks,
    phase-1 items per row tile)`` of the fused kernel on ``ws``'s mesh."""
    D = len(ws.slots)
    budget = ws.fused_smem_budget(lib)
    group = fused_group(f, num_bins, chunk, D, budget)
    reps = seg_replicas(group, num_bins, FUSED_THREADS // 32, budget)
    smem = seg_smem(group, reps, num_bins, FUSED_THREADS // 32)
    sys = int(len(ws.cards) > 1)
    nb_cap = ws.blocks(("fused", mode, sys, smem), lambda n_local:
                       lib.fused_hist_ring_blocks(mode, sys, smem, n_local))
    sub_items = sum(-(-(fb - fa) // group) for fa, fb in
                    fused_chunk_features(f, num_bins, chunk, D))
    return (group, reps, sys, nb_cap, min(-(-chunk // FUSED_THREADS), nb_cap),
            sub_items)


def fused_segment_hist_ring_cuda(shards, num_bins: int, mesh,
                                 accum: str = "float32"
                                 ) -> List[torch.Tensor]:
    """Gather → segment histogram → ring all-reduce in one kernel launch
    per card.  ``shards[d] = (bins, gh, row_order, off, cnt)`` on
    ``mesh.devices[d]``: ``(n_d, f)`` uint8 bins (< ``num_bins`` ≤ 256),
    ``(n_d, 3)`` gh, int32 ``row_order`` and the segment
    ``row_order[off:off+cnt]``.  ``accum``: ``"float32"`` or ``"int32"``.
    Returns the reduced ``(f, num_bins, 3)`` histogram on every shard's
    device."""
    if accum not in _MODES:
        raise ValueError(f"fused_segment_hist_ring accumulates in "
                         f"{sorted(_MODES)}, got {accum!r}")
    if not 1 <= num_bins <= FUSED_MAX_BINS:
        raise ValueError(f"the ring histogram kernel takes "
                         f"1..{FUSED_MAX_BINS} bins, got "
                         f"{num_bins}")
    if len(shards) != len(mesh):
        raise ValueError(f"{len(shards)} bins for a mesh of {len(mesh)}")
    out_dtype = _out_dtype(accum)
    lib = _lib()
    D = len(mesh)
    key = _shards_key(shards)
    f = shards[0][0].shape[1]
    total = f * num_bins * 3
    chunk = ring_chunk(total, D)
    ws = _workspace(mesh, "fused", total, chunk, out_dtype)
    hit = ws.pointers.get(key)
    if hit is None:
        # `pointed` keeps converted copies alive through the launch
        hit, pointed, converted = _fused_pointers(shards, mesh, out_dtype)
        if not converted:   # the pointers are the caller's tensors'
            if len(ws.pointers) >= _POINTER_CACHE:
                ws.pointers.clear()
            ws.pointers[key] = hit
    bins_p, gh_p, order_p, lengths = hit
    offs, cnts = [], []
    for (_, _, _, off, cnt), length in zip(shards, lengths):
        if off < 0 or cnt < 0 or off + cnt > length:
            raise ValueError(f"segment [{off}, {off + cnt}) lies outside "
                             f"row_order of length {length}")
        offs.append(int(off))
        cnts.append(int(cnt))
    mode = _MODES[accum]
    # one workspace serves every (f, B) of the same payload size, and the
    # group, copies and block counts follow f and B
    shape = (f, num_bins, mode)
    geo = ws.fused_geometry.get(shape)
    if geo is None:
        geo = ws.fused_geometry[shape] = _fused_geometry(ws, lib, f, num_bins,
                                                         chunk, mode)
    group, reps, sys, nb_cap, nb_ring, sub_items = geo
    tiles, nb = fused_grid(cnts, sub_items, nb_cap, nb_ring)
    out = [torch.empty(f, num_bins, 3, dtype=out_dtype, device=d)
           for d in mesh.devices]
    seq = ws.next_seq()
    args = (bins_p, gh_p, order_p, (ctypes.c_int64 * (3 * D))(
        *offs, *cnts, *tiles), ws.work_p, ws.ready_p, _ptrs(out), ws.slots_p,
        ws.flags_p, f, num_bins, mode, sys, group, reps, chunk, seq, nb,
        nb_ring)
    for dev, ranks in ws.cards.items():
        rc = _on_card(dev, lib.fused_hist_ring_launch, D, len(ranks),
                      ws.local[dev], *args, _stream(dev))
        _raise_if_failed(rc, "fused_segment_hist_ring")
    fused_segment_hist_ring_cuda.launches += 1
    return out


fused_segment_hist_ring_cuda.launches = 0
