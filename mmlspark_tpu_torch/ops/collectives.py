"""Cross-shard histogram reductions — the port's counterpart of the ring
part of ``mmlspark_tpu/ops/pallas_collectives.py``.

A reduction takes one partial per data shard (``parts[d]`` on
``mesh.devices[d]``) and returns the sum.  Two orders exist, as in the
reference, and each has a plain twin that adds in exactly that order:

``psum``
    :func:`psum_plain`, the sequential sum in device order
    ``((x_0 + x_1) + x_2) + …`` — what XLA's CPU ``lax.psum`` computes,
    bit for bit.  The default collective (``collective="auto"``).
``ring``
    :func:`ring_allreduce_plain`, the order of the reference's ring
    kernel: the flattened array is cut into D chunks of ``cb·128``
    elements (``cb = ceil(ceil(total/128)/D)``, as ``_ring_flat`` pads),
    and chunk ``c`` is summed starting at shard ``c``:
    ``((x_c + x_{c+1}) + x_{c+2}) + …``, indices mod D.  On CUDA tensors
    :func:`ring_allreduce` launches a kernel of ``csrc/ring.cu``
    (:mod:`.cuda_ring`) that adds in the same order and so equals the twin
    bit for bit: where every shard lies on one card the direct kernel (one
    ordinary launch, each element summed from its chunk's shard on), where
    the mesh spans cards the ring (:func:`.cuda_ring.ring_route`, by the
    mesh's layout alone).

:func:`ring_allreduce_select` (the reference's voted-column ring of the
PV-Tree learner) gathers the candidate columns of each shard's local
histogram (:func:`gather_cand`) and ring-reduces only that slab; its twin
is :func:`ring_allreduce_select_plain`, the gather followed by
:func:`ring_allreduce_plain` over the flattened slab.  On CUDA tensors it
launches the direct select kernel on one card or the ``ring_select``
kernel across cards, routed as above; both gather in-kernel.

:func:`fused_segment_hist_ring` (the reference's kernel of the same name)
gathers each shard's segment, histograms it and ring-reduces the result;
its twin is :func:`..cuda_histogram.histogram_fused_plain` per shard
followed by :func:`ring_allreduce_plain`.

Integer (quantized) parts ride the dense and select rings as f32 lanes
and are cast back, as the reference's ``_ring_flat`` does: the kernels
and the twins add float32, which is exact while every sum stays below
2**24 (the engine's ``_resolve_quantized`` keeps a ring fit there).

**A gang of controllers** (a mesh over several processes,
:class:`..core.mesh.Mesh` ``is_gang``): :func:`gang_gather` all-gathers
every process's local parts over ``torch.distributed``, so that each
process holds all D parts in shard order and sums them with the same
:func:`psum_plain`; the sum is then the one-controller mesh's bit for bit,
at any D and any number of processes.  ``all_reduce`` would add in the
backend's order instead.  Under gloo, CUDA parts are staged through host
memory.  The rings reduce within one process only; a gang refuses them
(the engine raises).

On a CUDA tensor the ring entries launch their kernels or raise: there is
no fallback to a twin or to a library collective.  The reference's TPU
VMEM gates (``RING_MAX_BYTES``, ``FUSED_RING_MAX_BINST_BYTES``) are
dropped: on the card both kernels work from device memory.
"""

from __future__ import annotations

import time
from typing import List, Sequence

import torch

from . import cuda_ring
from .cuda_histogram import histogram_fused_plain
from .cuda_ring import ring_chunk


def psum_plain(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Sequential sum in shard order, on the first shard's device."""
    dev = parts[0].device
    acc = parts[0].clone()
    for p in parts[1:]:
        acc = acc + p.to(dev)
    return acc


#: This process's all-gathers across a gang: how many, the bytes of
#: every part they delivered (its own included), and the host seconds
#: they took (staging through host memory included).
gang_stats = {"gathers": 0, "bytes": 0, "seconds": 0.0}


def is_gang(mesh) -> bool:
    """Whether ``mesh`` spans more than one process."""
    return mesh is not None and getattr(mesh, "process_count", 1) > 1


def gang_gather(parts: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Every process's ``parts`` (its local shards' tensors, all of one
    shape and dtype, the same in every process) in global shard order —
    process-major, as the gang's mesh numbers its data shards — on
    ``parts[0]``'s device.  One ``torch.distributed.all_gather`` of the
    stacked parts; under a backend other than nccl, CUDA parts travel
    through host memory.  Off a gang: ``parts`` as they are."""
    if not is_gang(mesh):
        return list(parts)
    import torch.distributed as dist
    t0 = time.perf_counter()
    dev = parts[0].device
    x = torch.stack([p.to(dev) for p in parts])
    if x.is_cuda and dist.get_backend() != "nccl":
        x = x.cpu()
    out = [torch.empty_like(x) for _ in range(mesh.process_count)]
    dist.all_gather(out, x.contiguous())
    full = torch.cat(out).to(dev)
    gang_stats["gathers"] += 1
    gang_stats["bytes"] += full.numel() * full.element_size()
    gang_stats["seconds"] += time.perf_counter() - t0
    return list(full.unbind(0))


def gang_barrier(mesh) -> None:
    """Wait for every process of ``mesh``'s gang (nothing off a gang)."""
    if is_gang(mesh):
        import torch.distributed as dist
        dist.barrier()


def _f32_lanes(parts: Sequence[torch.Tensor]):
    """Integer parts as float32 lanes and the dtype to cast the sum back
    to; float parts as they are (and None)."""
    dtype = parts[0].dtype
    if dtype.is_floating_point:
        return parts, None
    return [p.to(torch.float32) for p in parts], dtype


def _cast_back(out, dtype):
    if dtype is None:
        return out
    if isinstance(out, torch.Tensor):
        return out.to(dtype)
    return [o.to(dtype) for o in out]


def ring_allreduce_plain(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The ring kernel's sum, on the first shard's device: chunk ``c`` of
    the flattened array is added up starting at shard ``c`` (integer
    parts as f32 lanes, cast back)."""
    parts, dtype = _f32_lanes(parts)
    dev = parts[0].device
    D = len(parts)
    flat = [p.to(dev).reshape(-1) for p in parts]
    total = flat[0].numel()
    cs = ring_chunk(total, D)
    out = torch.empty_like(flat[0])
    for c in range(D):
        lo, hi = min(c * cs, total), min((c + 1) * cs, total)
        acc = flat[c][lo:hi].clone()
        for k in range(1, D):
            acc = acc + flat[(c + k) % D][lo:hi]
        out[lo:hi] = acc
    return _cast_back(out.view(parts[0].shape), dtype)


def resolve_collective(collective: str, data_shards: int = 0) -> str:
    """Resolve the training ``collective`` knob to ``"psum"`` or
    ``"ring"``: ``auto`` stays on psum, ``ring`` needs more than one data
    shard.  There is no compile probe: on the card a ring kernel that does
    not build or launch raises."""
    if collective in ("auto", "psum", ""):
        return "psum"
    if collective != "ring":
        raise ValueError(f"Unknown collective {collective!r}; "
                         "valid: auto, psum, ring")
    return "ring" if data_shards > 1 else "psum"


def ring_allreduce(parts: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """All-reduce of the float32 or integer ``parts`` (one per shard of
    ``mesh``): every shard gets the ring-order sum, on its own device.
    CUDA tensors go through :func:`.cuda_ring.ring_allreduce_cuda` (the
    direct kernel on one card, the ring across cards; integer parts as
    f32 lanes, cast back); CPU tensors through
    :func:`ring_allreduce_plain`."""
    if len(parts) != len(mesh):
        raise ValueError(f"{len(parts)} parts for a mesh of {len(mesh)} "
                         "shards")
    if parts[0].is_cuda:
        lanes, dtype = _f32_lanes(parts)
        return _cast_back(cuda_ring.ring_allreduce_cuda(lanes, mesh), dtype)
    out = ring_allreduce_plain(parts)
    return [out.to(d) for d in mesh.devices]


def gather_cand(hist: torch.Tensor, cand: torch.Tensor) -> torch.Tensor:
    """The voted candidate columns: ``(f, B, 3)[cand (k2,)]`` →
    ``(k2, B, 3)``, or the stacked children ``(m, f, B, 3)`` with ``cand
    (m, k2)`` → ``(m, k2, B, 3)`` (the reference's ``_gather_cand``)."""
    idx = cand.to(hist.device, torch.int64)
    if cand.dim() == 1:
        return hist.index_select(0, idx)
    return torch.stack([h.index_select(0, c) for h, c in zip(hist, idx)])


def ring_allreduce_select_plain(parts: Sequence[torch.Tensor],
                                cand: torch.Tensor) -> torch.Tensor:
    """Twin of :func:`ring_allreduce_select`: each shard's gathered slab,
    then the ring-order sum of the flattened slab (on the first shard's
    device; integer slabs as f32 lanes, cast back).  One shard: the
    gathered slab."""
    return ring_allreduce_plain([gather_cand(p, cand) for p in parts])


def ring_allreduce_select(parts: Sequence[torch.Tensor], cand: torch.Tensor,
                          mesh) -> List[torch.Tensor]:
    """Voted-column all-reduce over the shards of ``mesh``: the sum of
    ``gather_cand(parts[d], cand)``, on every shard's device.  CUDA tensors
    go through :func:`.cuda_ring.ring_allreduce_select_cuda` (the direct
    select kernel on one card, ``ring_select`` across cards; both gather
    in-kernel; integer parts as f32 lanes, cast back); CPU tensors through
    :func:`ring_allreduce_select_plain`."""
    if len(parts) != len(mesh):
        raise ValueError(f"{len(parts)} parts for a mesh of {len(mesh)} "
                         "shards")
    if len(parts) == 1:
        return [gather_cand(parts[0], cand)]
    if parts[0].is_cuda:
        lanes, dtype = _f32_lanes(parts)
        return _cast_back(cuda_ring.ring_allreduce_select_cuda(
            lanes, cand, mesh), dtype)
    out = ring_allreduce_select_plain(parts, cand)
    return [out.to(d) for d in mesh.devices]


def fused_segment_hist_ring_plain(shards, num_bins: int,
                                  accum: str = "float32") -> torch.Tensor:
    """Twin of :func:`fused_segment_hist_ring`: each shard's segment
    histogram, then the ring-order sum (on the first shard's device)."""
    return ring_allreduce_plain([
        histogram_fused_plain(b, g, o, off, cnt, num_bins, accum)
        for b, g, o, off, cnt in shards])


def fused_segment_hist_ring(shards, num_bins: int, mesh,
                            accum: str = "float32") -> List[torch.Tensor]:
    """Gather → segment histogram → ring all-reduce over the shards of
    ``mesh``.  ``shards[d] = (bins, gh, row_order, off, cnt)``: shard d's
    ``(n_d, f)`` bins, ``(n_d, 3)`` gh, its row permutation and the
    segment ``row_order[off:off+cnt]`` to histogram; ``cnt`` may differ
    between shards.  Returns the reduced ``(f, num_bins, 3)`` histogram on
    every shard's device (int32 when ``accum="int32"``)."""
    if len(shards) != len(mesh):
        raise ValueError(f"{len(shards)} shards for a mesh of {len(mesh)}")
    if shards[0][0].is_cuda:
        return cuda_ring.fused_segment_hist_ring_cuda(shards, num_bins,
                                                      mesh, accum)
    out = fused_segment_hist_ring_plain(shards, num_bins, accum)
    return [out.to(d) for d in mesh.devices]
