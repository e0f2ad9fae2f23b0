"""Data-shard mesh — the port's counterpart of ``mmlspark_tpu/core/mesh.py``.

The reference is single-controller SPMD: one process drives every device
of a host through ``shard_map`` over a ``jax.sharding.Mesh``.  The port
keeps the single controller and drops the compiler: a :class:`Mesh` is an
ordered tuple of ``torch.device``\\ s, one per data shard, and one host loop
drives all shards in lockstep (``gbdt/distributed.py``).  A device may
appear more than once: D shards on one card are the port's counterpart of
the reference's forced host device count, and ``devices=["cpu"] * D`` is
how the CPU tests run a mesh.

There is one axis, ``DATA_AXIS`` (row parallelism); the reference's
``feature`` axis belongs to the feature-parallel learner, which is not
ported.  No ``jax.distributed`` counterpart: multi-host training is not
ported either (ROADMAP.md Queue A).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

DATA_AXIS = "data"

_active_mesh: Optional["Mesh"] = None


class Mesh:
    """Ordered data shards: shard ``d`` lives on ``devices[d]``.

    ``scratch`` holds per-mesh device workspaces that kernels allocate
    once and reuse (the ring collectives' comm slots and flags)."""

    def __init__(self, devices: Sequence[DeviceLike]):
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's devices must share one type, got "
                             f"{sorted(kinds)}")
        self.devices: Tuple[torch.device, ...] = devs
        self.scratch: dict = {}

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: len(self.devices)}

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def __len__(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def build_mesh(data: Optional[int] = None,
               devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh of ``data`` shards over ``devices`` (default: every CUDA
    card of the host, one shard each; raises without a GPU).  ``data``
    defaults to the number of devices and must equal it otherwise."""
    if devices is None:
        resolve_device("cuda")   # raises without a GPU
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    if data is None:
        data = len(devs)
    if data != len(devs):
        raise ValueError(f"a mesh of {data} data shards needs {data} "
                         f"devices, got {len(devs)}")
    return Mesh(devs)


def get_mesh() -> Mesh:
    """The active mesh (set via :func:`use_mesh`), else a fresh default."""
    if _active_mesh is not None:
        return _active_mesh
    return build_mesh()


@contextmanager
def use_mesh(mesh: Mesh) -> Iterator[Mesh]:
    global _active_mesh
    prev = _active_mesh
    _active_mesh = mesh
    try:
        yield mesh
    finally:
        _active_mesh = prev


def num_workers(mesh: Optional[Mesh] = None) -> int:
    return len(mesh or get_mesh())


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def shard_rows(x: np.ndarray, mesh: Mesh, pad_value=0
               ) -> Tuple[np.ndarray, int]:
    """Pad the leading axis to a multiple of the shard count (the pad rows
    go at the end).  Returns ``(padded array, original length)``; shard
    ``d`` then holds rows ``[d·S, (d+1)·S)`` of the padded array."""
    k = num_workers(mesh)
    n = x.shape[0]
    m = pad_to_multiple(max(n, k), k)
    if m == n:
        return x, n
    pad = np.full((m - n,) + x.shape[1:], pad_value, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0), n
