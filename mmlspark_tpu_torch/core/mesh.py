"""Device mesh — the port's counterpart of ``mmlspark_tpu/core/mesh.py``.

The reference is single-controller SPMD: one process drives every device
of a host through ``shard_map`` over a ``jax.sharding.Mesh``.  The port
keeps the single controller and drops the compiler: a :class:`Mesh` is an
ordered tuple of ``torch.device``\\ s laid out as ``(data, feature)`` in
row-major order (device ``k`` is data shard ``k // F`` and feature slice
``k % F``, as the reference reshapes its device list), and one host loop
drives all of them in lockstep (``gbdt/distributed.py``).  A device may
appear more than once: several shards on one card are the port's
counterpart of the reference's forced host device count, and
``devices=["cpu"] * D`` is how the CPU tests run a mesh.

Axes: ``DATA_AXIS`` (row parallelism: data, voting) and ``FEATURE_AXIS``
(the feature-parallel learner; both for data+feature).

**A gang of controllers** (the reference's multi-controller mesh under
``jax.distributed``): once a ``torch.distributed`` group is initialized,
a mesh built in each of its P processes is one mesh of the gang.  Each
process lists its own devices only; the data axis is global, P times the
process's data shards, in process-major order as jax orders its devices
(process ``p`` holds data shards ``[p·Dl, (p+1)·Dl)``, ``Dl`` its local
count, the same in every process).  A feature axis stays inside one
process.  Cross-shard reductions gather every process's parts
(:func:`..ops.collectives.gang_gather`).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

DATA_AXIS = "data"
FEATURE_AXIS = "feature"

_active_mesh: Optional["Mesh"] = None


def gang_topology() -> Tuple[int, int]:
    """``(process_index, process_count)`` of the initialized
    ``torch.distributed`` group, else ``(0, 1)``."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A ``(data, feature)`` grid of devices: data shard ``d``'s feature
    slice ``j`` lives on ``devices[d * feature + j]``.  ``feature=1`` (the
    default) is a mesh of data shards alone, shard ``d`` on
    ``devices[d]``.

    ``scratch`` holds per-mesh device workspaces that kernels allocate
    once and reuse (the ring collectives' comm slots and flags).

    In a gang (``process_count`` > 1, by default read from the
    initialized ``torch.distributed`` group: :func:`gang_topology`)
    ``devices`` are this process's, and the data axis counts every
    process's shards: this process holds data shards ``data_offset …
    data_offset + local_data − 1``."""

    def __init__(self, devices: Sequence[DeviceLike], feature: int = 1,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None):
        devs = tuple(resolve_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in devs}
        if len(kinds) != 1:
            raise ValueError(f"a mesh's devices must share one type, got "
                             f"{sorted(kinds)}")
        if process_count is None:
            process_index, process_count = gang_topology()
        if not 0 <= process_index < process_count:
            raise ValueError(f"process {process_index} of a gang of "
                             f"{process_count}")
        if feature < 1 or len(devs) % feature:
            if process_count > 1:
                raise ValueError(
                    f"a feature axis of {feature} would span processes: "
                    f"each of the gang's {process_count} processes holds "
                    f"{len(devs)} devices, and a feature axis stays inside "
                    "one controller")
            raise ValueError(f"{len(devs)} devices do not form a mesh with "
                             f"a feature axis of {feature}")
        self.devices: Tuple[torch.device, ...] = devs
        self.feature = feature
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.scratch: dict = {}

    @property
    def local_data(self) -> int:
        """This process's data shards."""
        return len(self.devices) // self.feature

    @property
    def data(self) -> int:
        """Size of the data axis (every process's shards)."""
        return self.local_data * self.process_count

    @property
    def data_offset(self) -> int:
        """The global index of this process's first data shard."""
        return self.local_data * self.process_index

    @property
    def is_gang(self) -> bool:
        """Whether the mesh spans more than one process."""
        return self.process_count > 1

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, FEATURE_AXIS: self.feature}

    @property
    def device_type(self) -> str:
        return self.devices[0].type

    def __len__(self) -> int:
        """This process's devices."""
        return len(self.devices)

    def __repr__(self) -> str:
        gang = (f", process={self.process_index}/{self.process_count}"
                if self.is_gang else "")
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"shape={self.shape}{gang})")


def build_mesh(data: Optional[int] = None, feature: int = 1,
               devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A ``data × feature`` mesh over ``devices`` (default: every CUDA card
    of the host, once each; raises without a GPU), in row-major order.
    ``data`` defaults to the number of devices over ``feature``; the two
    must cover the devices exactly (the reference's checks).  In a gang
    ``devices`` are this process's and ``data`` is the global data axis,
    which the P processes' devices cover together."""
    if devices is None:
        resolve_device("cuda")   # raises without a GPU
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devs = list(devices)
    pid, procs = gang_topology()
    n = len(devs) * procs
    if data is None:
        if feature < 1 or n % feature:
            raise ValueError(f"{n} devices not divisible by "
                             f"feature={feature}")
        data = n // feature
    if data * feature != n:
        raise ValueError(f"a mesh of {data} x {feature} (data x feature) "
                         f"needs {data * feature} devices, got {n}"
                         + (f" ({len(devs)} in each of {procs} processes)"
                            if procs > 1 else ""))
    return Mesh(devs, feature, pid, procs)


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
    """Size of the data axis."""
    return (mesh or get_mesh()).data


def pad_to_multiple(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def shard_rows(x: np.ndarray, mesh: Mesh, pad_value=0
               ) -> Tuple[np.ndarray, int]:
    """Pad the leading axis to a multiple of the data-axis size (the pad rows
    go at the end).  Returns ``(padded array, original length)``; shard
    ``d`` then holds rows ``[d·S, (d+1)·S)`` of the padded array."""
    k = num_workers(mesh)
    n = x.shape[0]
    m = pad_to_multiple(max(n, k), k)
    if m == n:
        return x, n
    pad = np.full((m - n,) + x.shape[1:], pad_value, dtype=x.dtype)
    return np.concatenate([x, pad], axis=0), n
