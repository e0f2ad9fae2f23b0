"""Binary file datasource — batch and streaming.

The port's copy of ``mmlspark_tpu/io/binary.py``: (path, bytes) rows from
a directory tree, with subsampling, usable in batch and streaming
queries.  The native engine (``native/fastio.cc``, built at first use)
does the directory scan and the thread-pool bulk read with the GIL
released; a failed build raises, there is no Python fallback.  The
per-file subsample hashes the path with :func:`murmur3_32`, the
reference's ``featurize/hashing.py`` function copied here.
"""

from __future__ import annotations

import time
from typing import Iterator, List, Optional

import numpy as np

from .. import native
from ..core.schema import DataTable


_MASK = 0xFFFFFFFF


def murmur3_32(data: bytes, seed: int = 42) -> int:
    """murmur3 x86 32-bit of ``data``; returns a *signed* int32 like the
    JVM (Spark's ``Murmur3_x86_32``)."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & _MASK
    n4 = len(data) // 4 * 4
    for i in range(0, n4, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * c1) & _MASK
        k = ((k << 15) | (k >> 17)) & _MASK
        k = (k * c2) & _MASK
        h ^= k
        h = ((h << 13) | (h >> 19)) & _MASK
        h = (h * 5 + 0xE6546B64) & _MASK
    tail = data[n4:]
    if tail:
        k = int.from_bytes(tail.ljust(4, b"\0"), "little")
        k = (k * c1) & _MASK
        k = ((k << 15) | (k >> 17)) & _MASK
        k = (k * c2) & _MASK
        h ^= k
    h ^= len(data)
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & _MASK
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & _MASK
    h ^= h >> 16
    return h - (1 << 32) if h >= (1 << 31) else h


def _scan(path: str, pattern: Optional[str],
          recursive: bool) -> List[tuple]:
    import os
    if os.path.isfile(path):
        st = os.stat(path)
        return [(path, int(st.st_size), float(st.st_mtime))]
    return native.scan_dir(path, pattern, recursive)


def _subsample(entries: List[tuple], sample_ratio: float,
               seed: int) -> List[tuple]:
    """Per-file Bernoulli subsample (BinaryFileFormat's subsample option).

    The keep/drop decision is a pure function of (path, seed) — NOT a
    positional draw — so a file's sampling fate is stable as new files
    appear in a streaming listing."""
    if sample_ratio >= 1.0:
        return entries
    thresh = sample_ratio * 2147483648.0
    return [e for e in entries
            if (murmur3_32(e[0].encode("utf-8"), seed) & 0x7FFFFFFF)
            < thresh]


def _table(entries: List[tuple], with_stats: bool = True) -> DataTable:
    paths = [e[0] for e in entries]
    blobs_list = native.read_files(paths)
    blobs = np.empty(len(paths), dtype=object)
    lengths = np.zeros(len(paths), dtype=np.int64)
    for i, b in enumerate(blobs_list):
        blobs[i] = b
        lengths[i] = len(b)
    cols = {
        "path": np.asarray(paths, dtype=object),
        "length": lengths,
        "bytes": blobs,
    }
    if with_stats:
        cols["modificationTime"] = np.asarray(
            [e[2] for e in entries], np.float64)
    return DataTable(cols)


def read_binary_files(path: str, pattern: Optional[str] = None,
                      recursive: bool = True, with_stats: bool = True,
                      *, sample_ratio: float = 1.0,
                      seed: int = 0) -> DataTable:
    """Directory tree → (path, length[, modificationTime], bytes) table.

    New options are keyword-only so pre-existing positional callers of
    ``(path, pattern, recursive, with_stats)`` keep their meaning."""
    entries = _subsample(_scan(path, pattern, recursive), sample_ratio, seed)
    return _table(entries, with_stats)


class BinaryFileReader:
    """Streaming binary datasource: iterate micro-batches of binary rows.

    Batch mode (``follow=False``) yields the directory's current contents
    in ``batch_size`` chunks.  Streaming mode (``follow=True``) keeps
    polling for NEW files (by path + mtime) every ``poll_interval``
    seconds and yields them as they appear — the reference's streaming
    ``readStream.format("binaryFile")`` behavior — until ``stop()`` is
    called or ``max_batches`` is reached.
    """

    def __init__(self, path: str, pattern: Optional[str] = None,
                 recursive: bool = True, batch_size: int = 64,
                 sample_ratio: float = 1.0, seed: int = 0,
                 follow: bool = False, poll_interval: float = 0.25,
                 max_batches: Optional[int] = None):
        self.path = path
        self.pattern = pattern
        self.recursive = recursive
        self.batch_size = batch_size
        self.sample_ratio = sample_ratio
        self.seed = seed
        self.follow = follow
        self.poll_interval = poll_interval
        self.max_batches = max_batches
        self._stopped = False

    def stop(self) -> None:
        self._stopped = True

    def __iter__(self) -> Iterator[DataTable]:
        seen: dict = {}
        emitted = 0
        while not self._stopped:
            entries = _subsample(
                _scan(self.path, self.pattern, self.recursive),
                self.sample_ratio, self.seed)
            fresh = [e for e in entries
                     if seen.get(e[0]) != e[2]]
            for e in fresh:
                seen[e[0]] = e[2]
            for i in range(0, len(fresh), self.batch_size):
                yield _table(fresh[i:i + self.batch_size])
                emitted += 1
                if self.max_batches and emitted >= self.max_batches:
                    return
                if self._stopped:
                    return
            if not self.follow:
                return
            time.sleep(self.poll_interval)
