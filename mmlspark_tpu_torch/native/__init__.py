"""The reference's native host kernels: C++ for the host CPU, built with
``g++`` at first use and loaded with ctypes.

The port keeps its own copies of the reference's ``mmlspark_tpu/native``
sources, each with a plain C interface over pointers and sizes:

* ``fastbin.cc`` — :func:`bin_columns`, the BinMapper's quantization loop
  (``gbdt/binning.py`` ``BinMapper.transform_packed``, which every fit of
  at most 256 bins bins its rows with);
* ``fastforest.cc`` — :func:`predict_forest`, the early-exit forest walk
  of a CPU booster (``gbdt/booster.py``);
* ``fasthist.cc`` — the CPU fit's hot loop (``ops/histogram.py``'s
  ``"native"`` method, which ``"auto"`` takes on a CPU tensor): the full
  and segment histograms in f32 (:func:`hist`, :func:`seg_hist`) and on
  quantized int16 codes (:func:`qhist`, :func:`seg_qhist`), the in-place
  DataPartition split (:func:`partition`) and the numeric split scan
  (:func:`split`);
* ``fastio.cc`` — the binary datasource's directory scan
  (:func:`scan_dir`), thread-pool bulk read (:func:`read_files`,
  :func:`read_file`) and Spark-compatible murmur3 (:func:`murmur3_batch`),
  which ``io/binary.py`` reads through.

The loop bodies are the reference's, so the floats are its floats.  Each
source is compiled with the reference's flags (``CXX_FLAGS``: no
``-march=native`` and no ``-ffast-math``, either of which would let the
compiler contract multiply-adds and change the bits) into ``_build/``
beside this package (listed in ``.gitignore``), under a file name hashed
from the source, the compiler and the flags, so an edited source is
rebuilt and an unchanged one loaded as it is.  A failed build or load
raises ``RuntimeError`` with the compiler's log: there is no fallback.
Each build (``native_build``) and load (``native_load``) joins the
profiler's build ledger (:mod:`..core.profiler`).
The plain paths are reached only by naming them
(``histogram_method="segment"``, ``CompiledPredictor(backend="jit")``,
``BinMapper.transform``).

The wrappers take CPU tensors or numpy arrays, check every dtype, shape
and contiguity before passing a pointer, allocate the outputs, and count
their calls (``calls`` on each wrapper).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..core.profiler import get_profiler

#: the compiler and the reference's flags (mmlspark_tpu/native/__init__.py)
CXX = "g++"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
SOURCES = ("fastbin", "fastforest", "fasthist", "fastio")
NATIVE_DIR = Path(__file__).resolve().parent
BUILD_DIR = NATIVE_DIR.parent / "_build"

_P, _I, _I32, _I64 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int32,
                      ctypes.c_int64)
#: every C entry's argument types, by source
_SIGNATURES = {
    "fastbin": {"mmlspark_bin_columns": [
        _P, _I, _I64, _I64, _P, _I64, _P, _P, _I64, _P, _P, _P, _I, _P]},
    "fastforest": {"mmlspark_predict_forest": [
        _P, _I64, _I64, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
        _I64, _I64, _I64, _I64, _I64, _I, _I, _I, _P]},
    "fasthist": {
        "mmlspark_hist": [_P, _P, _I64, _I64, _I64, _P],
        "mmlspark_seg_hist": [_P, _P, _I64, _I64, _P, _I64, _I64, _I64,
                              _I64, _P],
        "mmlspark_partition": [_P, _I64, _P, _I64, _I64, _I64, _I32, _I,
                               _P, _I64, _P],
        "mmlspark_split": [_P, _I64, _I64, _P, _P, _P, _P, _P],
        "mmlspark_qhist": [_P, _P, _I64, _I64, _I64, _I, _I64, _P],
        "mmlspark_seg_qhist": [_P, _P, _I64, _I64, _P, _I64, _I64, _I64,
                               _I64, _I, _I64, _P]},
    "fastio": {
        "mmlspark_io_free": [_P],
        "mmlspark_scan_dir": [ctypes.c_char_p, ctypes.c_char_p, _I, _P,
                              _P, _P],
        "mmlspark_file_sizes": [_P, _I64, _P],
        "mmlspark_read_files": [_P, _I64, _P, _P, _I],
        "mmlspark_murmur3_batch": [_P, _P, _I64, ctypes.c_uint32, _P]},
}
#: return types other than the status ``int``
_RESTYPES = {"mmlspark_io_free": None, "mmlspark_file_sizes": None,
             "mmlspark_read_files": _I64, "mmlspark_murmur3_batch": None}

Array = Union[np.ndarray, torch.Tensor]


def lib_path(name: str) -> Path:
    """Where source ``<name>.cc`` builds to: a hash of the source, the
    compiler and the flags names the library."""
    src = (NATIVE_DIR / f"{name}.cc").read_bytes()
    key = hashlib.sha256(src + " ".join((CXX,) + CXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{key.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> Dict[str, Tuple[Path, float]]:
    """Compile every named source that has no library yet, one compiler
    process a source, all started together.  Returns ``{name: (library
    path, build seconds)}``; raises ``RuntimeError`` with the compiler's
    log when the compiler is missing or a build fails."""
    out: Dict[str, Tuple[Path, float]] = {}
    procs = {}
    for name in names:
        lib = lib_path(name)
        if lib.exists():
            out[name] = (lib, 0.0)
            continue
        cxx = shutil.which(CXX)
        if cxx is None:
            raise RuntimeError(
                f"the C++ compiler {CXX!r} was not found on PATH; the "
                f"native host kernels of mmlspark_tpu_torch ({name}.cc) "
                "cannot be built")
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [cxx, *CXX_FLAGS, str(NATIVE_DIR / f"{name}.cc"), "-o",
               str(tmp)]
        procs[name] = (cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), time.perf_counter(), lib, tmp)
    failed = []
    for name, (cmd, proc, t0, lib, tmp) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"{' '.join(cmd)} (exit {proc.returncode}):\n"
                          f"{log}")
            continue
        os.replace(tmp, lib)
        secs = time.perf_counter() - t0
        get_profiler().record_build("native_build", secs)
        out[name] = (lib, secs)
    if failed:
        raise RuntimeError("the native build failed: " + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The library of ``<name>.cc``, built first if needed, with every
    entry's argument types declared.  Loaded once per process."""
    path = build_all([name])[name][0]
    t0 = time.perf_counter()
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"cannot load {path}: {e}") from e
    get_profiler().record_build("native_load", time.perf_counter() - t0)
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _RESTYPES.get(fn, ctypes.c_int)
    return lib


def _ptr(a: Array, dtype, name: str, shape=None) -> int:
    """``a``'s data pointer after checking that it is a C-contiguous CPU
    array of ``dtype`` (a numpy dtype) and, where given, of ``shape``
    (``None`` entries match any extent)."""
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"{name}: the native kernels take CPU "
                             f"tensors, got one on {a.device}")
        ok = a.is_contiguous()
        dt = torch.empty(0, dtype=a.dtype).numpy().dtype
        ptr, got = a.data_ptr(), tuple(a.shape)
    else:
        ok = a.flags["C_CONTIGUOUS"]
        dt, ptr, got = a.dtype, a.ctypes.data, a.shape
    if dt != np.dtype(dtype):
        raise TypeError(f"{name}: expected {np.dtype(dtype)}, got {dt}")
    if not ok:
        raise ValueError(f"{name} must be C-contiguous")
    if shape is not None and (len(got) != len(shape) or any(
            s is not None and s != g for s, g in zip(shape, got))):
        raise ValueError(f"{name}: expected shape {shape}, got {got}")
    return ptr


def _check(rc: int, fn: str) -> None:
    """Raise for a C entry's failure: 1 is a host allocation or a worker
    thread that failed."""
    if rc != 0:
        raise RuntimeError(f"{fn} failed (code {rc}: out of host memory "
                           "or threads)")


# -- fastbin.cc ---------------------------------------------------------------

def bin_columns(X: np.ndarray, bext: np.ndarray, nb: np.ndarray,
                base: np.ndarray, lo: np.ndarray, scale: np.ndarray,
                use_table: np.ndarray, missing_bin: int,
                out: np.ndarray) -> None:
    """Bin ``X`` ``(n, f)`` (float32 or float64) into ``out`` ``(n, f)``
    uint8: ``bext`` ``(f, m)`` bounds of X's dtype, ``nb`` ``(f,)`` int32
    bounds a feature, ``base`` ``(f, C)`` int32 grid hints, ``lo`` and
    ``scale`` ``(f,)`` float32 grid origin and inverse cell width,
    ``use_table`` ``(f,)`` uint8 (see ``fastbin.cc``)."""
    if X.ndim != 2 or X.dtype not in (np.float32, np.float64):
        raise TypeError("X must be 2-D float32 or float64")
    n, f = X.shape
    m, cells = bext.shape[1], base.shape[1]
    args = (_ptr(X, X.dtype, "X"), int(X.dtype == np.float64), n, f,
            _ptr(bext, X.dtype, "bext", (f, None)), m,
            _ptr(nb, np.int32, "nb", (f,)),
            _ptr(base, np.int32, "base", (f, None)), cells,
            _ptr(lo, np.float32, "lo", (f,)),
            _ptr(scale, np.float32, "scale", (f,)),
            _ptr(use_table, np.uint8, "use_table", (f,)), int(missing_bin),
            _ptr(out, np.uint8, "out", (n, f)))
    bin_columns.calls += 1
    _check(load("fastbin").mmlspark_bin_columns(*args),
           "mmlspark_bin_columns")


bin_columns.calls = 0


# -- fastforest.cc ------------------------------------------------------------

#: the stacked forest's arrays, in the C entry's order, with their dtypes
FOREST_ARRAYS = (("feat", np.int32), ("thr", np.float32),
                 ("left", np.int32), ("right", np.int32),
                 ("leaf", np.float32), ("single", np.uint8),
                 ("is_cat", np.int32), ("dleft", np.int32),
                 ("cat_bnd", np.int32), ("cat_words", np.uint32))


def predict_forest(X: Array, forest: dict, K: int, has_cat: bool,
                   out: Array, n_threads: int = 0) -> None:
    """Add the margins of ``forest`` (``FOREST_ARRAYS``: every per-node
    array ``(T, m)``, ``leaf`` ``(T, L)``, ``single`` ``(T,)``,
    ``cat_bnd`` ``(T, C1)``, ``cat_words`` ``(T, W)``) over the float32
    rows ``X`` ``(n, f)`` into ``out`` ``(n, K)`` float32, tree t into
    class ``t % K``, in tree order.  ``n_threads`` <= 0 takes every
    hardware thread (from 4,096 rows)."""
    feat = forest["feat"]
    if X.ndim != 2 or feat.ndim != 2:
        raise ValueError("X and feat must be 2-D")
    n, f = X.shape
    T, m = feat.shape
    L, C1, W = (forest[k].shape[1] for k in ("leaf", "cat_bnd",
                                             "cat_words"))
    if L < 1 or C1 < 2 or W < 1 or f < 1 or K < 1:
        raise ValueError("leaf/cat_bnd/cat_words/X widths and K must be "
                         ">= 1 (cat_bnd >= 2)")
    shapes = {"feat": (T, m), "thr": (T, m), "left": (T, m),
              "right": (T, m), "is_cat": (T, m), "dleft": (T, m),
              "leaf": (T, L), "single": (T,), "cat_bnd": (T, C1),
              "cat_words": (T, W)}
    ptrs = [_ptr(forest[k], dt, k, shapes[k]) for k, dt in FOREST_ARRAYS]
    args = (_ptr(X, np.float32, "X", (n, f)), n, f, *ptrs, T, m, L, C1, W,
            int(K), int(bool(has_cat)), int(n_threads),
            _ptr(out, np.float32, "out", (n, K)))
    predict_forest.calls += 1
    _check(load("fastforest").mmlspark_predict_forest(*args),
           "mmlspark_predict_forest")


predict_forest.calls = 0


# -- fasthist.cc --------------------------------------------------------------

def _hist_out(f: int, num_bins: int, dtype) -> torch.Tensor:
    return torch.empty((f, num_bins, 3), dtype=dtype)


def hist(bins: torch.Tensor, gh: torch.Tensor, num_bins: int
         ) -> torch.Tensor:
    """``(n, f)`` uint8 bins, ``(n, 3)`` float32 gh → the ``(f, num_bins,
    3)`` float32 histogram, rows added in order."""
    n, f = bins.shape
    out = _hist_out(f, num_bins, torch.float32)
    args = (_ptr(bins, np.uint8, "bins"), _ptr(gh, np.float32, "gh", (n, 3)),
            n, f, num_bins, out.data_ptr())
    hist.calls += 1
    _check(load("fasthist").mmlspark_hist(*args), "mmlspark_hist")
    return out


def seg_hist(bins: torch.Tensor, gh: torch.Tensor, row_order: torch.Tensor,
             off: int, cnt: int, num_bins: int) -> torch.Tensor:
    """The float32 histogram of the rows ``row_order[off:off+cnt]``
    (int32 row ids), added in that order."""
    n, f = bins.shape
    out = _hist_out(f, num_bins, torch.float32)
    args = (_ptr(bins, np.uint8, "bins"), _ptr(gh, np.float32, "gh", (n, 3)),
            n, f, _ptr(row_order, np.int32, "row_order"),
            row_order.shape[0], int(off), int(cnt), num_bins, out.data_ptr())
    seg_hist.calls += 1
    _check(load("fasthist").mmlspark_seg_hist(*args), "mmlspark_seg_hist")
    return out


def qhist(bins: torch.Tensor, gh: torch.Tensor, num_bins: int, packed: bool,
          max_code: int) -> torch.Tensor:
    """``(n, 3)`` int16 grid codes → the exact ``(f, num_bins, 3)`` int32
    histogram; ``packed`` selects the packed-int64 single-add mode, exact
    under :func:`..ops.histogram.packed_accum_ok`."""
    n, f = bins.shape
    out = _hist_out(f, num_bins, torch.int32)
    args = (_ptr(bins, np.uint8, "bins"), _ptr(gh, np.int16, "gh", (n, 3)),
            n, f, num_bins, int(bool(packed)), int(max_code), out.data_ptr())
    qhist.calls += 1
    _check(load("fasthist").mmlspark_qhist(*args), "mmlspark_qhist")
    return out


def seg_qhist(bins: torch.Tensor, gh: torch.Tensor, row_order: torch.Tensor,
              off: int, cnt: int, num_bins: int, packed: bool,
              max_code: int) -> torch.Tensor:
    """:func:`qhist` of the rows ``row_order[off:off+cnt]``."""
    n, f = bins.shape
    out = _hist_out(f, num_bins, torch.int32)
    args = (_ptr(bins, np.uint8, "bins"), _ptr(gh, np.int16, "gh", (n, 3)),
            n, f, _ptr(row_order, np.int32, "row_order"),
            row_order.shape[0], int(off), int(cnt), num_bins,
            int(bool(packed)), int(max_code), out.data_ptr())
    seg_qhist.calls += 1
    _check(load("fasthist").mmlspark_seg_qhist(*args), "mmlspark_seg_qhist")
    return out


def partition(row_order: torch.Tensor, col: torch.Tensor, off: int,
              cnt: int, thr: int, use_cat: bool, bits: np.ndarray
              ) -> Tuple[int, int]:
    """Partition ``row_order[off:off+cnt]`` (int32, in place) stably into
    the rows whose uint8 bin ``col[row]`` is at most ``thr`` — or, with
    ``use_cat``, whose bit is set in the ``(W,)`` uint32 bitset ``bits``
    — then the rest.  Returns ``(cnt_left, cnt_right)``."""
    counts = np.zeros(2, np.int32)
    args = (_ptr(row_order, np.int32, "row_order"), row_order.shape[0],
            _ptr(col, np.uint8, "col"), col.shape[0], int(off), int(cnt),
            int(thr), int(bool(use_cat)), _ptr(bits, np.uint32, "bits"),
            bits.shape[0], counts.ctypes.data)
    partition.calls += 1
    _check(load("fasthist").mmlspark_partition(*args), "mmlspark_partition")
    return int(counts[0]), int(counts[1])


def split(hist_: torch.Tensor, parent: np.ndarray, fmask: torch.Tensor,
          conf: np.ndarray) -> Tuple[float, int, int]:
    """The numeric split scan of a ``(f, B, 3)`` float32 histogram:
    ``parent`` ``(3,)`` float32 totals, ``fmask`` ``(f,)`` float32,
    ``conf`` ``(6,)`` float32 [min_data_in_leaf, min_sum_hessian,
    lambda_l1, lambda_l2, gain_floor, depth_ok].  Returns ``(gain,
    feature, bin)``, the gain ``-inf`` unless above the floor."""
    f, B = hist_.shape[0], hist_.shape[1]
    gain = np.zeros(1, np.float32)
    fb = np.zeros(2, np.int32)
    args = (_ptr(hist_, np.float32, "hist", (f, B, 3)),
            f, B, _ptr(parent, np.float32, "parent", (3,)),
            _ptr(fmask, np.float32, "fmask", (f,)),
            _ptr(conf, np.float32, "conf", (6,)), gain.ctypes.data,
            fb.ctypes.data)
    split.calls += 1
    _check(load("fasthist").mmlspark_split(*args), "mmlspark_split")
    return float(gain[0]), int(fb[0]), int(fb[1])


for _fn in (hist, seg_hist, qhist, seg_qhist, partition, split):
    _fn.calls = 0

#: every wrapper that counts its calls, by name
COUNTED = {fn.__name__: fn for fn in (bin_columns, predict_forest, hist,
                                      seg_hist, qhist, seg_qhist, partition,
                                      split)}


# -- fastio.cc ----------------------------------------------------------------

def _c_strings(items) -> Tuple[ctypes.Array, list]:
    """A ``char*`` array over the UTF-8 bytes of ``items`` (and the bytes
    objects, which must outlive the call)."""
    raw = [s.encode("utf-8") for s in items]
    return (ctypes.c_char_p * max(len(raw), 1))(*raw), raw


def scan_dir(root: str, pattern: Optional[str] = None,
             recursive: bool = True) -> List[Tuple[str, int, float]]:
    """``[(path, size, mtime)]`` of the regular files under ``root`` whose
    name matches ``pattern`` (fnmatch; None: all): each directory's files
    sorted, then its subdirectories sorted; directory symlinks are not
    followed.  Raises ``OSError`` when a directory cannot be opened."""
    out, out_len, count = ctypes.c_void_p(), ctypes.c_int64(), \
        ctypes.c_int64()
    lib = load("fastio")
    rc = lib.mmlspark_scan_dir(
        root.encode("utf-8"),
        None if pattern is None else pattern.encode("utf-8"),
        int(bool(recursive)), ctypes.byref(out), ctypes.byref(out_len),
        ctypes.byref(count))
    try:
        buf = ctypes.string_at(out, out_len.value) if out.value else b""
    finally:
        lib.mmlspark_io_free(out)
    if rc == 2:
        raise OSError(buf.decode("utf-8", "replace"))
    _check(rc, "mmlspark_scan_dir")
    entries, off = [], 0
    for _ in range(count.value):
        (n,) = struct.unpack_from("<q", buf, off)
        path = buf[off + 8:off + 8 + n].decode("utf-8")
        size, mtime = struct.unpack_from("<qd", buf, off + 8 + n)
        entries.append((path, int(size), float(mtime)))
        off += 24 + n
    return entries


def read_files(paths: List[str], n_threads: int = 8) -> List[bytes]:
    """The bytes of every file of ``paths``, read on ``n_threads`` threads
    (a path that is not a regular file reads as ``b""``).  Raises
    ``OSError`` when a file fails to read or changes size."""
    paths = list(paths)
    n = len(paths)
    if n == 0:
        return []
    lib = load("fastio")
    cpaths, _keep = _c_strings(paths)
    sizes = np.zeros(n, np.int64)
    lib.mmlspark_file_sizes(cpaths, n, sizes.ctypes.data)
    offsets = np.concatenate([[0], np.cumsum(sizes)])
    block = np.empty(max(int(offsets[-1]), 1), np.uint8)
    bufs = (ctypes.c_void_p * n)(
        *[block.ctypes.data + int(o) for o in offsets[:-1]])
    if lib.mmlspark_read_files(cpaths, n, bufs, sizes.ctypes.data,
                               int(n_threads)) != 0:
        raise OSError("read_files: one or more files changed size or "
                      "failed to read")
    return [block[offsets[i]:offsets[i + 1]].tobytes() for i in range(n)]


def read_file(path: str) -> bytes:
    """The bytes of the regular file ``path``."""
    if not os.path.isfile(path):
        raise OSError(f"cannot stat {path}")
    return read_files([path], 1)[0]


def murmur3_batch(terms: List[str], seed: int = 42) -> List[int]:
    """Spark-compatible Murmur3_x86_32 of each term's UTF-8 bytes, as
    signed int32."""
    raw = [t.encode("utf-8") for t in terms]
    offsets = np.zeros(len(raw) + 1, np.int64)
    offsets[1:] = np.cumsum([len(r) for r in raw])
    data = np.frombuffer(b"".join(raw) or b"\0", np.uint8)
    out = np.zeros(len(raw), np.int32)
    load("fastio").mmlspark_murmur3_batch(
        data.ctypes.data, offsets.ctypes.data, len(raw),
        int(seed) & 0xFFFFFFFF, out.ctypes.data)
    return out.tolist()
