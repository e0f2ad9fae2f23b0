"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled for Hopper (``sm_90a``) into a shared
library with a plain C interface, at first use, into ``_build/`` beside
this package (listed in ``.gitignore``).  The library's file name carries a
hash of the source, the shared ``csrc/*.cuh`` headers and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  A
failed build raises.  Each build (``nvcc_build``) and each load
(``cuda_load``) joins the profiler's build ledger
(:meth:`..core.profiler.Profiler.record_build`).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

from ..core.profiler import get_profiler

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under /usr/local/cuda/bin); "
        "the CUDA kernels of mmlspark_tpu_torch cannot be built")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def build_all(names: List[str]) -> Dict[str, Tuple[Path, float, str]]:
    """Compile every named source that has no library yet, one ``nvcc``
    per source, all started together.  Returns ``{name: (library path,
    build seconds, compiler log)}``; raises ``RuntimeError`` when a build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    out: Dict[str, Tuple[Path, float, str]] = {}
    for name in names:
        lib = _lib_path(name)
        if lib.exists():
            out[name] = (lib, 0.0, "")
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), lib, tmp)
    failed = []
    for name, (proc, t0, lib, tmp) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, lib)
        get_profiler().record_build("nvcc_build", secs)
        out[name] = (lib, secs, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, building it first if
    needed.  Loaded once per process."""
    lib_path, _, _ = build_all([name])[name]
    t0 = time.perf_counter()
    lib = ctypes.CDLL(str(lib_path))
    get_profiler().record_build("cuda_load", time.perf_counter() - t0)
    return lib
