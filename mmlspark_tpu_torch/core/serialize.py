"""Stage persistence.

The port's copy of ``mmlspark_tpu/core/serialize.py``; the directory
format is the same, so a stage saved by either package loads in the
other::

    <path>/metadata.json     {"class": ..., "module": ..., "params": {...}}
    <path>/...               extra files a stage chooses to write

Stages holding non-Param state override ``_save_extra``/``_load_extra``.
A class resolves by its bare name in the port's registry: the port never
imports a module outside ``mmlspark_tpu_torch``, so a directory written
by the reference (its metadata names ``mmlspark_tpu.…`` modules, which
need jax) loads into the port's class of the same name.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any, List

import numpy as np

FORMAT_VERSION = 1


def _json_default(obj: Any):
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    raise TypeError(f"Param value {obj!r} is not JSON-serializable")


def save_stage(stage, path: str, overwrite: bool = False) -> None:
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(
            f"Path {path!r} exists; pass overwrite=True to replace")
    # Write into a sibling temp dir and swap at the end, so a failed save
    # never destroys an existing good artifact.
    parent = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp_save_", dir=parent)
    try:
        meta = {
            "class": type(stage).__name__,
            "module": type(stage).__module__,
            "format_version": FORMAT_VERSION,
            "params": {k: v for k, v in stage._iterSetParams()},
        }
        with open(os.path.join(tmp, "metadata.json"), "w") as f:
            json.dump(meta, f, indent=2, default=_json_default)
        stage._save_extra(tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)


def load_stage(path: str):
    meta_path = os.path.join(path, "metadata.json")
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"No stage metadata at {meta_path}")
    with open(meta_path) as f:
        meta = json.load(f)
    cls = _resolve_class(meta["class"], meta.get("module"))
    stage = cls.__new__(cls)
    # Re-run minimal init: Params.__init__ without subclass positional args.
    stage._paramMap = {}
    for k, v in meta.get("params", {}).items():
        stage.set(k, v)
    stage._load_extra(path)
    return stage


#: the port's package: the only modules stage loading may import
_PACKAGE = "mmlspark_tpu_torch"


def _resolve_class(name: str, module: str):
    """The port's stage class ``name``.  An exact ``(module, name)``
    registration wins, else the bare name; a module not imported yet is
    imported only when it lies in the port (a reference module
    ``mmlspark_tpu.x`` maps to ``mmlspark_tpu_torch.x``)."""
    from .pipeline import _ALL_STAGES

    def lookup():
        cls = _ALL_STAGES.get((module, name))
        if cls is None:
            cls = _ALL_STAGES.get(name)
        return cls

    cls = lookup()
    if cls is None and module:
        head, _, rest = module.partition(".")
        if head == "mmlspark_tpu":
            module = f"{_PACKAGE}.{rest}" if rest else _PACKAGE
        if module == _PACKAGE or module.startswith(_PACKAGE + "."):
            import importlib
            try:
                importlib.import_module(module)  # registers its stages
            except ModuleNotFoundError as e:
                if e.name != module:
                    raise
            cls = lookup()
    if cls is None:
        raise KeyError(f"Unknown stage class {name!r} (module {module!r})")
    return cls


def save_stage_list(stages: List[Any], path: str) -> None:
    os.makedirs(path, exist_ok=True)
    order = []
    for i, stage in enumerate(stages):
        name = f"{i}_{type(stage).__name__}"
        order.append(name)
        save_stage(stage, os.path.join(path, name), overwrite=True)
    with open(os.path.join(path, "order.json"), "w") as f:
        json.dump(order, f)


def load_stage_list(path: str) -> List[Any]:
    with open(os.path.join(path, "order.json")) as f:
        order = json.load(f)
    return [load_stage(os.path.join(path, name)) for name in order]


class StageWriter:
    """Spark-style ``stage.write().overwrite().save(path)`` shim."""

    def __init__(self, stage):
        self._stage = stage
        self._overwrite = False

    def overwrite(self) -> "StageWriter":
        self._overwrite = True
        return self

    def save(self, path: str) -> None:
        save_stage(self._stage, path, overwrite=self._overwrite)


class StageReader:
    """Spark-style ``Cls.read().load(path)`` shim."""

    def __init__(self, cls):
        self._cls = cls

    def load(self, path: str):
        stage = load_stage(path)
        if not isinstance(stage, self._cls):
            raise TypeError(
                f"Loaded {type(stage).__name__}, expected {self._cls.__name__}")
        return stage
