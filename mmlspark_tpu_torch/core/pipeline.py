"""Estimator/Transformer/Pipeline protocol.

The port's copy of ``mmlspark_tpu/core/pipeline.py``.
``fit``/``transform`` take any supported table flavor (pandas / Arrow /
dict-of-arrays / DataTable) and return the same flavor — see
:mod:`mmlspark_tpu_torch.core.schema`.  Persistence is directory-based
(JSON params plus whatever extra files a stage writes) — see
:mod:`mmlspark_tpu_torch.core.serialize`.  Every concrete stage registers
itself: ``STAGE_REGISTRY`` (the public stages) drives the structural
fuzzing tests, ``_ALL_STAGES`` the class resolution of ``load``.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Type

from .params import Params
from .schema import DataTable, TableLike, from_table, to_table
from . import serialize

# public stages only — drives fuzzing coverage enforcement
STAGE_REGISTRY: Dict[str, Type["PipelineStage"]] = {}
# every concrete subclass — drives persistence class resolution; keyed both
# by (module, name) and by bare name (first registrant wins the bare key)
_ALL_STAGES: Dict[Any, Type["PipelineStage"]] = {}


class PipelineStage(Params):
    """Base of every stage.  Concrete subclasses auto-register."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if cls.__dict__.get("__abstractstage__", False):
            return
        _ALL_STAGES[(cls.__module__, cls.__name__)] = cls
        # Bare-name fallback for persistence across module moves and for
        # directories the reference wrote; first registrant wins so later
        # stubs cannot shadow a public stage.
        _ALL_STAGES.setdefault(cls.__name__, cls)
        if not cls.__name__.startswith("_"):
            STAGE_REGISTRY[cls.__name__] = cls

    # -- persistence ---------------------------------------------------------

    def save(self, path: str, overwrite: bool = False) -> None:
        serialize.save_stage(self, path, overwrite=overwrite)

    def write(self):  # Spark-API compatibility shim
        return serialize.StageWriter(self)

    @classmethod
    def load(cls, path: str) -> "PipelineStage":
        stage = serialize.load_stage(path)
        if not isinstance(stage, cls):
            raise TypeError(
                f"Loaded {type(stage).__name__}, expected {cls.__name__}")
        return stage

    @classmethod
    def read(cls):  # Spark-API compatibility shim
        return serialize.StageReader(cls)

    # -- optional hooks for stages holding non-Param state -------------------

    def _save_extra(self, path: str) -> None:
        """Persist non-Param state (arrays, vocab, ...) under ``path``."""

    def _load_extra(self, path: str) -> None:
        """Restore non-Param state saved by :meth:`_save_extra`."""


class Transformer(PipelineStage):
    __abstractstage__ = True

    def transform(self, dataset: TableLike) -> TableLike:
        table = to_table(dataset)
        out = self._transform(table)
        return from_table(out, dataset)

    def _transform(self, table: DataTable) -> DataTable:
        raise NotImplementedError


class Estimator(PipelineStage):
    __abstractstage__ = True

    def fit(self, dataset: TableLike, params: Optional[Dict[str, Any]] = None
            ) -> "Model":
        est = self.copy(params) if params else self
        table = to_table(dataset)
        return est._fit(table)

    def _fit(self, table: DataTable) -> "Model":
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer produced by an Estimator."""
    __abstractstage__ = True


class Pipeline(Estimator):
    """Chains stages; Estimators are fit in sequence, like Spark ML Pipeline."""

    def __init__(self, stages: Optional[List[PipelineStage]] = None, **kwargs):
        super().__init__(**kwargs)
        self._stages: List[PipelineStage] = list(stages or [])

    def setStages(self, stages: List[PipelineStage]) -> "Pipeline":
        self._stages = list(stages)
        return self

    def getStages(self) -> List[PipelineStage]:
        return list(self._stages)

    def _fit(self, table: DataTable) -> "PipelineModel":
        fitted: List[Transformer] = []
        current = table
        for i, stage in enumerate(self._stages):
            if isinstance(stage, Estimator):
                model = stage._fit(current)
                fitted.append(model)
                if i < len(self._stages) - 1:
                    current = model._transform(current)
            elif isinstance(stage, Transformer):
                fitted.append(stage)
                if i < len(self._stages) - 1:
                    current = stage._transform(current)
            else:
                raise TypeError(
                    f"Pipeline stage {i} is neither Estimator nor Transformer: "
                    f"{type(stage).__name__}")
        return PipelineModel(fitted)

    def _save_extra(self, path: str) -> None:
        serialize.save_stage_list(self._stages, os.path.join(path, "stages"))

    def _load_extra(self, path: str) -> None:
        self._stages = serialize.load_stage_list(os.path.join(path, "stages"))


class PipelineModel(Model):
    def __init__(self, stages: Optional[List[Transformer]] = None, **kwargs):
        super().__init__(**kwargs)
        self._stages: List[Transformer] = list(stages or [])

    @property
    def stages(self) -> List[Transformer]:
        return list(self._stages)

    def _transform(self, table: DataTable) -> DataTable:
        for stage in self._stages:
            table = stage._transform(table)
        return table

    def _save_extra(self, path: str) -> None:
        serialize.save_stage_list(self._stages, os.path.join(path, "stages"))

    def _load_extra(self, path: str) -> None:
        self._stages = serialize.load_stage_list(os.path.join(path, "stages"))
