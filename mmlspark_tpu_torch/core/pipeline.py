"""Estimator/Transformer protocol.

The port's copy of ``mmlspark_tpu/core/pipeline.py`` without directory
persistence and without the stage registry: fitted GBDT models persist
through the LightGBM text format (``Booster.save_native_model``).
``fit``/``transform`` take any supported table flavor (pandas / Arrow /
dict-of-arrays / DataTable) and return the same flavor — see
:mod:`mmlspark_tpu_torch.core.schema`.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from .params import Params
from .schema import DataTable, TableLike, from_table, to_table


class PipelineStage(Params):
    """Base of every stage."""


class Transformer(PipelineStage):

    def transform(self, dataset: TableLike) -> TableLike:
        table = to_table(dataset)
        out = self._transform(table)
        return from_table(out, dataset)

    def _transform(self, table: DataTable) -> DataTable:
        raise NotImplementedError


class Estimator(PipelineStage):

    def fit(self, dataset: TableLike, params: Optional[Dict[str, Any]] = None
            ) -> "Model":
        est = self.copy(params) if params else self
        table = to_table(dataset)
        return est._fit(table)

    def _fit(self, table: DataTable) -> "Model":
        raise NotImplementedError


class Model(Transformer):
    """A fitted Transformer produced by an Estimator."""
