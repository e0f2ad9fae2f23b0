"""Tabular data adapter — the framework's "DataFrame" boundary.

A copy of ``mmlspark_tpu/core/schema.py``: the port keeps its own so that
it never imports the JAX package.

The reference operates on Spark DataFrames (reference layer L1, SURVEY.md §1).
A TPU-native framework has no JVM; its natural data plane is Arrow/pandas/
numpy on the host feeding ``jax.numpy`` arrays on device.  This module defines
a minimal columnar ``DataTable`` plus conversion helpers so that every stage
accepts, interchangeably:

* ``pandas.DataFrame`` (vector columns = object columns of 1-D arrays/lists)
* ``pyarrow.Table``
* ``dict[str, np.ndarray]`` (a 2-D array is a "vector column")
* ``DataTable`` itself

and returns the same flavor it was given, mirroring the reference's
DataFrame-in/DataFrame-out Transformer contract
(core/schema/DatasetExtensions.scala, expected path, UNVERIFIED).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

import numpy as np

try:  # pandas is baked into the image, but keep it soft anyway
    import pandas as pd
except ImportError:  # pragma: no cover
    pd = None

try:
    import pyarrow as pa
except ImportError:  # pragma: no cover
    pa = None


ColumnLike = np.ndarray  # rows on axis 0: 1-D scalar, 2-D vector, N-D tensor
TableLike = Union["DataTable", "pd.DataFrame", "pa.Table", Dict[str, Any]]


class DataTable:
    """An ordered, column-oriented table backed by numpy arrays.

    Columns are 1-D numpy arrays (scalar columns), 2-D numpy arrays
    (fixed-width vector columns — the analog of Spark ML vector columns),
    or higher-rank arrays whose leading axis is the row axis (e.g. NHWC
    image batches).  Object-dtype 1-D columns may hold arbitrary python
    payloads (image structs, HTTP responses) just as Spark rows may hold
    structs.
    """

    def __init__(self, columns: Dict[str, Any]):
        self._cols: Dict[str, np.ndarray] = {}
        n = None
        for name, col in columns.items():
            arr = _as_column(col)
            if n is None:
                n = arr.shape[0]
            elif arr.shape[0] != n:
                raise ValueError(
                    f"Column {name!r} has length {arr.shape[0]}, expected {n}")
            self._cols[name] = arr
        self._n = 0 if n is None else int(n)

    # -- basic protocol ------------------------------------------------------

    @property
    def columns(self) -> List[str]:
        return list(self._cols)

    def __len__(self) -> int:
        return self._n

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        if name not in self._cols:
            raise KeyError(
                f"Column {name!r} not found; available: {self.columns}")
        return self._cols[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self._cols)

    def column(self, name: str) -> np.ndarray:
        return self[name]

    # -- functional updates (tables are treated as immutable by stages) -----

    def withColumn(self, name: str, col: Any) -> "DataTable":
        cols = dict(self._cols)
        cols[name] = col
        return DataTable(cols)

    def withColumns(self, new: Dict[str, Any]) -> "DataTable":
        cols = dict(self._cols)
        cols.update(new)
        return DataTable(cols)

    def drop(self, *names: str) -> "DataTable":
        return DataTable({k: v for k, v in self._cols.items() if k not in names})

    def select(self, *names: str) -> "DataTable":
        return DataTable({k: self[k] for k in names})

    def rename(self, mapping: Dict[str, str]) -> "DataTable":
        return DataTable({mapping.get(k, k): v for k, v in self._cols.items()})

    def take(self, idx: np.ndarray) -> "DataTable":
        """Row-select by integer index or boolean mask."""
        idx = np.asarray(idx)
        return DataTable({k: v[idx] for k, v in self._cols.items()})

    def head(self, n: int = 5) -> "DataTable":
        return self.take(np.arange(min(n, self._n)))

    def slice(self, start: int, stop: int) -> "DataTable":
        """Contiguous row range [start, stop) as a new table (views)."""
        return DataTable({k: v[start:stop] for k, v in self._cols.items()})

    def concat(self, other: "DataTable") -> "DataTable":
        if set(self.columns) != set(other.columns):
            raise ValueError("Cannot concat tables with differing columns")
        return DataTable({
            k: np.concatenate([self._cols[k], other._cols[k]], axis=0)
            for k in self._cols})

    # -- conversions ---------------------------------------------------------

    def toPandas(self) -> "pd.DataFrame":
        if pd is None:  # pragma: no cover
            raise ImportError("pandas is not available")
        data = {}
        for k, v in self._cols.items():
            if v.ndim >= 2:
                data[k] = list(v)  # vector/tensor column -> object column
            else:
                data[k] = v
        return pd.DataFrame(data)

    def toArrow(self) -> "pa.Table":
        if pa is None:  # pragma: no cover
            raise ImportError("pyarrow is not available")
        arrays, names = [], []
        for k, v in self._cols.items():
            names.append(k)
            if v.ndim == 2:
                arrays.append(pa.FixedSizeListArray.from_arrays(
                    pa.array(v.reshape(-1)), v.shape[1]))
            elif v.ndim > 2:
                raise ValueError(
                    f"Column {k!r} has shape {v.shape}; tensor columns "
                    "(rank > 2) cannot round-trip Arrow without losing their "
                    "shape — reshape to 2-D or keep the DataTable flavor")
            else:
                arrays.append(pa.array(v))
        return pa.Table.from_arrays(arrays, names=names)

    def toDict(self) -> Dict[str, np.ndarray]:
        return dict(self._cols)

    def __repr__(self) -> str:
        specs = ", ".join(
            f"{k}:{v.dtype}{list(v.shape[1:]) if v.ndim > 1 else ''}"
            for k, v in self._cols.items())
        return f"DataTable[{self._n} rows]({specs})"


def _as_column(col: Any) -> np.ndarray:
    """Normalize a column to a numpy array with rows on axis 0."""
    if isinstance(col, np.ndarray):
        if col.ndim >= 1:
            return col
        raise ValueError("Columns must have at least one axis")
    if pd is not None and isinstance(col, pd.Series):
        return _series_to_column(col)
    if pa is not None and isinstance(col, (pa.Array, pa.ChunkedArray)):
        return _arrow_to_column(col)
    arr = np.asarray(col)
    if arr.dtype == object and arr.ndim == 1 and len(arr) > 0:
        first = arr[0]
        if isinstance(first, (list, tuple, np.ndarray)) and not isinstance(
                first, (str, bytes)):
            try:
                return np.stack([np.asarray(x, dtype=np.float64) for x in arr])
            except (ValueError, TypeError):
                return arr  # ragged or non-numeric payloads stay object
    if arr.ndim >= 1:
        return arr
    raise ValueError("Columns must have at least one axis")


def _series_to_column(s: "pd.Series") -> np.ndarray:
    if s.dtype == object and len(s) > 0:
        first = s.iloc[0]
        if isinstance(first, (list, tuple, np.ndarray)) and not isinstance(
                first, (str, bytes)):
            try:
                return np.stack(
                    [np.asarray(x, dtype=np.float64) for x in s.to_numpy()])
            except (ValueError, TypeError):
                return s.to_numpy()
    if str(s.dtype) == "category":
        return s.astype(object).to_numpy()
    return s.to_numpy()


def _arrow_to_column(a) -> np.ndarray:
    if isinstance(a, pa.ChunkedArray):
        a = a.combine_chunks()
    if pa.types.is_fixed_size_list(a.type):
        width = a.type.list_size
        flat = a.flatten().to_numpy(zero_copy_only=False)
        return flat.reshape(-1, width)
    if pa.types.is_list(a.type) or pa.types.is_large_list(a.type):
        rows = a.to_pylist()
        return np.stack([np.asarray(r, dtype=np.float64) for r in rows])
    return a.to_numpy(zero_copy_only=False)


# -- public entry points -----------------------------------------------------

def to_table(data: TableLike) -> DataTable:
    """Convert any supported tabular input to a :class:`DataTable`."""
    if isinstance(data, DataTable):
        return data
    if pd is not None and isinstance(data, pd.DataFrame):
        return DataTable({c: _series_to_column(data[c]) for c in data.columns})
    if pa is not None and isinstance(data, pa.Table):
        return DataTable(
            {name: _arrow_to_column(data.column(name))
             for name in data.column_names})
    if isinstance(data, dict):
        return DataTable(data)
    raise TypeError(
        f"Unsupported table type {type(data).__name__}; expected DataTable, "
        "pandas.DataFrame, pyarrow.Table, or dict of arrays")


def from_table(table: DataTable, like: TableLike) -> TableLike:
    """Convert a DataTable back to the flavor of ``like``.

    When the row count is unchanged, a pandas input's index is propagated to
    the output so callers can join/assign against their original frame.
    """
    if isinstance(like, DataTable):
        return table
    if pd is not None and isinstance(like, pd.DataFrame):
        out = table.toPandas()
        if len(out) == len(like):
            out.index = like.index
        return out
    if pa is not None and isinstance(like, pa.Table):
        return table.toArrow()
    if isinstance(like, dict):
        return table.toDict()
    return table


def features_matrix(table: DataTable, featuresCol: str) -> np.ndarray:
    """Fetch a 2-D float feature matrix from a vector column."""
    col = table[featuresCol]
    if col.ndim != 2:
        raise ValueError(
            f"Column {featuresCol!r} is not a vector column (shape {col.shape}); "
            "use Featurize/AssembleFeatures to build one, or pass featureCols")
    return np.ascontiguousarray(col, dtype=np.float64)
