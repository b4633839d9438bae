"""Columnar DataFrame: the host-side data plane — the port's copy of the
JAX package's ``core/dataframe.py`` without its device side
(``to_device``): the estimators move the columns they train on to the
card themselves.

Replaces Spark's DataFrame in the reference architecture (SURVEY.md §1 L0).
Design:

  - a column is a numpy array: 1-D for scalars, 2-D ``(n, d)`` for vector
    columns (the analog of Spark ML ``VectorUDT``), object dtype for
    strings / ragged lists;
  - per-column metadata carries categorical levels etc. (analog of
    ``core/schema/Categoricals.scala:1``).

There is no lazy plan: transforms are eager on host metadata.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Sequence, Union)

import numpy as np


def _as_column(values: Any) -> np.ndarray:
    if isinstance(values, np.ndarray):
        if values.ndim > 2:
            raise ValueError(f"columns must be 1-D or 2-D, got shape {values.shape}")
        return values
    if len(values) and isinstance(values[0], str):
        return np.asarray(values, dtype=object)
    arr = np.asarray(values)
    if arr.dtype == np.dtype("O") or arr.ndim > 2:
        return np.asarray(list(values), dtype=object)
    return arr


class DataFrame:
    """Immutable-ish columnar table. Cheap column ops, numpy row storage."""

    def __init__(self, columns: Mapping[str, Any],
                 metadata: Optional[Dict[str, Dict[str, Any]]] = None):
        self._cols: Dict[str, np.ndarray] = {}
        n = None
        for name, values in columns.items():
            arr = _as_column(values)
            if n is None:
                n = len(arr)
            elif len(arr) != n:
                raise ValueError(
                    f"column {name!r} has {len(arr)} rows, expected {n}")
            self._cols[name] = arr
        self._n = 0 if n is None else n
        self._meta: Dict[str, Dict[str, Any]] = dict(metadata or {})

    # -- construction -------------------------------------------------------
    @staticmethod
    def from_pandas(pdf) -> "DataFrame":
        cols = {}
        for name in pdf.columns:
            s = pdf[name]
            if s.dtype == object and len(s) and isinstance(s.iloc[0], (list, np.ndarray)):
                try:
                    cols[name] = np.stack([np.asarray(v) for v in s])
                    continue
                except ValueError:
                    pass
            cols[name] = s.to_numpy()
        return DataFrame(cols)

    def to_pandas(self):
        import pandas as pd
        out = {}
        for name, arr in self._cols.items():
            out[name] = list(arr) if arr.ndim == 2 else arr
        return pd.DataFrame(out)

    @staticmethod
    def from_rows(rows: Sequence[Mapping[str, Any]]) -> "DataFrame":
        if not rows:
            return DataFrame({})
        names = list(rows[0].keys())
        return DataFrame({n: [r[n] for r in rows] for n in names})

    # -- basic accessors ----------------------------------------------------
    @property
    def columns(self) -> List[str]:
        return list(self._cols.keys())

    @property
    def num_rows(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    def __contains__(self, name: str) -> bool:
        return name in self._cols

    def __getitem__(self, name: str) -> np.ndarray:
        return self._cols[name]

    def col(self, name: str) -> np.ndarray:
        if name not in self._cols:
            raise KeyError(f"no column {name!r}; have {self.columns}")
        return self._cols[name]

    def schema(self) -> Dict[str, str]:
        out = {}
        for name, arr in self._cols.items():
            kind = str(arr.dtype)
            if arr.ndim == 2:
                kind = f"vector[{arr.shape[1]},{arr.dtype}]"
            elif arr.dtype == object:
                kind = "object"
            out[name] = kind
        return out

    def metadata(self, name: str) -> Dict[str, Any]:
        return self._meta.get(name, {})

    def with_metadata(self, name: str, meta: Dict[str, Any]) -> "DataFrame":
        md = dict(self._meta)
        md[name] = {**md.get(name, {}), **meta}
        return DataFrame(self._cols, md)

    # -- column ops ---------------------------------------------------------
    def with_column(self, name: str, values: Any) -> "DataFrame":
        cols = dict(self._cols)
        cols[name] = values
        meta = self._meta
        if name in meta:  # replacing a column invalidates its metadata
            meta = {k: v for k, v in meta.items() if k != name}
        return DataFrame(cols, meta)

    def with_columns(self, new: Mapping[str, Any]) -> "DataFrame":
        cols = dict(self._cols)
        cols.update(new)
        # replacing a column invalidates its metadata (same rule as
        # with_column) — stale categorical flags would otherwise steer
        # downstream consumers
        meta = {k: v for k, v in self._meta.items() if k not in new}
        return DataFrame(cols, meta)

    def select(self, *names: str) -> "DataFrame":
        return DataFrame({n: self.col(n) for n in names},
                         {n: self._meta[n] for n in names if n in self._meta})

    def drop(self, *names: str) -> "DataFrame":
        return DataFrame({n: a for n, a in self._cols.items() if n not in names},
                         {n: m for n, m in self._meta.items() if n not in names})

    def rename(self, mapping: Mapping[str, str]) -> "DataFrame":
        return DataFrame({mapping.get(n, n): a for n, a in self._cols.items()},
                         {mapping.get(n, n): m for n, m in self._meta.items()})

    # -- row ops ------------------------------------------------------------
    def take_rows(self, idx: Union[np.ndarray, Sequence[int]]) -> "DataFrame":
        idx = np.asarray(idx)
        return DataFrame({n: a[idx] for n, a in self._cols.items()}, self._meta)

    def filter(self, mask_or_fn: Union[np.ndarray, Callable[["DataFrame"], np.ndarray]]) -> "DataFrame":
        mask = np.asarray(mask_or_fn(self) if callable(mask_or_fn) else mask_or_fn)
        if mask.dtype != bool:
            raise ValueError("filter expects a boolean mask")
        return self.take_rows(np.nonzero(mask)[0])

    def head(self, n: int = 5) -> "DataFrame":
        return self.take_rows(np.arange(min(n, self._n)))

    def sort(self, by: str, ascending: bool = True) -> "DataFrame":
        order = np.argsort(self.col(by), kind="stable")
        if not ascending:
            order = order[::-1]
        return self.take_rows(order)

    def sample(self, fraction: float, seed: int = 0) -> "DataFrame":
        rng = np.random.default_rng(seed)
        mask = rng.random(self._n) < fraction
        return self.filter(mask)

    def random_split(self, weights: Sequence[float], seed: int = 0) -> List["DataFrame"]:
        w = np.asarray(weights, dtype=np.float64)
        w = w / w.sum()
        rng = np.random.default_rng(seed)
        draws = rng.random(self._n)
        bounds = np.concatenate([[0.0], np.cumsum(w)])
        return [self.filter((draws >= bounds[i]) & (draws < bounds[i + 1]))
                for i in range(len(w))]

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        for i in range(self._n):
            yield {n: a[i] for n, a in self._cols.items()}

    @staticmethod
    def concat(dfs: Sequence["DataFrame"]) -> "DataFrame":
        if not dfs:
            return DataFrame({})
        dfs = [d for d in dfs if d.num_rows > 0] or list(dfs[:1])
        names = dfs[0].columns
        meta: Dict[str, Dict[str, Any]] = {}
        for d in dfs:
            meta.update(d._meta)
        return DataFrame(
            {n: np.concatenate([d.col(n) for d in dfs]) for n in names}, meta)

    # -- groupby-lite (host side; used by SAR / ranking eval) ---------------
    def group_indices(self, by: str) -> Dict[Any, np.ndarray]:
        keys = self.col(by)
        if len(keys) == 0:
            return {}
        order = np.argsort(keys, kind="stable")
        sorted_keys = keys[order]
        bounds = np.nonzero(np.concatenate([[True], sorted_keys[1:] != sorted_keys[:-1]]))[0]
        bounds = np.concatenate([bounds, [len(keys)]])
        return {sorted_keys[bounds[i]]: order[bounds[i]:bounds[i + 1]]
                for i in range(len(bounds) - 1)}

    def __repr__(self) -> str:
        return f"DataFrame({self._n} rows, schema={self.schema()})"
