"""Quantile feature binning — the port's copy of ``BinMapper``.

Bin boundaries are computed once on the host from a row sample, as the
JAX package does; the binned (row, feature) -> uint8 matrix is what goes
to the card. Conventions (unchanged from the JAX package):

  - bin 0 is reserved for missing values (NaN);
  - boundaries are upper edges: value v lands in the smallest bin with
    v <= edge; the last bin catches +inf;
  - categorical features bin by integer category id: the sample's
    categories by count, at most ``max_bin - 2`` of them, category i of
    the sorted kept ids in bin i + 1; a value that is not a kept
    category (rare, unseen, fractional) lands in bin 0 with NaN.

``transform`` bins numeric columns in the port's own C++
(``native/data_plane.cpp``, a copy of the JAX package's
``mmls_bin_matrix``, built at first use by ``native/bindings.py``), as
the JAX package's ``transform`` does by default, and categorical columns
by the JAX package's numpy lookup; ``_transform_python`` is the plain
numpy version of both, which the tests hold it to bit for bit.

``fit_streaming`` builds the edges in one pass over row chunks (an exact
distinct-value tally beside a ``QuantileSketch`` per feature), for fits
whose rows never exist as one array (``models/gbdt/ooc.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.native import bindings
from mmlspark_tpu_torch.ops.sketch import DEFAULT_SKETCH_K, QuantileSketch

# Row-block size for BinMapper.transform: bounds the float64 staging copy
# to block_rows x F instead of N x F.
_TRANSFORM_BLOCK_ROWS = 65536


def _feat_max_bin(fi: int, max_bin: int,
                  max_bin_by_feature: Optional[Sequence[int]]) -> int:
    if max_bin_by_feature is None or fi >= len(max_bin_by_feature):
        return max_bin
    o = int(max_bin_by_feature[fi])
    # floor of 4: below that the missing + catch-all reservation leaves
    # no usable bins
    return min(max_bin, max(o, 4)) if o > 0 else max_bin


def _numeric_edges(uniq: np.ndarray, counts: np.ndarray, usable_bins: int,
                   min_data_in_bin: int) -> np.ndarray:
    """Bin edges for one numeric feature from (distinct values, counts)."""
    if len(uniq) == 0:
        return np.empty(0, dtype=np.float64)
    if len(uniq) <= usable_bins:
        # boundary = midpoint between adjacent distinct values
        e = (uniq[:-1] + uniq[1:]) / 2.0
    else:
        # weighted quantiles over distinct values
        cum = np.cumsum(counts)
        total = cum[-1]
        qs = (np.arange(1, usable_bins) / usable_bins) * total
        idx = np.searchsorted(cum, qs)
        idx = np.unique(np.minimum(idx, len(uniq) - 2))
        e = (uniq[idx] + uniq[idx + 1]) / 2.0
    if min_data_in_bin > 1 and len(e):
        # drop edges that separate fewer than min_data_in_bin rows
        bins = np.searchsorted(e, uniq, side="left")
        counts_per = np.bincount(bins, weights=counts, minlength=len(e) + 1)
        keep = []
        acc = 0.0
        for i in range(len(e)):
            acc += counts_per[i]
            if acc >= min_data_in_bin:
                keep.append(i)
                acc = 0.0
        e = e[keep]
    return np.asarray(e, dtype=np.float64)


@dataclass
class BinMapper:
    """Per-dataset binning state."""

    # upper_edges[f] has shape (num_bins_f - 2,); +inf edge implicit
    upper_edges: List[np.ndarray]
    max_bin: int
    # (F,) bool, and per feature the sorted kept category ids (None for
    # a numeric feature); None: every feature numeric
    is_categorical: Optional[np.ndarray] = None
    categories: Optional[List[Optional[np.ndarray]]] = None

    def __post_init__(self):
        if self.is_categorical is None:
            self.is_categorical = np.zeros(len(self.upper_edges), bool)
        if self.categories is None:
            self.categories = [None] * len(self.upper_edges)

    @property
    def num_features(self) -> int:
        return len(self.upper_edges)

    def num_bins(self, f: int) -> int:
        if self.is_categorical[f]:
            return len(self.categories[f]) + 1
        return len(self.upper_edges[f]) + 2  # + catch-all last bin + missing bin

    @property
    def max_num_bins(self) -> int:
        return max((self.num_bins(f) for f in range(self.num_features)), default=2)

    @staticmethod
    def fit(sample: np.ndarray, max_bin: int = 255,
            categorical_features: Sequence[int] = (),
            min_data_in_bin: int = 3,
            max_bin_by_feature: Optional[Sequence[int]] = None
            ) -> "BinMapper":
        """Bin boundaries from a host-side row sample: quantile binning
        over distinct values, merging bins that would hold fewer than
        ``min_data_in_bin`` sampled rows. ``max_bin_by_feature`` caps
        individual features below ``max_bin`` (entries <= 0 mean no
        override). ``categorical_features``: the slots binned by category
        id, the ``max_bin - 2`` most frequent of the sample's (ties broken
        as the JAX package's ``np.argsort(-counts)`` breaks them)."""
        sample = np.asarray(sample, dtype=np.float64)
        _, num_f = sample.shape
        cat = np.zeros(num_f, dtype=bool)
        cat[list(categorical_features)] = True
        edges: List[np.ndarray] = []
        cats: List[Optional[np.ndarray]] = []
        for f in range(num_f):
            col = sample[:, f]
            col = col[~np.isnan(col)]
            if cat[f]:
                edges.append(np.empty(0))
                vals, counts = np.unique(col.astype(np.int64),
                                         return_counts=True)
                # rare categories overflow to the missing bin
                cap = _feat_max_bin(f, max_bin, max_bin_by_feature) - 2
                if len(vals) > cap:
                    vals = np.sort(vals[np.argsort(-counts)[:cap]])
                cats.append(vals)
                continue
            cats.append(None)
            if len(col) == 0:
                edges.append(np.empty(0))
                continue
            uniq, counts = np.unique(col, return_counts=True)
            # reserve missing + catch-all
            usable_bins = _feat_max_bin(f, max_bin, max_bin_by_feature) - 2
            edges.append(_numeric_edges(uniq, counts, usable_bins,
                                        min_data_in_bin))
        return BinMapper(edges, max_bin, cat, cats)

    @staticmethod
    def fit_streaming(chunks: Iterable[np.ndarray], max_bin: int = 255,
                      categorical_features: Sequence[int] = (),
                      min_data_in_bin: int = 3,
                      max_bin_by_feature: Optional[Sequence[int]] = None,
                      sketch_k: int = DEFAULT_SKETCH_K) -> "BinMapper":
        """One pass over row chunks (the JAX package's
        ``fit_streaming``). Per feature an exact distinct-value tally runs
        beside a mergeable ``QuantileSketch``: while a feature's distinct
        values stay within ``max(4096, 4 * usable bins)`` the edges are
        ``fit``'s over the concatenated chunks, bit for bit; past that cap
        the tally is dropped and the sketch's (value, weight) items feed
        the same edge computation, within the sketch's rank-error bound.
        Peak memory is one chunk plus the sketches, never the whole
        dataset. Categorical features need exact global category counts
        and are refused: bin them with ``fit`` on a row sample."""
        if len(list(categorical_features)) > 0:
            raise ValueError(
                "fit_streaming supports numeric features only; bin "
                "categorical features via BinMapper.fit on a row sample")
        sketches: Optional[List[QuantileSketch]] = None
        tallies: List[Optional[Dict[float, int]]] = []
        num_f = 0
        for chunk in chunks:
            c = np.asarray(chunk, dtype=np.float64)
            if c.ndim != 2:
                raise ValueError(f"chunks must be 2-d, got shape {c.shape}")
            if sketches is None:
                num_f = c.shape[1]
                sketches = [QuantileSketch(sketch_k) for _ in range(num_f)]
                tallies = [dict() for _ in range(num_f)]
            elif c.shape[1] != num_f:
                raise ValueError(
                    f"chunk has {c.shape[1]} features, expected {num_f}")
            for f in range(num_f):
                col = c[:, f]
                col = col[~np.isnan(col)]
                sketches[f].update(col)
                tally = tallies[f]
                if tally is not None:
                    uniq, counts = np.unique(col, return_counts=True)
                    for v, cnt in zip(uniq.tolist(), counts.tolist()):
                        tally[v] = tally.get(v, 0) + cnt
                    usable = _feat_max_bin(f, max_bin, max_bin_by_feature) - 2
                    if len(tally) > max(4096, 4 * usable):
                        tallies[f] = None  # high cardinality: sketch only
        if sketches is None:
            raise ValueError("fit_streaming requires at least one chunk")
        edges: List[np.ndarray] = []
        for f in range(num_f):
            usable = _feat_max_bin(f, max_bin, max_bin_by_feature) - 2
            tally = tallies[f]
            if tally is not None:
                items = sorted(tally.items())
                uniq = np.asarray([it[0] for it in items], dtype=np.float64)
                counts = np.asarray([it[1] for it in items], dtype=np.int64)
            else:
                uniq, counts = sketches[f].items()
            edges.append(_numeric_edges(uniq, counts, usable,
                                        min_data_in_bin))
        return BinMapper(edges, max_bin)

    def transform(self, x: np.ndarray, dtype=np.int32) -> np.ndarray:
        """Map raw features (N, F) to bin ids (N, F); NaN -> bin 0. The
        ids are written as ``dtype`` (int32, or uint8 / uint16 where the
        mapper's bins fit, as ``binned_ingest_dtype`` picks), in the
        port's C++ (``native/data_plane.cpp``); categorical columns are
        then looked up among their categories (``_category_bins``).
        float32 and float64 rows are read as they are; other inputs are
        converted to float64 one block of ``_TRANSFORM_BLOCK_ROWS`` rows
        at a time, so no full float64 copy is made."""
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[1] != self.num_features:
            raise ValueError(f"expected (N, {self.num_features}) features, "
                             f"got shape {x.shape}")
        out = np.empty(x.shape, dtype=dtype)
        edges = self._padded_edges()
        for s in range(0, x.shape[0], _TRANSFORM_BLOCK_ROWS):
            block = x[s:s + _TRANSFORM_BLOCK_ROWS]
            if block.dtype not in (np.float32, np.float64) \
                    or not block.flags.c_contiguous:
                block = np.ascontiguousarray(block, dtype=np.float64)
            bindings.bin_matrix(block, edges, out[s:s + _TRANSFORM_BLOCK_ROWS])
            for f in np.flatnonzero(self.is_categorical):
                out[s:s + _TRANSFORM_BLOCK_ROWS, f] = self._category_bins(
                    f, np.asarray(block[:, f], dtype=np.float64))
        return out

    def _category_bins(self, f: int, col: np.ndarray) -> np.ndarray:
        """Bin ids of categorical feature ``f``'s float64 values: the kept
        category i in bin i + 1, anything else (NaN, a rare, unseen or
        fractional value) in bin 0 (the JAX package's lookup)."""
        cats = self.categories[f]
        if not len(cats):
            return np.zeros(len(col), np.int64)
        idx = np.clip(np.searchsorted(cats, col), 0, len(cats) - 1)
        b = np.where(cats[idx] == col, idx + 1, 0)
        return np.where(np.isnan(col), 0, b)

    def _padded_edges(self) -> np.ndarray:
        """The (F, max edges + 1) float64 edges, each row padded with
        +inf, built once per mapper (the edges do not change after
        ``fit`` / ``from_dict``)."""
        padded = self.__dict__.get("_padded")
        if padded is None:
            width = max((len(e) for e in self.upper_edges), default=0) + 1
            padded = np.full((self.num_features, width), np.inf)
            for f, e in enumerate(self.upper_edges):
                padded[f, :len(e)] = e
            self.__dict__["_padded"] = padded
        return padded

    def _transform_python(self, x: np.ndarray) -> np.ndarray:
        out = np.zeros(x.shape, dtype=np.int32)
        for f in range(self.num_features):
            col = x[:, f]
            if self.is_categorical[f]:
                out[:, f] = self._category_bins(f, col)
                continue
            b = np.searchsorted(self.upper_edges[f], col, side="left") + 1
            out[:, f] = np.where(np.isnan(col), 0, b)
        return out

    def bin_upper_values(self, total_bins: int) -> np.ndarray:
        """(F, total_bins) raw-value upper bound per bin, so a trained
        model carries real-valued thresholds and prediction never needs
        the BinMapper."""
        out = np.full((self.num_features, total_bins), np.inf, dtype=np.float64)
        for f in range(self.num_features):
            if self.is_categorical[f]:
                # a categorical bin's value is its category id
                cats = self.categories[f]
                out[f, 1:len(cats) + 1] = cats
            else:
                e = self.upper_edges[f]
                out[f, 1:len(e) + 1] = e
            out[f, 0] = np.nan  # missing bin has no upper value
        return out

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        """The JAX package's ``BinMapper.to_dict`` layout, so a saved
        model's mapper loads in either package."""
        return {
            "max_bin": self.max_bin,
            "is_categorical": self.is_categorical.tolist(),
            "upper_edges": [e.tolist() for e in self.upper_edges],
            "categories": [None if c is None else c.tolist()
                           for c in self.categories],
        }

    @staticmethod
    def from_dict(d: dict) -> "BinMapper":
        edges = [np.asarray(e, dtype=np.float64) for e in d["upper_edges"]]
        return BinMapper(
            upper_edges=edges,
            max_bin=d["max_bin"],
            is_categorical=np.asarray(d.get("is_categorical")
                                      or [False] * len(edges), dtype=bool),
            categories=[None if c is None else np.asarray(c, dtype=np.int64)
                        for c in (d.get("categories") or [None] * len(edges))],
        )
