"""Quantile feature binning — the port's copy of ``BinMapper`` for
numeric features.

Bin boundaries are computed once on the host from a row sample, as the
JAX package does; the binned (row, feature) -> uint8 matrix is what goes
to the card. Conventions (unchanged from the JAX package):

  - bin 0 is reserved for missing values (NaN);
  - boundaries are upper edges: value v lands in the smallest bin with
    v <= edge; the last bin catches +inf.

``transform`` bins in the port's own C++ (``native/data_plane.cpp``, a
copy of the JAX package's ``mmls_bin_matrix``, built at first use by
``native/bindings.py``), as the JAX package's ``transform`` does by
default; ``_transform_python`` is its plain numpy version, which the
tests hold it to bit for bit.

This slice covers numeric features only; categorical binning and the
streaming sketch fit (``fit_streaming``) are later work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

from mmlspark_tpu_torch.native import bindings

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
    """Per-dataset numeric binning state."""

    # upper_edges[f] has shape (num_bins_f - 2,); +inf edge implicit
    upper_edges: List[np.ndarray]
    max_bin: int

    @property
    def num_features(self) -> int:
        return len(self.upper_edges)

    def num_bins(self, f: int) -> int:
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
        override)."""
        if len(list(categorical_features)) > 0:
            raise NotImplementedError(
                "categorical binning is not in the port yet (ROADMAP A7, "
                "GBDT breadth); bin numeric features only")
        sample = np.asarray(sample, dtype=np.float64)
        _, num_f = sample.shape
        edges: List[np.ndarray] = []
        for f in range(num_f):
            col = sample[:, f]
            col = col[~np.isnan(col)]
            if len(col) == 0:
                edges.append(np.empty(0))
                continue
            uniq, counts = np.unique(col, return_counts=True)
            # reserve missing + catch-all
            usable_bins = _feat_max_bin(f, max_bin, max_bin_by_feature) - 2
            edges.append(_numeric_edges(uniq, counts, usable_bins,
                                        min_data_in_bin))
        return BinMapper(edges, max_bin)

    def transform(self, x: np.ndarray, dtype=np.int32) -> np.ndarray:
        """Map raw features (N, F) to bin ids (N, F); NaN -> bin 0. The
        ids are written as ``dtype`` (int32, or uint8 / uint16 where the
        mapper's bins fit, as ``binned_ingest_dtype`` picks), in the
        port's C++ (``native/data_plane.cpp``). float32 and float64 rows
        are read as they are; other inputs are converted to float64 one
        block of ``_TRANSFORM_BLOCK_ROWS`` rows at a time, so no full
        float64 copy is made."""
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
        return out

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
            b = np.searchsorted(self.upper_edges[f], col, side="left") + 1
            out[:, f] = np.where(np.isnan(col), 0, b)
        return out

    def bin_upper_values(self, total_bins: int) -> np.ndarray:
        """(F, total_bins) raw-value upper bound per bin, so a trained
        model carries real-valued thresholds and prediction never needs
        the BinMapper."""
        out = np.full((self.num_features, total_bins), np.inf, dtype=np.float64)
        for f in range(self.num_features):
            e = self.upper_edges[f]
            out[f, 1:len(e) + 1] = e
            out[f, 0] = np.nan  # missing bin has no upper value
        return out

    # -- serialization ------------------------------------------------------
    def to_dict(self) -> dict:
        """The JAX package's ``BinMapper.to_dict`` layout (every feature
        numeric), so a saved model's mapper loads in either package."""
        return {
            "max_bin": self.max_bin,
            "is_categorical": [False] * self.num_features,
            "upper_edges": [e.tolist() for e in self.upper_edges],
            "categories": [None] * self.num_features,
        }

    @staticmethod
    def from_dict(d: dict) -> "BinMapper":
        if any(d.get("is_categorical") or ()):
            raise NotImplementedError(
                "categorical binning is not in the port yet (ROADMAP A7, "
                "GBDT breadth); this mapper has categorical features")
        return BinMapper(
            upper_edges=[np.asarray(e, dtype=np.float64)
                         for e in d["upper_edges"]],
            max_bin=d["max_bin"],
        )
