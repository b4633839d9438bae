"""Quantile feature binning — the port's copy of ``BinMapper`` for
numeric features.

Bin boundaries are computed once on the host from a row sample, as the
JAX package does; the binned (row, feature) -> uint8 matrix is what goes
to the card. Conventions (unchanged from the JAX package):

  - bin 0 is reserved for missing values (NaN);
  - boundaries are upper edges: value v lands in the smallest bin with
    v <= edge; the last bin catches +inf.

This slice covers numeric features only; categorical binning and the
streaming sketch fit (``fit_streaming``) are later work.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np

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

    def transform(self, x: np.ndarray) -> np.ndarray:
        """Map raw features (N, F) to bin ids (N, F) int32; NaN -> bin 0.
        Rows are binned in bounded blocks so a non-float64 input never
        materializes a full float64 copy."""
        x = np.asarray(x)
        out = np.zeros(x.shape, dtype=np.int32)
        for s in range(0, x.shape[0], _TRANSFORM_BLOCK_ROWS):
            block = np.asarray(x[s:s + _TRANSFORM_BLOCK_ROWS],
                               dtype=np.float64)
            out[s:s + _TRANSFORM_BLOCK_ROWS] = self._transform_python(block)
        return out

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
