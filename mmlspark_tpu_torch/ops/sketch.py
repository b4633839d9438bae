"""Mergeable streaming quantile sketch for one-pass bin-edge estimation
— the port's copy of the JAX package's ``ops/sketch.py`` (which imports
no JAX; the port keeps its own copy all the same).

KLL/GK-style compactor hierarchy with a deterministic parity schedule:
level ``i`` holds items of weight ``2**i``; when a level overflows its
capacity it is sorted and every other element is promoted to level
``i + 1``, alternating which half survives on successive compactions.
Classic KLL flips a random coin per compaction; the sketch replaces the
coin with a per-level parity bit that flips on every compaction, which
keeps the same worst-case rank-error telescope while staying
bit-reproducible across runs: no RNG, no clock. Its items,
``rank_error()`` and quantiles are the JAX package's, bit for bit.

Each compaction of level ``i`` perturbs the rank of any query point by
at most ``2**i`` (the weight of the items whose survival the parity
decides), so the sketch tracks an exact additive rank-error bound in
``rank_error()`` as it goes: ``sum(2**level over compactions)``.

Sketches over disjoint chunks merge associatively: ``merge``
concatenates per-level buffers and recompacts, and the error bounds
add. ``n``, ``min``/``max`` and NaN filtering are tracked exactly, so
degenerate features (constant, all-NaN, tiny-n) take exact paths
downstream in ``BinMapper.fit_streaming``.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["QuantileSketch", "DEFAULT_SKETCH_K"]

# Per-level capacity.  Rank error after N items is roughly
# N / k * log2(N / k) in the worst case; k = 2048 keeps the relative
# rank error below ~1e-3 out to billions of rows while holding at most
# a few hundred KiB per feature.
DEFAULT_SKETCH_K = 2048


class QuantileSketch:
    """Deterministic mergeable quantile sketch over a stream of floats.

    NaNs are filtered on ingest (callers bin NaN/missing separately);
    +-inf are kept — they sort to the ends and cannot split a bin edge
    anyway.  All floats are handled as float64.
    """

    __slots__ = ("k", "n", "vmin", "vmax", "_levels", "_parity", "_err")

    def __init__(self, k: int = DEFAULT_SKETCH_K) -> None:
        if k < 8:
            raise ValueError(f"sketch capacity k must be >= 8, got {k}")
        self.k = int(k)
        self.n = 0              # exact count of non-NaN items ingested
        self.vmin = np.inf      # exact running min / max
        self.vmax = -np.inf
        self._levels: List[np.ndarray] = [np.empty(0, dtype=np.float64)]
        self._parity: List[int] = [0]
        self._err = 0           # additive rank-error bound (in rank units)

    # -- ingest ---------------------------------------------------------

    def update(self, values: np.ndarray) -> None:
        """Ingest a chunk of values (any shape; flattened, NaN-dropped)."""
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return
        v = v[~np.isnan(v)]
        if v.size == 0:
            return
        self.n += int(v.size)
        self.vmin = min(self.vmin, float(v.min()))
        self.vmax = max(self.vmax, float(v.max()))
        # Feed level 0 in capacity-sized slices so a huge chunk cannot
        # transiently hold chunk_rows extra floats in the buffer.
        buf = self._levels[0]
        for s in range(0, v.size, self.k):
            buf = np.concatenate([buf, v[s:s + self.k]])
            if buf.size >= self.k:
                self._levels[0] = buf
                self._compact_from(0)
                buf = self._levels[0]
        self._levels[0] = buf

    def _ensure_level(self, i: int) -> None:
        while len(self._levels) <= i:
            self._levels.append(np.empty(0, dtype=np.float64))
            self._parity.append(0)

    def _compact_from(self, start: int) -> None:
        i = start
        while i < len(self._levels) and self._levels[i].size >= self.k:
            arr = np.sort(self._levels[i], kind="stable")
            if arr.size % 2 == 1:
                # Odd length: the last element stays behind so the
                # promoted pairs cover an even prefix exactly.
                keep_back, arr = arr[-1:], arr[:-1]
            else:
                keep_back = arr[:0]
            p = self._parity[i]
            self._parity[i] = 1 - p
            promoted = arr[p::2]
            self._levels[i] = keep_back
            self._err += 1 << i
            self._ensure_level(i + 1)
            self._levels[i + 1] = np.concatenate(
                [self._levels[i + 1], promoted])
            i += 1

    # -- merge ----------------------------------------------------------

    def merge(self, other: "QuantileSketch") -> "QuantileSketch":
        """Fold ``other`` into this sketch in place (and return self)."""
        if other.k != self.k:
            raise ValueError(
                f"cannot merge sketches with k={self.k} and k={other.k}")
        if other.n == 0:
            return self
        self.n += other.n
        self.vmin = min(self.vmin, other.vmin)
        self.vmax = max(self.vmax, other.vmax)
        self._err += other._err
        self._ensure_level(len(other._levels) - 1)
        for i, arr in enumerate(other._levels):
            if arr.size:
                self._levels[i] = np.concatenate([self._levels[i], arr])
        self._compact_from(0)
        return self

    # -- queries --------------------------------------------------------

    def rank_error(self) -> int:
        """Additive bound on |estimated rank - true rank| for any value."""
        return self._err

    def items(self) -> Tuple[np.ndarray, np.ndarray]:
        """All retained items as (sorted unique values, summed weights).

        Weights are the level weights (2**i); summing them per unique
        value gives the sketch's estimate of each value's multiplicity.
        ``weights.sum() == n`` is NOT guaranteed exactly (odd-length
        compactions shed one item's weight per promotion), but stays
        within ``rank_error()`` of it.
        """
        vals: List[np.ndarray] = []
        wts: List[np.ndarray] = []
        for i, arr in enumerate(self._levels):
            if arr.size:
                vals.append(arr)
                wts.append(np.full(arr.size, float(1 << i)))
        if not vals:
            return (np.empty(0, dtype=np.float64),
                    np.empty(0, dtype=np.float64))
        v = np.concatenate(vals)
        w = np.concatenate(wts)
        uniq, inv = np.unique(v, return_inverse=True)
        agg = np.bincount(inv, weights=w, minlength=uniq.size)
        return uniq, agg

    def rank(self, value: float) -> float:
        """Estimated number of ingested items <= value."""
        total = 0.0
        for i, arr in enumerate(self._levels):
            if arr.size:
                total += float(np.sum(arr <= value)) * (1 << i)
        return total

    def quantiles(self, qs: Sequence[float]) -> np.ndarray:
        """Estimated quantile values for each q in [0, 1]."""
        uniq, w = self.items()
        out = np.empty(len(qs), dtype=np.float64)
        if uniq.size == 0:
            out.fill(np.nan)
            return out
        cum = np.cumsum(w)
        total = cum[-1]
        targets = np.clip(np.asarray(qs, dtype=np.float64), 0.0, 1.0) * total
        idx = np.searchsorted(cum, targets, side="left")
        idx = np.minimum(idx, uniq.size - 1)
        return uniq[idx]

    def quantile(self, q: float) -> float:
        return float(self.quantiles([q])[0])

    def __len__(self) -> int:
        return self.n

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        held = sum(a.size for a in self._levels)
        return (f"QuantileSketch(k={self.k}, n={self.n}, held={held}, "
                f"levels={len(self._levels)}, rank_err<={self._err})")
