"""Windowed distribution-drift detection for the streaming refresh loop
— the port's copy of the JAX package's ``exploratory/drift.py`` (numpy
on host rows; nothing here touches the card).

The reference system's streaming layer reacts to the data it serves;
ours needs a trigger that says *when* the served model has gone stale.
This module compares two windows of feature (or score) rows — a
**reference** window frozen at fit time and a **current** window fed by
the ingestion stream — with either of two classical two-sample
statistics:

  - **PSI** (population stability index): histogram the reference into
    quantile bins, measure ``sum((p - q) * ln(p / q))`` per feature;
    the industry-standard ``0.2`` threshold is the default
    (``MMLSPARK_TORCH_DRIFT_THRESHOLD``);
  - **KS** (Kolmogorov–Smirnov): the max CDF gap between the two
    windows, scale-free and binning-free.

Both windows are fixed-size uniform **reservoir samples** (Vitter's
algorithm R, seeded) so memory stays bounded no matter how long the
stream runs, and a deterministic stream yields a deterministic verdict
— the chaos tests replay drift decisions bit-for-bit.

A :class:`DriftDetector` never acts on its own: :meth:`check` returns a
:class:`DriftReport`, and the :class:`~mmlspark_tpu_torch.io.refresh.
RefreshController` arms a warm-start refit when ``report.drifted``.
After a successful refresh the controller calls :meth:`promote` — the
current window becomes the new reference (the refreshed model was fit
on exactly that data regime).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = ["ReservoirWindow", "DriftDetector", "DriftReport", "psi",
           "ks_statistic"]

_EPS = 1e-6


def psi(expected: np.ndarray, actual: np.ndarray,
        bins: int = 16) -> float:
    """Population stability index of ``actual`` against ``expected``
    (both 1-d). Bin edges are ``expected``'s quantiles, so every
    reference bin starts near-uniformly filled; empty-bin ratios are
    floored at ``1e-6`` (the standard PSI regularization)."""
    expected = np.asarray(expected, dtype=np.float64).ravel()
    actual = np.asarray(actual, dtype=np.float64).ravel()
    edges = np.quantile(expected, np.linspace(0.0, 1.0, bins + 1))
    edges[0], edges[-1] = -np.inf, np.inf
    p = np.histogram(expected, edges)[0] / max(len(expected), 1)
    q = np.histogram(actual, edges)[0] / max(len(actual), 1)
    p = np.clip(p, _EPS, None)
    q = np.clip(q, _EPS, None)
    return float(np.sum((p - q) * np.log(p / q)))


def ks_statistic(a: np.ndarray, b: np.ndarray) -> float:
    """Two-sample Kolmogorov–Smirnov statistic: the max gap between the
    empirical CDFs of ``a`` and ``b`` (both 1-d)."""
    a = np.sort(np.asarray(a, dtype=np.float64).ravel())
    b = np.sort(np.asarray(b, dtype=np.float64).ravel())
    both = np.concatenate([a, b])
    cdf_a = np.searchsorted(a, both, side="right") / max(len(a), 1)
    cdf_b = np.searchsorted(b, both, side="right") / max(len(b), 1)
    return float(np.max(np.abs(cdf_a - cdf_b)))


class ReservoirWindow:
    """Fixed-size uniform sample over a row stream (algorithm R).

    ``add`` absorbs ``(n, F)`` row blocks; once ``capacity`` rows have
    been seen, each later row replaces a uniformly-chosen slot with
    probability ``capacity / seen`` — an unbiased sample of the whole
    stream so far, in O(capacity) memory. Seeded: the same stream in
    the same order produces the same sample."""

    def __init__(self, capacity: int, seed: int = 0):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        self.seen = 0
        self._rows: Optional[np.ndarray] = None   # (capacity, F) storage
        self._fill = 0
        self._rng = np.random.default_rng(seed)

    def add(self, rows: np.ndarray) -> None:
        rows = np.atleast_2d(np.asarray(rows, dtype=np.float64))
        if self._rows is None:
            self._rows = np.empty((self.capacity, rows.shape[1]),
                                  dtype=np.float64)
        for row in rows:
            self.seen += 1
            if self._fill < self.capacity:
                self._rows[self._fill] = row
                self._fill += 1
            else:
                j = int(self._rng.integers(0, self.seen))
                if j < self.capacity:
                    self._rows[j] = row

    @property
    def count(self) -> int:
        return self._fill

    def snapshot(self) -> np.ndarray:
        """The sampled rows, ``(count, F)`` (a copy)."""
        if self._rows is None:
            return np.empty((0, 0), dtype=np.float64)
        return self._rows[:self._fill].copy()

    def clear(self) -> None:
        self.seen = 0
        self._fill = 0


@dataclass
class DriftReport:
    """One :meth:`DriftDetector.check` verdict."""

    drifted: bool
    score: float                      # max per-feature statistic
    feature: int                      # argmax feature (-1 when unscored)
    metric: str
    threshold: float
    rows_reference: int
    rows_current: int
    per_feature: np.ndarray = field(
        default_factory=lambda: np.empty(0, dtype=np.float64))


class DriftDetector:
    """PSI/KS drift over reservoir windows of feature rows.

    ``metric``: ``"psi"`` (default) or ``"ks"``. ``threshold``: arm
    level for the **max** per-feature statistic; ``None`` reads
    ``MMLSPARK_TORCH_DRIFT_THRESHOLD`` (default 0.2, the standard PSI
    "significant shift" level — for KS pick ~0.1–0.15). ``window``:
    reservoir capacity per side. ``min_rows``: both windows must hold
    at least this many rows before a verdict can arm (tiny windows
    produce noisy statistics; an unarmed check reports
    ``drifted=False`` with ``feature=-1``)."""

    def __init__(self, metric: str = "psi",
                 threshold: Optional[float] = None,
                 window: int = 4096, bins: int = 16,
                 min_rows: int = 256, seed: int = 0):
        if metric not in ("psi", "ks"):
            raise ValueError(f"metric must be psi|ks, got {metric!r}")
        if threshold is None:
            from mmlspark_tpu_torch.core.env import (DRIFT_THRESHOLD,
                                                     env_float)
            threshold = env_float(DRIFT_THRESHOLD, 0.2, minimum=0.0)
        self.metric = metric
        self.threshold = float(threshold)
        self.bins = int(bins)
        self.min_rows = int(min_rows)
        self.reference = ReservoirWindow(window, seed=seed)
        self.current = ReservoirWindow(window, seed=seed + 1)

    def set_reference(self, rows: np.ndarray) -> "DriftDetector":
        """Freeze the reference regime (typically the training rows)."""
        self.reference.clear()
        self.reference.add(rows)
        return self

    def update(self, rows: np.ndarray) -> None:
        """Absorb fresh stream rows into the current window."""
        self.current.add(rows)

    def check(self) -> DriftReport:
        ref = self.reference.snapshot()
        cur = self.current.snapshot()
        if (len(ref) < self.min_rows or len(cur) < self.min_rows
                or ref.shape[1] != cur.shape[1] or ref.shape[1] == 0):
            return DriftReport(False, 0.0, -1, self.metric,
                               self.threshold, len(ref), len(cur))
        stat = psi if self.metric == "psi" else ks_statistic
        per = np.asarray(
            [stat(ref[:, f], cur[:, f]) if self.metric == "ks"
             else psi(ref[:, f], cur[:, f], self.bins)
             for f in range(ref.shape[1])], dtype=np.float64)
        worst = int(np.argmax(per))
        score = float(per[worst])
        return DriftReport(score >= self.threshold, score, worst,
                           self.metric, self.threshold, len(ref),
                           len(cur), per)

    def promote(self) -> None:
        """After a refresh fit on the current regime: the current
        window becomes the reference, and a fresh current window starts
        accumulating (same seeds are NOT reused — the reservoir RNGs
        keep their streams, so promotion never replays samples)."""
        self.reference, self.current = self.current, self.reference
        self.current.clear()
