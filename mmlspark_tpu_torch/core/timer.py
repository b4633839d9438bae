"""Phase-level wall-clock instrumentation — the port's copy of the JAX
package's ``core/timer.py``.

Analog of the reference's ``StopWatch`` (core/utils/StopWatch.scala:1) and
the LightGBM ``TaskInstrumentationMeasures``/``InstrumentationMeasures``
(lightgbm/.../LightGBMPerformance.scala:11-66), which mark
init/network/dataPrep/datasetCreation/validation/iterations phases per
task and aggregate per batch. Here phases are named spans on a single
recorder; in SPMD there is one program, so "per task" collapses to
per-host (optionally per training batch).
"""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Dict, List, Optional


class StopWatch:
    def __init__(self):
        self._start: Optional[float] = None
        self.elapsed = 0.0

    def start(self) -> "StopWatch":
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        if self._start is not None:
            self.elapsed += time.perf_counter() - self._start
            self._start = None
        return self.elapsed

    @contextmanager
    def measure(self):
        self.start()
        try:
            yield self
        finally:
            self.stop()


class InstrumentationMeasures:
    """Named-phase timing record, queryable after fit/transform."""

    CANONICAL_PHASES = (
        "initialization", "binning", "dataPreparation", "datasetTransfer",
        "training", "validation", "collectives", "cleanup",
    )

    def __init__(self):
        self._phases: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._order: List[str] = []

    @contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if name not in self._phases:
                self._order.append(name)
            self._phases[name] = self._phases.get(name, 0.0) + dt
            self._counts[name] = self._counts.get(name, 0) + 1

    def seconds(self, name: str) -> float:
        return self._phases.get(name, 0.0)

    def count(self, name: str) -> int:
        return self._counts.get(name, 0)

    def total_seconds(self) -> float:
        return sum(self._phases.values())

    def as_dict(self) -> Dict[str, float]:
        return {n: self._phases[n] for n in self._order}

    def merged(self, other: "InstrumentationMeasures") -> "InstrumentationMeasures":
        out = InstrumentationMeasures()
        for src in (self, other):
            for n in src._order:
                if n not in out._phases:
                    out._order.append(n)
                out._phases[n] = out._phases.get(n, 0.0) + src._phases[n]
                out._counts[n] = out._counts.get(n, 0) + src._counts[n]
        return out

    def __repr__(self) -> str:
        body = ", ".join(f"{n}={v:.4f}s" for n, v in self.as_dict().items())
        return f"InstrumentationMeasures({body})"
