"""Batch-size bucket ladder — the port's copy of ``bucket_ladder`` and
``bucket_for`` from the JAX package's ``parallel/inference.py`` (its
ONNX half is ROADMAP A11).

The serving binned plane pads each drained batch up to a rung of this
ladder, so the scorer sees at most ``len(ladder)`` shapes however the
request batch sizes vary."""

from __future__ import annotations

from typing import List, Optional


def bucket_ladder(max_batch: int, buckets: Optional[List[int]] = None
                  ) -> List[int]:
    """Pow2 padding ladder ending at ``max_batch`` (ascending).
    ``buckets`` overrides the ladder (values are clamped into
    [1, max_batch]; max_batch is always included so every batch has a
    rung)."""
    max_batch = max(int(max_batch), 1)
    if buckets:
        return sorted({min(max(int(b), 1), max_batch) for b in buckets}
                      | {max_batch})
    ladder, b = [], 1
    while b < max_batch:
        ladder.append(b)
        b *= 2
    ladder.append(max_batch)
    return ladder


def bucket_for(n: int, ladder: List[int]) -> int:
    """Smallest rung >= n (top rung when n exceeds the ladder)."""
    for b in ladder:
        if n <= b:
            return b
    return ladder[-1]
