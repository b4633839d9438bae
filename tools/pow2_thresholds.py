#!/usr/bin/env python3
"""Derive, from JAX on the CPU, the exponent decision of the JAX
package's ``trainer._pow2_scale``, as the table of float32 thresholds
that ``mmlspark_tpu_torch.models.gbdt.trainer`` keeps.

    JAX_PLATFORMS=cpu python3 tools/pow2_thresholds.py [--full]

``_pow2_scale`` takes ``e = clip(floor(log2(r)), -126, 126)`` with
``r = float32(qmax) / amax``. XLA's ``log2`` is ``log(r) / log(2)`` in
float32, which misses the exact floor near powers of two (it often
gives k just below 2^k) and flushes subnormal ``r`` to ``-inf``. The
decision depends on ``r`` alone, so where it is monotone in ``r`` it
is fixed by ``t_k``, the smallest float32 ``r`` whose decision is at
least ``k``, for k in [-126, 126]: ``e = clip(#{k: t_k <= r} - 127,
-126, 126)``. The port compares bit patterns, since positive float32
values order as their int32 bits.

Each ``t_k`` is found in a window of ``WINDOW`` ulps either side of
2^k, where the decision must step from below k to k exactly once.
``--full`` also evaluates the decision at every positive finite
float32 value (2^31 of them, in blocks of one binade) and checks that
it never falls, so no step lies outside the windows. It prints the
table as int32 bit patterns, one JSON line.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

K_MIN, K_MAX = -126, 126
WINDOW = 1 << 12


def xla_floor_log2(r: np.ndarray) -> np.ndarray:
    """``floor(log2(r))`` as ``_pow2_scale`` evaluates it (eager jnp
    ops, float32), returned as float64 (``-inf`` where XLA flushed)."""
    import jax.numpy as jnp
    return np.asarray(jnp.floor(jnp.log2(jnp.asarray(r, jnp.float32))),
                      dtype=np.float64)


def _floats(lo_bits: int, hi_bits: int) -> np.ndarray:
    return np.arange(lo_bits, hi_bits, dtype=np.int64).astype(
        np.uint32).view(np.float32)


def derive_thresholds(window: int = WINDOW) -> np.ndarray:
    """(253,) int32: the bit pattern of ``t_k`` for k = -126 .. 126.
    Raises where a window does not step from below k to k exactly
    once."""
    out = []
    for k in range(K_MIN, K_MAX + 1):
        centre = int(np.float32(2.0 ** k).view(np.uint32))
        lo = max(centre - window, 1)
        r = _floats(lo, centre + window)
        d = xla_floor_log2(r)
        reached = d >= k
        steps = np.flatnonzero(reached[1:] != reached[:-1])
        if reached[0] or not reached[-1] or len(steps) != 1:
            raise AssertionError(
                f"k={k}: XLA's decision is not one step within "
                f"{window} ulps of 2^k")
        first = steps[0] + 1
        if not (d[first:] == k).all() or (d[:first] > k - 1).any():
            raise AssertionError(f"k={k}: the decision skips a value "
                                 "near 2^k")
        out.append(lo + first)
    return np.asarray(out, dtype=np.int64).astype(np.int32)


def check_monotone() -> dict:
    """Evaluate the decision at every positive finite float32 value, one
    binade per block; raise where it falls. Returns counts."""
    last = -np.inf
    checked = 0
    inf_bits = int(np.float32(np.inf).view(np.uint32))
    for lo in range(1, inf_bits, 1 << 23):
        d = xla_floor_log2(_floats(lo, min(lo + (1 << 23), inf_bits)))
        with np.errstate(invalid="ignore"):     # -inf - -inf in the flush
            falls = (np.diff(d) < 0).any()
        if d[0] < last or falls:
            raise AssertionError(f"XLA's decision falls in the block at "
                                 f"bits {lo:#x}")
        last = d[-1]
        checked += len(d)
    return {"values_checked": checked, "monotone": True}


def main() -> int:
    import jax
    jax.config.update("jax_platforms", "cpu")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="also check every positive float32 value")
    args = ap.parse_args()
    t0 = time.perf_counter()
    table = derive_thresholds()
    exact = np.asarray([np.float32(2.0 ** k).view(np.int32)
                        for k in range(K_MIN, K_MAX + 1)])
    out = {"jax": jax.__version__, "k_min": K_MIN, "k_max": K_MAX,
           "window_ulps": WINDOW,
           "thresholds_off_the_power_of_two": int((table != exact).sum()),
           "threshold_bits": table.tolist()}
    if args.full:
        out.update(check_monotone())
    out["seconds"] = time.perf_counter() - t0
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
