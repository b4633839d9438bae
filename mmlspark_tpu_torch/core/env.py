"""Environment-variable readers for the port's knobs.

The port's own copy of the readers it needs from the JAX package's
``core/env.py`` (``env_str``, ``env_flag``, ``env_int``, ``env_float``,
``env_override`` and the warn-once contract). Port knobs are named
``MMLSPARK_TORCH_*`` and read only here and by the module that owns each
one; the defaults are the JAX package's:

  - ``MMLSPARK_TORCH_HIST_QUANT``  off|q16|q8 (``trainer.resolve_hist_quant``)
  - ``MMLSPARK_TORCH_HIST_SUB``    0|1 (``trainer.resolve_subtract``)
  - ``MMLSPARK_TORCH_EFB``  auto|off|on: exclusive feature bundling
    (``ops.efb.resolve_efb``); auto plans bundles where a sampled
    sparsity estimate finds at least two sparse columns, on scans every
    column, off never bundles
  - ``MMLSPARK_TORCH_SERVE_BINNED``  auto|off|on: the serving binned data
    plane (``io/serving.py``); auto activates it where the served model
    supports it, on warns once (reason in ``/healthz``) where it cannot,
    off keeps the generic ``transform`` path
  - ``MMLSPARK_TORCH_SERVE_BUCKETS``  comma-separated batch-size ladder
    of the binned plane (empty: powers of two up to ``max_batch_size``)
  - ``MMLSPARK_TORCH_SERVE_MODEL_QUEUE``  per-model pending-queue cap in a
    multi-model server (0: ``max_queue`` applies to each model)
  - ``MMLSPARK_TORCH_SERVE_WARM_MODELS``  served models that keep their
    binned plane resident (LRU; default 4)
  - ``MMLSPARK_TORCH_SERVE_TENANT_RATE``  per-tenant token-bucket refill
    in requests/s (0: admission buckets off)
  - ``MMLSPARK_TORCH_SERVE_TENANT_BURST``  per-tenant bucket capacity
    (default 8)
  - ``MMLSPARK_TORCH_INFER_AUTOCAST``  off|bf16: the binned scorer's leaf
    table in bfloat16 (``parallel.shard_rules.resolve_infer_autocast``)
  - ``MMLSPARK_TORCH_SPILL_VERIFY``  auto|off|on: checksum verification
    of persisted payloads (``ops.ingest.resolve_spill_verify``); auto and
    on verify every checkpoint's crc32 at resume and a spill chunk's at
    its first read (auto) or every read (on); off trusts the disk
  - ``MMLSPARK_TORCH_OOC``  auto|off|on: out-of-core training
    (``models.gbdt.trainer.resolve_ooc``); auto streams a supported fit
    from a spill directory (``models/gbdt/ooc.py``) when its in-core fit
    would not fit in the card's free memory (``trainer.fits_in_core``),
    on streams every supported fit (and warns once where the fit cannot
    stream), off never streams
  - ``MMLSPARK_TORCH_FAULTS``  fault-injection specs armed at import
    (``core.faults.arm_from_env``; ``point:action[:nth[:param]]``, comma
    separated)
  - ``MMLSPARK_TORCH_PREFETCH_DEPTH``  items ``parallel.prefetch.
    BatchPrefetcher`` stages ahead on its thread (default 2; 0 feeds
    synchronously)
  - ``MMLSPARK_TORCH_STREAM_BUFFER``  rows the refresh loop's
    ``StreamBuffer`` holds before its producer blocks (default 65536)
  - ``MMLSPARK_TORCH_REFRESH_INTERVAL_S``  seconds between time-armed
    refits (default 300; 0 turns the interval trigger off)
  - ``MMLSPARK_TORCH_REFRESH_PRIORITY``  low|high: a low-priority refit
    beside a server yields at train-step boundaries while the server's
    queue is past high water (default low)
  - ``MMLSPARK_TORCH_REFRESH_YIELD_S``  the most a refit yields at one
    step boundary (default 2.0)
  - ``MMLSPARK_TORCH_DRIFT_THRESHOLD``  the drift detector's arm level
    for the largest per-feature statistic (default 0.2)
  - ``MMLSPARK_TORCH_FLEET_MIN`` / ``_FLEET_MAX``  the supervisor's
    worker envelope (defaults 1 and 4)
  - ``MMLSPARK_TORCH_FLEET_SCALE_P99_MS``  worker p99 above which the
    supervisor scales up; below a quarter of it, down (default 250)
  - ``MMLSPARK_TORCH_FLEET_COOLDOWN_S``  seconds between two scaling
    actions (default 10)
  - ``MMLSPARK_TORCH_FLEET_HEARTBEAT_S``  seconds between the
    supervisor's ``/healthz`` sweeps (default 1.0)
  - ``MMLSPARK_TORCH_REQUEST_DEADLINE_MS``  ``FleetClient``'s request
    budget, sent as ``X-Deadline-Ms`` (default 0: none)
  - ``MMLSPARK_TORCH_HEDGE_DELAY_MS``  floor of ``FleetClient``'s
    adaptive hedge delay (default 30)
  - ``MMLSPARK_TORCH_HEDGE_BUDGET_PCT``  hedges as a share of requests,
    in percent (default 5)
  - ``MMLSPARK_TORCH_RETRY_BUDGET_PCT``  failover retries as a share of
    requests, in percent (default 10)
  - ``MMLSPARK_TORCH_HIST_SHARD``  auto|off|on: a data-parallel fit
    under a mesh reduce-scatters its histogram sums by feature slices
    (``data_sharded``) where the config allows it (auto: at dp > 1; on:
    forced, with one warning where it cannot), else all-reduces them
    whole (default auto; ``trainer.resolve_hist_shard_mode``)

Parsing contract, as in the JAX package: a malformed value must not
abort or silently mislabel a run, so it warns once per variable and the
default applies.
"""

from __future__ import annotations

import os
import warnings
from contextlib import contextmanager
from typing import Iterator, Optional, Set

_TRUTHY = frozenset(("1", "true", "yes", "on"))
_FALSEY = frozenset(("0", "false", "off", "no"))

SERVE_BINNED = "MMLSPARK_TORCH_SERVE_BINNED"
SERVE_BUCKETS = "MMLSPARK_TORCH_SERVE_BUCKETS"
SERVE_MODEL_QUEUE = "MMLSPARK_TORCH_SERVE_MODEL_QUEUE"
SERVE_WARM_MODELS = "MMLSPARK_TORCH_SERVE_WARM_MODELS"
SERVE_TENANT_RATE = "MMLSPARK_TORCH_SERVE_TENANT_RATE"
SERVE_TENANT_BURST = "MMLSPARK_TORCH_SERVE_TENANT_BURST"
INFER_AUTOCAST = "MMLSPARK_TORCH_INFER_AUTOCAST"
SPILL_VERIFY = "MMLSPARK_TORCH_SPILL_VERIFY"
OOC = "MMLSPARK_TORCH_OOC"
EFB = "MMLSPARK_TORCH_EFB"
FAULTS = "MMLSPARK_TORCH_FAULTS"
PREFETCH_DEPTH = "MMLSPARK_TORCH_PREFETCH_DEPTH"
STREAM_BUFFER = "MMLSPARK_TORCH_STREAM_BUFFER"
REFRESH_INTERVAL_S = "MMLSPARK_TORCH_REFRESH_INTERVAL_S"
REFRESH_PRIORITY = "MMLSPARK_TORCH_REFRESH_PRIORITY"
REFRESH_YIELD_S = "MMLSPARK_TORCH_REFRESH_YIELD_S"
DRIFT_THRESHOLD = "MMLSPARK_TORCH_DRIFT_THRESHOLD"
FLEET_MIN = "MMLSPARK_TORCH_FLEET_MIN"
FLEET_MAX = "MMLSPARK_TORCH_FLEET_MAX"
FLEET_SCALE_P99_MS = "MMLSPARK_TORCH_FLEET_SCALE_P99_MS"
FLEET_COOLDOWN_S = "MMLSPARK_TORCH_FLEET_COOLDOWN_S"
FLEET_HEARTBEAT_S = "MMLSPARK_TORCH_FLEET_HEARTBEAT_S"
REQUEST_DEADLINE_MS = "MMLSPARK_TORCH_REQUEST_DEADLINE_MS"
HEDGE_DELAY_MS = "MMLSPARK_TORCH_HEDGE_DELAY_MS"
HEDGE_BUDGET_PCT = "MMLSPARK_TORCH_HEDGE_BUDGET_PCT"
RETRY_BUDGET_PCT = "MMLSPARK_TORCH_RETRY_BUDGET_PCT"
HIST_SHARD = "MMLSPARK_TORCH_HIST_SHARD"

_WARNED: Set[str] = set()


def warn_once(name: str, message: str) -> None:
    """Warn about variable ``name`` once per process."""
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(message, stacklevel=3)


def reset_warnings() -> None:
    """Forget which variables already warned (test hook)."""
    _WARNED.clear()


def env_str(name: str, default: Optional[str] = None) -> Optional[str]:
    """String knob, unstripped (callers strip and validate)."""
    v = os.environ.get(name)
    return default if v is None else v


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean knob: 1/true/yes/on -> True, 0/false/off/no -> False
    (case-insensitive); unset/empty -> ``default``; anything else warns
    once and returns ``default``."""
    v = os.environ.get(name)
    if v is None:
        return default
    v = v.strip().lower()
    if not v:
        return default
    if v in _TRUTHY:
        return True
    if v in _FALSEY:
        return False
    warn_once(name, f"{name}={v!r} is not a recognized boolean "
                    f"(1/true/yes/on or 0/false/off/no); using {default}")
    return default


def env_int(name: str, default: int, minimum: Optional[int] = None) -> int:
    """Integer knob; a non-integer or below-``minimum`` value warns once
    and returns ``default``."""
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        value = int(v.strip())
    except ValueError:
        warn_once(name, f"{name}={v!r} is not an integer; using {default}")
        return default
    if minimum is not None and value < minimum:
        warn_once(name, f"{name}={value} is below the minimum {minimum}; "
                        f"using {default}")
        return default
    return value


def env_float(name: str, default: float,
              minimum: Optional[float] = None) -> float:
    """Float knob; a non-numeric or below-``minimum`` value warns once
    and returns ``default``."""
    v = os.environ.get(name)
    if v is None or not v.strip():
        return default
    try:
        value = float(v.strip())
    except ValueError:
        warn_once(name, f"{name}={v!r} is not a number; using {default}")
        return default
    if minimum is not None and value < minimum:
        warn_once(name, f"{name}={value} is below the minimum {minimum}; "
                        f"using {default}")
        return default
    return value


@contextmanager
def env_override(name: str, value: Optional[str]) -> Iterator[None]:
    """Set (or, with ``None``, unset) a variable for the block and
    restore its previous state on exit."""
    prev = os.environ.get(name)
    if value is None:
        os.environ.pop(name, None)
    else:
        os.environ[name] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev
