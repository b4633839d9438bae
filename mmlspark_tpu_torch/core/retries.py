"""Retry/backoff policy, circuit breakers and fractional budgets — the
port's copy of the JAX package's ``core/retries.py``.

One retry implementation (exponential backoff, bounded jitter, overall
deadline); in the port the fleet supervisor's restarts use it
(``io/fleet.py``), and ``FleetClient`` its ``CircuitBreaker`` and
``FractionBudget`` (``io/serving.py``). The engine analog of the
reference's ``FaultToleranceUtils.retryWithTimeout``
(core/utils/FaultToleranceUtils.scala:9-31). Jitter draws from a
``random.Random`` the caller may seed.

Retry exhaustion is a *degradation*, not just an exception: it logs
once per process through :func:`logging_utils.warn_once` so long runs
that quietly fall back don't mislabel A/B measurements.
"""

from __future__ import annotations

import random
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple, Type

from mmlspark_tpu_torch.core.logging_utils import logger, warn_once

__all__ = ["RetryPolicy", "with_retries", "backoff_schedule",
           "CircuitBreaker", "FractionBudget"]


@dataclass(frozen=True)
class RetryPolicy:
    """``max_attempts`` total calls (1 = no retries). Delay before retry
    k (1-based) is ``min(base_delay * multiplier**(k-1), max_delay)``
    plus up to ``jitter`` fraction of itself, capped so the sum never
    exceeds ``deadline`` seconds from the first attempt."""

    max_attempts: int = 3
    base_delay: float = 0.1
    multiplier: float = 2.0
    max_delay: float = 5.0
    jitter: float = 0.1
    deadline: Optional[float] = None

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.base_delay * self.multiplier ** (attempt - 1),
                self.max_delay)
        return d * (1.0 + self.jitter * rng.random())


def backoff_schedule(delays: Sequence[float],
                     deadline: Optional[float] = None) -> RetryPolicy:
    """Adapt an explicit delay list (the ``backoffs`` param surface of
    the HTTP transformers) onto a policy: attempts = len+1, and
    ``with_retries`` consults the list verbatim via ``fixed_delays``.
    ``deadline`` bounds the TOTAL retry span in seconds from the first
    attempt — without it a long backoff list can exceed the caller's
    own per-request budget (the concurrentTimeout contract)."""
    policy = RetryPolicy(max_attempts=len(delays) + 1, jitter=0.0,
                         deadline=deadline)
    object.__setattr__(policy, "_fixed", tuple(float(d) for d in delays))
    return policy


class CircuitBreaker:
    """Per-target circuit breaker: ``failure_threshold`` CONSECUTIVE
    errors/timeouts open the circuit — further calls are skipped
    outright (no connect) for ``open_s`` seconds, after which ONE
    half-open probe is admitted; its success closes the circuit, its
    failure re-opens for another ``open_s``. Thread-safe; callers pair
    each admitted call with :meth:`record_success` or
    :meth:`record_failure`."""

    __slots__ = ("failure_threshold", "open_s", "_lock", "_state",
                 "_failures", "_opened_t", "_probing")

    def __init__(self, failure_threshold: int = 3, open_s: float = 2.0):
        self.failure_threshold = max(int(failure_threshold), 1)
        self.open_s = open_s
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0
        self._opened_t = 0.0
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    def allow(self) -> bool:
        """True when a call may proceed. While open, returns False
        until ``open_s`` elapsed; then transitions to half-open and
        admits exactly one probe (concurrent callers keep skipping
        until that probe resolves)."""
        with self._lock:
            if self._state == "closed":
                return True
            if self._state == "open":
                if time.monotonic() - self._opened_t < self.open_s:
                    return False
                self._state = "half-open"
                self._probing = True
                return True
            # half-open: one probe in flight owns the circuit
            if self._probing:
                return False
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._state = "closed"
            self._failures = 0
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            if self._state == "half-open":
                # failed probe: straight back to open, fresh window
                self._state = "open"
                self._opened_t = time.monotonic()
                self._probing = False
                return
            self._failures += 1
            if self._failures >= self.failure_threshold:
                self._state = "open"
                self._opened_t = time.monotonic()


class FractionBudget:
    """Token bucket expressed as a FRACTION of primary traffic: every
    :meth:`note_request` accrues ``pct/100`` tokens (capped at
    ``burst``) and each :meth:`take` spends one — the mechanism behind
    both the FleetClient hedge budget (extra backend load stays under
    ``pct``%) and its global retry budget (a fleet-wide brownout stops
    amplifying once retries outrun ``pct``% of request volume).
    Thread-safe."""

    __slots__ = ("pct", "burst", "_lock", "_tokens", "noted", "taken",
                 "denied")

    def __init__(self, pct: float, burst: float = 8.0):
        self.pct = max(float(pct), 0.0)
        self.burst = max(float(burst), 1.0)
        self._lock = threading.Lock()
        self._tokens = self.burst
        self.noted = 0
        self.taken = 0
        self.denied = 0

    def note_request(self) -> None:
        with self._lock:
            self.noted += 1
            self._tokens = min(self.burst,
                               self._tokens + self.pct / 100.0)

    def take(self) -> bool:
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.taken += 1
                return True
            self.denied += 1
            return False


def with_retries(fn: Callable, *, policy: Optional[RetryPolicy] = None,
                 retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                 should_retry: Optional[Callable[[BaseException], bool]] = None,
                 describe: str = "operation",
                 min_delay_override: Optional[
                     Callable[[BaseException], Optional[float]]] = None,
                 sleep: Callable[[float], None] = time.sleep,
                 seed: Optional[int] = None):
    """Call ``fn()`` retrying transient failures.

    - ``retry_on``: exception classes eligible for retry;
    - ``should_retry``: optional refinement over a caught eligible
      exception (e.g. HTTP status in {429, 5xx});
    - ``min_delay_override``: per-exception floor on the next delay
      (Retry-After honoring);
    - ``seed``: deterministic jitter for tests.

    On exhaustion the last exception re-raises and the degradation is
    logged once per process (keyed by ``describe``).
    """
    policy = policy or RetryPolicy()
    rng = random.Random(seed)
    fixed = getattr(policy, "_fixed", None)
    start = time.monotonic()
    last: Optional[BaseException] = None
    attempts = 0
    for attempt in range(1, max(policy.max_attempts, 1) + 1):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — retry loop by design
            last = e
            attempts = attempt
            if should_retry is not None and not should_retry(e):
                raise
            if attempt >= policy.max_attempts:
                break
            delay = (fixed[attempt - 1] if fixed is not None
                     else policy.delay(attempt, rng))
            if min_delay_override is not None:
                floor = min_delay_override(e)
                if floor is not None:
                    delay = max(delay, floor)
            if policy.deadline is not None:
                remaining = policy.deadline - (time.monotonic() - start)
                if remaining <= 0:
                    break
                delay = min(delay, remaining)
            logger.info("%s failed (%s: %s); retry %d/%d in %.2fs",
                        describe, type(e).__name__, e, attempt,
                        policy.max_attempts - 1, delay)
            sleep(delay)
    assert last is not None
    elapsed = time.monotonic() - start
    detail = (f"{describe}: gave up after {attempts}/{policy.max_attempts} "
              f"attempts in {elapsed:.2f}s"
              + (f" (deadline {policy.deadline:.2f}s)"
                 if policy.deadline is not None else ""))
    warn_once(f"retry.exhausted.{describe}",
              "%s failed after %d attempts; giving up (last error: %s)",
              describe, attempts, last)
    _annotate(last, detail)
    raise last


def _annotate(exc: BaseException, detail: str) -> None:
    """Append retry attribution to ``exc``'s message in place, keeping
    the original exception type so callers' ``except`` clauses (and a
    ``TrainStalled`` wrapping a retried ``distributed_init``) still
    match — the *why it gave up* travels with the error."""
    try:
        if not exc.args:
            exc.args = (detail,)
        elif len(exc.args) == 1 and isinstance(exc.args[0], str):
            exc.args = (f"{exc.args[0]} [{detail}]",)
        elif hasattr(exc, "add_note"):
            exc.add_note(detail)
    except Exception:
        pass
