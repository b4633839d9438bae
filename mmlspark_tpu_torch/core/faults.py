"""Deterministic fault injection — the port's copy of the JAX package's
``core/faults.py``.

Named injection points that production code threads through a
``fault_point()`` call, and that tests arm programmatically (:func:`arm`
/ :func:`injected`) or through ``MMLSPARK_TORCH_FAULTS`` to raise, delay
or corrupt on the Nth hit. Disarmed, ``fault_point`` reads one module
global and returns its value: it never syncs with the card, allocates
on it or launches anything.

Points are registered (``KNOWN_POINTS``, the reference's whole list) and
a test pins that every ``fault_point("...")`` call site in the port
names a registered one. The port places the training-path points
(``gbdt.train_step``, ``gbdt.level_hist``, ``checkpoint.write``,
``io.disk_full``) and those of serving, the fleet and the refresh loop
(``serving.score``, ``serving.worker_kill``, ``serving.observe_log``,
``registry.swap``, ``registry.swap_fanout``, ``fleet.spawn``,
``fleet.heartbeat``, ``net.half_open``, ``net.slow_reply``,
``net.latency``, ``stream.ingest``, ``refresh.fit``); the rest belong
to modules not yet ported.

Env interface::

    MMLSPARK_TORCH_FAULTS="gbdt.train_step:raise:7,checkpoint.write:delay:1:0.2"

comma-separated ``point:action[:nth[:param]]`` specs; ``action`` is
``raise`` | ``delay`` | ``corrupt``, ``nth`` is the 1-based hit that
triggers (default 1, every hit from there on), ``param`` is the delay
in seconds for ``delay``. Parsed once at import; call
:func:`arm_from_env` after changing the variable in-process.

``corrupt`` passes the point's value through the armed callable. At
``gbdt.level_hist`` that value is the histogram tensor on the fit's
device, so a corrupting callable written with torch ops (``torch.
zeros_like``, ``h * 2``) stays on the device and makes no host sync.

Determinism contract: each point counts its hits process-wide (thread
safe), so for a deterministic workload the Nth hit is the same
operation every run — a fit interrupted at hit N and resumed is a
reproducible experiment, not a flake.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

__all__ = ["FaultInjected", "KNOWN_POINTS", "fault_point", "arm",
           "disarm", "reset", "hits", "fired", "injected",
           "arm_from_env"]


class FaultInjected(RuntimeError):
    """Raised by an armed ``raise`` fault (default exception)."""


# Canonical registry: point name -> where it lives / what arming it
# simulates. Production call sites must use names listed here.
KNOWN_POINTS: Dict[str, str] = {
    "gbdt.train_step": "trainer boosting loop, once per dispatched "
                       "iteration — a preempted/killed training step",
    "gbdt.level_hist": "native/numpy level-histogram kernel entry — a "
                       "wrong or slow histogram from the data plane",
    "native.callback": "host-callback boundary of the native histogram "
                       "primitive — a hung or failing C++ callback",
    "allreduce": "host sync boundaries of cross-replica reductions "
                 "(trainer metric sync, VW inter-pass weight average)",
    "serving.score": "ServingServer micro-batch scoring — a slow or "
                     "failing model under load",
    "io.http": "outbound HTTP attempt in HTTPTransformer — a flaky "
               "remote service",
    "checkpoint.write": "checkpoint persistence — a full disk or "
                        "failing blob store",
    "distributed.init": "multi-process rendezvous in distributed_init "
                        "— a coordinator that is slow to come up",
    "stream.ingest": "streaming refresh loop's bounded-buffer put "
                     "(io/refresh.py) — a stalled or dying producer "
                     "feeding the ingestion stream",
    "refresh.fit": "streaming refresh loop's warm-start refit entry — "
                   "a refit killed mid-flight (must resume from the "
                   "latest checkpoint bitwise)",
    "registry.swap": "serving registry's atomic model hot-swap "
                     "(ServingServer.swap_model) — a corrupted or "
                     "crashed swap that must roll back to the old "
                     "model",
    "registry.swap_fanout": "fleet-wide two-phase swap fan-out "
                            "(FleetSupervisor.swap_model_fleet), once "
                            "per worker prepare — a worker that dies "
                            "mid-fan-out; every already-prepared "
                            "worker must roll back and the old model "
                            "keeps serving fleet-wide",
    "serving.observe_log": "serving request-log tap "
                           "(ServingServer._notify_taps) — a dying or "
                           "stalling observer; the data plane must "
                           "keep replying and the refresh loop later "
                           "replays the dropped rows from the durable "
                           "request log",
    "fleet.spawn": "ServingFleet worker construction "
                   "(ServingFleet._make_server) — a worker that fails "
                   "to come up; the supervisor's restart path must "
                   "retry with backoff",
    "fleet.heartbeat": "FleetSupervisor /healthz probe "
                       "(io/fleet.py) — a lost or timed-out "
                       "heartbeat; K consecutive misses mark the "
                       "worker dead and evict it",
    "serving.worker_kill": "ServingServer batch loop, once per drained "
                           "batch — armed, the worker dies abruptly "
                           "mid-batch (no flush, connections reset) to "
                           "prove fleet failover and supervised "
                           "restart",
    "mesh.collective_hang": "host sync boundary of a cross-replica "
                            "reduction (trainer metric sync, DL epoch "
                            "loss fetch) — an armed delay simulates a "
                            "collective that never completes; the "
                            "train watchdog must abort with a "
                            "collective-stall attribution instead of "
                            "hanging",
    "train.participant_loss": "trainer step loops (GBDT + DL), once "
                              "per dispatched step — armed, a mesh "
                              "participant is lost mid-fit; "
                              "fit_resilient must re-form the mesh on "
                              "the surviving dp slice and resume from "
                              "the last segment checkpoint bitwise",
    "io.disk_full": "guarded persistence writes (spill chunks, "
                    "chunk-store state, checkpoint payloads and "
                    "manifests) — an ENOSPC/quota failure; writers "
                    "raise the attributed DiskFull and callers "
                    "degrade (OOC falls back in-core when the rows "
                    "permit, checkpoint writes skip with a warn-once) "
                    "instead of crashing the fit",
    "spill.read": "spill-plane chunk read (SpillReader / ChunkStore), "
                  "applied to the payload bytes before checksum "
                  "verification — an armed corrupt simulates disk "
                  "bit-rot, which the crc32 check must catch and "
                  "either repair from the source chunk iterator or "
                  "raise an attributed SpillCorrupt",
    "net.latency": "FleetClient outbound socket layer "
                   "(FleetClient._post) — an armed delay is network "
                   "RTT inflation / a slow connect, an armed raise a "
                   "dropped connection; hedging + breakers must keep "
                   "tail latency bounded",
    "net.half_open": "ServingServer request handler entry — an armed "
                     "delay means the worker ACCEPTED the connection "
                     "then stalls before reading or replying (a "
                     "half-open connection); clients must fail over "
                     "within their deadline instead of hanging, an "
                     "armed raise tears the connection down with no "
                     "HTTP reply",
    "net.slow_reply": "ServingServer reply write path — an armed "
                      "delay is a gray worker whose replies crawl out "
                      "(headers/body stall) while heartbeats still "
                      "pass; the supervisor's p99-outlier detection "
                      "must classify it gray-degraded and recycle it",
}

_VALID_ACTIONS = ("raise", "delay", "corrupt")


@dataclass
class _Armed:
    action: str
    nth: int = 1                 # 1-based hit that starts triggering
    count: Optional[int] = None  # max triggers (None = every hit >= nth)
    delay_s: float = 0.05
    exc: Optional[BaseException] = None
    corrupt: Optional[Callable[[Any], Any]] = None
    hits: int = 0
    fired: int = 0


_lock = threading.Lock()
_armed: Dict[str, _Armed] = {}
_hit_counts: Dict[str, int] = {}
# fast-path flag: fault_point() reads ONE module global and returns when
# nothing is armed anywhere, so disarmed production hot paths pay a
# single attribute load + branch
_enabled = False


def fault_point(name: str, value: Any = None) -> Any:
    """Declare an injection point; returns ``value`` (possibly corrupted).

    Production code calls this unconditionally; with nothing armed it is
    one global-boolean check (no lock, no device work). With a fault armed on ``name``:

      - ``raise``: raises the armed exception (:class:`FaultInjected`
        by default) on the configured hits;
      - ``delay``: sleeps ``delay_s`` seconds;
      - ``corrupt``: passes ``value`` through the armed ``corrupt``
        callable and returns the result.
    """
    if not _enabled:
        return value
    return _slow_fault_point(name, value)


def _slow_fault_point(name: str, value: Any) -> Any:
    with _lock:
        _hit_counts[name] = _hit_counts.get(name, 0) + 1
        spec = _armed.get(name)
        if spec is None:
            return value
        spec.hits += 1
        if spec.hits < spec.nth:
            return value
        if spec.count is not None and spec.fired >= spec.count:
            return value
        spec.fired += 1
        action, delay_s = spec.action, spec.delay_s
        exc, corrupt = spec.exc, spec.corrupt
    # act outside the lock: a delay must not serialize other points
    if action == "raise":
        raise exc if exc is not None else FaultInjected(
            f"injected fault at {name!r} (hit {spec.hits})")
    if action == "delay":
        time.sleep(delay_s)
        return value
    if action == "corrupt":
        return corrupt(value) if corrupt is not None else value
    return value


def arm(name: str, action: str = "raise", *, nth: int = 1,
        count: Optional[int] = 1, delay_s: float = 0.05,
        exc: Optional[BaseException] = None,
        corrupt: Optional[Callable[[Any], Any]] = None) -> None:
    """Arm ``name`` to trigger ``action`` starting at the ``nth`` hit,
    for at most ``count`` triggers (``None`` = unbounded)."""
    global _enabled
    if name not in KNOWN_POINTS:
        raise ValueError(f"unknown fault point {name!r}; register it in "
                         f"mmlspark_tpu_torch.core.faults.KNOWN_POINTS "
                         f"(have: {sorted(KNOWN_POINTS)})")
    if action not in _VALID_ACTIONS:
        raise ValueError(f"action must be one of {_VALID_ACTIONS}, "
                         f"got {action!r}")
    with _lock:
        _armed[name] = _Armed(action=action, nth=nth, count=count,
                              delay_s=delay_s, exc=exc, corrupt=corrupt)
        _enabled = True


def disarm(name: str) -> None:
    global _enabled
    with _lock:
        _armed.pop(name, None)
        _enabled = bool(_armed)


def reset() -> None:
    """Disarm everything and zero all hit counters."""
    global _enabled
    with _lock:
        _armed.clear()
        _hit_counts.clear()
        _enabled = False


def is_armed(name: str) -> bool:
    """Whether a fault is armed on ``name`` (one flag check when nothing
    is armed anywhere)."""
    if not _enabled:
        return False
    with _lock:
        return name in _armed


def hits(name: str) -> int:
    """Process-wide hit count of a point while any fault was armed
    (counting is part of the slow path: 0 when nothing was ever armed)."""
    with _lock:
        return _hit_counts.get(name, 0)


def fired(name: str) -> int:
    """How many times the fault currently armed on ``name`` actually
    triggered (0 when disarmed) — the chaos-fuzz campaign's per-point
    coverage signal."""
    with _lock:
        spec = _armed.get(name)
        return 0 if spec is None else spec.fired


@contextmanager
def injected(name: str, action: str = "raise", **kwargs):
    """Scoped :func:`arm`; always disarms on exit (exceptions included),
    so an armed test fault can never leak into later tests."""
    arm(name, action, **kwargs)
    try:
        yield
    finally:
        disarm(name)


def arm_from_env(env: Optional[str] = None) -> None:
    """Parse ``MMLSPARK_TORCH_FAULTS`` (or ``env``) and arm the specs in
    it. Malformed entries raise immediately — a chaos run with a typo'd
    spec silently doing nothing would report false health."""
    from mmlspark_tpu_torch.core.env import FAULTS, env_str
    raw = env if env is not None else env_str(FAULTS, "")
    for entry in filter(None, (e.strip() for e in raw.split(","))):
        parts = entry.split(":")
        if len(parts) < 2:
            raise ValueError(
                f"bad {FAULTS} entry {entry!r}; expected "
                "point:action[:nth[:param]]")
        name, action = parts[0], parts[1]
        nth = int(parts[2]) if len(parts) > 2 else 1
        kwargs: Dict[str, Any] = {"nth": nth, "count": None}
        if action == "delay" and len(parts) > 3:
            kwargs["delay_s"] = float(parts[3])
        arm(name, action, **kwargs)


arm_from_env()
