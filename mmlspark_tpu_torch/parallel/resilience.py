"""Train-step watchdog, stall attribution and elastic dp-shrink recovery
— the port's copy of the JAX package's ``parallel/resilience.py``.

A fit that stops making progress without dying (a collective whose peer
hangs, a card read that never returns, an input pipeline that starves)
looks the same from outside. This module turns that silence into an
attributed, recoverable error:

- :class:`TrainWatchdog` observes every train-step boundary (the
  trainers call :func:`step_start` / :func:`step_end`, one ``is None``
  check each while no watchdog is armed). It keeps a rolling window of
  completed host spans and a budget ``max(p99(window) *
  MMLSPARK_TORCH_WATCHDOG_MULT, MMLSPARK_TORCH_WATCHDOG_MIN_S)``. When an
  open span passes the budget, a monitor thread classifies the stall
  from the blocking boundary the fit thread marked (collective / host
  callback / input wait, :func:`mark_boundary`), logs a per-rank
  progress report and aborts the fit with :class:`TrainStalled`.

- :func:`stall_guard` is the fixed-budget form for one blocking call
  (each ``parallel.mesh.distributed_init`` attempt).

- :func:`fit_resilient` is the elastic recovery loop: on
  :class:`TrainStalled`, :class:`ParticipantLost` or an injected fault it
  re-forms the mesh on the surviving ``dp`` slice
  (:func:`parallel.mesh.shrink_mesh`) and fits again, resuming from the
  last segment checkpoint. The port's learners reduce exact integer sums
  and are the serial fit at every ``dp``, so a recovered fit is bitwise
  the uninterrupted serial checkpointed fit (the reference holds its
  own only to an uninterrupted run with the same mesh schedule, since
  its float histograms change with ``dp``).

Abort delivery: the monitor thread interrupts the fit thread with
``signal.pthread_kill(SIGUSR1)`` when the fit runs on the main thread
(the handler raises :class:`_WatchdogInterrupt`), else with
``PyThreadState_SetAsyncExc``. Both act only between bytecodes, so the
port's blocking waits stay interruptible while a watchdog is armed: the
mesh's collectives issue ``async_op=True`` and poll the work (NCCL) or
hand it to a waiter thread (gloo; ``parallel/mesh.py``), and host reads of card values poll a CUDA event
(:func:`wait_for_device`). With no watchdog armed they wait directly, as
before. ``_WatchdogInterrupt`` derives from ``BaseException`` so an
``except Exception`` cannot swallow it; the watchdog's ``__exit__``
turns it into the prepared :class:`TrainStalled`.

The step throttle (:func:`install_step_throttle`) runs at every
:func:`step_start` before any span opens: the streaming refresh loop
installs one for a low-priority refit that shares the process and the
card with a server (``io/refresh.py``).
"""

from __future__ import annotations

import ctypes
import signal
import threading
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import (Any, Callable, Dict, Iterator, List, Optional, Tuple,
                    Union)

from mmlspark_tpu_torch.core.env import (RECOVERY_MAX, RECOVERY_MIN_DP,
                                         WATCHDOG_INIT_S, WATCHDOG_MIN_S,
                                         WATCHDOG_MULT, env_float, env_int)
from mmlspark_tpu_torch.core.logging_utils import logger

__all__ = [
    "TrainStalled", "ParticipantLost", "TrainWatchdog", "FitRecovery",
    "ResilientFitResult", "fit_watchdog", "stall_guard", "fit_resilient",
    "step_start", "step_end", "install_step_throttle", "mark_boundary",
    "restore_boundary", "boundary", "stall_count", "recovery_count",
    "reset",
]


class TrainStalled(RuntimeError):
    """A train step exceeded the watchdog's stall budget.

    Carries the classification (``backend-hang`` / ``collective-stall`` /
    ``host-callback-stall`` / ``input-starvation``), the elapsed and
    budget seconds, and the per-rank progress report dict.
    """

    def __init__(self, message: str, *, classification: str, label: str,
                 elapsed_s: float, budget_s: float,
                 report: Optional[Dict[str, Any]] = None) -> None:
        super().__init__(message)
        self.classification = classification
        self.label = label
        self.elapsed_s = elapsed_s
        self.budget_s = budget_s
        self.report = report or {}


class ParticipantLost(RuntimeError):
    """A mesh participant died or became unreachable mid-fit."""


class _WatchdogInterrupt(BaseException):
    """Async delivery sentinel; translated to TrainStalled on exit.

    BaseException so library ``except Exception`` blocks can't eat it.
    """


# ---------------------------------------------------------------------------
# module-level hooks — the disabled fast path is one global None check
# ---------------------------------------------------------------------------

_active: Optional["TrainWatchdog"] = None
# set by fit_resilient around each fit on a gloo mesh of more than one
# rank (``recovery_watch``)
_recovery_watch: Optional[Callable[[], bool]] = None
_step_throttle: Optional[Callable[[Any], None]] = None
# the reference's sanitizer lock; a plain lock until ROADMAP A14
_lock = threading.Lock()
_stall_count = 0
_recovery_count = 0
# how often a blocking wait looks again while a watchdog is armed
_POLL_S = 0.0005


def install_step_throttle(fn: Optional[Callable[[Any], None]]
                          ) -> Optional[Callable[[Any], None]]:
    """Install (``None`` clears) a callable invoked at every train-step
    boundary with the step's tag (its iteration number, counting the
    trees of a warm start), before any watchdog span opens, so a yield
    never counts against the stall budget — the refit admission-control
    hook of ``io/refresh.py``. Returns the previous throttle so callers
    can restore it."""
    global _step_throttle
    prev = _step_throttle
    _step_throttle = fn
    return prev


def step_start(tag: Any = None) -> None:
    """Open a host span at a train-step boundary. Free when disabled."""
    if _step_throttle is not None:
        _step_throttle(tag)
    if _active is None:
        return
    _active._span_start(tag)


def span_start(tag: Any = None) -> None:
    """Open a host span that is not a train step (a fit's final drain):
    the throttle, which yields between steps, does not run. Free when
    disabled."""
    if _active is None:
        return
    _active._span_start(tag)


def step_end() -> None:
    """Close the current host span. Free when disabled; idempotent."""
    if _active is None:
        return
    _active._span_end()


def armed() -> bool:
    """Whether a watchdog is armed: blocking waits then poll, so that its
    interrupt can land."""
    return _active is not None


def recovery_watch() -> Optional[Callable[[], bool]]:
    """The check a collective's wait makes inside :func:`fit_resilient`
    (true once a peer began recovering from a loss), or None outside
    it."""
    return _recovery_watch


def polling() -> bool:
    """Whether the mesh's collectives wait interruptibly (a watchdog is
    armed, or a resilient fit on a gloo mesh of more than one rank
    watches for a peer's recovery) rather than wait in the backend."""
    return _active is not None or _recovery_watch is not None


def wait_for_device(device: Any) -> None:
    """Before a host read of values on ``device``: while a watchdog is
    armed and ``device`` is a CUDA device, wait for the card's queued
    work by polling a CUDA event, so the wait stays interruptible (a
    blocking copy or ``synchronize`` is not). Otherwise returns at once,
    and the read waits as it always did."""
    if _active is None or getattr(device, "type", None) != "cuda":
        return
    import torch
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(device))
    while not event.query():
        time.sleep(_POLL_S)


def mark_boundary(kind: Optional[str],
                  detail: Union[str, Callable[[], str], None] = None
                  ) -> Optional[Tuple[Any, Any]]:
    """Mark the kind of blocking call the fit thread is about to enter.

    ``kind`` is one of ``"collective"``, ``"host_callback"``,
    ``"input_wait"`` (or None to clear). ``detail`` may be a string or a
    zero-arg callable evaluated only if a stall fires. Returns the
    previous marker for :func:`restore_boundary`. Free when no watchdog
    is armed.
    """
    if _active is None:
        return None
    return _active._set_boundary(kind, detail)


def restore_boundary(prev: Optional[Tuple[Any, Any]]) -> None:
    """Restore a boundary marker saved by :func:`mark_boundary`."""
    if _active is None or prev is None:
        return
    _active._boundary = prev


class boundary:
    """Context-manager form of mark/restore for non-hot paths."""

    def __init__(self, kind: str,
                 detail: Union[str, Callable[[], str], None] = None) -> None:
        self._kind = kind
        self._detail = detail
        self._prev: Optional[Tuple[Any, Any]] = None

    def __enter__(self) -> "boundary":
        self._prev = mark_boundary(self._kind, self._detail)
        return self

    def __exit__(self, *exc: Any) -> None:
        restore_boundary(self._prev)


def stall_count() -> int:
    """Process-wide count of watchdog-fired stalls."""
    return _stall_count


def recovery_count() -> int:
    """Process-wide count of dp-shrink recoveries."""
    return _recovery_count


def reset() -> None:
    """Test hook: clear counters, any leaked active watchdog, and any
    leaked step throttle."""
    global _active, _step_throttle, _stall_count, _recovery_count
    _active = None
    _step_throttle = None
    _stall_count = 0
    _recovery_count = 0


_CLASSIFY = {
    "collective": "collective-stall",
    "host_callback": "host-callback-stall",
    "input_wait": "input-starvation",
}


def _p99(window: "deque[float]") -> float:
    ordered = sorted(window)
    return ordered[min(len(ordered) - 1, int(0.99 * len(ordered)))]


class TrainWatchdog:
    """Adaptive stall watchdog over train-step host spans.

    Use as a context manager around a fit; trainers feed it through the
    module-level :func:`step_start` / :func:`step_end` hooks. Disabled
    (``MULT <= 0`` and no fixed budget) it is a complete no-op: enter
    and exit do nothing, no thread is started, ``_active`` stays None so
    the hooks stay one check each and fits keep their bits.
    """

    _WINDOW = 64
    _MIN_SAMPLES = 8

    def __init__(self, label: str, *, mult: Optional[float] = None,
                 min_s: Optional[float] = None,
                 fixed_budget_s: Optional[float] = None,
                 classification: Optional[str] = None) -> None:
        self.label = label
        self.mult = env_float(WATCHDOG_MULT, 0.0) if mult is None else mult
        self.min_s = (env_float(WATCHDOG_MIN_S, 60.0, minimum=0.001)
                      if min_s is None else min_s)
        self.fixed_budget_s = fixed_budget_s
        self._fixed_classification = classification
        self.enabled = (fixed_budget_s is not None and fixed_budget_s > 0) \
            or self.mult > 0
        self._window: "deque[float]" = deque(maxlen=self._WINDOW)
        self._steps = 0
        self._span_t0: Optional[float] = None
        self._span_tag: Any = None
        self._boundary: Tuple[Optional[str],
                              Union[str, Callable[[], str], None]] = (None,
                                                                      None)
        self._stall: Optional[TrainStalled] = None
        self._fired = False
        self._closed = False
        self._monitor: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._observed: Optional[threading.Thread] = None
        self._prev_active: Optional["TrainWatchdog"] = None
        self._prev_handler: Any = None

    # -- span accounting (called from the fit thread via module hooks) --

    def _span_start(self, tag: Any) -> None:
        self._span_tag = tag
        self._span_t0 = time.monotonic()

    def _span_end(self) -> None:
        t0 = self._span_t0
        if t0 is None:
            return
        self._span_t0 = None
        self._window.append(time.monotonic() - t0)
        self._steps += 1

    def _set_boundary(self, kind: Optional[str],
                      detail: Union[str, Callable[[], str], None]
                      ) -> Tuple[Any, Any]:
        prev = self._boundary
        self._boundary = (kind, detail)
        return prev

    # -- budget ---------------------------------------------------------

    def budget_s(self) -> float:
        if self.fixed_budget_s is not None:
            return self.fixed_budget_s
        if len(self._window) >= self._MIN_SAMPLES:
            return max(_p99(self._window) * self.mult, self.min_s)
        return self.min_s

    # -- context manager ------------------------------------------------

    def __enter__(self) -> "TrainWatchdog":
        if not self.enabled:
            return self
        global _active
        with _lock:
            self._prev_active = _active
            _active = self
        self._observed = threading.current_thread()
        if self._observed is threading.main_thread():
            try:
                self._prev_handler = signal.signal(signal.SIGUSR1,
                                                   self._on_signal)
            except ValueError:  # not actually on the main thread
                self._prev_handler = None
        self._monitor = threading.Thread(
            target=self._monitor_loop,
            name=f"mmlspark-watchdog-{self.label}", daemon=True)
        self._monitor.start()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        if not self.enabled:
            return False
        global _active
        self._closed = True
        self._wake.set()
        with _lock:
            _active = self._prev_active
        if self._prev_handler is not None:
            try:
                signal.signal(signal.SIGUSR1, self._prev_handler)
            except ValueError:
                pass
        observed = self._observed
        if (observed is not None
                and observed is not threading.main_thread()
                and observed.ident is not None):
            # cancel any still-pending async exception
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(observed.ident), None)
        if self._monitor is not None:
            self._monitor.join(timeout=5.0)
        if exc_type is not None and issubclass(exc_type, _WatchdogInterrupt):
            assert self._stall is not None
            raise self._stall from None
        if exc_type is None and self._stall is not None:
            # the fit completed despite a fired stall (the monitor fired
            # as the blocking call returned): keep the result, log it
            logger.warning(
                "watchdog %s fired (%s) but the fit completed; "
                "keeping the result", self.label,
                self._stall.classification)
        return False

    # -- monitor thread -------------------------------------------------

    def _poll_interval(self) -> float:
        return max(0.02, min(self.budget_s() / 4.0, 0.25))

    def _monitor_loop(self) -> None:
        while not self._closed:
            self._wake.wait(self._poll_interval())
            if self._closed or self._fired:
                return
            t0 = self._span_t0
            if t0 is None:
                continue
            elapsed = time.monotonic() - t0
            budget = self.budget_s()
            if elapsed > budget:
                self._fire(elapsed, budget)
                return

    def _fire(self, elapsed: float, budget: float) -> None:
        global _stall_count
        self._fired = True
        kind, detail = self._boundary
        if callable(detail):
            try:
                detail = detail()
            except Exception:
                detail = "<detail unavailable>"
        classification = _CLASSIFY.get(
            kind, self._fixed_classification or "backend-hang")
        report = self._progress_report(elapsed, budget, kind, detail)
        logger.error("train stall detected: %s", report)
        with _lock:
            _stall_count += 1
        self._stall = TrainStalled(
            f"{self.label}: train step stalled for {elapsed:.2f}s "
            f"(budget {budget:.2f}s, classification {classification}"
            f"{', at ' + str(detail) if detail else ''})",
            classification=classification, label=self.label,
            elapsed_s=elapsed, budget_s=budget, report=report)
        self._deliver()

    def _progress_report(self, elapsed: float, budget: float,
                         kind: Optional[str],
                         detail: Any) -> Dict[str, Any]:
        from mmlspark_tpu_torch.parallel import mesh as mesh_mod
        window = sorted(self._window)
        return {
            "label": self.label,
            "rank": mesh_mod.process_index(),
            "span_tag": self._span_tag,
            "elapsed_s": round(elapsed, 3),
            "budget_s": round(budget, 3),
            "steps_observed": self._steps,
            "step_p50_s": round(window[len(window) // 2], 4) if window
            else None,
            "step_p99_s": round(_p99(self._window), 4) if window else None,
            "boundary": kind,
            "boundary_detail": detail,
            "last_collective": mesh_mod.last_collective(),
        }

    def _deliver(self) -> None:
        observed = self._observed
        if observed is None or observed.ident is None:
            return
        if observed is threading.main_thread() \
                and self._prev_handler is not None:
            signal.pthread_kill(observed.ident, signal.SIGUSR1)
        else:
            ctypes.pythonapi.PyThreadState_SetAsyncExc(
                ctypes.c_ulong(observed.ident),
                ctypes.py_object(_WatchdogInterrupt))

    def _on_signal(self, signum: int, frame: Any) -> None:
        # only raise for our own, still-armed stall; a stray SIGUSR1
        # returns and the interrupted sleep resumes (PEP 475)
        if _active is self and self._stall is not None and not self._closed:
            raise _WatchdogInterrupt()


def fit_watchdog(label: str) -> TrainWatchdog:
    """Env-configured watchdog for a trainer fit (off unless MULT > 0)."""
    return TrainWatchdog(label)


def init_budget_s() -> float:
    """``MMLSPARK_TORCH_WATCHDOG_INIT_S``: each rendezvous attempt's
    fixed budget in seconds (0: none)."""
    return env_float(WATCHDOG_INIT_S, 0.0)


@contextmanager
def stall_guard(label: str, budget_s: Optional[float] = None,
                classification: str = "backend-hang"
                ) -> Iterator[TrainWatchdog]:
    """Fixed-budget watchdog for one blocking call (e.g. backend init).

    With ``budget_s`` None the budget comes from
    ``MMLSPARK_TORCH_WATCHDOG_INIT_S`` (0 = disabled). The whole guarded
    block is timed as a single span.
    """
    if budget_s is None:
        budget_s = init_budget_s()
    wd = TrainWatchdog(label, mult=0.0, min_s=budget_s,
                       fixed_budget_s=budget_s if budget_s > 0 else None,
                       classification=classification)
    with wd:
        if wd.enabled:
            wd._span_start(label)
        yield wd


# ---------------------------------------------------------------------------
# elastic recovery
# ---------------------------------------------------------------------------


@dataclass
class FitRecovery:
    """One dp-shrink recovery hop taken by :func:`fit_resilient`."""
    cause: str
    classification: str
    dp_before: int
    dp_after: int
    error: str


@dataclass
class ResilientFitResult:
    """Outcome of :func:`fit_resilient`. On a rank that left the fit (its
    dp coordinate fell outside the kept slice) ``model`` and ``mesh`` are
    None."""
    model: Any
    recoveries: List[FitRecovery] = field(default_factory=list)
    mesh: Any = None


# how long fit_resilient's survivors wait for each other in the
# rendezvous store before they agree on who survived; a rank that has not
# posted by then counts as lost
RECOVERY_WAIT_S = 10.0
_STORE_ERROR = ("fit_resilient: the survivors cannot agree on a kept set: "
                "the rendezvous store is unreachable (was it held by a "
                "lost rank?)")


def _default_store() -> Any:
    """The default process group's rendezvous store (torch keeps it
    private: ``distributed_c10d._get_default_store``)."""
    import torch.distributed as dist
    return dist.distributed_c10d._get_default_store()


def _call_key(mesh: Any, store: Any) -> str:
    """The store keys' prefix of one ``fit_resilient`` call on ``mesh``:
    the mesh's ranks and this rank's count of calls on them, held in the
    store, so it starts at 0 in every new world and matches on every rank
    that makes the same calls."""
    base = ("mmlspark_tpu_torch/fit_resilient/"
            + ",".join(map(str, mesh.ranks)))
    return f"{base}/{store.add(f'{base}/calls/{mesh.rank}', 1) - 1}"


@contextmanager
def _watching(mesh: Any, store: Any, key: str) -> Iterator[None]:
    """Inside, on a gloo mesh of more than one rank: the mesh's
    collectives wait on a waiter thread and, while one waits, look for
    the ``begun`` flag of ``key``'s agreement in ``store``, so that a rank
    blocked on a peer that went on to recover raises
    :class:`ParticipantLost` and joins the agreement. On NCCL a
    collective only queues work, so there is no wait to end."""
    global _recovery_watch
    if mesh.backend != "gloo" or len(mesh.ranks) < 2:
        yield
        return

    def begun() -> bool:
        return store.check([f"{key}/begun"])

    prev = _recovery_watch
    _recovery_watch = begun
    try:
        yield
    finally:
        _recovery_watch = prev


def agree_survivors(mesh: Any, key: str, wait_s: Optional[float] = None,
                    store: Any = None) -> List[int]:
    """The dp coordinates of ``mesh`` that survived a loss, the same list
    on every survivor: each survivor posts its rank under ``key`` in the
    rendezvous ``store`` (default: the default process group's, which
    outlives dead ranks: a ``file://`` store, or a TCP store on a kept
    rank) and waits up to ``wait_s`` seconds (default
    :data:`RECOVERY_WAIT_S`) for every rank of the mesh to post. The first survivor done waiting writes the ranks it saw as
    the decision (the store's ``compare_set``: only the first write
    lands), and every survivor reads that. A dp coordinate survives where
    each of its ranks is in the decision (a survivor that posted too
    late is not: it leaves the fit). A store that fails raises
    :class:`ParticipantLost` with the same message on every survivor."""
    if store is None:
        store = _default_store()
    if wait_s is None:
        wait_s = RECOVERY_WAIT_S
    fp = mesh.shape["fp"]
    try:
        # the flag the other ranks' collectives watch for (a rank blocked
        # in a collective with a peer that went on to recover waits for
        # nothing else: gloo fails only the ops on a dead peer's pairs)
        store.set(f"{key}/begun", "1")
        store.set(f"{key}/rank/{mesh.rank}", "1")
        deadline = time.monotonic() + wait_s
        pause = 0.001
        while True:
            seen = [r for r in mesh.ranks
                    if store.check([f"{key}/rank/{r}"])]
            if len(seen) == len(mesh.ranks) or time.monotonic() >= deadline:
                break
            time.sleep(pause)
            pause = min(2 * pause, 0.05)
        decided = store.compare_set(f"{key}/decision", "",
                                    ",".join(map(str, seen)))
    except Exception as e:  # a gone TCP store: broken pipe, refused
        raise ParticipantLost(_STORE_ERROR) from e
    alive = {int(r) for r in decided.decode().split(",")}
    coords = len(mesh.ranks) // fp
    return [i for i in range(coords)
            if all(mesh.ranks[i * fp + j] in alive for j in range(fp))]


def fit_resilient(estimator: Any, df: Any, *, checkpoint_dir: str,
                  checkpoint_interval: int = 1, mesh: Any = None,
                  max_recoveries: Optional[int] = None,
                  min_dp: Optional[int] = None) -> ResilientFitResult:
    """Fit with segment checkpoints and elastic dp-shrink recovery.

    Every rank of ``mesh`` calls it with the same arguments. It runs
    ``estimator.fit`` with the checkpoint protocol armed
    (``checkpointDir`` / ``checkpointInterval``; under a mesh the mesh's
    first rank reads and writes the directory and broadcasts where to
    resume). If the fit dies with :class:`TrainStalled`,
    :class:`ParticipantLost` or an injected fault, the surviving ranks
    agree on which dp coordinates survived (:func:`agree_survivors`,
    through the rendezvous store, waiting at most
    :data:`RECOVERY_WAIT_S` seconds for each other) and keep the first
    ``dp // 2`` of them (all of them where fewer survive): with no rank
    lost, coordinates ``0 .. dp // 2 - 1``, as the reference keeps. A
    rank outside the kept coordinates leaves the fit and returns
    ``ResilientFitResult(model=None, mesh=None)``; the kept ranks re-form
    the mesh (:func:`parallel.mesh.shrink_mesh`, new process groups among
    themselves only) and fit again from the last segment checkpoint in
    the new first rank's ``checkpoint_dir`` (the fingerprint leaves out
    the mesh). Where rank 0 is not kept, that is another rank's
    directory: unless ``checkpoint_dir`` names storage that every rank
    shares (or the ranks share a host and pass one path), it holds no
    checkpoint and the fit starts again from iteration 0. The learners
    are the serial fit at every ``dp``, so the recovered model is bitwise
    the uninterrupted serial checkpointed fit.

    The agreement's store keys name the mesh's ranks and this rank's
    count of ``fit_resilient`` calls on them, kept in the store: every
    rank of ``mesh`` must make the same calls. On a gloo mesh of more
    than one rank every collective of the fit is waited on by the mesh's
    waiter thread while the fit's thread reads the store each 10 ms of a
    wait (:func:`polling`): a hand-off between two threads a collective.
    On an H100 with two gloo ranks the fault-free bench fit (2M x 28, 20
    trees) took 1.003x the wall of the same fit outside
    ``fit_resilient`` (``chip_smoke.py``'s ``resilience_path``). On NCCL
    a collective only queues work, and nothing waits for a recovery's
    flag.

    The rendezvous store must outlive the lost ranks: a ``file://``
    store, or a TCP store on a rank that survives. Where no kept set can
    be formed (the store is gone, or fewer than ``min_dp`` coordinates
    survive) every survivor raises the same :class:`ParticipantLost`,
    with the reason. A real loss is recovered only at ``fp == 1``: with
    ``fp > 1`` the survivors of one loss may sit in different rows and
    columns when it surfaces. A peer that died surfaces at the next
    collective of a group that holds it (gloo: "Connection closed by
    peer", as :class:`ParticipantLost`); a peer that hangs alive
    surfaces only through an armed watchdog or the process group's
    timeout.

    Recovery stops, re-raising the original error, when ``mesh`` is
    None, ``dp // 2`` is below ``min_dp``
    (``MMLSPARK_TORCH_RECOVERY_MIN_DP``), or ``max_recoveries``
    (``MMLSPARK_TORCH_RECOVERY_MAX``) is spent.
    """
    from mmlspark_tpu_torch.core.faults import FaultInjected
    from mmlspark_tpu_torch.parallel import mesh as mesh_mod

    if max_recoveries is None:
        max_recoveries = env_int(RECOVERY_MAX, 2)
    if min_dp is None:
        min_dp = env_int(RECOVERY_MIN_DP, 1)

    global _recovery_count
    est = estimator.copy(checkpointDir=checkpoint_dir,
                         checkpointInterval=checkpoint_interval)
    recoveries: List[FitRecovery] = []
    if mesh is None:
        return ResilientFitResult(model=est.fit(df), recoveries=recoveries)
    store = _default_store()
    call = _call_key(mesh, store)
    while True:
        key = f"{call}/{len(recoveries)}"
        try:
            with _watching(mesh, store, key):
                model = est.set_mesh(mesh).fit(df)
            return ResilientFitResult(model=model, recoveries=recoveries,
                                      mesh=mesh)
        except (TrainStalled, ParticipantLost, FaultInjected) as err:
            dp_before = mesh_mod.axis_size(mesh, mesh_mod.DATA_AXIS)
            if dp_before // 2 < min_dp or len(recoveries) >= max_recoveries:
                raise
            survivors = agree_survivors(mesh, key, store=store)
            kept = survivors[:dp_before // 2]
            dp_after = len(kept)
            if dp_after < min_dp:
                raise ParticipantLost(
                    f"fit_resilient: {len(survivors)} dp coordinate(s) "
                    f"survived, fewer than min_dp={min_dp}") from err
            classification = getattr(err, "classification",
                                     type(err).__name__)
            leaving = mesh_mod.axis_index(mesh, mesh_mod.DATA_AXIS) \
                not in kept
            logger.warning(
                "fit_resilient: %s (%s); re-forming mesh dp=%d -> dp=%d "
                "and resuming from the last segment checkpoint%s",
                type(err).__name__, classification, dp_before, dp_after,
                "; this rank leaves the fit" if leaving else "")
            recoveries.append(FitRecovery(
                cause=type(err).__name__, classification=str(classification),
                dp_before=dp_before, dp_after=dp_after, error=str(err)))
            with _lock:
                _recovery_count += 1
            if leaving:
                return ResilientFitResult(model=None, recoveries=recoveries,
                                          mesh=None)
            mesh = mesh_mod.shrink_mesh(
                mesh, lost_ranks=[i for i in range(dp_before)
                                  if i not in kept])
