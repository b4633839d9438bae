"""graftsan — the port's opt-in runtime sanitizer, its own copy of the
JAX package's ``core/sanitizer.py`` (same public names, exception
classes and message words), written over torch tensors and
``torch.distributed``:

* **NaN/Inf boundary guards** — :func:`check_finite` wraps values
  crossing a guarded boundary (the trainer's entry, exit and metric
  sync, the histogram wrappers, the out-of-core loop, the serving score
  path) and raises :class:`NonFiniteError` naming the boundary and the
  leaf, instead of letting a NaN flow through a reduction into every
  rank's model. A CUDA tensor costs one ``torch.isfinite(t).all()``
  reduction on the card per leaf and one host read per boundary (the
  leaves' flags are stacked and read once), never a read per element.
* **collective-sequence divergence detection** — the mesh's one
  collective choke point (``parallel/mesh.py`` ``_run``) and the
  attention ops' ring and all-to-all exchanges call
  :func:`record_collective` once per collective they issue: op, axis,
  shape, dtype, in the reference's vocabulary (``psum``,
  ``reduce_scatter``, ``all_gather``, ``pbroadcast``, ``ppermute``,
  ``all_to_all``). The port has no trace: its collectives are issued
  eagerly, so the sequence is recorded as it runs. :func:`step_boundary`
  hashes the cumulative sequence and, on a mesh of more than one rank,
  all-gathers every rank's hash and names the first rank that disagrees.
  The events and their hashing are the reference's, so the same events
  give the same ``sequence_hash`` in both packages.
* **recompilation budget** — what the port builds once per new key
  reports through :func:`count_recompile`: a serving scorer's first
  batch of a new shape (``io/serving.py`` ``_BinnedPlane._mark_shape``,
  the twin of the reference's binned scorer) and ``ShardedScorer``'s
  first call on a new rung (``parallel/shard_rules.py``). A per-process
  budget (``MMLSPARK_TORCH_SAN_RECOMPILE_BUDGET``) turns shape churn
  into a hard signal. The reference also counts its trainer's compile
  misses; the port's twin of that compile is a new captured step (a
  miss of ``models/gbdt/step.py``'s cache), and a sanitized fit never
  captures (below), so no sanitized fit builds one to count.
* **dtype contracts (graftdtype)** — :func:`check_dtype_contract`
  records the dtype signature of every array leaf crossing a parity
  boundary the first time it crosses (a torch leaf's dtype written as
  numpy names it: ``float32``, ``int64``, ...), and raises
  :class:`DtypeDrift` naming the boundary and the leaf path when a later
  crossing disagrees. Gated by ``MMLSPARK_TORCH_SAN_DTYPE`` (default on)
  so the rest of the sanitizer can run with contracts off.
* **lock-order recorder (graftlock)** — :func:`san_lock` wraps the
  locks and conditions that the reference wraps (``resilience.state``,
  ``native.build``, ``refresh.stream_buffer``, ``serving.http.active``,
  ``serving.server``, ``serving.continuous.score``,
  ``serving.fleet.servers``, ``serving.fleet.client``); enabled, every
  acquire checks the acquisition against a global lock-order graph and
  raises :class:`LockOrderViolation` *before* blocking when two threads
  take the same pair in opposite orders. Hold times past
  ``MMLSPARK_TORCH_SAN_LOCK_HOLD_MS`` warn with the acquire site. The
  port's other plain locks have no twin in the reference and stay plain:
  the step cache's and each cached step's (``models/gbdt/step.py``), the
  fault registry's (``core/faults.py``), the warn-once set's
  (``core/logging_utils.py``) and the retry budgets' and circuit
  breakers' (``core/retries.py``).

Zero-overhead contract (the pattern of ``faults.fault_point``): every
entry point reads ONE module-global boolean and returns at once when
the sanitizer is off. Enable with ``MMLSPARK_TORCH_SAN=1`` (read at
import; :func:`refresh_from_env` re-reads it) or :func:`enable`.

The captured step: a CUDA graph replays kernels, not Python, so a check
inside the captured training step would run once, at capture, and a host
read there is refused during capture. While the sanitizer is on, a fit
therefore runs its step uncaptured (as it does with a fault armed inside
the step), and the ``gbdt.level_hist`` check runs after every histogram
launch. The uncaptured step grows bitwise the captured step's trees, so
a clean sanitized fit gives the trees of the same fit unsanitized.

Cross-rank checks: every rank of a mesh must run with the sanitizer in
the same state. :func:`step_boundary` issues an all-gather on the mesh
only while the sanitizer is on, so enabling it on one rank alone leaves
that rank waiting in the gather while the others go on to their next
collective: the ranks hang (or a mismatched collective fails). Set
``MMLSPARK_TORCH_SAN`` for every rank alike. :func:`reset` at run start,
as ``trainer.train`` does, keeps the ranks' cumulative hashes comparable.
"""

from __future__ import annotations

import hashlib
import sys
import threading
import time
import warnings
from contextlib import contextmanager
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core import env

__all__ = [
    "SanitizerError", "NonFiniteError", "CollectiveDivergence",
    "RecompileBudgetExceeded", "LockOrderViolation",
    "SanLockHoldWarning", "DtypeDrift", "enabled", "enable", "disable",
    "refresh_from_env", "reset", "check_finite",
    "check_dtype_contract", "dtype_contracts", "record_collective",
    "CollectiveRecorder", "recorder", "use_recorder", "last_collective",
    "step_boundary",
    "crosscheck_hashes", "count_recompile", "recompile_count",
    "set_recompile_budget", "san_lock", "set_lock_hold_budget_ms",
    "lock_order_edges",
]


class SanitizerError(RuntimeError):
    """Base class for graftsan diagnostics."""


class NonFiniteError(SanitizerError):
    """A NaN/Inf crossed a guarded boundary."""


class CollectiveDivergence(SanitizerError):
    """Ranks disagree on the collective sequence for a step."""


class RecompileBudgetExceeded(SanitizerError):
    """More builds than the per-process budget allows."""


class LockOrderViolation(SanitizerError):
    """Two threads acquired the same lock pair in opposite orders (the
    ABBA deadlock class). Carries the acquiring thread's name, the
    names of the locks it already held, and the lock it was about to
    take; the message names both call sites."""

    def __init__(self, message: str, thread: str = "",
                 held: Sequence[str] = (), acquiring: str = "") -> None:
        super().__init__(message)
        self.thread = thread
        self.held = tuple(held)
        self.acquiring = acquiring


class DtypeDrift(SanitizerError):
    """A value crossed a parity boundary with a dtype signature that
    disagrees with the one recorded at the boundary's first crossing.
    Carries the boundary name, the drifting leaf's path and the
    before/after dtype names."""

    def __init__(self, message: str, boundary: str = "",
                 leaf: str = "", before: str = "",
                 after: str = "") -> None:
        super().__init__(message)
        self.boundary = boundary
        self.leaf = leaf
        self.before = before
        self.after = after


class SanLockHoldWarning(RuntimeWarning):
    """A san_lock was held past MMLSPARK_TORCH_SAN_LOCK_HOLD_MS."""


# fast-path flag: every public entry point checks this one module
# global and returns immediately when the sanitizer is off
_enabled = False

_lock = threading.Lock()
_recompiles = 0
_recompile_budget = 0          # 0 = count only, never raise
_recent_recompiles: List[str] = []
_RECENT_KEEP = 8


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def refresh_from_env() -> None:
    """Re-read ``MMLSPARK_TORCH_SAN`` / ``_SAN_RECOMPILE_BUDGET`` /
    ``_SAN_LOCK_HOLD_MS`` / ``_SAN_DTYPE`` (call after changing them
    in-process, e.g. under ``env_override``)."""
    global _enabled, _recompile_budget, _lock_hold_budget_ms
    global _dtype_enabled
    _enabled = env.env_flag(env.SAN, False)
    _recompile_budget = env.env_int(env.SAN_RECOMPILE_BUDGET, 0, minimum=0)
    _lock_hold_budget_ms = env.env_float(env.SAN_LOCK_HOLD_MS, 0.0,
                                         minimum=0.0)
    _dtype_enabled = env.env_flag(env.SAN_DTYPE, True)


def reset() -> None:
    """Clear recorded state (collective events, recompile counter,
    lock-order graph, dtype contracts) without touching the enabled
    flag. Run-start and test hook."""
    global _recompiles
    with _lock:
        _recompiles = 0
        _recent_recompiles.clear()
    with _dtype_lock:
        _dtype_contracts.clear()
    _recorder.clear()
    with _order_lock:
        _order_edges.clear()
    # held stacks are thread-local; clear at least the calling thread's
    # so a test that aborted mid-acquire starts clean
    getattr(_tls, "held", []) and _tls.held.clear()


# --- NaN/Inf boundary guards -----------------------------------------------

def check_finite(boundary: str, value: Any) -> Any:
    """Return ``value`` unchanged; when the sanitizer is enabled, raise
    :class:`NonFiniteError` naming ``boundary`` if any floating-point
    leaf (torch tensor, numpy array or scalar, Python float) contains
    NaN or Inf. Disabled cost: one boolean check."""
    if not _enabled:
        return value
    bad = _find_non_finite(value)
    if bad is not None:
        path, nan_count, inf_count, shape = bad
        raise NonFiniteError(
            f"graftsan: non-finite values at jit boundary "
            f"{boundary!r}: {nan_count} NaN / {inf_count} Inf in "
            f"{path} (shape {shape}); enable the fault log or bisect "
            f"with MMLSPARK_TORCH_SAN=1 upstream of this boundary")
    return value


def _float_leaves(value: Any, path: str, out: List[Tuple[str, Any]]
                  ) -> None:
    """Collect ``(path, leaf)`` for every floating-point leaf of
    ``value`` in walk order (dicts by key order, lists and tuples by
    index): Python floats, numpy float/complex arrays and scalars, torch
    float/complex tensors. Integer, bool, string and dtype-less leaves
    carry no NaN and are skipped."""
    if value is None or isinstance(value, (bool, int, str, bytes)):
        return
    if isinstance(value, float):
        out.append((path, value))
        return
    if isinstance(value, dict):
        for k, v in value.items():
            _float_leaves(v, f"{path}[{k!r}]", out)
        return
    if isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _float_leaves(v, f"{path}[{i}]", out)
        return
    if isinstance(value, torch.Tensor):
        if value.is_floating_point() or value.is_complex():
            out.append((path, value))
        return
    dtype = getattr(value, "dtype", None)
    if dtype is None:
        return
    try:
        kind = np.dtype(dtype).kind
    except TypeError:
        return    # extension dtypes: not float
    if kind in "fc":
        out.append((path, value))


def _find_non_finite(value: Any
                     ) -> Optional[Tuple[str, int, int, tuple]]:
    """``(path, NaN count, Inf count, shape)`` of the first leaf in walk
    order that is not finite, or None. The tensors' flags are computed on
    their devices and read in one host copy per device; counts are taken
    only for the leaf that fails."""
    leaves: List[Tuple[str, Any]] = []
    _float_leaves(value, "value", leaves)
    by_device: Dict[torch.device, List[int]] = {}
    for i, (_, leaf) in enumerate(leaves):
        if isinstance(leaf, torch.Tensor):
            by_device.setdefault(leaf.device, []).append(i)
    finite: Dict[int, bool] = {}
    for idx in by_device.values():
        flags = torch.stack([torch.isfinite(leaves[i][1]).all()
                             for i in idx]).tolist()
        finite.update(zip(idx, flags))
    for i, (path, leaf) in enumerate(leaves):
        if isinstance(leaf, float):
            if leaf != leaf or leaf in (float("inf"), float("-inf")):
                return (path, int(leaf != leaf), int(leaf == leaf), ())
        elif isinstance(leaf, torch.Tensor):
            if not finite[i]:
                return (path, int(torch.isnan(leaf).sum()),
                        int(torch.isinf(leaf).sum()), tuple(leaf.shape))
        else:
            arr = np.asarray(leaf)
            if not np.isfinite(arr).all():
                return (path, int(np.isnan(arr).sum()),
                        int(np.isinf(arr).sum()), tuple(arr.shape))
    return None


# --- dtype contracts (graftdtype runtime twin) ------------------------------

_dtype_enabled = True          # secondary gate under _enabled
_dtype_lock = threading.Lock()
# boundary name -> {leaf path: dtype name} recorded at first crossing
_dtype_contracts: Dict[str, Dict[str, str]] = {}


def check_dtype_contract(boundary: str, value: Any) -> Any:
    """Return ``value`` unchanged; when the sanitizer is enabled (and
    ``MMLSPARK_TORCH_SAN_DTYPE`` is not 0), record the dtype signature of
    every array leaf in ``value`` the first time ``boundary`` is
    crossed, and raise :class:`DtypeDrift` naming the boundary and the
    drifting leaf when a later crossing disagrees.

    Only leaves present in *both* signatures are compared: boundaries
    with optional payloads (a probe batch without labels, a validation
    set's weights) don't false-positive on arity. Disabled cost: one
    boolean check."""
    if not _enabled:
        return value
    if not _dtype_enabled:
        return value
    sig: Dict[str, str] = {}
    _dtype_signature(value, "value", sig)
    with _dtype_lock:
        recorded = _dtype_contracts.get(boundary)
        if recorded is None:
            _dtype_contracts[boundary] = sig
            return value
        for leaf, dt in sig.items():
            before = recorded.get(leaf)
            if before is not None and before != dt:
                raise DtypeDrift(
                    f"graftsan: dtype drift at parity boundary "
                    f"{boundary!r}: leaf {leaf} was {before} at the "
                    f"first crossing, now {dt} — a width change on a "
                    f"parity path silently breaks resume/failover "
                    f"bitwise parity (graftlint GL013-GL016's runtime "
                    f"counterpart); pin the dtype at the producer or "
                    f"reset() if the contract legitimately changed",
                    boundary=boundary, leaf=leaf, before=before,
                    after=dt)
        recorded.update(
            (k, v) for k, v in sig.items() if k not in recorded)
    return value


def _dtype_name(dtype: Any) -> str:
    """A dtype's name as numpy writes it: a torch dtype without its
    ``torch.`` prefix (``float32``, ``int64``, ``bfloat16``), anything
    else through ``str``."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return str(dtype)


def _dtype_signature(value: Any, path: str, out: Dict[str, str]) -> None:
    """Walk ``value`` like :func:`_float_leaves`, collecting ``{leaf
    path: dtype name}`` for every array leaf (a torch tensor, or
    anything with a numpy-coercible ``dtype``); host scalars and strings
    carry no width contract and are skipped."""
    if value is None or isinstance(value, (bool, int, float, str,
                                           bytes)):
        return
    if isinstance(value, dict):
        for k, v in value.items():
            _dtype_signature(v, f"{path}[{k!r}]", out)
        return
    if isinstance(value, (list, tuple)):
        for i, v in enumerate(value):
            _dtype_signature(v, f"{path}[{i}]", out)
        return
    if isinstance(value, torch.Tensor):
        out[path] = _dtype_name(value.dtype)
        return
    dtype = getattr(value, "dtype", None)
    if dtype is None:
        return
    try:
        out[path] = np.dtype(dtype).name
    except TypeError:
        return    # extension dtypes: no contract


def dtype_contracts() -> Dict[str, Dict[str, str]]:
    """Snapshot of the recorded per-boundary dtype signatures
    (test/debug hook)."""
    with _dtype_lock:
        return {b: dict(sig) for b, sig in _dtype_contracts.items()}


# --- collective-sequence recorder ------------------------------------------

class CollectiveRecorder:
    """Accumulates (op, axis, shape, dtype) collective events for one
    rank/process; swappable via :func:`use_recorder` so tests can run
    simulated ranks against separate recorders."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.events: List[Tuple[str, str, tuple, str]] = []

    def record(self, op: str, axis: Any, shape: Any = None,
               dtype: Any = None) -> None:
        event = (str(op), _axis_str(axis),
                 tuple(shape) if shape is not None else (),
                 _dtype_name(dtype) if dtype is not None else "")
        with self._lock:
            self.events.append(event)

    def last(self) -> Optional[Tuple[str, str, tuple, str]]:
        with self._lock:
            return self.events[-1] if self.events else None

    def sequence_hash(self) -> str:
        with self._lock:
            blob = repr(self.events).encode("utf-8")
        return hashlib.sha1(blob).hexdigest()[:16]

    def clear(self) -> None:
        with self._lock:
            self.events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self.events)


def _axis_str(axis: Any) -> str:
    if isinstance(axis, (tuple, list)):
        return ",".join(str(a) for a in axis)
    return str(axis)


_recorder = CollectiveRecorder()
_active_recorder: Optional[CollectiveRecorder] = None


def recorder() -> CollectiveRecorder:
    return _active_recorder if _active_recorder is not None else _recorder


def last_collective() -> Optional[Tuple[str, str, tuple, str]]:
    """Most recent collective event recorded on the active recorder, or
    None (populated only while graftsan is enabled, since
    :func:`record_collective` is behind the ``_enabled`` gate). The
    train watchdog's stall report reads the mesh's own record instead
    (``parallel.mesh.last_collective``), kept whenever a watchdog is
    armed."""
    return recorder().last()


@contextmanager
def use_recorder(r: CollectiveRecorder) -> Iterator[CollectiveRecorder]:
    """Route :func:`record_collective` to ``r`` inside the block — how
    tests simulate two ranks issuing (possibly divergent) collective
    sequences in one process."""
    global _active_recorder
    prev = _active_recorder
    _active_recorder = r
    try:
        yield r
    finally:
        _active_recorder = prev


# the collective vocabulary the sequence cross-check understands: the
# reference's, so both packages hash one protocol alike. The port's
# spellings map onto it: all_reduce sum / max / min -> psum / pmax /
# pmin, reduce_scatter, all_gather, broadcast -> pbroadcast, the ring's
# send/receive -> ppermute, all_to_all_single -> all_to_all.
KNOWN_COLLECTIVES = frozenset((
    "psum", "pmean", "pmax", "pmin", "all_gather", "all_to_all",
    "ppermute", "pshuffle", "psum_scatter", "reduce_scatter",
    "pbroadcast", "pcast",
))

_warned_unknown_ops: set = set()


def record_collective(op: str, axis: Any, shape: Any = None,
                      dtype: Any = None) -> None:
    """Instrumentation hook called once per collective the port issues
    (the mesh's ``_run``, the attention ops' exchanges), before it is
    issued. Disabled cost: one boolean check.

    ``op`` should come from :data:`KNOWN_COLLECTIVES`; an unknown kind
    still records (the cross-check hashes whatever sequence ran) but
    warns once per op, since a typo'd kind would silently weaken the
    divergence check's diagnostics."""
    if not _enabled:
        return
    if op not in KNOWN_COLLECTIVES and op not in _warned_unknown_ops:
        _warned_unknown_ops.add(op)
        warnings.warn(
            f"graftsan: record_collective got unknown collective kind "
            f"{op!r} (known: {sorted(KNOWN_COLLECTIVES)}); recording "
            f"anyway", stacklevel=2)
    recorder().record(op, axis, shape, dtype)


def crosscheck_hashes(hashes: Sequence[str],
                      tag: str = "step") -> None:
    """Pure agreement check over per-rank sequence hashes: raises
    :class:`CollectiveDivergence` naming the first divergent rank."""
    if not hashes:
        return
    reference = hashes[0]
    for rank, h in enumerate(hashes):
        if h != reference:
            raise CollectiveDivergence(
                f"graftsan: collective-sequence divergence at "
                f"{tag!r}: rank {rank} hash {h} != rank 0 hash "
                f"{reference} — ranks compiled different collective "
                f"protocols (the `if rank == 0: psum` deadlock class); "
                f"diff the ranks' recorded (op, axis, shape, dtype) "
                f"sequences")


def step_boundary(tag: str = "step", mesh: Any = None) -> str:
    """Hash the cumulative recorded collective sequence; on a ``mesh``
    (``parallel.mesh.Mesh``) of more than one rank, all-gather every
    rank's hash over the mesh's group and raise
    :class:`CollectiveDivergence` on every rank, naming the first rank
    (in the mesh's rank order) that disagrees. Returns the local hash
    ('' when the sanitizer is off).

    The gather is one ``parallel.mesh.all_gather`` of a 16-byte uint8
    tensor (the hex digest's characters): a collective boundary like
    the mesh's others, so an armed watchdog can interrupt it, and not
    itself recorded. It runs only while the sanitizer is on: every rank
    must call this with the sanitizer in the same state, or the ranks
    that did not gather hang the ones that did."""
    if not _enabled:
        return ""
    h = recorder().sequence_hash()
    if mesh is None or mesh.size <= 1:
        return h
    crosscheck_hashes(_allgather_hash(h, mesh), tag=tag)
    return h


def _allgather_hash(h: str, mesh: Any) -> List[str]:
    from mmlspark_tpu_torch.parallel import mesh as mesh_mod

    local = torch.frombuffer(bytearray(h.ljust(16, "0").encode("ascii")),
                             dtype=torch.uint8)
    rows = mesh_mod.all_gather(mesh, local, axis="mesh", tag="sanitizer",
                               record=False)
    return [bytes(row).decode("ascii")
            for row in rows.cpu().reshape(mesh.size, -1).tolist()]


# --- recompilation budget ---------------------------------------------------

def count_recompile(description: str) -> None:
    """Build caches report misses here; with a budget set, the
    (budget+1)-th miss raises :class:`RecompileBudgetExceeded` listing
    the most recent build descriptions."""
    if not _enabled:
        return
    global _recompiles
    with _lock:
        _recompiles += 1
        _recent_recompiles.append(description[:200])
        del _recent_recompiles[:-_RECENT_KEEP]
        count = _recompiles
        budget = _recompile_budget
        recent = list(_recent_recompiles)
    if budget and count > budget:
        raise RecompileBudgetExceeded(
            f"graftsan: {count} compilations exceed the per-process "
            f"budget of {budget} (MMLSPARK_TORCH_SAN_RECOMPILE_BUDGET); "
            f"recent: {recent} — look for unstable cache keys (GL003) "
            f"or shape churn")


def recompile_count() -> int:
    return _recompiles


def set_recompile_budget(budget: int) -> None:
    global _recompile_budget
    _recompile_budget = max(0, int(budget))


# --- lock-discipline recorder (graftlock runtime twin) ----------------------

_lock_hold_budget_ms = 0.0     # 0 = hold-time check off
_order_lock = threading.Lock()
# directed lock-order edges: (held, acquired) -> (held site, acquire
# site) of the first acquisition that established the order
_order_edges: Dict[Tuple[str, str], Tuple[str, str]] = {}
_tls = threading.local()

_THIS_FILE = __file__


def _held_stack() -> List[Tuple[str, str, float]]:
    held = getattr(_tls, "held", None)
    if held is None:
        held = _tls.held = []
    return held


def _call_site() -> str:
    """``path:line`` of the nearest frame outside this module — the
    production call site that acquired/released the lock."""
    f = sys._getframe(1)
    while f is not None and f.f_code.co_filename == _THIS_FILE:
        f = f.f_back
    if f is None:
        return "<unknown>"
    fn = f.f_code.co_filename
    parts = fn.replace("\\", "/").rsplit("/", 3)[-2:]
    return f"{'/'.join(parts)}:{f.f_lineno}"


def _check_order(name: str, site: str) -> None:
    """Raise :class:`LockOrderViolation` if taking ``name`` while the
    current held-set contains a lock that some thread has ever taken
    *after* ``name`` — i.e. the (held, name) pair has been seen in the
    opposite order. Called before blocking on the real lock, so the
    ABBA drill aborts instead of deadlocking."""
    held = _held_stack()
    if not held:
        return
    thread = threading.current_thread().name
    with _order_lock:
        for h_name, h_site, _t0 in held:
            if h_name == name:
                continue    # reentrant re-acquire: not an order edge
            rev = _order_edges.get((name, h_name))
            if rev is not None:
                raise LockOrderViolation(
                    f"graftsan: lock-order inversion (potential ABBA "
                    f"deadlock): thread {thread!r} holds {h_name!r} "
                    f"(acquired at {h_site}) and is acquiring {name!r} "
                    f"at {site}, but the opposite order "
                    f"{name!r} -> {h_name!r} was recorded earlier "
                    f"(held at {rev[0]}, acquired at {rev[1]}); pick "
                    f"one acquisition order for this pair",
                    thread=thread,
                    held=[h for h, _s, _t in held],
                    acquiring=name)
            _order_edges.setdefault((h_name, name), (h_site, site))


def _note_acquired(name: str, site: str) -> None:
    _held_stack().append((name, site, time.perf_counter()))


def _note_released(name: str) -> None:
    held = _held_stack()
    for i in range(len(held) - 1, -1, -1):
        if held[i][0] == name:
            _n, site, t0 = held.pop(i)
            budget = _lock_hold_budget_ms
            if budget > 0.0:
                ms = (time.perf_counter() - t0) * 1e3
                if ms > budget:
                    warnings.warn(
                        f"graftsan: lock {name!r} held {ms:.1f}ms > "
                        f"MMLSPARK_TORCH_SAN_LOCK_HOLD_MS={budget:g} "
                        f"(acquired at {site}, released at "
                        f"{_call_site()}) — hoist blocking work out "
                        f"of the critical section (GL012)",
                        SanLockHoldWarning, stacklevel=3)
            return


class _SanLock:
    """Lock wrapper produced by :func:`san_lock`. Disabled, every
    operation is one module-global check plus direct delegation to the
    wrapped ``threading`` primitive (the fault_point contract)."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str, lock: Any) -> None:
        self.name = name
        self._lock = lock

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _enabled:
            return self._lock.acquire(blocking, timeout)
        site = _call_site()
        _check_order(self.name, site)
        ok = self._lock.acquire(blocking, timeout)
        if ok:
            _note_acquired(self.name, site)
        return ok

    def release(self) -> None:
        self._lock.release()
        if _enabled:
            _note_released(self.name)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> "_SanLock":
        if not _enabled:
            self._lock.acquire()
            return self
        self.acquire()
        return self

    def __exit__(self, exc_type: Any, exc: Any, tb: Any) -> bool:
        if not _enabled:
            self._lock.release()
            return False
        self.release()
        return False

    def __repr__(self) -> str:
        return f"<san_lock {self.name!r} wrapping {self._lock!r}>"


class _SanCondition(_SanLock):
    """Condition wrapper: wait()/notify() delegate to the wrapped
    ``threading.Condition``; for hold-time accounting a ``wait`` is a
    release + re-acquire (the condition drops the lock while parked, so
    parked time must not count against the hold budget)."""

    __slots__ = ()

    def wait(self, timeout: Optional[float] = None) -> bool:
        if not _enabled:
            return self._lock.wait(timeout)
        _note_released(self.name)
        try:
            return self._lock.wait(timeout)
        finally:
            _note_acquired(self.name, _call_site())

    def wait_for(self, predicate: Any,
                 timeout: Optional[float] = None) -> Any:
        if not _enabled:
            return self._lock.wait_for(predicate, timeout)
        _note_released(self.name)
        try:
            return self._lock.wait_for(predicate, timeout)
        finally:
            _note_acquired(self.name, _call_site())

    def notify(self, n: int = 1) -> None:
        self._lock.notify(n)

    def notify_all(self) -> None:
        self._lock.notify_all()


def san_lock(name: str, kind: str = "lock") -> _SanLock:
    """Factory for discipline-monitored locks.

    ``kind`` is ``"lock"`` (default), ``"rlock"`` or ``"condition"``.
    ``name`` keys the global lock-order graph — instances of the same
    class share a name, so an order established on one server instance
    constrains every other (exactly what ABBA detection wants).
    Disabled (the default), the wrapper adds one boolean check per
    operation."""
    if kind == "lock":
        return _SanLock(name, threading.Lock())
    if kind == "rlock":
        return _SanLock(name, threading.RLock())
    if kind == "condition":
        return _SanCondition(name, threading.Condition())
    raise ValueError(
        f"san_lock: unknown kind {kind!r} (expected 'lock', 'rlock' "
        f"or 'condition')")


def set_lock_hold_budget_ms(ms: float) -> None:
    global _lock_hold_budget_ms
    _lock_hold_budget_ms = max(0.0, float(ms))


def lock_order_edges() -> Dict[Tuple[str, str], Tuple[str, str]]:
    """Snapshot of the recorded lock-order graph (test/debug hook)."""
    with _order_lock:
        return dict(_order_edges)


# arm from the environment at import, like faults.arm_from_env()
refresh_from_env()
