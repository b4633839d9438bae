"""Chaos-hardened streaming model refresh: ingest → drift → warm-start
refit → atomic hot-swap — the port's copy of the JAX package's
``io/refresh.py``. The refit runs on the estimator's device (the card
unless ``set_device("cpu")``): each of its levels launches the level
histogram kernel, and its probe and served batches the tree scorer. A
refit beside a server in the same process shares the card with it.

The reference keeps served models fresh by re-running batch pipelines
and re-deploying; a long-lived single-process engine needs the loop
*inside* the process: fresh labeled rows stream into a bounded buffer,
a drift detector decides when the served model has gone stale, a
warm-start refit extends the model on the buffered window, and the
serving registry flips to the new model atomically — old model serving
until the new one has proven itself on a scored batch.

Pieces, each chaos-tested against the reference
(tests/test_torch_refresh.py):

  - :class:`StreamBuffer` — bounded labeled-row ingestion
    (``MMLSPARK_TORCH_STREAM_BUFFER`` rows); a full buffer **blocks the
    producer** (backpressure) instead of growing without bound, the
    same contract as the serving queues and
    :class:`~mmlspark_tpu_torch.parallel.prefetch.BatchPrefetcher`, whose
    producer/consumer shape :meth:`RefreshController.pump` reuses for
    background ingestion. Fault point ``stream.ingest``.
  - :class:`~mmlspark_tpu_torch.exploratory.drift.DriftDetector` — PSI/KS
    over seeded reservoir windows arms a refit
    (``MMLSPARK_TORCH_DRIFT_THRESHOLD``); a time-based fallback refit
    fires every ``MMLSPARK_TORCH_REFRESH_INTERVAL_S`` seconds so a
    slowly-rotting model refreshes even when no single feature trips
    the detector.
  - warm-start refit — ``fit_incremental`` on the estimator: GBDT adds
    trees on the fresh window (resuming mid-refit kills from the
    estimator's segment checkpoints, bitwise identical to an unkilled
    run); VW's continued weight vector waits for ROADMAP A12.
    Fault point ``refresh.fit``. The drained window is **retained**
    until the refit commits, so a killed refit retries on identical
    data.
  - generation commit — each refreshed model persists through the
    crash-safe checkpoint protocol (:func:`~mmlspark_tpu_torch.core.
    serialize.save_checkpoint`; manifest written last is the commit
    point); a restarted controller resumes from
    :func:`~mmlspark_tpu_torch.core.serialize.load_latest_checkpoint`.
    The layout is the reference's, so a generation directory written by
    either package resumes in the other.
  - atomic hot-swap — :meth:`~mmlspark_tpu_torch.io.serving.
    ServingServer.swap_model`: new plane built cold, registry pointer
    flipped under the model lock, ``/healthz`` ``degraded`` for the
    window, old scorer freed only after the new model scores a clean
    batch — rollback (old model keeps serving) on any failure. Fault
    point ``registry.swap``.
"""

from __future__ import annotations

import hashlib
import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.env import (REFRESH_INTERVAL_S,
                                         REFRESH_PRIORITY, REFRESH_YIELD_S,
                                         STREAM_BUFFER, env_float, env_int,
                                         env_str)
from mmlspark_tpu_torch.core.faults import fault_point
from mmlspark_tpu_torch.core.logging_utils import logger, warn_once
from mmlspark_tpu_torch.core.serialize import (dir_digest,
                                               load_latest_checkpoint,
                                               load_stage, save_checkpoint,
                                               save_stage)
from mmlspark_tpu_torch.exploratory.drift import DriftDetector, DriftReport
from mmlspark_tpu_torch.io.serving import ServingServer, SwapFailed
from mmlspark_tpu_torch.ops.ingest import resolve_spill_verify
from mmlspark_tpu_torch.parallel import resilience
from mmlspark_tpu_torch.parallel.prefetch import BatchPrefetcher

__all__ = ["StreamBuffer", "RefreshController", "RefreshResult"]


class StreamBuffer:
    """Bounded buffer of labeled training rows with producer
    backpressure.

    ``put`` blocks while admitting the block would exceed ``capacity``
    rows (default ``MMLSPARK_TORCH_STREAM_BUFFER``); a block larger than
    the whole capacity is admitted only into an empty buffer (it could
    never fit otherwise — refusing it would deadlock the producer).
    ``drain`` hands the consumer everything buffered and wakes blocked
    producers. Thread-safe; ``close`` unblocks every waiter."""

    def __init__(self, capacity: Optional[int] = None):
        if capacity is None:
            capacity = env_int(STREAM_BUFFER, 65536, minimum=1)
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = int(capacity)
        # the reference's san_lock("refresh.stream_buffer",
        # kind="condition")
        self._lock = threading.Condition()
        self._blocks: list = []          # [(x_block, y_block), ...]
        self._rows = 0
        self._closed = False
        self.total_rows = 0              # lifetime ingested

    @property
    def rows(self) -> int:
        with self._lock:
            return self._rows

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def put(self, x: np.ndarray, y: np.ndarray,
            timeout: Optional[float] = None) -> bool:
        """Buffer a labeled block; blocks under backpressure. Returns
        False on timeout (rows NOT buffered), True when buffered.
        Raises RuntimeError when the buffer is closed."""
        x = np.atleast_2d(np.asarray(x, dtype=np.float64))
        y = np.asarray(y, dtype=np.float64).ravel()
        if len(x) != len(y):
            raise ValueError(
                f"features/labels row mismatch: {len(x)} vs {len(y)}")
        # chaos boundary: a producer dying (raise) or stalling (delay)
        # mid-ingest — the loop must keep serving and later refit on
        # whatever DID arrive
        fault_point("stream.ingest")
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._lock:
            # canonical predicate loop: the backpressure
            # condition is re-tested after every wakeup, and the wait
            # itself carries no control flow of its own
            while (not self._closed and self._rows > 0
                   and self._rows + len(x) > self.capacity):
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    return False
                self._lock.wait(0.5 if remaining is None else remaining)
            if self._closed:
                raise RuntimeError("put() on a closed StreamBuffer")
            self._blocks.append((x, y))
            self._rows += len(x)
            self.total_rows += len(x)
            self._lock.notify_all()
        return True

    def drain(self) -> Tuple[np.ndarray, np.ndarray]:
        """Everything buffered as one ``(x, y)`` pair (``(0, 0)``-row
        arrays when empty); wakes producers blocked on a full buffer."""
        with self._lock:
            blocks, self._blocks = self._blocks, []
            self._rows = 0
            self._lock.notify_all()
        if not blocks:
            return (np.empty((0, 0), dtype=np.float64),
                    np.empty((0,), dtype=np.float64))
        return (np.concatenate([b[0] for b in blocks]),
                np.concatenate([b[1] for b in blocks]))

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify_all()


class _RefitYield:
    """Refit admission control: installed as the resilience step
    throttle (:func:`~mmlspark_tpu_torch.parallel.resilience.\\
install_step_throttle`) for the duration of a low-priority refit
    co-located with live serving. At every train-step boundary it
    snapshots the bound server's total queue depth (lock-free read — an
    approximate depth is fine for a throttle) and, while the queue sits
    at or past the server's priority high-water mark, sleeps in short
    slices until the data plane drains or the per-step yield budget
    (``MMLSPARK_TORCH_REFRESH_YIELD_S``) is spent: the refit hands the
    core to the scoring thread instead of racing it for the interpreter
    lock and the card, which is what "a background refit cannot starve
    the data plane" means mechanically."""

    def __init__(self, server: ServingServer,
                 max_yield_s: Optional[float] = None,
                 poll_s: float = 0.005):
        self.server = server
        if max_yield_s is None:
            max_yield_s = env_float(REFRESH_YIELD_S, 2.0, minimum=0.0)
        self.max_yield_s = float(max_yield_s)
        self.poll_s = poll_s
        self.yields = 0
        self.yield_s = 0.0

    def _depth(self) -> int:
        try:
            return sum(len(m.queue)
                       for m in list(self.server._models.values()))
        except RuntimeError:
            return 0  # registry resized mid-iteration; skip this read

    def __call__(self, tag: Any = None) -> None:
        if self._depth() < self.server.queue_high_water:
            return
        self.yields += 1
        t0 = time.monotonic()
        while (time.monotonic() - t0 < self.max_yield_s
               and self._depth() >= self.server.queue_high_water):
            time.sleep(self.poll_s)
        self.yield_s += time.monotonic() - t0


@dataclass
class RefreshResult:
    """One committed :meth:`RefreshController.refresh` cycle."""

    generation: int
    model: Any
    rows: int                            # rows the refit trained on
    trigger: str                         # drift | interval | forced
    drift: Optional[DriftReport]
    refit_s: float
    swap: Optional[Dict[str, Any]] = None   # swap_model timings
    swap_error: Optional[str] = None        # rollback reason, if any
    total_s: float = 0.0

    @property
    def swapped(self) -> bool:
        return self.swap is not None


class RefreshController:
    """Drive the ingest → drift → refit → hot-swap loop for one model.

    ``estimator``: the configured estimator whose ``fit_incremental``
    extends the served model (the port's ``LightGBMClassifier`` /
    ``LightGBMRegressor`` add trees; VW's learners are ROADMAP A12 and
    any estimator without ``fit_incremental`` raises naming it). The
    refit runs on the estimator's device (``set_device``; the card by
    default), and a generation resumed from disk is set to that device
    too. ``model``: the currently-served generation — superseded on
    construction by a newer committed generation found in
    ``checkpoint_dir`` (crash recovery). ``server``/``model_name``:
    when given, every committed refresh hot-swaps the serving registry
    via :meth:`ServingServer.swap_model` (rollback on failure leaves
    the old model serving and is reported, not raised).

    ``segment_interval`` threads through the estimator's own
    checkpointing (trees per GBDT segment) so a refit killed mid-flight
    resumes from its latest segment; the drained window is retained
    until commit, so the retry sees identical data and the resumed
    model is **bitwise identical** to an unkilled run."""

    def __init__(self, estimator, model, checkpoint_dir: str,
                 server: Optional[ServingServer] = None,
                 model_name: Optional[str] = None,
                 detector: Optional[DriftDetector] = None,
                 buffer: Optional[StreamBuffer] = None,
                 refresh_interval_s: Optional[float] = None,
                 min_refit_rows: int = 256,
                 segment_interval: int = 1,
                 reference_rows: Optional[np.ndarray] = None,
                 priority: Optional[str] = None):
        if not callable(getattr(estimator, "fit_incremental", None)):
            raise NotImplementedError(
                f"warm-start refits of {type(estimator).__name__} are not "
                "in the port yet: the port refits its LightGBM estimators"
                " (VW's continued weight vector is ROADMAP A12)")
        self.estimator = estimator
        self.checkpoint_dir = checkpoint_dir
        self.server = server
        self.model_name = model_name
        self.detector = detector if detector is not None else DriftDetector()
        self.buffer = buffer if buffer is not None else StreamBuffer()
        if refresh_interval_s is None:
            # 0 = interval trigger off (drift/forced refreshes only)
            refresh_interval_s = env_int(REFRESH_INTERVAL_S, 300,
                                         minimum=0)
        self.refresh_interval_s = float(refresh_interval_s)
        self.min_refit_rows = int(min_refit_rows)
        self.segment_interval = int(segment_interval)
        self.model = model
        self.generation = 0
        # refit admission control: at "low" (the default), a refit
        # sharing a process with self.server installs the train-step
        # throttle so serving queue pressure pauses the refit, never
        # the other way around
        if priority is None:
            priority = env_str(REFRESH_PRIORITY, "low") or "low"
        priority = priority.strip().lower()
        if priority not in ("low", "high"):
            warn_once("refresh.priority",
                      "%s=%r is not low|high; using low",
                      REFRESH_PRIORITY, priority)
            priority = "low"
        self.priority = priority
        # drained-but-uncommitted window: survives a killed refit so
        # the retry trains on the same rows (determinism contract)
        self._pending: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self._last_refresh = time.monotonic()
        self.stats = {"refreshes": 0, "refresh_failures": 0,
                      "swaps": 0, "swap_failures": 0,
                      "drift_arms": 0, "interval_arms": 0,
                      "tap_rows": 0, "tap_dropped": 0,
                      "refit_yields": 0, "refit_yield_s": 0.0,
                      "leaked_thread": None}
        if reference_rows is not None:
            self.detector.set_reference(reference_rows)
        # crash recovery: the newest committed generation on disk wins
        # over the caller's model (the caller typically passes the
        # generation-0 fit, which a restart must not re-serve)
        latest = load_latest_checkpoint(checkpoint_dir,
                                        self._config_hash(),
                                        validate=self._validate_generation)
        if latest is not None:
            tag, state = latest
            self.generation = int(tag)
            self.model = load_stage(
                os.path.join(checkpoint_dir, state["model_dir"]))
            if hasattr(self.model, "set_device"):
                # a loaded stage runs on the card; it follows the refit
                self.model.set_device(getattr(estimator, "_device", None))
            logger.info("refresh: resumed generation %d from %s",
                        self.generation, checkpoint_dir)

    def _validate_generation(self, tag: int, state: dict):
        """load_latest_checkpoint hook: re-digest the generation's
        model directory against the digest its manifest committed.
        A mismatch (bit-rot in a staged model file — the npz crc only
        covers the manifest payload) makes the loader skip this
        generation and fall back to the previous committed one, so a
        restart never serves — or crashes on — rotten bytes.
        Pre-digest generations pass unverified."""
        digest = state.get("model_digest")
        if digest is None:
            return None
        if resolve_spill_verify() == "off":
            return None
        model_dir = os.path.join(self.checkpoint_dir, state["model_dir"])
        actual = dir_digest(model_dir)
        if actual != digest:
            return (f"generation {tag} model payload in {model_dir} "
                    f"fails its digest (manifest {digest}, on disk "
                    f"{actual}) — silent bit-rot")
        return None

    def _config_hash(self) -> str:
        """Stable digest of the refit configuration: a restarted
        controller with changed estimator params must refuse the old
        generations rather than silently continue them."""
        items = sorted(self.estimator.simple_param_values().items())
        return hashlib.sha256(
            f"refresh:{type(self.estimator).__name__}:{items!r}"
            .encode()).hexdigest()[:16]

    # -- ingestion -----------------------------------------------------------
    def observe(self, x: np.ndarray, y: np.ndarray,
                timeout: Optional[float] = None) -> bool:
        """Feed fresh labeled rows: buffered for the next refit and
        absorbed into the drift detector's current window. Blocks
        under buffer backpressure; False on timeout."""
        ok = self.buffer.put(x, y, timeout=timeout)
        if ok:
            self.detector.update(np.atleast_2d(
                np.asarray(x, dtype=np.float64)))
        return ok

    def pump(self, stream: Iterable[Tuple[np.ndarray, np.ndarray]],
             depth: Optional[int] = None) -> int:
        """Drain an iterable of ``(x, y)`` blocks through a bounded
        background producer into the buffer (the input-pipeline
        overlap of parallel/prefetch.py applied to ingestion: the
        stream source runs ahead on its own thread, bounded by
        ``depth`` staged blocks plus the buffer's row capacity).
        Returns rows ingested; the producer thread is always joined on
        exit, exceptions included, with the prefetcher's 10s join
        budget — a producer wedged past it is surfaced warn-once by
        the prefetcher and recorded in ``stats["leaked_thread"]``
        instead of silently dropped."""
        rows = 0
        prefetcher = BatchPrefetcher(stream, depth=depth,
                                     label="refresh-ingest")
        try:
            with prefetcher as staged:
                for x, y in staged:
                    self.observe(x, y)
                    rows += len(np.atleast_2d(x))
        finally:
            # the close already happened (with-exit runs even when an
            # armed stream.ingest fault raises out of observe); what
            # remains is surfacing its leak verdict
            self.stats["leaked_thread"] = \
                prefetcher.stats().get("leaked_thread")
        return rows

    def tap_serving(self, server: Optional[ServingServer] = None,
                    label_fn: Optional[Any] = None,
                    model_name: Optional[str] = None):
        """Close the loop: feed this controller's refit window from a
        server's own scored traffic. Registers a request-log tap
        (:meth:`ServingServer.observe_log`) that converts every scored
        batch into labeled rows — features straight from each request
        payload's ``featuresCol`` field, label from
        ``label_fn(payload, reply_row)`` (default: the served
        ``prediction``, i.e. self-training pseudo-labels; pass a real
        labeler when ground truth travels with the request).

        The tap NEVER blocks the data plane: rows are offered to the
        buffer with a zero timeout and *dropped* under backpressure
        (counted in ``stats["tap_dropped"]``; delivered rows in
        ``stats["tap_rows"]``) — the durable request log, not this
        best-effort tap, is the source of truth for replaying a refit
        window. Returns the registered tap callable."""
        server = server if server is not None else self.server
        if server is None:
            raise ValueError(
                "tap_serving() needs a server: pass one or construct "
                "the controller with server=")
        features_col = self.estimator.get("featuresCol")

        def _tap(name: str, payloads, cols) -> None:
            rows, labels = [], []
            for i, payload in enumerate(payloads):
                feats = payload.get(features_col)
                if feats is None:
                    continue
                reply_row = {c: cols[c][i] for c in cols}
                if label_fn is not None:
                    label = label_fn(payload, reply_row)
                else:
                    col = ("prediction" if "prediction" in reply_row
                           else next(iter(reply_row)))
                    label = reply_row[col]
                if label is None:
                    continue  # labeler abstained; not a window row
                rows.append(np.asarray(feats, dtype=np.float64).ravel())
                labels.append(float(np.asarray(label).ravel()[0]))
            if not rows:
                return
            if self.observe(np.stack(rows), np.asarray(labels),
                            timeout=0.0):
                self.stats["tap_rows"] += len(rows)
            else:
                self.stats["tap_dropped"] += len(rows)

        server.observe_log(_tap, model_name=model_name)
        return _tap

    # -- refresh decision ----------------------------------------------------
    def poll(self) -> Tuple[Optional[str], DriftReport]:
        """Should a refit run now? Returns ``(trigger, report)`` with
        trigger ``"drift"`` | ``"interval"`` | ``None``."""
        report = self.detector.check()
        pending = 0 if self._pending is None else len(self._pending[0])
        if self.buffer.rows + pending < self.min_refit_rows:
            return None, report
        if report.drifted:
            return "drift", report
        # 0 = interval trigger off (the checkpointInterval convention):
        # drift and forced refreshes only
        if (self.refresh_interval_s > 0
                and time.monotonic() - self._last_refresh
                >= self.refresh_interval_s):
            return "interval", report
        return None, report

    def maybe_refresh(self, swap: bool = True) -> Optional[RefreshResult]:
        """One loop tick: refit + hot-swap iff armed; None otherwise."""
        trigger, report = self.poll()
        if trigger is None:
            return None
        self.stats["drift_arms" if trigger == "drift"
                   else "interval_arms"] += 1
        return self.refresh(swap=swap, trigger=trigger, drift=report)

    # -- refit + commit + swap -----------------------------------------------
    def refresh(self, swap: bool = True, trigger: str = "forced",
                drift: Optional[DriftReport] = None) -> RefreshResult:
        """Warm-start refit on the buffered window, commit the new
        generation, hot-swap the registry.

        Kill-safety: the drained window lands in ``_pending`` before
        the fault boundary and is only cleared at commit — a refit
        killed anywhere in between retries on identical rows, and the
        estimator's segment checkpoints resume its partial progress
        (``gen_<N>_segments/``). A failed hot-swap is reported on the
        result (``swap_error``), never raised: the old model keeps
        serving, which is the rollback contract."""
        t0 = time.monotonic()
        x, y = self.buffer.drain()
        if self._pending is not None:
            px, py = self._pending
            if len(x):
                x = np.concatenate([px, x])
                y = np.concatenate([py, y])
            else:
                x, y = px, py
        if len(x) == 0:
            raise RuntimeError(
                "refresh() with an empty window: observe()/pump() rows "
                "first (or lower min_refit_rows and use maybe_refresh)")
        self._pending = (x, y)
        gen = self.generation + 1
        seg_dir = os.path.join(self.checkpoint_dir,
                               f"gen_{gen:08d}_segments")
        # admission control: a low-priority refit co-located with live
        # serving yields at train-step boundaries while the serving
        # queue sits past high water (restored even on a killed refit)
        throttle: Optional[_RefitYield] = None
        prev_throttle = None
        if self.server is not None and self.priority == "low":
            throttle = _RefitYield(self.server)
            prev_throttle = resilience.install_step_throttle(throttle)
        try:
            # chaos boundary: the refit killed at entry (raise) or fed
            # a mangled window (corrupt) — retried refits must resume
            # deterministically
            fault_point("refresh.fit")
            df = DataFrame({
                self.estimator.get("featuresCol"): x,
                self.estimator.get("labelCol"): y})
            new_model = self.estimator.fit_incremental(
                df, base_model=self.model,
                checkpoint_dir=seg_dir,
                checkpoint_interval=self.segment_interval)
        except Exception:
            self.stats["refresh_failures"] += 1
            raise
        finally:
            if throttle is not None:
                resilience.install_step_throttle(prev_throttle)
                self.stats["refit_yields"] += throttle.yields
                self.stats["refit_yield_s"] += throttle.yield_s
        refit_s = time.monotonic() - t0
        # generation commit: stage dir first, crash-safe manifest last
        # (the save_checkpoint manifest is the commit point — a kill
        # between the two leaves the generation invisible and the
        # retry rewrites it)
        model_dir = f"gen_{gen:08d}_model"
        save_stage(new_model,
                   os.path.join(self.checkpoint_dir, model_dir))
        save_checkpoint(self.checkpoint_dir, gen,
                        {"model_dir": model_dir, "rows": int(len(x)),
                         "trigger": trigger,
                         "model_digest": dir_digest(os.path.join(
                             self.checkpoint_dir, model_dir))},
                        self._config_hash())
        self.model = new_model
        self.generation = gen
        self._pending = None
        self._last_refresh = time.monotonic()
        self.detector.promote()
        self.stats["refreshes"] += 1
        result = RefreshResult(generation=gen, model=new_model,
                               rows=int(len(x)), trigger=trigger,
                               drift=drift, refit_s=refit_s)
        if swap and self.server is not None:
            name = self.model_name or self.server._default
            # probe with a row from the refit window so eviction of the
            # old plane is always gated on a real scored batch
            probe = {self.estimator.get("featuresCol"): x[-1].tolist()}
            try:
                result.swap = self.server.swap_model(
                    name, new_model, probe_payload=probe)
                self.stats["swaps"] += 1
            except SwapFailed as e:
                self.stats["swap_failures"] += 1
                result.swap_error = str(e)
                logger.warning(
                    "refresh: generation %d hot-swap rolled back, the "
                    "previous model keeps serving (%s)", gen, e)
        result.total_s = time.monotonic() - t0
        return result

    def close(self) -> None:
        self.buffer.close()
