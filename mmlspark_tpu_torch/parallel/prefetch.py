"""Background-thread batch prefetch — the port's copy of
``BatchPrefetcher`` and ``resolve_prefetch_depth`` from the JAX
package's ``parallel/prefetch.py``, host side.

A background thread pulls items from an iterator, applies ``place_fn``
(identity by default) and stages up to ``MMLSPARK_TORCH_PREFETCH_DEPTH``
of them in a bounded queue while the consumer works on the current
one. The streaming refresh loop's ``RefreshController.pump`` runs its
ingestion stream through it (``io/refresh.py``).

Depth 0 feeds synchronously — same items, same order, no thread.

Teardown contract: ``close()`` (or leaving the ``with`` block, even on
an exception) stops the producer thread and joins it; a producer still
alive after the join budget is named in :meth:`BatchPrefetcher.stats`
and warned about once.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

from mmlspark_tpu_torch.core.env import PREFETCH_DEPTH, env_int
from mmlspark_tpu_torch.core.logging_utils import warn_once
from mmlspark_tpu_torch.parallel import resilience

_SENTINEL_DONE = object()


def resolve_prefetch_depth(depth: Optional[int] = None) -> int:
    """Staged-batch budget: explicit ``depth`` wins, else the
    MMLSPARK_TORCH_PREFETCH_DEPTH knob (default 2 — double buffering).
    0 means synchronous feeding."""
    if depth is not None:
        return max(int(depth), 0)
    return env_int(PREFETCH_DEPTH, 2, minimum=0)


class BatchPrefetcher:
    """Iterate ``source`` with ``place_fn`` applied one-or-more batches
    ahead on a background thread.

    ``source``: iterable of host batches (any value).
    ``place_fn``: applied to each batch on the producer thread;
    identity when None.
    ``depth``: staged-batch cap; None reads the env knob; 0 = sync.

    A producer-side exception is re-raised in the consumer at the point
    the failing batch would have been delivered, after which the
    prefetcher is closed.
    """

    _join_timeout = 10.0  # seconds; tests shrink it to force the leak path

    def __init__(self, source: Iterable, place_fn: Optional[Callable] = None,
                 depth: Optional[int] = None, label: str = "prefetch"):
        self.label = label
        self.depth = resolve_prefetch_depth(depth)
        self._place = place_fn if place_fn is not None else (lambda b: b)
        self._source = iter(source)
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False
        self._leaked_thread: Optional[str] = None
        if self.depth > 0:
            self._queue = queue.Queue(maxsize=self.depth)
            self._thread = threading.Thread(
                target=self._produce, name=f"mmlspark-torch-{label}",
                daemon=True)
            self._thread.start()

    @property
    def async_mode(self) -> bool:
        """True when a producer thread is staging batches ahead."""
        return self._thread is not None

    # -- producer ------------------------------------------------------

    def _produce(self) -> None:
        try:
            for batch in self._source:
                if self._stop.is_set():
                    return
                staged = self._place(batch)
                while not self._stop.is_set():
                    try:
                        self._queue.put(staged, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                else:
                    return
            self._put_final(_SENTINEL_DONE)
        except BaseException as e:  # delivered to the consumer
            self._put_final(e)

    def _put_final(self, item) -> None:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return
            except queue.Full:
                continue

    # -- consumer ------------------------------------------------------

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        if self._queue is None:  # synchronous fallback
            try:
                return self._place(next(self._source))
            except StopIteration:
                self.close()
                raise
        # a train-step watchdog classifies a stall here as input
        # starvation
        prev = resilience.mark_boundary("input_wait", self._wait_detail)
        try:
            while True:
                try:
                    item = self._queue.get(timeout=0.1)
                    break
                except queue.Empty:
                    if (self._thread is not None
                            and not self._thread.is_alive()):
                        # producer died without delivering its sentinel
                        # (should not happen; never hang the consumer)
                        self.close()
                        raise StopIteration
        finally:
            resilience.restore_boundary(prev)
        if item is _SENTINEL_DONE:
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        return item

    def _wait_detail(self) -> str:
        alive = self._thread is not None and self._thread.is_alive()
        return (f"{self.label}: queue {self._queue.qsize()}/{self.depth} "
                f"staged, producer {'alive' if alive else 'dead'}")

    def close(self) -> None:
        """Stop and join the producer; idempotent, exception-safe."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        if self._queue is not None:
            # unblock a producer waiting on a full queue
            try:
                while True:
                    self._queue.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=self._join_timeout)
            if self._thread.is_alive():
                # the join timed out: the producer is wedged (most
                # likely inside place_fn) and its daemon thread leaks —
                # say so instead of silently dropping the handle
                self._leaked_thread = self._thread.name
                warn_once(
                    f"prefetch.leaked_thread.{self._thread.name}",
                    "prefetcher %s: producer thread %r did not stop "
                    "within %.1fs of close(); leaking it as a daemon",
                    self.label, self._thread.name, self._join_timeout)
            self._thread = None

    def stats(self) -> dict:
        """Observability snapshot: queue depth/occupancy and whether
        close() leaked the producer thread (None = clean)."""
        return {
            "label": self.label,
            "depth": self.depth,
            "queued": self._queue.qsize() if self._queue is not None else 0,
            "leaked_thread": self._leaked_thread,
        }

    def __enter__(self) -> "BatchPrefetcher":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()

    def __del__(self):  # best-effort backstop; close() is the contract
        try:
            self.close()
        except Exception:
            pass
