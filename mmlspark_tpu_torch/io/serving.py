"""Model serving: HTTP requests -> batches on the card -> replies.

The port's copy of the JAX package's ``io/serving.py`` for one server
(Spark Serving's head-node and continuous modes, SURVEY.md §3.5):

  - :class:`ServingServer` — requests become micro-batch rows
    (``max_batch_size`` rows or ``max_latency_ms``), scored as one batch
    by one scoring thread, replies matched by request; a client's
    ``"id"`` field is echoed back, unless the served model consumes a
    column literally named 'id', in which case only the reserved
    ``"__id__"`` key is stripped and echoed;
  - :class:`ContinuousServingServer` — each request is scored on
    arrival, under one score lock, by a scorer warmed at start.

The binned data plane: where the served model exposes
``serving_binned_plan`` (the GBDT models, trained or imported from a
model string), request threads bin each row to the narrowest ingest
dtype with numpy (no device work; int32 past 65,536 bins, whose
thresholds the scorer takes in wide bin nodes), and the scoring thread
pads each drained batch up to a rung of a power-of-two ladder capped at
``max_batch_size``, scores it on the model's device and slices the pad
rows off: replies are bitwise those of ``transform``. The plane counts
the shapes it has scored (``shapes_seen``), which stays at the ladder's
length. ``MMLSPARK_TORCH_SERVE_BINNED=auto|off|on`` selects the plane;
a model without a plan, mode ``off`` and a batch whose binned scoring
raised each fall back to ``transform``, visibly (``/healthz``:
``binned.reason``, ``binned_fallbacks``, ``binned-fallback``). A missing
card is not such a fallback: ``start()`` raises.

Multi-model: ``ServingServer(models={...})`` serves a named registry
with per-model bounded queues, routed by path
(``/models/<name><api_path>``) or payload field (``"__model__"``);
``GET /models`` lists them, ``GET /models/<name>/healthz`` reports one.
Binned planes stay resident for the ``MMLSPARK_TORCH_SERVE_WARM_MODELS``
most recently scored models (LRU); an evicted model drops its plane and
its booster's scorer tables and rebuilds them on its next batch.

Admission control: requests carry a tenant (``__tenant__`` / ``X-Tenant``)
and a priority (``__priority__`` / ``X-Priority``, ``low`` or ``high``).
With ``MMLSPARK_TORCH_SERVE_TENANT_RATE`` > 0 each tenant draws from a
token bucket (burst ``MMLSPARK_TORCH_SERVE_TENANT_BURST``) and sheds with
``503 + Retry-After`` when empty; past a model's queue high-water mark
low-priority requests shed. An ``X-Deadline-Ms`` budget that expires
while queued is shed at dequeue with an attributed 504.

Model lifecycle: :meth:`ServingServer.swap_model` replaces a served
model atomically (the new plane built and warmed cold, the registry
flipped under the lock, a probe batch scored, the old scorer's tables
and staged batches freed only after a clean probe; any failure rolls
back, :class:`SwapFailed`); ``prepare_swap`` / ``commit_swap`` /
``abort_swap`` are the same in two phases, for a fleet-wide swap.
``/healthz`` reports ``degraded`` (``swap-in-progress``) for the whole
window. :meth:`ServingServer.observe_log` registers request-log taps
(the refresh loop's ingest source). :meth:`ServingServer.drain` retires
a worker without losing an accepted request; :meth:`ServingServer.kill`
is an abrupt death for chaos drills (connections reset).

Fleet: :class:`ServingFleet` runs N ``ServingServer`` workers in one
process on the one card, with ``/registry`` and ``/healthz`` endpoints
and runtime ``spawn_worker`` / ``remove_worker`` (the supervisor is in
``io/fleet.py``). :class:`FleetClient` spreads requests over the
registry's workers with failover, per-worker circuit breakers, hedged
requests under a budget, a retry budget and deadline propagation.

Fault points (``core/faults.py``): ``serving.score``,
``serving.worker_kill``, ``serving.observe_log``, ``registry.swap``,
``fleet.spawn``, ``net.half_open``, ``net.slow_reply`` and
``net.latency``.
"""

from __future__ import annotations

import json
import queue as queue_lib
import socket
import threading
import time
import urllib.parse
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.core import env
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device import DeviceUnavailable
from mmlspark_tpu_torch.core.faults import fault_point
from mmlspark_tpu_torch.core.logging_utils import logger, warn_once
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.retries import CircuitBreaker, FractionBudget
from mmlspark_tpu_torch.parallel.inference import bucket_for, bucket_ladder


# how often a listener's serve_forever loop checks for shutdown
_POLL_S = 0.1


class _CappedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a hard cap on concurrent connections.

    HTTP/1.1 keep-alive pins one thread per persistent connection, so
    without a cap N idle clients hold N threads. Connections beyond the
    cap are answered with an immediate ``503 + Retry-After`` and closed
    (``FleetClient`` takes that as "try another worker"). Live
    connections are tracked so :meth:`kill_connections` can reset them.
    """

    daemon_threads = True

    def __init__(self, addr, handler, max_connections: int,
                 retry_after_s: float = 1.0):
        # the listen backlog covers the cap: with socketserver's default
        # of 5, clients connecting at once overflow it and wait out SYN
        # retransmits (seconds) before the cap ever applies
        self.request_queue_size = max(max_connections, 5)
        super().__init__(addr, handler)
        self._conn_sem = threading.BoundedSemaphore(max_connections)
        self._retry_after_s = retry_after_s
        self.rejected_connections = 0
        # live per-connection sockets, so an abrupt kill() can reset
        # every in-flight client: a dead worker looks dead (connection
        # errors, not polite 5xx replies). The reference's
        # san_lock("serving.http.active")
        self._active_lock = threading.Lock()
        self._active: set = set()

    def process_request(self, request, client_address):
        if not self._conn_sem.acquire(blocking=False):
            self.rejected_connections += 1
            env.warn_once("serving.connection_cap",
                          "serving connection cap reached; rejecting new "
                          "connections with 503 + Retry-After")
            try:
                request.sendall(
                    b"HTTP/1.1 503 Service Unavailable\r\n"
                    b"Retry-After: " +
                    str(max(int(self._retry_after_s), 1)).encode() +
                    b"\r\nConnection: close\r\nContent-Length: 0\r\n\r\n")
            except OSError:
                pass
            self.shutdown_request(request)
            return
        with self._active_lock:
            self._active.add(request)
        try:
            super().process_request(request, client_address)
        except BaseException:
            self._conn_sem.release()
            with self._active_lock:
                self._active.discard(request)
            raise

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            self._conn_sem.release()
            with self._active_lock:
                self._active.discard(request)

    def kill_connections(self) -> None:
        """Hard-reset every live connection (no goodbye): clients see a
        connection error mid-request, as if the worker process died.
        Handler threads unblock on their next socket operation and exit
        through :meth:`handle_error`."""
        with self._active_lock:
            conns = list(self._active)
            self._active.clear()
        for conn in conns:
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                conn.close()
            except OSError:
                pass

    def handle_error(self, request, client_address):
        # client disconnects and killed connections are normal under
        # load and chaos; the default traceback dump would spam stderr
        logger.debug("serving connection error from %s", client_address,
                     exc_info=True)


class _Pending:
    __slots__ = ("payload", "event", "reply", "error", "binned", "t0",
                 "deadline", "tenant")

    def __init__(self, payload):
        self.payload = payload
        self.event = threading.Event()
        self.reply = None
        self.error = None
        self.binned = None  # pre-binned (F,) row, set on request threads
        self.t0 = time.monotonic()  # admission time, for service p99
        # absolute monotonic deadline from the client's X-Deadline-Ms
        # budget (None: no deadline); the batch loop sheds it at dequeue
        self.deadline: Optional[float] = None
        self.tenant = "default"  # for attributing a deadline shed


class _TokenBucket:
    """Per-tenant admission budget: ``rate`` tokens/s refill up to
    ``burst``; a request costs one token, an empty bucket sheds. Lazy
    refill on each take. Callers hold the server lock."""

    __slots__ = ("rate", "burst", "tokens", "t_last")

    def __init__(self, rate: float, burst: int):
        self.rate = rate
        self.burst = float(burst)
        self.tokens = float(burst)
        self.t_last = time.monotonic()

    def take(self) -> bool:
        now = time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self.t_last) * self.rate)
        self.t_last = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


def _latency_pctls(entries, now: float,
                   window_s: float) -> Tuple[Optional[float],
                                             Optional[float]]:
    """(p50_ms, p99_ms) over ``(t_done, lat_ms)`` entries completed in
    the trailing ``window_s`` (a rolling window, not all-time)."""
    lat = sorted(ms for t, ms in entries if now - t <= window_s)
    if not lat:
        return None, None
    p50 = lat[len(lat) // 2]
    p99 = lat[min(len(lat) - 1, int(0.99 * len(lat)))]
    return round(p50, 3), round(p99, 3)


def _bucket_ladder(max_batch_size: int) -> List[int]:
    """Padded shapes of the binned data plane: the pow2 ladder of
    :mod:`mmlspark_tpu_torch.parallel.inference`, overridable by
    ``MMLSPARK_TORCH_SERVE_BUCKETS`` as a comma-separated size list."""
    spec = (env.env_str(env.SERVE_BUCKETS, "") or "").strip()
    buckets = None
    if spec:
        try:
            buckets = [int(tok) for tok in spec.split(",") if tok.strip()]
        except ValueError:
            env.warn_once(env.SERVE_BUCKETS,
                          f"{env.SERVE_BUCKETS}={spec!r} is not a "
                          "comma-separated int list; using the "
                          "power-of-two ladder")
            buckets = None
    return bucket_ladder(max_batch_size, buckets)


class _BinnedPlane:
    """Shape-stable binned scoring for one served model.

    ``bin_row`` runs on request threads (the C++ binning, which gives
    the interpreter lock up while it runs); ``score_rows`` runs on the
    one scoring thread: it writes the batch into its rung's staged
    buffers (one set per rung, kept while the plane lives; pad rows are
    all bin 0, the always-valid missing sentinel) and scores them with
    one call (on the card: the copy in, the ``tree_score`` kernel, the
    copy out and the wait for the stream), then takes the real rows'
    margins. Rows are independent, so the result is bitwise that of the
    exact shape. ``shapes_seen`` counts the distinct shapes scored."""

    def __init__(self, plan, ladder: List[int]):
        self.plan = plan
        self.ladder = list(ladder)
        self._seen: set = set()
        self._batches: Dict[int, Any] = {}

    @property
    def shapes_seen(self) -> int:
        return len(self._seen)

    def bin_row(self, payload: Dict[str, Any]) -> np.ndarray:
        feats = payload.get(self.plan.features_col)
        if feats is None:
            raise KeyError(f"payload lacks {self.plan.features_col!r}")
        row = np.asarray(feats, dtype=np.float64).reshape(1, -1)
        return self.plan.bin_rows(row)[0]

    def _batch(self, rows: int):
        """The staged buffers of the rung of ``rows`` rows."""
        batch = self._batches.get(rows)
        if batch is None:
            batch = self._batches[rows] = self.plan.score.staged_batch(
                rows, self.plan.num_features, self.plan.ingest_dtype)
        return batch

    def _score(self, batch, n: int) -> np.ndarray:
        batch.x[n:] = 0
        self._seen.add((batch.x.shape, str(batch.x.dtype)))
        self.plan.score.score_staged(batch)
        out = batch.out[:n]
        return (out[:, 0] if out.shape[1] == 1 else out).copy()

    def score_rows(self, rows: List[np.ndarray]) -> Dict[str, np.ndarray]:
        n = len(rows)
        batch = self._batch(bucket_for(n, self.ladder))
        batch.x[:n] = rows
        return self.plan.finish(self._score(batch, n))

    def warmup(self) -> None:
        """Score every rung once before the first request (bin 0 is
        always a valid input, so no payload is needed); this also makes
        every rung's buffers."""
        for b in self.ladder:
            self._score(self._batch(b), 0)


class SwapFailed(RuntimeError):
    """A :meth:`ServingServer.swap_model` that could not be committed:
    the registry was rolled back to the previous model, which kept (and
    keeps) serving every request."""


class _PreparedSwap:
    """Handle for phase 1 of a two-phase hot-swap: the new plane is
    built, warmed and probed but the registry pointer has not flipped.
    Pass it to :meth:`ServingServer.commit_swap` or
    :meth:`ServingServer.abort_swap` (exactly one of them)."""

    __slots__ = ("name", "new", "t0")

    def __init__(self, name: str, new: "_ServedModel", t0: float):
        self.name = name
        self.new = new
        self.t0 = t0


class _ServedModel:
    """One registered model: its bounded queue, stats, and (while warm)
    binned plane."""

    def __init__(self, name: str, model: Transformer, max_queue: int,
                 keep_id: bool):
        self.name = name
        self.model = model
        self.max_queue = max_queue
        self.keep_id = keep_id
        self.queue: List[_Pending] = []
        self.stats = {"served": 0, "errors": 0, "rejected": 0,
                      "timeouts": 0, "binned_batches": 0,
                      "generic_batches": 0, "binned_fallbacks": 0,
                      "cold_rebuilds": 0, "evictions": 0,
                      "swaps": 0, "swap_rollbacks": 0,
                      "admitted": 0, "shed_tenant": 0,
                      "shed_priority": 0, "shed_deadline": 0,
                      "queue_wait_s": 0.0, "score_s": 0.0, "reply_s": 0.0}
        # rolling (t_done, lat_ms) service latencies (admission ->
        # reply) for the /healthz p50/p99
        self.latencies: deque = deque(maxlen=1024)
        # per-tenant admission counters (bounded: past _MAX_TENANTS
        # distinct tenants, new ones aggregate under "__other__")
        self.tenants: Dict[str, Dict[str, int]] = {}
        self.plane: Optional[_BinnedPlane] = None
        self.binned_mode = "off"            # resolved at start()
        self.binned_supported: Optional[bool] = None  # None = untried
        self.binned_reason: Optional[str] = None
        # hot-swap probation: a just-swapped-in model is held out of the
        # batch loop until its probe batch scores clean (the old model
        # is evicted only after that)
        self.held = False


class ServingServer:
    """Serve fitted Transformers over HTTP with micro-batched scoring.

    ``ServingServer(model)`` serves one model;
    ``ServingServer(models={"a": m_a, "b": m_b})`` a named registry (see
    the module docstring for routing and the binned data plane)."""

    # bounded per-tenant state: beyond this many distinct tenants, new
    # ones aggregate under "__other__" (counters and token bucket)
    _MAX_TENANTS = 256
    # rolling window of the /healthz p50/p99
    _latency_window_s = 30.0
    # extra wait past a request's own deadline before its handler stops
    # waiting for the batch loop to shed it at dequeue
    _deadline_grace_s = 0.25

    def __init__(self, model: Optional[Transformer] = None,
                 host: str = "127.0.0.1",
                 port: int = 0, reply_col: Optional[str] = None,
                 max_batch_size: int = 64, max_latency_ms: float = 5.0,
                 api_path: str = "/score", max_queue: int = 256,
                 request_timeout_s: float = 30.0,
                 max_connections: int = 64,
                 idle_timeout_s: float = 15.0,
                 retry_after_s: float = 1.0,
                 models: Optional[Dict[str, Transformer]] = None,
                 default_model: Optional[str] = None,
                 warmup_payload: Optional[dict] = None,
                 queue_high_water: Optional[int] = None):
        if (model is None) == (models is None):
            raise ValueError("pass exactly one of model= or models=")
        if models is None:
            models = {default_model or "default": model}
        for name in models:
            if "/" in name or not name:
                raise ValueError(f"invalid model name {name!r}")
        self._default = default_model or next(iter(models))
        if self._default not in models:
            raise ValueError(f"default_model {self._default!r} not in "
                             f"models {sorted(models)}")
        self.model = models[self._default]
        self.reply_col = reply_col
        self.max_batch_size = max_batch_size
        self.max_latency_ms = max_latency_ms
        self.api_path = api_path
        # every pending queue is bounded; a full queue answers 503 +
        # Retry-After instead of queueing past any deadline
        self.max_queue = max_queue
        self.request_timeout_s = request_timeout_s
        self.retry_after_s = retry_after_s
        self._warmup_payload = warmup_payload
        self.queue_high_water = (queue_high_water if queue_high_water
                                 is not None else max(max_queue // 2, 1))
        self._tenant_rate = env.env_float(env.SERVE_TENANT_RATE, 0.0,
                                          minimum=0.0)
        self._tenant_burst = env.env_int(env.SERVE_TENANT_BURST, 8,
                                         minimum=1)
        self._tenant_buckets: Dict[str, _TokenBucket] = {}
        # lifecycle flags: draining = stop admitting, flush pendings
        # (graceful retirement); killed = abrupt chaos death
        self._draining = False
        self._killed = False
        self._started = False
        self._stopped = False
        self._inflight_batches = 0
        per_model_queue = env.env_int(env.SERVE_MODEL_QUEUE, 0, minimum=0)
        self._models: Dict[str, _ServedModel] = {
            name: _ServedModel(name, m, per_model_queue or max_queue,
                               self._consumes_id_column(m))
            for name, m in models.items()}
        self._model_names = list(self._models)
        self._rr = 0                     # round-robin cursor (batch loop)
        self._warm: "OrderedDict[str, None]" = OrderedDict()
        self._warm_capacity = env.env_int(env.SERVE_WARM_MODELS, 4,
                                          minimum=1)
        self._ladder: List[int] = _bucket_ladder(max_batch_size)
        # the reference's san_lock("serving.server", kind="condition")
        self._lock = threading.Condition()
        self._stop = False
        self._stats = {"served": 0, "errors": 0, "rejected": 0,
                       "timeouts": 0, "swaps": 0, "swap_rollbacks": 0,
                       "admitted": 0, "shed_tenant": 0,
                       "shed_priority": 0, "shed_deadline": 0,
                       "log_rows": 0, "log_tap_errors": 0}
        # sustained gray-worker throttle (drills, chip_smoke): every
        # scored batch sleeps this long before replying, so the worker
        # stays heartbeat-alive while its /healthz p99 inflates — the
        # signal the supervisor's gray detection keys on
        self.gray_delay_ms = 0.0
        self._last_shed = 0.0  # monotonic time of the last 503
        self._last_binned_fallback = 0.0
        # model name -> reason while a hot-swap runs (/healthz reports
        # degraded with it for the whole window)
        self._swapping: Dict[str, str] = {}
        # request-log taps: (model-name filter, callable) observers of
        # every scored batch, the refresh loop's ingest source
        self._log_taps: List[Tuple[Optional[str], Callable]] = []

        server = self

        class Handler(BaseHTTPRequestHandler):
            # HTTP/1.1 keep-alive: every reply carries Content-Length,
            # so persistent connections are safe
            protocol_version = "HTTP/1.1"
            # small request/reply pairs on a persistent connection hit
            # the Nagle/delayed-ACK stall without this
            disable_nagle_algorithm = True
            # an idle keep-alive connection gives its thread back
            timeout = idle_timeout_s

            def log_message(self, fmt, *args):  # quiet
                pass

            def _reply_json(self, code, obj, extra_headers=None):
                body = json.dumps(obj).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra_headers or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def _reply_503(self, error):
                self._reply_json(
                    503, {"error": error},
                    {"Retry-After": str(max(int(server.retry_after_s), 1))})

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply_json(200, server._health())
                    return
                if self.path == "/models":
                    self._reply_json(200, server._models_listing())
                    return
                if (self.path.startswith("/models/")
                        and self.path.endswith("/healthz")):
                    name = self.path[len("/models/"):-len("/healthz")]
                    served = server._models.get(name)
                    if served is not None:
                        self._reply_json(200, server._model_health(served))
                        return
                self.send_error(404)

            def do_POST(self):
                # chaos boundary: an armed delay is a worker that took
                # the connection and stalls before reading (half open);
                # an armed raise drops the connection with no reply
                fault_point("net.half_open")
                if server._draining:
                    # graceful retirement: a retiring worker turns new
                    # traffic away and flushes what it already admitted
                    self._reply_503("worker draining")
                    return
                served = server._route_post(self.path)
                if served is None:
                    self.send_error(404)
                    return
                if "chunked" in (self.headers.get(
                        "Transfer-Encoding") or "").lower():
                    # chunked bodies are not read: demand a length
                    self.send_error(411, "Content-Length required")
                    return
                length = int(self.headers.get("Content-Length", 0))
                try:
                    payload = json.loads(self.rfile.read(length))
                except json.JSONDecodeError as e:
                    self.send_error(400, f"bad json: {e}")
                    return
                route = payload.pop("__model__", None) \
                    if isinstance(payload, dict) else None
                if route is not None:
                    served = server._models.get(route)
                    if served is None:
                        self.send_error(404, f"unknown model {route!r}")
                        return
                # admission control: tenant + priority ride in the
                # payload (stripped before scoring) or headers
                tenant = priority = None
                if isinstance(payload, dict):
                    tenant = payload.pop("__tenant__", None)
                    priority = payload.pop("__priority__", None)
                tenant = str(tenant or self.headers.get("X-Tenant")
                             or "default")
                priority = str(priority or self.headers.get("X-Priority")
                               or "high").strip().lower()
                shed = server._admit(served, tenant, priority)
                if shed is not None:
                    self._reply_503(shed)
                    return
                pending = _Pending(payload)
                pending.tenant = tenant
                hdr = self.headers.get("X-Deadline-Ms")
                if hdr is not None:
                    try:
                        pending.deadline = \
                            pending.t0 + float(hdr) / 1000.0
                    except ValueError:
                        pass  # malformed budget = no deadline
                plane = served.plane
                if plane is not None:
                    # bin on the request thread (numpy only): the
                    # scoring thread receives bin rows, not raw dicts;
                    # a bad row sends its batch down the generic path
                    try:
                        pending.binned = plane.bin_row(payload)
                    except Exception:
                        pending.binned = None
                if not server._enqueue(pending, served):
                    self._reply_503("server overloaded")
                    return
                # a deadline-carrying request waits only (remaining +
                # grace) for the batch loop to dequeue-and-shed it
                wait_s = server.request_timeout_s
                if pending.deadline is not None:
                    wait_s = min(wait_s, max(
                        pending.deadline - time.monotonic(), 0.0)
                        + server._deadline_grace_s)
                if not pending.event.wait(timeout=wait_s):
                    expired = (pending.deadline is not None
                               and time.monotonic() >= pending.deadline)
                    with server._lock:
                        # a timed-out request still queued must not
                        # take a scoring slot
                        if pending in served.queue:
                            served.queue.remove(pending)
                        if expired:
                            server._count_deadline_shed(served, tenant)
                        else:
                            server._stats["timeouts"] += 1
                            served.stats["timeouts"] += 1
                    if expired:
                        self._reply_json(504, server._deadline_body(
                            pending, served, tenant))
                    else:
                        self.send_error(504, "scoring timed out")
                    return
                if pending.error is not None:
                    if pending.error in ("server stopped",
                                         "worker killed"):
                        # a lifecycle flush, not the request's fault:
                        # 503 tells FleetClient to fail over
                        self._reply_503(pending.error)
                    elif pending.error.startswith("deadline exceeded"):
                        self._reply_json(504, server._deadline_body(
                            pending, served, tenant))
                    else:
                        self.send_error(500, pending.error)
                    return
                body = json.dumps(pending.reply).encode()
                # chaos boundary: a gray worker whose replies crawl out
                # while its heartbeats keep passing
                fault_point("net.slow_reply")
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = _CappedThreadingHTTPServer(
            (host, port), Handler, max_connections=max_connections,
            retry_after_s=retry_after_s)
        self.host, self.port = self._httpd.server_address
        # named threads so teardown tests can assert none leaked; the
        # listener polls its shutdown flag every 0.1 s, so stop() and a
        # fleet's teardown of N workers return promptly
        self._server_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
            kwargs={"poll_interval": _POLL_S},
            name=f"mmlspark-torch-serve-http-{self.port}")
        self._batch_thread = threading.Thread(
            target=self._batch_loop, daemon=True,
            name=f"mmlspark-torch-serve-batch-{self.port}")

    # -- routing -------------------------------------------------------------
    def _route_post(self, path: str) -> Optional[_ServedModel]:
        if path == self.api_path:
            return self._models[self._default]
        if path.startswith("/models/"):
            name, _, sub = path[len("/models/"):].partition("/")
            served = self._models.get(name)
            if served is not None and ("/" + sub) == self.api_path:
                return served
        return None

    def _enqueue(self, pending: _Pending, served: _ServedModel) -> bool:
        with self._lock:
            # a hot-swap may have replaced this model's registry entry
            # between routing and here: re-resolve so the request cannot
            # strand on the orphaned old queue, and drop its binned row,
            # which holds the old plane's bin ids
            live = self._models.get(served.name)
            if live is not None and live is not served:
                served = live
                pending.binned = None
            if len(served.queue) >= served.max_queue:
                self._stats["rejected"] += 1
                served.stats["rejected"] += 1
                self._last_shed = time.monotonic()
                env.warn_once("serving.backpressure",
                              f"serving queue full (max_queue="
                              f"{served.max_queue}); shedding load with "
                              "503 + Retry-After")
                return False
            served.queue.append(pending)
            self._lock.notify()
            return True

    # -- admission control ---------------------------------------------------
    def _tenant_counters(self, served: _ServedModel,
                         tenant: str) -> Dict[str, int]:
        counters = served.tenants.get(tenant)
        if counters is None:
            if (tenant != "__other__"
                    and len(served.tenants) >= self._MAX_TENANTS):
                return self._tenant_counters(served, "__other__")
            counters = {"admitted": 0, "shed_tenant": 0,
                        "shed_priority": 0, "shed_deadline": 0}
            served.tenants[tenant] = counters
        return counters

    def _count_deadline_shed(self, served: _ServedModel,
                             tenant: str) -> None:
        """Attribute one deadline shed (caller holds the lock)."""
        self._stats["shed_deadline"] += 1
        served.stats["shed_deadline"] += 1
        self._tenant_counters(served, tenant)["shed_deadline"] += 1
        self._last_shed = time.monotonic()

    @staticmethod
    def _deadline_body(pending: _Pending, served: _ServedModel,
                       tenant: str) -> Dict[str, Any]:
        """Attributed 504 payload for a deadline shed."""
        overdue_ms = (time.monotonic() - pending.deadline) * 1e3 \
            if pending.deadline is not None else 0.0
        reason = pending.error if (
            pending.error or "").startswith("deadline exceeded") else (
            f"deadline exceeded: request budget spent "
            f"{max(overdue_ms, 0.0):.0f} ms ago while queued; shed "
            f"before scoring")
        return {"error": reason, "model": served.name,
                "tenant": tenant, "shed": "deadline"}

    def _admit(self, served: _ServedModel, tenant: str,
               priority: str) -> Optional[str]:
        """``None`` admits; a string is the shed reason for the 503
        body. Two gates: the per-tenant token bucket (with
        ``MMLSPARK_TORCH_SERVE_TENANT_RATE`` > 0) and priority shedding
        once the model's queue crosses its high-water mark."""
        with self._lock:
            counters = self._tenant_counters(served, tenant)
            if self._tenant_rate > 0.0:
                bucket = self._tenant_buckets.get(tenant)
                if bucket is None:
                    if len(self._tenant_buckets) >= self._MAX_TENANTS:
                        bucket = self._tenant_buckets.setdefault(
                            "__other__",
                            _TokenBucket(self._tenant_rate,
                                         self._tenant_burst))
                    else:
                        bucket = self._tenant_buckets[tenant] = \
                            _TokenBucket(self._tenant_rate,
                                         self._tenant_burst)
                if not bucket.take():
                    counters["shed_tenant"] += 1
                    served.stats["shed_tenant"] += 1
                    self._stats["shed_tenant"] += 1
                    self._last_shed = time.monotonic()
                    return (f"tenant {tenant!r} over budget "
                            f"(rate={self._tenant_rate:g}/s, "
                            f"burst={self._tenant_burst})")
            if (priority == "low"
                    and len(served.queue) >= self.queue_high_water):
                counters["shed_priority"] += 1
                served.stats["shed_priority"] += 1
                self._stats["shed_priority"] += 1
                self._last_shed = time.monotonic()
                return (f"queue past high-water mark "
                        f"({self.queue_high_water}); low-priority "
                        "request shed")
            counters["admitted"] += 1
            served.stats["admitted"] += 1
            self._stats["admitted"] += 1
            return None

    # -- health --------------------------------------------------------------
    @staticmethod
    def _binned_health(served: _ServedModel) -> Dict[str, Any]:
        return {"mode": served.binned_mode,
                "active": served.plane is not None,
                "reason": served.binned_reason}

    def _model_health(self, served: _ServedModel) -> Dict[str, Any]:
        with self._lock:
            p50, p99 = _latency_pctls(list(served.latencies),
                                      time.monotonic(),
                                      self._latency_window_s)
            return {"name": served.name, "queueDepth": len(served.queue),
                    "maxQueue": served.max_queue,
                    "warm": served.name in self._warm,
                    "p50_ms": p50, "p99_ms": p99,
                    "tenants": {t: dict(c)
                                for t, c in served.tenants.items()},
                    "binned": self._binned_health(served),
                    **served.stats}

    def _models_listing(self) -> Dict[str, Any]:
        return {"default": self._default,
                "models": {name: self._model_health(m)
                           for name, m in self._models.items()}}

    def _health(self) -> Dict[str, Any]:
        """/healthz payload: ``status: ok|degraded`` and a readable
        ``reason``. Degraded while the worker drains (``draining``),
        while a hot-swap runs (``swap-in-progress``), while the pending
        queues sit at half capacity (``queue-saturated``), while load
        was shed in the last 5 s (``load-shed``), or right after a
        binned batch fell back to generic scoring (``binned-fallback``).
        Scrapers, the fleet registry and :class:`FleetClient` steer
        traffic away on it; the flag clears once the condition passes."""
        with self._lock:
            depth = sum(len(m.queue) for m in self._models.values())
            stats = dict(self._stats)
            last_shed = self._last_shed
            last_fallback = self._last_binned_fallback
            swapping = sorted(self._swapping)
            draining = self._draining
            entries: List[Tuple[float, float]] = []
            for m in self._models.values():
                entries.extend(m.latencies)
            binned = self._binned_health(self._models[self._default])
        now = time.monotonic()
        p50, p99 = _latency_pctls(entries, now, self._latency_window_s)
        reasons: List[str] = []
        if draining:
            reasons.append("draining")
        if swapping:
            reasons.append("swap-in-progress: " + ", ".join(swapping))
        if depth >= max(self.max_queue // 2, 1):
            reasons.append("queue-saturated")
        elif last_shed and now - last_shed < 5.0:
            reasons.append("load-shed")
        if last_fallback and now - last_fallback < 5.0:
            reasons.append("binned-fallback")
        health = {"status": "degraded" if reasons else "ok",
                  "reason": "; ".join(reasons) if reasons else None,
                  "queueDepth": depth, "maxQueue": self.max_queue,
                  "p50_ms": p50, "p99_ms": p99, "draining": draining,
                  "rejectedConnections": self._httpd.rejected_connections,
                  **stats, "binned": binned, "buckets": list(self._ladder)}
        if len(self._models) > 1:
            health["models"] = {name: self._model_health(m)
                                for name, m in self._models.items()}
        return health

    # -- binned plane / warm-set management ----------------------------------
    def _ensure_plane(self, served: _ServedModel) -> None:
        """Build (or rebuild) a model's binned plane and score every
        rung once; on failure record the downgrade reason (``/healthz``)
        and, under ``MMLSPARK_TORCH_SERVE_BINNED=on``, warn once. A
        missing card (``DeviceUnavailable``) is not a downgrade: it
        raises."""
        if (served.binned_mode == "off" or served.plane is not None
                or served.binned_supported is False):
            return
        plan_fn = getattr(served.model, "serving_binned_plan", None)
        if plan_fn is None:
            served.binned_supported = False
            served.binned_reason = ("model exposes no "
                                    "serving_binned_plan (generic "
                                    "Transformer)")
        else:
            try:
                plane = _BinnedPlane(plan_fn(), self._ladder)
                plane.warmup()
                served.plane = plane
                served.binned_supported = True
                served.binned_reason = None
                return
            except DeviceUnavailable:
                raise
            except Exception as e:
                served.binned_supported = False
                served.binned_reason = str(e)
        if served.binned_mode == "on":
            env.warn_once(
                f"serving.binned_downgrade.{served.name}",
                f"{env.SERVE_BINNED}=on but model {served.name!r} cannot "
                f"use the binned data plane ({served.binned_reason}); "
                "using the generic transform path")

    def _touch_warm(self, served: _ServedModel) -> None:
        """LRU warm-set bookkeeping at scoring time: the scored model
        becomes most recent; beyond capacity, the coldest model drops
        its plane and its booster's scorers (rebuilt on next use)."""
        if served.name in self._warm:
            self._warm.move_to_end(served.name)
            return
        self._warm[served.name] = None
        if served.plane is None:
            # first touch of a model that was cold at start builds its
            # plane now; a previously built one rebuilds (counted)
            rebuilt = served.binned_supported is True
            self._ensure_plane(served)
            if rebuilt and served.plane is not None:
                served.stats["cold_rebuilds"] += 1
        while len(self._warm) > self._warm_capacity:
            cold_name, _ = self._warm.popitem(last=False)
            cold = self._models[cold_name]
            self._release_scorer(cold)
            cold.stats["evictions"] += 1

    @staticmethod
    def _release_scorer(served: _ServedModel) -> None:
        """Free a model's device state: the plane's staged batches and
        its booster's scorer tables (``clear_jit_cache``); both are
        built again on the model's next use."""
        plane, served.plane = served.plane, None
        if plane is not None:
            plane._batches.clear()
        booster = getattr(served.model, "booster", None)
        if booster is not None and hasattr(booster, "clear_jit_cache"):
            booster.clear_jit_cache()

    def _warm_start(self) -> None:
        """Check that every served model's device exists, resolve the
        binned mode, build and warm the planes of the first
        ``MMLSPARK_TORCH_SERVE_WARM_MODELS`` models, and, given a
        ``warmup_payload``, run the generic ``transform`` once at sizes
        1 and ``max_batch_size`` for warm models without a plane."""
        for served in self._models.values():
            resolved = getattr(served.model, "resolved_device", None)
            if callable(resolved):
                resolved()     # DeviceUnavailable without a card
        mode = (env.env_str(env.SERVE_BINNED, "auto")
                or "auto").strip().lower()
        if mode not in ("auto", "off", "on"):
            env.warn_once(env.SERVE_BINNED,
                          f"{env.SERVE_BINNED}={mode!r} is not "
                          "auto|off|on; using auto")
            mode = "auto"
        for served in self._models.values():
            served.binned_mode = mode
            if mode == "off":
                served.binned_reason = f"disabled ({env.SERVE_BINNED}=off)"
        for served in list(self._models.values())[:self._warm_capacity]:
            self._warm[served.name] = None
            self._ensure_plane(served)
            if served.plane is None and self._warmup_payload is not None:
                for b in sorted({1, self.max_batch_size}):
                    self._score([_Pending(dict(self._warmup_payload))
                                 for _ in range(b)], served)

    # -- atomic hot-swap -----------------------------------------------------
    def _probe(self, served: _ServedModel,
               probe_payload: Optional[Dict[str, Any]]) -> None:
        """Score one verification batch on a swapped-in model, the
        condition for evicting the old one. Runs on the swapping thread,
        outside the batch loop (no stats, no warm-LRU touch), through the
        plane or ``transform`` as served batches do. Raises on any
        failure, a non-finite reply included."""
        if served.plane is not None:
            if probe_payload is not None:
                rows = [served.plane.bin_row(dict(probe_payload))]
            else:
                # bin 0 is the always-valid missing sentinel, so a zero
                # row runs the whole binned path
                rows = [np.zeros(served.plane.plan.num_features,
                                 dtype=served.plane.plan.ingest_dtype)]
            cols = served.plane.score_rows(rows)
        elif probe_payload is not None:
            df = DataFrame.from_rows([dict(probe_payload)])
            out = served.model.transform(df)
            cols = {c: out.col(c) for c in out.columns
                    if c not in df.columns} or \
                {c: out.col(c) for c in out.columns}
        else:
            warn_once(
                f"serving.swap_probe.{served.name}",
                "swap_model(%r) has no binned plane and no probe_payload;"
                " committing the swap without a verification batch",
                served.name)
            return
        for c, values in cols.items():
            arr = np.asarray(values)
            if arr.dtype.kind == "f" and not np.isfinite(arr).all():
                raise ValueError(f"probe reply column {c!r} is not "
                                 "finite")

    def _open_swap(self, name: str, what: str) -> _ServedModel:
        """Mark ``name`` as swapping (``/healthz`` degraded) and return
        its registry entry; refuses an unknown name or a second swap."""
        with self._lock:
            if name not in self._models:
                raise KeyError(
                    f"{what}: {name!r} is not a served model (have "
                    f"{sorted(self._models)}); the swap API replaces "
                    "models, it does not add them")
            if self._swapping.get(name):
                raise SwapFailed(f"a swap of {name!r} is already in "
                                 "progress")
            self._swapping[name] = "swap-in-progress"
            return self._models[name]

    def _count_rollback(self, name: str, old: Optional[_ServedModel]
                        ) -> None:
        """Close a swap window as rolled back (caller holds the lock)."""
        self._swapping.pop(name, None)
        self._stats["swap_rollbacks"] += 1
        if old is not None:
            old.stats["swap_rollbacks"] += 1
        self._lock.notify_all()

    def swap_model(self, name: str, model: Transformer,
                   probe_payload: Optional[Dict[str, Any]] = None
                   ) -> Dict[str, Any]:
        """Atomically replace served model ``name`` with ``model``:

          1. the new binned plane is built and warmed cold (scorer
             tables to the card, one staged batch per rung) while the
             old model serves every request;
          2. the registry pointer flips under the lock; pending requests
             move to the new model's queue (their binned rows dropped:
             the new binning owns them) but stay held out of the batch
             loop;
          3. a verification batch (``probe_payload``, or a zero row
             through the plane) must score clean; only then are the old
             scorer's tables and staged batches freed and the queue
             released;
          4. any failure in 1–3 rolls back: the old model is restored
             with every queued request, and :class:`SwapFailed` is
             raised.

        ``/healthz`` reports ``degraded`` (``swap-in-progress``) for the
        whole window, and its counters carry over to the new entry.
        Returns ``{"model", "swap_s", "downtime_s"}``; ``downtime_s`` is
        the flip-to-release window during which requests queue rather
        than score. Fault point ``registry.swap`` (a raise before the
        flip, or a corrupt of the built entry, which the probe catches).
        """
        old = self._open_swap(name, "swap_model")
        t0 = time.monotonic()
        t_flip = None
        new = _ServedModel(name, model, old.max_queue,
                           self._consumes_id_column(model))
        new.stats = dict(old.stats)
        new.binned_mode = old.binned_mode
        new.held = True
        flipped = False
        try:
            self._ensure_plane(new)
            new = fault_point("registry.swap", new)
            with self._lock:
                new.queue = old.queue
                old.queue = []
                for p in new.queue:
                    p.binned = None  # the old plane's bin ids
                self._models[name] = new
                if self.model is old.model:
                    self.model = model
                flipped = True
            t_flip = time.monotonic()
            self._probe(new, probe_payload)
        except Exception as e:
            with self._lock:
                if flipped:
                    old.queue = new.queue
                    for p in old.queue:
                        p.binned = None
                    self._models[name] = old
                    if self.model is model:
                        self.model = old.model
                self._count_rollback(name, old)
            if new.plane is not None and new.model is not old.model:
                self._release_scorer(new)
            raise SwapFailed(
                f"swap of model {name!r} failed and was rolled back; the "
                f"previous model keeps serving ({type(e).__name__}: {e})"
            ) from e
        with self._lock:
            new.held = False
            new.stats["swaps"] += 1
            self._swapping.pop(name, None)
            self._stats["swaps"] += 1
            self._lock.notify_all()
        if old.model is not new.model:
            self._release_scorer(old)
        now = time.monotonic()
        return {"model": name, "swap_s": now - t0,
                "downtime_s": now - (t_flip if t_flip else now)}

    # -- two-phase hot-swap (the fleet-wide swap's building blocks) ----------
    def prepare_swap(self, name: str, model: Transformer,
                     probe_payload: Optional[Dict[str, Any]] = None
                     ) -> _PreparedSwap:
        """Phase 1 of a fleet-wide swap (``FleetSupervisor.
        swap_model_fleet``): build and warm the new plane and score its
        verification batch without flipping the registry, so the old
        model serves right through the probe and a prepare that fails on
        any worker leaves nothing to undo. ``/healthz`` reports
        ``degraded`` (``swap-in-progress``) until :meth:`commit_swap` or
        :meth:`abort_swap`. Fault point ``registry.swap``. Raises
        :class:`SwapFailed` (window closed, rollback counted) on any
        failure."""
        old = self._open_swap(name, "prepare_swap")
        t0 = time.monotonic()
        new = _ServedModel(name, model, old.max_queue,
                           self._consumes_id_column(model))
        new.binned_mode = old.binned_mode
        new.held = True
        try:
            self._ensure_plane(new)
            new = fault_point("registry.swap", new)
            self._probe(new, probe_payload)
        except Exception as e:
            with self._lock:
                self._count_rollback(name, old)
            if new.plane is not None and new.model is not old.model:
                self._release_scorer(new)
            raise SwapFailed(
                f"prepared swap of model {name!r} failed and was rolled "
                f"back; the previous model keeps serving "
                f"({type(e).__name__}: {e})") from e
        return _PreparedSwap(name=name, new=new, t0=t0)

    def commit_swap(self, prepared: _PreparedSwap) -> Dict[str, Any]:
        """Phase 2: flip the registry pointer to an already-probed plane.
        The flip is the whole per-worker downtime: pending requests move
        to the new model's queue (binned rows dropped) and score at once.
        Returns ``{"model", "swap_s", "downtime_s"}``."""
        name, new = prepared.name, prepared.new
        t_flip = time.monotonic()
        with self._lock:
            old = self._models[name]
            # counters copied at flip time: the old model kept serving
            # through the probe and the sibling workers' prepares
            new.stats = dict(old.stats)
            new.queue = old.queue
            old.queue = []
            for p in new.queue:
                p.binned = None
            new.held = False
            new.stats["swaps"] += 1
            self._models[name] = new
            if self.model is old.model:
                self.model = new.model
            self._swapping.pop(name, None)
            self._stats["swaps"] += 1
            self._lock.notify_all()
        if old.model is not new.model:
            self._release_scorer(old)
        now = time.monotonic()
        return {"model": name, "swap_s": now - prepared.t0,
                "downtime_s": now - t_flip}

    def abort_swap(self, prepared: _PreparedSwap) -> None:
        """Roll back a prepared (never flipped) swap: the old model never
        stopped serving, so this closes the degraded window, counts the
        rollback and frees the built plane."""
        with self._lock:
            old = self._models.get(prepared.name)
            self._count_rollback(prepared.name, old)
        if old is None or prepared.new.model is not old.model:
            self._release_scorer(prepared.new)

    # -- request-log taps ----------------------------------------------------
    def observe_log(self, tap: Callable[..., None],
                    model_name: Optional[str] = None) -> None:
        """Register a request-log tap: after every scored batch the
        scoring thread calls ``tap(model_name, payloads, cols)`` with the
        batch's (id-stripped) payload dicts and reply columns — the
        ingest source of a co-located ``RefreshController``
        (``tap_serving``). ``model_name`` filters to one registry entry
        (None: every model). A tap must not block (it runs on the one
        scoring thread); a raising tap is absorbed (warn-once and the
        ``log_tap_errors`` counter). Fault point
        ``serving.observe_log``."""
        with self._lock:
            self._log_taps.append((model_name, tap))

    def _notify_taps(self, served: _ServedModel,
                     batch: List[_Pending], cols: Dict[str, Any]) -> None:
        with self._lock:
            taps = [t for mn, t in self._log_taps
                    if mn is None or mn == served.name]
        if not taps:
            return
        payloads = [p.payload for p in batch]
        for tap in taps:
            try:
                # chaos boundary: a dying observer; the replies already
                # went out, and the refresh loop replays dropped rows
                # from the durable request log
                fault_point("serving.observe_log")
                tap(served.name, payloads, cols)
                with self._lock:
                    self._stats["log_rows"] += len(batch)
            except Exception as e:
                warn_once("serving.observe_log",
                          "request-log tap failed (%s); serving continues"
                          " — dropped rows must be replayed from the "
                          "durable request log", e)
                with self._lock:
                    self._stats["log_tap_errors"] += 1

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "ServingServer":
        self._start_warm()
        self._server_thread.start()
        self._batch_thread.start()
        logger.info("serving on %s:%s%s (%d model(s))", self.host,
                    self.port, self.api_path, len(self._models))
        return self

    def _start_warm(self) -> None:
        """Warm start; a failure (a missing card) closes the listener
        before it raises, so a server that never started holds no
        port."""
        try:
            self._warm_start()
        except BaseException:
            self._httpd.server_close()
            self._stopped = True
            raise
        self._started = True

    def stop(self) -> None:
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._stop = True
            flush: List[_Pending] = []
            for m in self._models.values():
                flush.extend(m.queue)
                m.queue.clear()
            self._lock.notify_all()
        for p in flush:
            # never strand a waiting request thread on shutdown
            p.error = "server stopped"
            p.event.set()
        if self._started:
            # shutdown() waits on the serve_forever loop, which a
            # server that never started does not run
            self._httpd.shutdown()
            if self._batch_thread.is_alive():
                self._batch_thread.join(timeout=5.0)
        self._httpd.server_close()

    def kill(self) -> None:
        """Abrupt chaos death (the ``serving.worker_kill`` contract): no
        flush, no goodbye. Pending requests error out, every live
        connection is hard-reset so clients see a connection error (what
        :class:`FleetClient` fails over on), and the listener stops. The
        ``FleetSupervisor`` notices through missed heartbeats and
        spawns a replacement."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._killed = True
            self._stop = True
            flush: List[_Pending] = []
            for m in self._models.values():
                flush.extend(m.queue)
                m.queue.clear()
            self._lock.notify_all()
        for p in flush:
            p.error = "worker killed"
            p.event.set()
        self._httpd.kill_connections()
        if self._started:
            self._httpd.shutdown()
        self._httpd.server_close()

    def drain(self, timeout_s: float = 30.0) -> bool:
        """Graceful retirement, phase 1: stop admitting (new POSTs get
        ``503 + Retry-After``; deregister from the fleet first so clients
        stop picking this worker), then wait until every accepted request
        has been scored and replied — queues empty, no batch in flight
        and no hot-swap holding a queue. Returns True when drained, False
        on timeout. Call :meth:`stop` afterwards.

        A swap in flight holds its migrated queue out of the batch loop
        until its probe resolves; those are accepted requests, so drain
        outlives the swap window (commit and rollback both release the
        queue and notify) and then restarts its budget once so the
        released requests get scored."""
        self._draining = True
        deadline = time.monotonic() + timeout_s
        extended = False
        with self._lock:
            while True:
                depth = sum(len(m.queue) for m in self._models.values())
                swapping = bool(self._swapping)
                if (depth == 0 and self._inflight_batches == 0
                        and not swapping):
                    return True
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    if swapping:
                        extended = True
                    elif extended:
                        extended = False
                        deadline = time.monotonic() + timeout_s
                        continue
                    else:
                        return False
                self._lock.wait(timeout=(min(remaining, 0.1)
                                         if remaining > 0 else 0.1))

    @property
    def url(self) -> str:
        return f"http://{self.host}:{self.port}{self.api_path}"

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- scoring loop --------------------------------------------------------
    def _next_served(self) -> Optional[_ServedModel]:
        """Round-robin over models with pending requests (caller holds
        the lock): one slow model's queue cannot starve the others'."""
        n = len(self._model_names)
        for i in range(n):
            served = self._models[self._model_names[(self._rr + i) % n]]
            if served.queue and not served.held:
                # held = swap probation: requests wait until the new
                # model's probe scored clean (or the swap rolled back)
                self._rr = (self._rr + i + 1) % n
                return served
        return None

    def _batch_loop(self):
        while not self._stop:
            with self._lock:
                served = self._next_served()
                while served is None and not self._stop:
                    self._lock.wait(timeout=0.5)
                    served = self._next_served()
                if served is None:
                    continue
                deadline = time.monotonic() + self.max_latency_ms / 1000.0
                while (len(served.queue) < self.max_batch_size
                       and time.monotonic() < deadline):
                    self._lock.wait(timeout=max(
                        deadline - time.monotonic(), 0.0))
                batch = served.queue[:self.max_batch_size]
                del served.queue[:len(batch)]
                # a request whose budget expired while queued gets an
                # attributed 504 before it takes a scoring slot
                expired: List[_Pending] = []
                now = time.monotonic()
                live = []
                for p in batch:
                    if p.deadline is not None and p.deadline <= now:
                        expired.append(p)
                        self._count_deadline_shed(served, p.tenant)
                    else:
                        live.append(p)
                batch = live
                if batch:
                    self._inflight_batches += 1
            for p in expired:
                p.error = ("deadline exceeded: request budget spent "
                           "while queued; shed at dequeue before "
                           "scoring")
                p.event.set()
            if not batch:
                continue
            try:
                try:
                    # chaos point: armed, the worker dies abruptly with
                    # this batch in flight (the fleet failover drill)
                    fault_point("serving.worker_kill")
                except Exception:
                    self.kill()
                    for p in batch:
                        p.error = "worker killed"
                        p.event.set()
                    return
                try:
                    self._score(batch, served)
                    with self._lock:
                        self._stats["served"] += len(batch)
                        served.stats["served"] += len(batch)
                except Exception as e:  # surface scoring errors to callers
                    with self._lock:
                        self._stats["errors"] += len(batch)
                        served.stats["errors"] += len(batch)
                    for p in batch:
                        p.error = str(e)
                        p.event.set()
            finally:
                # drain() waits on empty queues and no batch in flight:
                # a popped batch is invisible to the queue depth
                with self._lock:
                    self._inflight_batches -= 1
                    self._lock.notify_all()

    @staticmethod
    def _consumes_id_column(m) -> bool:
        """True when the served model declares a column literally named
        'id' as an input: then 'id' is data and reaches the scoring
        DataFrame, and clients correlate with the reserved ``__id__``."""
        for pname in ("featuresCol", "inputCol"):
            try:
                if m.get(pname) == "id":
                    return True
            except Exception:
                pass
        try:
            if "id" in (m.get("inputCols") or ()):
                return True
        except Exception:
            pass
        return False

    def _score(self, batch: List[_Pending],
               served: Optional[_ServedModel] = None):
        """Score one batch and set its replies. The model's stats sum
        the requests' queue wait (admission to here), the scoring
        (binned plane or ``transform``, the copy to the host included)
        and the building of the replies, in seconds. Fault point
        ``serving.score`` (a slow or failing model); ``gray_delay_ms``
        sleeps inside the measured window, so ``/healthz`` p99 carries
        it."""
        t_start = time.monotonic()
        fault_point("serving.score")
        if self.gray_delay_ms > 0.0:
            time.sleep(self.gray_delay_ms / 1000.0)
        if served is None:
            served = self._models[self._default]
        keep_id = served.keep_id
        ids = []
        for p in batch:
            rid = p.payload.pop("__id__", None)
            if not keep_id:
                legacy = p.payload.pop("id", None)
                rid = rid if rid is not None else legacy
            ids.append(rid)
        self._touch_warm(served)
        cols: Optional[Dict[str, Any]] = None
        plane = served.plane
        if plane is not None and all(p.binned is not None for p in batch):
            try:
                cols = plane.score_rows([p.binned for p in batch])
                if self.reply_col:
                    cols = {self.reply_col: cols[self.reply_col]}
            except Exception as e:
                env.warn_once(f"serving.binned_score.{served.name}",
                              f"binned scoring failed ({e}); batch falls "
                              "back to the generic transform path")
                cols = None
        if cols is not None:
            served.stats["binned_batches"] += 1
        else:
            if plane is not None:
                served.stats["binned_fallbacks"] += 1
                self._last_binned_fallback = time.monotonic()
            df = DataFrame.from_rows([p.payload for p in batch])
            out = served.model.transform(df)
            reply_cols = [self.reply_col] if self.reply_col else \
                [c for c in out.columns if c not in df.columns] or out.columns
            cols = {c: out.col(c) for c in reply_cols}
            served.stats["generic_batches"] += 1
        t_scored = time.monotonic()
        for i, p in enumerate(batch):
            reply = {}
            for c, values in cols.items():
                v = values[i]
                if isinstance(v, np.ndarray):
                    v = v.tolist()
                elif isinstance(v, np.generic):
                    v = v.item()
                reply[c] = v
            if ids[i] is not None:  # request-id correlation for clients
                reply["id"] = ids[i]
            p.reply = reply
        t_done = time.monotonic()
        served.stats["queue_wait_s"] += sum(t_start - p.t0 for p in batch)
        served.stats["score_s"] += t_scored - t_start
        served.stats["reply_s"] += t_done - t_scored
        for p in batch:
            served.latencies.append((t_done, (t_done - p.t0) * 1e3))
            p.event.set()
        # observation after every reply went out: a slow or dying tap
        # adds no client-visible latency to this batch
        if self._log_taps:
            self._notify_taps(served, batch, cols)


class ContinuousServingServer(ServingServer):
    """Low-latency mode: each request is scored on arrival, on its
    handler thread under one score lock (no micro-batch wait), by a
    scorer warmed at start (continuous/HTTPSourceV2.scala:305)."""

    def __init__(self, model: Optional[Transformer] = None,
                 warmup_payload: Optional[dict] = None, **kwargs):
        kwargs.setdefault("max_batch_size", 1)
        super().__init__(model, warmup_payload=warmup_payload, **kwargs)
        self._score_lock = threading.Lock()
        # no queue here: the backpressure bound caps how many requests
        # may wait on the score lock at once
        self._inflight = threading.BoundedSemaphore(max(self.max_queue, 1))

    def start(self) -> "ContinuousServingServer":
        self._start_warm()
        self._server_thread.start()  # no batch thread: scoring is inline
        logger.info("continuous serving on %s:%s%s", self.host, self.port,
                    self.api_path)
        return self

    def _enqueue(self, pending: _Pending, served: _ServedModel) -> bool:
        if not self._inflight.acquire(blocking=False):
            with self._lock:
                self._stats["rejected"] += 1
                served.stats["rejected"] += 1
                self._last_shed = time.monotonic()
            env.warn_once("serving.backpressure",
                          f"serving queue full (max_queue={self.max_queue});"
                          " shedding load with 503 + Retry-After")
            return False
        try:
            with self._score_lock:
                self._score([pending], served)
            with self._lock:
                self._stats["served"] += 1
                served.stats["served"] += 1
        except Exception as e:
            with self._lock:
                self._stats["errors"] += 1
                served.stats["errors"] += 1
            pending.error = str(e)
            pending.event.set()
        finally:
            self._inflight.release()
        return True


class ServingFleet:
    """Distributed serving: N worker servers + a registry endpoint.

    The reference runs a WorkerServer per executor JVM with a driver
    service registry (DistributedHTTPSource.scala:203,
    HTTPSourceV2.scala:132-193 DriverServiceUtils); here each worker is
    a :class:`ServingServer` in this process, all on the served model's
    device (one card: the workers' scoring threads share it), and the
    registry is an HTTP endpoint returning every worker's address so
    clients can spray requests — requests enter at the workers, never
    proxied. Pass ``models={...}`` to serve a named registry on every
    worker."""

    def __init__(self, model: Optional[Transformer] = None,
                 num_servers: int = 2,
                 continuous: bool = False, host: str = "127.0.0.1",
                 **server_kwargs):
        # construction config is retained so the fleet can build
        # replacement and scale-up workers at runtime (FleetSupervisor)
        self._model = model
        self._continuous = continuous
        self._host = host
        self._server_kwargs = dict(server_kwargs)
        # the reference's san_lock("serving.fleet.servers")
        self._servers_lock = threading.Lock()
        self._started = False
        self.servers = [self._make_server() for _ in range(num_servers)]
        fleet = self

        class RegistryHandler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                pass

            def do_GET(self):
                # snapshot under the membership lock: spawn/retire may
                # run concurrently, and a registry read must never see
                # a half-updated worker list
                with fleet._servers_lock:
                    servers = list(fleet.servers)
                if self.path == "/registry":
                    obj = {"workers": [s.url for s in servers]}
                elif self.path == "/healthz":
                    # fleet-level health: the registry runs in-process
                    # with its workers, so it can aggregate their
                    # health snapshots without extra HTTP hops
                    workers = [s._health() for s in servers]
                    status = ("degraded" if any(
                        w["status"] != "ok" for w in workers) else "ok")
                    obj = {"status": status, "workers": workers}
                else:
                    self.send_error(404)
                    return
                body = json.dumps(obj).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._registry = ThreadingHTTPServer((host, 0), RegistryHandler)
        self.registry_host, self.registry_port = self._registry.server_address
        self._registry_thread = threading.Thread(
            target=self._registry.serve_forever, daemon=True,
            kwargs={"poll_interval": _POLL_S},
            name="mmlspark-torch-fleet-registry")

    def _make_server(self) -> ServingServer:
        """Construct one worker (not started). ``fleet.spawn`` makes
        bring-up failable for chaos tests — the supervisor's restart
        path must retry it with backoff, not crash."""
        fault_point("fleet.spawn")
        cls = ContinuousServingServer if self._continuous else ServingServer
        return cls(self._model, host=self._host, port=0,
                   **self._server_kwargs)

    def spawn_worker(self) -> ServingServer:
        """Grow the fleet by one worker (started when the fleet is
        running); it appears in ``/registry`` as soon as it can score."""
        server = self._make_server()
        if self._started:
            server.start()
        with self._servers_lock:
            self.servers.append(server)
        return server

    def remove_worker(self, server: ServingServer) -> bool:
        """Deregister a worker (does NOT stop it — retirement drains
        or kills it separately, AFTER it stops being discoverable).
        Returns False when it was already gone."""
        with self._servers_lock:
            try:
                self.servers.remove(server)
                return True
            except ValueError:
                return False

    @property
    def registry_url(self) -> str:
        return f"http://{self.registry_host}:{self.registry_port}/registry"

    @property
    def worker_urls(self) -> List[str]:
        with self._servers_lock:
            return [s.url for s in self.servers]

    def start(self) -> "ServingFleet":
        with self._servers_lock:
            servers = list(self.servers)
        for s in servers:
            s.start()
        self._started = True
        self._registry_thread.start()
        logger.info("serving fleet: %d workers, registry %s",
                    len(servers), self.registry_url)
        return self

    def stop(self) -> None:
        """Tear the whole fleet down. One worker's failing ``stop()``
        must not leak the others or the registry handler thread: every
        worker gets its own try, the registry shuts down in a finally,
        and the FIRST worker error re-raises after the full sweep."""
        with self._servers_lock:
            servers = list(self.servers)
        first: Optional[BaseException] = None
        try:
            for s in servers:
                try:
                    s.stop()
                except BaseException as e:
                    if first is None:
                        first = e
        finally:
            if self._started:
                self._registry.shutdown()
            self._registry.server_close()
        if first is not None:
            raise first

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


class FleetClient:
    """Client-side load balancing + failover over a :class:`ServingFleet`.

    The reference leaves request spraying to an external load balancer in
    front of the executor listeners; here the registry makes workers
    discoverable, and this client round-robins across them, retrying a
    failed request on the next worker (the serving-path analog of
    FaultToleranceUtils.retryWithTimeout,
    core/utils/FaultToleranceUtils.scala:9-31).

    Gray-failure tolerance (the arXiv:1605.08695 §4 hedging playbook —
    real fleets mostly fail *slow*, not dead):

      - **deadline propagation** — with ``deadline_ms`` set (default
        ``MMLSPARK_TORCH_REQUEST_DEADLINE_MS``), every attempt stamps the
        REMAINING budget as the ``X-Deadline-Ms`` header; the server
        sheds expired requests at dequeue with an attributed 504, and
        the client stops retrying once the budget is spent;
      - **hedged requests** (``hedging=True``) — when the primary has
        not replied within an adaptive delay (rolling per-worker p95,
        floor ``MMLSPARK_TORCH_HEDGE_DELAY_MS``), the same idempotent
        request fires at a second worker and the first reply wins (the
        loser is counted cancelled); a token bucket caps hedges at
        ``MMLSPARK_TORCH_HEDGE_BUDGET_PCT``% extra backend load, and a
        worker whose rolling p95 is an outlier vs its peers is ejected
        from rotation like a degraded one (``slow_ejections``);
      - **per-worker circuit breakers** — consecutive connection
        errors/timeouts open a breaker: the worker is skipped outright
        (no connect) until a half-open probe re-admits it;
      - **global retry budget** — retries draw from a
        ``MMLSPARK_TORCH_RETRY_BUDGET_PCT``%-of-traffic token bucket, so
        a fleet-wide brownout sheds retries to the caller (attributed
        ``retry budget exhausted``) instead of amplifying the overload.

    Counters for all of it live in :attr:`stats`."""

    # floor between re-discoveries when the worker list has shrunk: a
    # permanently-dead worker stays listed by the registry, so without
    # a floor every score() would re-add it and pay a failed attempt
    _min_refresh_gap_s = 1.0

    # a worker marked degraded leaves rotation for this long; after
    # that it is retried (swaps and queue spikes are transient, and the
    # next health poll re-marks it if it still reports degraded)
    _degraded_ttl_s = 5.0
    # floor between /healthz sweeps when route_around_degraded is on
    _health_poll_interval_s = 2.0
    # rolling per-worker latency window feeding the adaptive hedge
    # delay and the slow-outlier ejection
    _latency_window = 128
    # minimum samples before a worker's p95 participates in either
    _min_latency_samples = 8
    # a worker slower than this multiple of its peers' median p95 (and
    # above the hedge-delay floor) is ejected from rotation
    _slow_outlier_factor = 4.0
    # hedge fires at this multiple of the typical worker p95: at 1x,
    # ~5% of ORDINARY requests would hedge and drain the budget ahead
    # of the genuine stragglers the hedge exists for
    _hedge_delay_mult = 2.0

    def __init__(self, registry_url: str, timeout: float = 15.0,
                 retries_per_worker: int = 1,
                 refresh_interval_s: float = 30.0,
                 route_around_degraded: bool = False,
                 hedging: bool = False,
                 deadline_ms: Optional[float] = None,
                 hedge_delay_ms: Optional[float] = None,
                 hedge_budget_pct: Optional[float] = None,
                 retry_budget_pct: Optional[float] = None,
                 breaker_threshold: int = 3,
                 breaker_open_s: float = 2.0):
        self.registry_url = registry_url
        self.timeout = timeout
        self.retries_per_worker = retries_per_worker
        self.refresh_interval_s = refresh_interval_s
        # /healthz-aware routing: periodically sweep worker health and
        # skip workers reporting status != ok (mid-swap, saturated
        # queue) while any healthy worker remains
        self.route_around_degraded = route_around_degraded
        self.hedging = hedging
        self.deadline_ms = (deadline_ms if deadline_ms is not None
                            else env.env_float(env.REQUEST_DEADLINE_MS, 0.0,
                                           minimum=0.0))
        self.hedge_delay_ms = (hedge_delay_ms if hedge_delay_ms
                               is not None
                               else env.env_float(env.HEDGE_DELAY_MS, 30.0,
                                              minimum=0.0))
        # burst 8: hedging earns its keep in the first seconds after a
        # worker goes gray (before the latency map has the samples to
        # eject it) and at each degraded-TTL re-probe — windows where
        # the pct-accrual alone would strangle it; steady-state load
        # stays capped at pct% because the bucket stores at most burst
        self._hedge_budget = FractionBudget(
            hedge_budget_pct if hedge_budget_pct is not None
            else env.env_float(env.HEDGE_BUDGET_PCT, 5.0, minimum=0.0),
            burst=8.0)
        self._retry_budget = FractionBudget(
            retry_budget_pct if retry_budget_pct is not None
            else env.env_float(env.RETRY_BUDGET_PCT, 10.0, minimum=0.0),
            burst=8.0)
        self._breaker_threshold = breaker_threshold
        self._breaker_open_s = breaker_open_s
        self._breakers: Dict[str, CircuitBreaker] = {}
        self._lat: Dict[str, deque] = {}  # url -> rolling latencies ms
        self.stats = {"requests": 0, "hedges_fired": 0, "hedges_won": 0,
                      "hedges_cancelled": 0, "hedge_denied": 0,
                      "breaker_skips": 0, "retries": 0,
                      "retries_shed": 0, "deadline_shed": 0,
                      "slow_ejections": 0}
        self._workers: List[str] = []
        self._next = 0
        # the reference's san_lock("serving.fleet.client")
        self._lock = threading.Lock()
        self._registry_count = 0
        self._last_refresh = 0.0
        self._degraded: Dict[str, float] = {}  # url -> marked time
        self._last_health_poll = 0.0

    def refresh(self) -> List[str]:
        import urllib.request
        with urllib.request.urlopen(self.registry_url,
                                    timeout=self.timeout) as r:
            workers = json.loads(r.read())["workers"]
        with self._lock:
            self._workers = workers
            self._registry_count = len(workers)
            self._last_refresh = time.monotonic()
        return list(workers)

    @staticmethod
    def _healthz_url(worker_url: str) -> str:
        # worker addresses include the api path (".../score"); health
        # lives at the server root
        parts = urllib.parse.urlsplit(worker_url)
        return f"{parts.scheme}://{parts.netloc}/healthz"

    def worker_health(self) -> Dict[str, Dict[str, Any]]:
        """Poll every known worker's ``/healthz``. Returns
        ``{worker_url: health_json}`` with an
        ``{"status": "unreachable", "reason": ...}`` stub for workers
        that do not answer, and records non-``ok`` workers so
        :meth:`score` routes around them (``route_around_degraded``)."""
        import urllib.request
        with self._lock:
            workers = list(self._workers)
        out: Dict[str, Dict[str, Any]] = {}
        for url in workers:
            try:
                with urllib.request.urlopen(
                        self._healthz_url(url), timeout=self.timeout) as r:
                    health = json.loads(r.read())
            except Exception as e:
                health = {"status": "unreachable",
                          "reason": f"{type(e).__name__}: {e}"}
            out[url] = health
            with self._lock:
                if health.get("status") != "ok":
                    self._degraded[url] = time.monotonic()
                else:
                    self._degraded.pop(url, None)
        return out

    def _maybe_poll_health(self) -> None:
        now = time.monotonic()
        with self._lock:
            due = (now - self._last_health_poll
                   >= self._health_poll_interval_s)
            if due:
                self._last_health_poll = now
        if due:
            self.worker_health()

    def _breaker(self, url: str) -> CircuitBreaker:
        with self._lock:
            br = self._breakers.get(url)
            if br is None:
                br = self._breakers[url] = CircuitBreaker(
                    failure_threshold=self._breaker_threshold,
                    open_s=self._breaker_open_s)
            return br

    def _observe(self, url: str, lat_ms: float) -> None:
        """Record one reply latency; with hedging on, eject a worker
        that has gone clearly slower than its peers (gray: slow but
        alive) from rotation via the degraded map — the TTL expiry
        doubles as the re-probe that lets a recovered worker rejoin.
        The victim needs only TWO consecutive over-threshold samples
        (its peers' rolling p95s define the threshold, and THOSE need
        ``_min_latency_samples`` each): a gray worker serves so slowly
        that waiting for a full victim-side window would cost seconds
        of tail latency per ejection."""
        def p95(lat) -> float:
            s = sorted(lat)
            return s[min(len(s) - 1, int(0.95 * len(s)))]
        with self._lock:
            lat = self._lat.get(url)
            if lat is None:
                lat = self._lat[url] = deque(maxlen=self._latency_window)
            lat.append(lat_ms)
            if not self.hedging or len(lat) < 2:
                return
            others = [p95(l) for u, l in self._lat.items()
                      if u != url and len(l) >= self._min_latency_samples]
            if not others:
                return
            med = sorted(others)[len(others) // 2]
            threshold = max(self._slow_outlier_factor * med,
                            self.hedge_delay_ms)
            recent = list(lat)[-2:]
            if all(v > threshold for v in recent):
                now = time.monotonic()
                marked = self._degraded.get(url)
                # (re-)eject when unmarked OR the mark has expired: a
                # TTL re-probe that comes back still-slow must not slip
                # past a stale entry back into full rotation
                if (marked is None
                        or now - marked > self._degraded_ttl_s):
                    self._degraded[url] = now
                    self.stats["slow_ejections"] += 1

    def _hedge_delay_s(self) -> float:
        """Adaptive hedge delay: ``_hedge_delay_mult`` times the median
        of the per-worker rolling p95s (median is robust to the very
        outlier being hedged around; the multiple keeps ordinary p95
        stragglers from burning hedge budget), floored at
        ``hedge_delay_ms``."""
        with self._lock:
            p95s = []
            for lat in self._lat.values():
                if len(lat) >= self._min_latency_samples:
                    s = sorted(lat)
                    p95s.append(s[min(len(s) - 1, int(0.95 * len(s)))])
        delay_ms = self.hedge_delay_ms
        if p95s:
            delay_ms = max(delay_ms, self._hedge_delay_mult
                           * sorted(p95s)[len(p95s) // 2])
        return delay_ms / 1000.0

    def _pick(self, excluded: Optional[set] = None) -> Optional[str]:
        """Next worker in rotation, skipping ``excluded`` (workers that
        already dropped THIS request's connection — retrying them would
        repeat the same failure), open-breaker workers (skipped with no
        connect; a half-open probe re-admits) and, while alternatives
        remain, degraded ones. All candidates degraded or blocked:
        degraded service beats none. All candidates excluded: ``None``
        — the caller re-discovers."""
        excluded = excluded or set()
        with self._lock:
            if not self._workers:
                return None
            now = time.monotonic()
            workers = list(self._workers)
            # round-robin: each call starts one past the previous
            # call's start, then walks the whole ring as fallbacks
            start = self._next
            self._next += 1
            order = [workers[(start + k) % len(workers)]
                     for k in range(len(workers))]
            degraded_fallback: Optional[str] = None
            blocked_fallback: Optional[str] = None
        for url in order:
            if url in excluded:
                continue
            with self._lock:
                marked = self._degraded.get(url)
            if marked is not None and now - marked <= self._degraded_ttl_s:
                if degraded_fallback is None:
                    degraded_fallback = url
                continue
            br = self._breakers.get(url)
            # allow() is consulted only on a candidate that is actually
            # returned on True — a half-open probe slot must never be
            # consumed by a worker this request then ignores
            if br is None or br.allow():
                return url
            with self._lock:
                self.stats["breaker_skips"] += 1
            if blocked_fallback is None:
                blocked_fallback = url
        if degraded_fallback is not None:
            br = self._breakers.get(degraded_fallback)
            if br is None or br.allow():
                return degraded_fallback
        # total blackout: every candidate degraded or breaker-blocked —
        # one bypassed attempt beats refusing service outright
        return degraded_fallback or blocked_fallback

    def _maybe_refresh(self) -> None:
        """Re-discover workers when the local list has shrunk below the
        registry's count (a worker evicted on one transient failure
        must rejoin rotation without waiting for ANOTHER failure) or on
        the staleness interval. Refresh failures are non-fatal here —
        the known worker list still serves."""
        with self._lock:
            now = time.monotonic()
            shrunk = len(self._workers) < self._registry_count
            stale = now - self._last_refresh > self.refresh_interval_s
            recent = now - self._last_refresh < self._min_refresh_gap_s
        if (shrunk or stale) and not recent:
            try:
                self.refresh()
            except Exception:
                pass

    def _post(self, url: str, data: bytes,
              abs_deadline: Optional[float] = None) -> Dict[str, Any]:
        import urllib.request
        # chaos boundary: the client socket layer — an armed delay is
        # network RTT inflation, an armed raise a dropped connection
        fault_point("net.latency")
        headers = {"Content-Type": "application/json"}
        timeout = self.timeout
        if abs_deadline is not None:
            # deadline propagation: the REMAINING budget rides as the
            # X-Deadline-Ms header (never the original total — time
            # already spent on refreshes/failovers is gone), and the
            # socket timeout shrinks to it so a stalled worker cannot
            # hold this attempt past the budget
            remaining_ms = max(
                (abs_deadline - time.monotonic()) * 1e3, 1.0)
            headers["X-Deadline-Ms"] = f"{remaining_ms:.0f}"
            timeout = min(timeout, remaining_ms / 1000.0 + 0.5)
        req = urllib.request.Request(url, data=data, headers=headers)
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return json.loads(r.read())

    def _call_worker(self, url: str, data: bytes,
                     abs_deadline: Optional[float],
                     failed: set, results: "queue_lib.Queue") -> None:
        """One worker call with full accounting (latency observation,
        breaker bookkeeping, dead-worker eviction); the outcome lands
        on ``results`` so a hedge race takes the first reply."""
        t0 = time.monotonic()
        try:
            reply = self._post(url, data, abs_deadline)
        except Exception as e:
            import urllib.error
            if isinstance(e, urllib.error.HTTPError):
                if e.code in (503, 504):  # alive-but-shedding
                    with self._lock:
                        self._degraded[url] = time.monotonic()
            else:  # dead worker: breaker + evict + exclude
                self._breaker(url).record_failure()
                with self._lock:
                    failed.add(url)
                    if url in self._workers:
                        self._workers.remove(url)
            results.put((url, None, e))
            return
        self._observe(url, (time.monotonic() - t0) * 1e3)
        self._breaker(url).record_success()
        results.put((url, reply, None))

    def _hedged_post(self, primary: str, data: bytes,
                     abs_deadline: Optional[float],
                     failed: set) -> Dict[str, Any]:
        """One hedged attempt: the primary call runs on a worker
        thread; if it has not resolved within the adaptive hedge delay,
        the same request fires at a second worker (budget permitting)
        and the FIRST reply wins — the loser is abandoned (counted
        cancelled). Raises only when every in-flight leg failed."""
        results: "queue_lib.Queue" = queue_lib.Queue()
        threading.Thread(
            target=self._call_worker,
            args=(primary, data, abs_deadline, failed, results),
            daemon=True, name="mmlspark-torch-fleet-req").start()
        outstanding = 1
        try:
            url, reply, err = results.get(timeout=self._hedge_delay_s())
        except queue_lib.Empty:
            hedge_url = self._pick(excluded=failed | {primary})
            if hedge_url is not None and self._hedge_budget.take():
                with self._lock:
                    self.stats["hedges_fired"] += 1
                threading.Thread(
                    target=self._call_worker,
                    args=(hedge_url, data, abs_deadline, failed,
                          results),
                    daemon=True, name="mmlspark-torch-fleet-hedge").start()
                outstanding += 1
            elif hedge_url is not None:
                with self._lock:
                    self.stats["hedge_denied"] += 1
            wait_s = self.timeout + 1.0
            if abs_deadline is not None:
                wait_s = min(wait_s, max(
                    abs_deadline - time.monotonic(), 0.0) + 1.0)
            try:
                url, reply, err = results.get(timeout=wait_s)
            except queue_lib.Empty:
                raise TimeoutError(
                    f"no reply from {primary} (or its hedge) within "
                    f"{wait_s:.1f}s") from None
        outstanding -= 1
        while err is not None and outstanding > 0:
            # the first leg lost; its sibling may still win
            try:
                url, reply, err = results.get(timeout=self.timeout + 1.0)
                outstanding -= 1
            except queue_lib.Empty:
                break
        if err is not None:
            raise err
        with self._lock:
            if url != primary:
                self.stats["hedges_won"] += 1
            if outstanding > 0:
                self.stats["hedges_cancelled"] += 1
        return reply

    def score(self, payload: Dict[str, Any]) -> Dict[str, Any]:
        """Score ``payload`` on some worker, failing over by error
        class: a connection-level failure (reset, refused, timeout)
        means the worker is dead — evict it, open its breaker a step,
        exclude it from this request's retries, and fail over to a
        DIFFERENT worker (scoring is idempotent, so the retry is safe
        and the reply identical); a 503/504 means alive-but-shedding —
        mark degraded and rotate on without evicting; any other HTTP
        status is a semantic error no retry can fix and surfaces
        immediately. Failover attempts draw from the global retry
        budget; the request's remaining ``deadline_ms`` bounds every
        leg (see the class docstring)."""
        import urllib.error
        t_start = time.monotonic()
        budget_ms = self.deadline_ms if self.deadline_ms > 0 else None
        abs_deadline = (t_start + budget_ms / 1000.0
                        if budget_ms is not None else None)
        with self._lock:
            have_workers = bool(self._workers)
        if not have_workers:
            self.refresh()
        else:
            self._maybe_refresh()
        if self.route_around_degraded:
            self._maybe_poll_health()
        data = json.dumps(payload).encode()
        with self._lock:
            self.stats["requests"] += 1
            n = max(len(self._workers), 1)
        self._retry_budget.note_request()
        self._hedge_budget.note_request()
        attempts = max(n * self.retries_per_worker, 1)
        failed: set = set()  # connection-failed workers, this request
        last: Optional[Exception] = None
        first = True
        for _ in range(attempts):
            if not first:
                self._spend_retry(last)  # raises once the budget drains
                if abs_deadline is not None \
                        and time.monotonic() >= abs_deadline:
                    self._shed_deadline(budget_ms, last)
            first = False
            url = self._pick(excluded=failed)
            if url is None:
                break
            try:
                if self.hedging:
                    return self._hedged_post(url, data, abs_deadline,
                                             failed)
                return self._plain_post(url, data, abs_deadline)
            except urllib.error.HTTPError as e:
                if e.code in (503, 504):
                    last = e
                    with self._lock:
                        self._degraded[url] = time.monotonic()
                    continue
                raise
            except Exception as e:  # dead worker(s): already evicted
                last = e
                failed.add(url)
                with self._lock:
                    if url in self._workers:
                        self._workers.remove(url)
        # last chance: addresses may be stale (fleet respawned workers
        # on fresh ports) — re-discover once and try a fresh worker
        if last is not None:
            self._spend_retry(last)  # raises once the budget drains
        if abs_deadline is not None and time.monotonic() >= abs_deadline:
            self._shed_deadline(budget_ms, last)
        try:
            self.refresh()
            url = self._pick(excluded=failed)
            if url is not None:
                if self.hedging:
                    return self._hedged_post(url, data, abs_deadline,
                                             failed)
                return self._plain_post(url, data, abs_deadline)
        except urllib.error.HTTPError:
            raise
        except Exception as e2:
            last = e2
        if last is None:
            raise RuntimeError(
                f"registry {self.registry_url} lists no workers")
        raise RuntimeError(
            f"all workers failed after {attempts} attempts: {last}")

    def _plain_post(self, url: str, data: bytes,
                    abs_deadline: Optional[float]) -> Dict[str, Any]:
        """Unhedged call with the same latency/breaker accounting."""
        t0 = time.monotonic()
        try:
            reply = self._post(url, data, abs_deadline)
        except Exception as e:
            import urllib.error
            if not isinstance(e, urllib.error.HTTPError):
                self._breaker(url).record_failure()
            raise
        self._observe(url, (time.monotonic() - t0) * 1e3)
        self._breaker(url).record_success()
        return reply

    def _spend_retry(self, last: Optional[Exception]) -> bool:
        """Draw one token from the global retry budget before a
        failover attempt; an empty bucket sheds the retry to the caller
        with attribution (the brownout anti-amplification contract)."""
        if self._retry_budget.take():
            with self._lock:
                self.stats["retries"] += 1
            return True
        with self._lock:
            self.stats["retries_shed"] += 1
        raise RuntimeError(
            f"retry budget exhausted "
            f"({self._retry_budget.pct:g}% of request volume): retry "
            f"shed to caller instead of amplifying a fleet-wide "
            f"brownout (last error: {last})")

    def _shed_deadline(self, budget_ms: Optional[float],
                       last: Optional[Exception]) -> None:
        with self._lock:
            self.stats["deadline_shed"] += 1
        raise TimeoutError(
            f"deadline exceeded: request budget "
            f"{budget_ms:.0f} ms spent across failover attempts "
            f"(last error: {last})")


def serve_pipeline(model: Transformer, **kwargs) -> ServingServer:
    """spark.readStream.server() analog: start serving a fitted model."""
    return ServingServer(model, **kwargs).start()


def serve_distributed(model: Transformer, num_servers: int = 2,
                      **kwargs) -> ServingFleet:
    """spark.readStream.distributedServer() analog."""
    return ServingFleet(model, num_servers=num_servers, **kwargs).start()


def serve_continuous(model: Transformer, **kwargs) -> ContinuousServingServer:
    """spark.readStream.continuousServer() analog."""
    return ContinuousServingServer(model, **kwargs).start()
