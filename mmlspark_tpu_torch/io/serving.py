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
dtype with numpy (no device work), and the scoring thread pads each
drained batch up to a rung of a power-of-two ladder capped at
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

The serving fleet and model lifecycle (hot-swap, drain, kill, request-log
taps, ``ServingFleet``, ``FleetClient``) are ROADMAP A6d and raise
``NotImplementedError``.
"""

from __future__ import annotations

import json
import threading
import time
from collections import OrderedDict, deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from mmlspark_tpu_torch.core import env
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device import DeviceUnavailable
from mmlspark_tpu_torch.core.logging_utils import logger
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.parallel.inference import bucket_for, bucket_ladder

_A6D = "A6d (serving fleet and lifecycle)"


def _later(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not in the port yet "
                               f"(ROADMAP {_A6D})")


class _CappedThreadingHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer with a hard cap on concurrent connections.

    HTTP/1.1 keep-alive pins one thread per persistent connection, so
    without a cap N idle clients hold N threads. Connections beyond the
    cap are answered with an immediate ``503 + Retry-After`` and closed.
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
        try:
            super().process_request(request, client_address)
        except BaseException:
            self._conn_sem.release()
            raise

    def process_request_thread(self, request, client_address):
        try:
            super().process_request_thread(request, client_address)
        finally:
            self._conn_sem.release()

    def handle_error(self, request, client_address):
        # client disconnects are normal under load; the default
        # traceback dump would spam stderr
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
        self._started = False
        self._stopped = False
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
        self._lock = threading.Condition()
        self._stop = False
        self._stats = {"served": 0, "errors": 0, "rejected": 0,
                       "timeouts": 0, "admitted": 0, "shed_tenant": 0,
                       "shed_priority": 0, "shed_deadline": 0}
        self._last_shed = 0.0  # monotonic time of the last 503
        self._last_binned_fallback = 0.0

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
                    if pending.error == "server stopped":
                        # a lifecycle flush, not the request's fault
                        self._reply_503(pending.error)
                    elif pending.error.startswith("deadline exceeded"):
                        self._reply_json(504, server._deadline_body(
                            pending, served, tenant))
                    else:
                        self.send_error(500, pending.error)
                    return
                body = json.dumps(pending.reply).encode()
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

        self._httpd = _CappedThreadingHTTPServer(
            (host, port), Handler, max_connections=max_connections,
            retry_after_s=retry_after_s)
        self.host, self.port = self._httpd.server_address
        # named threads so teardown tests can assert none leaked
        self._server_thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True,
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
        ``reason``. Degraded while the pending queues sit at half
        capacity (``queue-saturated``), while load was shed in the last
        5 s (``load-shed``), or right after a binned batch fell back to
        generic scoring (``binned-fallback``)."""
        with self._lock:
            depth = sum(len(m.queue) for m in self._models.values())
            stats = dict(self._stats)
            last_shed = self._last_shed
            last_fallback = self._last_binned_fallback
            entries: List[Tuple[float, float]] = []
            for m in self._models.values():
                entries.extend(m.latencies)
            binned = self._binned_health(self._models[self._default])
        now = time.monotonic()
        p50, p99 = _latency_pctls(entries, now, self._latency_window_s)
        reasons: List[str] = []
        if depth >= max(self.max_queue // 2, 1):
            reasons.append("queue-saturated")
        elif last_shed and now - last_shed < 5.0:
            reasons.append("load-shed")
        if last_fallback and now - last_fallback < 5.0:
            reasons.append("binned-fallback")
        health = {"status": "degraded" if reasons else "ok",
                  "reason": "; ".join(reasons) if reasons else None,
                  "queueDepth": depth, "maxQueue": self.max_queue,
                  "p50_ms": p50, "p99_ms": p99,
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
            cold.plane = None
            booster = getattr(cold.model, "booster", None)
            if booster is not None and hasattr(booster, "clear_jit_cache"):
                booster.clear_jit_cache()
            cold.stats["evictions"] += 1

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

    # -- out of this slice (ROADMAP A6d) -------------------------------------
    def swap_model(self, name, model, probe_payload=None):
        raise _later("hot-swapping a served model (swap_model)")

    def prepare_swap(self, name, model, probe_payload=None):
        raise _later("the two-phase hot-swap (prepare_swap)")

    def commit_swap(self, prepared):
        raise _later("the two-phase hot-swap (commit_swap)")

    def abort_swap(self, prepared):
        raise _later("the two-phase hot-swap (abort_swap)")

    def drain(self, timeout_s: float = 30.0):
        raise _later("graceful retirement (drain)")

    def kill(self):
        raise _later("the chaos kill of a worker (kill)")

    def observe_log(self, tap, model_name=None):
        raise _later("request-log taps (observe_log)")

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
            if served.queue:
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
            for p in expired:
                p.error = ("deadline exceeded: request budget spent "
                           "while queued; shed at dequeue before "
                           "scoring")
                p.event.set()
            if not batch:
                continue
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
        and the building of the replies, in seconds."""
        t_start = time.monotonic()
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
    """N worker servers behind a registry: ROADMAP A6d."""

    def __init__(self, *args: Any, **kwargs: Any):
        raise _later("the serving fleet (ServingFleet)")


class FleetClient:
    """The fleet's failover client: ROADMAP A6d."""

    def __init__(self, *args: Any, **kwargs: Any):
        raise _later("the fleet client (FleetClient)")


def serve_pipeline(model: Transformer, **kwargs) -> ServingServer:
    """spark.readStream.server() analog: start serving a fitted model."""
    return ServingServer(model, **kwargs).start()


def serve_distributed(model: Transformer, num_servers: int = 2,
                      **kwargs) -> ServingFleet:
    """spark.readStream.distributedServer() analog: ROADMAP A6d."""
    raise _later("distributed serving (serve_distributed)")


def serve_continuous(model: Transformer, **kwargs) -> ContinuousServingServer:
    """spark.readStream.continuousServer() analog."""
    return ContinuousServingServer(model, **kwargs).start()
