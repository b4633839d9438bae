"""Fleet supervision: heartbeats, supervised restart, autoscaling — the
port's copy of the JAX package's ``io/fleet.py``, over the port's
:class:`~mmlspark_tpu_torch.io.serving.ServingFleet` (its workers share
one process and the card).

The TF-system playbook (arXiv:1605.08695 §4.3) treats worker failure
and membership churn as the *normal case* owned by a supervisor, not an
error path. :class:`FleetSupervisor` closes that loop over
:class:`~mmlspark_tpu_torch.io.serving.ServingFleet`:

  - **heartbeats** — every ``MMLSPARK_TORCH_FLEET_HEARTBEAT_S`` the
    supervisor polls each worker's ``/healthz`` (queue depth, rolling
    p99, served/shed counters). ``dead_after_misses`` consecutive
    failed probes mark a worker dead: it is evicted from the registry,
    best-effort stopped, and replaced;
  - **supervised restart** — replacement workers are spawned through
    :func:`~mmlspark_tpu_torch.core.retries.with_retries` (the ``fleet.spawn``
    fault point makes bring-up failable), so a flaky spawn backs off
    instead of crashing the supervisor;
  - **autoscaling** — when the worst worker p99 exceeds
    ``MMLSPARK_TORCH_FLEET_SCALE_P99_MS`` (or a queue passes half its
    bound) for ``scale_streak`` consecutive polls, the fleet grows
    toward ``MMLSPARK_TORCH_FLEET_MAX``; when every worker is calm
    (p99 under a quarter of the threshold, queues near empty) for the
    same streak, it shrinks toward ``MMLSPARK_TORCH_FLEET_MIN``. A
    cooldown (``MMLSPARK_TORCH_FLEET_COOLDOWN_S``) between consecutive
    scaling actions plus the 4x up/down threshold gap is the
    hysteresis that prevents flapping;
  - **graceful retirement** — scale-down deregisters the worker FIRST
    (clients stop discovering it), then
    :meth:`~mmlspark_tpu_torch.io.serving.ServingServer.drain` flushes every
    already-accepted request, then the worker stops: zero accepted
    requests are lost;
  - **gray-failure detection** — a worker can pass every heartbeat and
    still serve at 50x latency (a *gray* failure: slow, not dead). A
    worker whose rolling ``/healthz`` p99 exceeds ``gray_factor`` times
    the median of its peers (and an absolute ``gray_min_p99_ms`` floor)
    for ``gray_streak`` consecutive sweeps is classified gray-degraded
    and recycled: deregistered, drained, stopped — convergence then
    respawns a fresh worker (``gray_recycles`` in :meth:`stats`).

The chaos contract (``fleet.heartbeat`` / ``fleet.spawn`` /
``serving.worker_kill`` / ``net.slow_reply`` in ``core/faults.py``) and
tests/test_torch_fleet.py pin these behaviors against the reference.
"""

from __future__ import annotations

import json
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from mmlspark_tpu_torch.core.env import (
    FLEET_COOLDOWN_S,
    FLEET_HEARTBEAT_S,
    FLEET_MAX,
    FLEET_MIN,
    FLEET_SCALE_P99_MS,
    env_float,
    env_int,
)
from mmlspark_tpu_torch.core.faults import fault_point
from mmlspark_tpu_torch.core.logging_utils import logger
from mmlspark_tpu_torch.core.retries import RetryPolicy, with_retries
from mmlspark_tpu_torch.io.serving import (ServingFleet, ServingServer,
                                           SwapFailed)

__all__ = ["FleetSupervisor"]


class FleetSupervisor:
    """Supervise a :class:`ServingFleet`: heartbeat its workers, restart
    the dead, and scale membership to load (see the module docstring
    for the policy). One supervisor per fleet; all mutation of fleet
    membership goes through the fleet's own thread-safe
    ``spawn_worker`` / ``remove_worker``.

    ``start()`` runs the loop on a daemon thread; tests drive single
    deterministic passes via :meth:`tick` without starting it.
    """

    def __init__(self, fleet: ServingFleet,
                 min_workers: Optional[int] = None,
                 max_workers: Optional[int] = None,
                 scale_p99_ms: Optional[float] = None,
                 heartbeat_s: Optional[float] = None,
                 cooldown_s: Optional[float] = None,
                 dead_after_misses: int = 3,
                 scale_streak: int = 2,
                 queue_high_frac: float = 0.5,
                 queue_low_frac: float = 0.05,
                 drain_timeout_s: float = 10.0,
                 probe_timeout_s: Optional[float] = None,
                 spawn_policy: Optional[RetryPolicy] = None,
                 gray_factor: float = 4.0,
                 gray_min_p99_ms: float = 50.0,
                 gray_streak: int = 3):
        self.fleet = fleet
        self.min_workers = (min_workers if min_workers is not None
                            else env_int(FLEET_MIN, 1, minimum=1))
        self.max_workers = (max_workers if max_workers is not None
                            else env_int(FLEET_MAX, 4, minimum=1))
        if self.max_workers < self.min_workers:
            raise ValueError(
                f"fleet envelope is empty: min={self.min_workers} > "
                f"max={self.max_workers}")
        self.scale_p99_ms = (scale_p99_ms if scale_p99_ms is not None
                             else env_float(FLEET_SCALE_P99_MS, 250.0,
                                            minimum=1e-6))
        self.heartbeat_s = (heartbeat_s if heartbeat_s is not None
                            else env_float(FLEET_HEARTBEAT_S, 1.0,
                                           minimum=1e-3))
        self.cooldown_s = (cooldown_s if cooldown_s is not None
                           else env_float(FLEET_COOLDOWN_S, 10.0,
                                          minimum=0.0))
        self.dead_after_misses = max(int(dead_after_misses), 1)
        self.scale_streak = max(int(scale_streak), 1)
        self.queue_high_frac = queue_high_frac
        self.queue_low_frac = queue_low_frac
        self.drain_timeout_s = drain_timeout_s
        # a probe must resolve well inside one heartbeat period, or K
        # missed beats would take K*timeout longer than the budget
        self.probe_timeout_s = (probe_timeout_s if probe_timeout_s
                                is not None else
                                max(self.heartbeat_s * 0.8, 0.05))
        self.spawn_policy = spawn_policy or RetryPolicy(
            max_attempts=4, base_delay=0.05, max_delay=1.0)
        # target size the supervisor converges the fleet to; scaling
        # decisions move it inside [min, max]
        self.target = min(max(len(fleet.worker_urls), self.min_workers),
                          self.max_workers)
        # gray-failure detection thresholds: a heartbeat-PASSING worker
        # whose p99 is a clear outlier vs its peers is slow-not-dead
        self.gray_factor = gray_factor
        self.gray_min_p99_ms = gray_min_p99_ms
        self.gray_streak = max(int(gray_streak), 1)
        self._gray_streaks: Dict[int, int] = {}  # id(server) -> streak
        self._misses: Dict[int, int] = {}  # id(server) -> missed beats
        self._up_streak = 0
        self._down_streak = 0
        self._last_scale_t = 0.0
        self._stats = {"heartbeats": 0, "deaths": 0, "spawns": 0,
                       "scale_ups": 0, "scale_downs": 0, "drained": 0,
                       "spawn_failures": 0, "fleet_swaps": 0,
                       "fleet_swap_rollbacks": 0, "gray_recycles": 0}
        # (t_monotonic, n_workers) after every pass: the worker-count
        # trajectory
        self.history: List[Tuple[float, int]] = []
        self._stop_ev = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- heartbeat -----------------------------------------------------------
    def _probe(self, server: ServingServer) -> Optional[Dict[str, Any]]:
        """One ``/healthz`` heartbeat; ``None`` means missed (probe
        error or timeout — the ``fleet.heartbeat`` fault point makes
        this failable for chaos tests)."""
        import urllib.request
        try:
            fault_point("fleet.heartbeat")
            url = f"http://{server.host}:{server.port}/healthz"
            with urllib.request.urlopen(
                    url, timeout=self.probe_timeout_s) as r:
                return json.loads(r.read())
        except Exception:
            return None

    def _sweep(self) -> List[Tuple[ServingServer, Dict[str, Any]]]:
        """Heartbeat every worker; evict + stop the dead. Returns the
        live workers with their health snapshots (autoscaler + gray
        detection input)."""
        with self.fleet._servers_lock:
            servers = list(self.fleet.servers)
        healths: List[Tuple[ServingServer, Dict[str, Any]]] = []
        live_ids = set()
        for server in servers:
            self._stats["heartbeats"] += 1
            health = self._probe(server)
            live_ids.add(id(server))
            if health is not None:
                self._misses[id(server)] = 0
                healths.append((server, health))
                continue
            misses = self._misses.get(id(server), 0) + 1
            self._misses[id(server)] = misses
            if misses < self.dead_after_misses:
                continue
            # dead: deregister so clients stop finding it, then
            # best-effort teardown (it may be gone already)
            logger.warning(
                "fleet worker %s:%s dead after %d missed heartbeats; "
                "evicting", server.host, server.port, misses)
            self.fleet.remove_worker(server)
            live_ids.discard(id(server))
            self._stats["deaths"] += 1
            try:
                server.stop()
            except Exception:
                pass
        # forget miss counts of evicted workers (id() values recycle)
        self._misses = {k: v for k, v in self._misses.items()
                        if k in live_ids}
        self._gray_streaks = {k: v for k, v in self._gray_streaks.items()
                              if k in live_ids}
        return healths

    # -- gray-failure detection ----------------------------------------------
    def _gray_sweep(
            self,
            healths: List[Tuple[ServingServer, Dict[str, Any]]]
    ) -> "set[int]":
        """Classify heartbeat-passing p99 outliers as gray-degraded and
        recycle them: a worker ``gray_factor``x slower (rolling p99)
        than the MEDIAN of its peers — and past the absolute
        ``gray_min_p99_ms`` floor — for ``gray_streak`` consecutive
        sweeps is slow-not-dead (``net.slow_reply`` territory: it
        answers every heartbeat). Recycle = deregister first (clients
        stop discovering it), drain what it already accepted, stop;
        :meth:`_converge` then respawns a fresh worker. Returns the
        recycled ``id(server)`` set so the caller can keep the outlier's
        p99 out of the scaling decision."""
        p99s = {id(s): h.get("p99_ms") for s, h in healths}
        victims: List[ServingServer] = []
        for server, health in healths:
            p99 = health.get("p99_ms")
            peers = [v for k, v in p99s.items()
                     if k != id(server) and v is not None]
            if p99 is None or not peers:
                self._gray_streaks[id(server)] = 0
                continue
            median = sorted(peers)[len(peers) // 2]
            gray = (p99 > self.gray_factor * max(median, 1e-9)
                    and p99 > self.gray_min_p99_ms)
            if not gray:
                self._gray_streaks[id(server)] = 0
                continue
            streak = self._gray_streaks.get(id(server), 0) + 1
            self._gray_streaks[id(server)] = streak
            if streak >= self.gray_streak:
                victims.append(server)
        for server in victims:
            logger.warning(
                "fleet worker %s:%s is gray-degraded (p99=%s ms vs "
                "fleet median; heartbeats still passing); recycling",
                server.host, server.port,
                p99s.get(id(server)))
            self.fleet.remove_worker(server)
            self._gray_streaks.pop(id(server), None)
            self._misses.pop(id(server), None)
            self._stats["gray_recycles"] += 1
            try:
                server.drain(timeout_s=self.drain_timeout_s)
                server.stop()
            except Exception:  # teardown is best-effort
                logger.exception(
                    "gray recycle teardown failed on %s:%s",
                    server.host, server.port)
        return {id(s) for s in victims}

    # -- membership ----------------------------------------------------------
    def _spawn(self) -> bool:
        """Spawn one worker with backoff (``fleet.spawn`` chaos);
        False when every attempt failed — retried next pass, so a
        transiently-failing spawn cannot kill the supervisor."""
        try:
            with_retries(self.fleet.spawn_worker,
                         policy=self.spawn_policy,
                         describe="fleet.spawn")
            return True
        except Exception:
            self._stats["spawn_failures"] += 1
            return False

    def _retire_one(self) -> None:
        """Gracefully retire the least-loaded worker: deregister ->
        drain (flush accepted requests) -> stop. Zero accepted-request
        loss is the drain contract."""
        with self.fleet._servers_lock:
            servers = list(self.fleet.servers)
        if len(servers) <= self.min_workers:
            return
        def _depth(s: ServingServer) -> int:
            with s._lock:
                return sum(len(m.queue) for m in s._models.values())
        victim = min(servers, key=_depth)
        self.fleet.remove_worker(victim)
        if victim.drain(timeout_s=self.drain_timeout_s):
            self._stats["drained"] += 1
        else:
            logger.warning(
                "fleet worker %s:%s did not drain within %.1fs; "
                "stopping with pendings flushed as errors",
                victim.host, victim.port, self.drain_timeout_s)
        victim.stop()

    # -- fleet-wide hot-swap -------------------------------------------------
    def swap_model_fleet(self, name: str, model,
                         probe_payload: Optional[Dict[str, Any]] = None
                         ) -> Dict[str, Any]:
        """Atomically hot-swap served model ``name`` to ``model`` on
        EVERY worker of the fleet — the fleet-wide consistent update of
        arXiv:1605.08695 §4.2, as a two-phase commit over the
        per-server swap machinery:

          1. **prepare** — each worker builds, warms and probes the new
             plane via :meth:`ServingServer.prepare_swap` WITHOUT
             flipping its registry; the old model keeps serving every
             request on every worker for the whole phase (``/healthz``
             walks ``ok -> degraded(swap-in-progress)`` per worker, so
             :class:`~mmlspark_tpu_torch.io.serving.FleetClient` routes
             around mid-swap workers exactly as for a local swap);
          2. **commit** — only when every prepare succeeded, each
             worker flips its pointer (:meth:`ServingServer.\\
commit_swap`); the per-worker downtime is the flip alone, the plane
             build (tables to the card, staged batches) already
             happened cold;
          3. **rollback** — ANY prepare failure aborts every
             already-prepared worker (:meth:`ServingServer.\\
abort_swap`; nothing was flipped, so the old model never stopped
             serving anywhere) and raises an attributed
             :class:`SwapFailed` naming the failing worker.

        Chaos boundary ``registry.swap_fanout`` fires once per worker
        prepare. Membership is snapshotted under the fleet lock at
        entry: workers spawned mid-swap serve the old model until the
        next swap (supervise accordingly — typically call this from
        the same thread that ticks the supervisor). Returns
        ``{"model", "workers", "swap_s", "per_worker": {"host:port":
        {"swap_s", "downtime_s"}}}``."""
        with self.fleet._servers_lock:
            servers = list(self.fleet.servers)
        if not servers:
            raise SwapFailed(
                f"fleet-wide swap of {name!r}: the fleet has no "
                "workers to swap")
        t0 = time.monotonic()
        prepared: List[Tuple[ServingServer, Any]] = []
        try:
            for server in servers:
                # chaos boundary: a worker that dies mid-fan-out —
                # every already-prepared sibling must roll back
                fault_point("registry.swap_fanout")
                prepared.append(
                    (server,
                     server.prepare_swap(name, model,
                                         probe_payload=probe_payload)))
        except Exception as e:
            failing = servers[len(prepared)]
            for server, handle in prepared:
                try:
                    server.abort_swap(handle)
                except Exception:  # rollback is best-effort per worker
                    logger.exception(
                        "fleet swap rollback failed on %s:%s",
                        server.host, server.port)
            self._stats["fleet_swap_rollbacks"] += 1
            raise SwapFailed(
                f"fleet-wide swap of {name!r} rolled back: worker "
                f"{failing.host}:{failing.port} failed prepare "
                f"({type(e).__name__}: {e}); the old model keeps "
                f"serving on all {len(servers)} workers") from e
        per_worker: Dict[str, Dict[str, Any]] = {}
        for server, handle in prepared:
            per_worker[f"{server.host}:{server.port}"] = \
                server.commit_swap(handle)
        self._stats["fleet_swaps"] += 1
        logger.info(
            "fleet-wide swap of %r committed on %d workers in %.3fs",
            name, len(servers), time.monotonic() - t0)
        return {"model": name, "workers": len(servers),
                "swap_s": time.monotonic() - t0,
                "per_worker": per_worker}

    # -- policy --------------------------------------------------------------
    def _decide(self, healths: List[Dict[str, Any]]) -> None:
        """Move ``target`` inside [min, max] from the worst worker's
        pressure signals, with streak + cooldown hysteresis."""
        p99s = [h["p99_ms"] for h in healths
                if h.get("p99_ms") is not None]
        worst_p99 = max(p99s) if p99s else None
        fracs = [h["queueDepth"] / max(h.get("maxQueue", 1), 1)
                 for h in healths]
        worst_frac = max(fracs) if fracs else 0.0
        hot = ((worst_p99 is not None and worst_p99 > self.scale_p99_ms)
               or worst_frac > self.queue_high_frac)
        # scale-down arms only WELL below the scale-up point (4x gap):
        # the dead band between them is what stops flapping
        calm = ((worst_p99 is None or worst_p99 < self.scale_p99_ms / 4)
                and worst_frac <= self.queue_low_frac)
        if hot:
            self._up_streak += 1
            self._down_streak = 0
        elif calm:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        now = time.monotonic()
        cooled = now - self._last_scale_t >= self.cooldown_s
        if (self._up_streak >= self.scale_streak and cooled
                and self.target < self.max_workers):
            self.target += 1
            self._last_scale_t = now
            self._up_streak = 0
            self._stats["scale_ups"] += 1
            logger.info("fleet scale-up -> %d (p99=%s ms, queue=%.0f%%)",
                        self.target, worst_p99, worst_frac * 100)
        elif (self._down_streak >= self.scale_streak and cooled
                and self.target > self.min_workers):
            self.target -= 1
            self._last_scale_t = now
            self._down_streak = 0
            self._stats["scale_downs"] += 1
            logger.info("fleet scale-down -> %d", self.target)

    def _converge(self) -> None:
        """Drive actual membership to ``target``: respawn shortfalls
        (crash replacement AND scale-up share this path — restart is
        just convergence), retire surplus gracefully."""
        while len(self.fleet.worker_urls) < self.target:
            if not self._spawn():
                break
            self._stats["spawns"] += 1
        while len(self.fleet.worker_urls) > self.target:
            before = len(self.fleet.worker_urls)
            self._retire_one()
            if len(self.fleet.worker_urls) >= before:
                break  # at min_workers floor; nothing retired

    def tick(self) -> None:
        """One full supervision pass: heartbeat sweep -> gray-outlier
        recycle -> scaling decision -> converge membership. The loop is
        just this on a timer; tests call it directly for determinism."""
        healths = self._sweep()
        recycled = self._gray_sweep(healths)
        # a recycled outlier's p99 must not ALSO trigger a scale-up:
        # its replacement arrives via convergence, not via target bump
        self._decide([h for s, h in healths if id(s) not in recycled])
        self._converge()
        self.history.append((time.monotonic(),
                             len(self.fleet.worker_urls)))

    # -- lifecycle -----------------------------------------------------------
    def _run(self) -> None:
        while not self._stop_ev.is_set():
            try:
                self.tick()
            except Exception:
                # a supervisor that dies stops ALL recovery: log and
                # keep beating
                logger.exception("fleet supervisor pass failed")
            self._stop_ev.wait(self.heartbeat_s)

    def start(self) -> "FleetSupervisor":
        self._converge()  # bring the fleet inside the envelope first
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name="mmlspark-torch-fleet-supervisor")
        self._thread.start()
        logger.info(
            "fleet supervisor: %d workers (envelope %d..%d), "
            "heartbeat %.2fs, scale p99 %.0f ms",
            len(self.fleet.worker_urls), self.min_workers,
            self.max_workers, self.heartbeat_s, self.scale_p99_ms)
        return self

    def stop(self) -> None:
        self._stop_ev.set()
        if self._thread is not None:
            self._thread.join(timeout=max(self.heartbeat_s * 4, 5.0))
            self._thread = None

    def stats(self) -> Dict[str, Any]:
        return {"workers": len(self.fleet.worker_urls),
                "target": self.target,
                "min": self.min_workers, "max": self.max_workers,
                **self._stats}

    def __enter__(self) -> "FleetSupervisor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
