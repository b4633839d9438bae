"""The port's serving fleet (``ServingFleet``, ``serve_distributed``),
its supervisor (``io/fleet.FleetSupervisor``: heartbeats, supervised
restarts, autoscaling, the fleet-wide two-phase swap, gray recycling)
and its client (``FleetClient``: failover, breakers, hedges, the retry
budget, deadlines) against the JAX package's contracts
(``tests/io/test_fleet_elastic.py``, ``test_online_platform.py``,
``test_net_gray.py``, ``test_serving_fleet_models.py`` and the fleet
case of ``test_backpressure.py``), on the CPU.

Held against the JAX package directly:

  - the supervisor's scale decisions (``_decide``) and gray verdicts
    (``_gray_sweep``) over the same health sequences equal the JAX
    supervisor's, step for step;
  - after a fleet-wide swap every worker's replies are bitwise the new
    model's ``transform`` and the JAX model's; after a rolled-back one
    (``registry.swap_fanout`` or ``registry.swap`` armed) bitwise the
    old model's;
  - failover replies are bitwise a single worker's.
"""

import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import faults as jax_faults
from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
from mmlspark_tpu.io import fleet as jax_fleet
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core import faults
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.core.retries import FractionBudget
from mmlspark_tpu_torch.io import fleet as port_fleet
from mmlspark_tpu_torch.io.fleet import FleetSupervisor
from mmlspark_tpu_torch.io.serving import (FleetClient, ServingFleet,
                                           ServingServer, SwapFailed,
                                           serve_distributed)
from mmlspark_tpu_torch.models.gbdt.convert import model_from_jax

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

N, F = 300, 6
JAX_PINS = {"MMLSPARK_TPU_HIST_FORMULATION": "per_feature",
            "MMLSPARK_TPU_EFB": "off", "MMLSPARK_TPU_OOC": "off"}


class _ScaleModel(Transformer):
    def __init__(self, factor=2.0):
        super().__init__()
        self.factor = factor

    def _transform(self, df):
        return df.with_column(
            "scaled", np.asarray(df.col("x"), np.float64) * self.factor)


@pytest.fixture(autouse=True)
def _reset_faults():
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


def _make_data(seed, n=N, shift=0.0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, F)) + shift
    y = x[:, 0] - 0.5 * x[:, 1] + 0.25 * x[:, 2] * x[:, 3] \
        + rng.normal(size=n) * 0.1
    return x, y


def _jax_fit(x, y):
    with pytest.MonkeyPatch.context() as mp:
        for k, v in JAX_PINS.items():
            mp.setenv(k, v)
        return jax_est.LightGBMRegressor(
            numIterations=4, numLeaves=7, maxBin=15, seed=0).fit(
            JaxFrame({"features": x, "label": y}))


def _to_port(ref):
    state = {k: (np.asarray(v) if hasattr(v, "shape") else v)
             for k, v in ref._get_state().items()}
    return model_from_jax(type(ref).__name__, state,
                          ref.simple_param_values()).set_device("cpu")


@pytest.fixture(scope="module")
def base():
    """(JAX old, JAX new, port old, port new, rows)."""
    x, y = _make_data(0)
    x2, y2 = _make_data(1, shift=0.8)
    old, new = _jax_fit(x, y), _jax_fit(x2, y2)
    return old, new, _to_port(old), _to_port(new), x


def _post(url, payload, headers=None, timeout=10.0):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=5.0):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _health(server):
    return _get(f"http://{server.host}:{server.port}/healthz")


def _named_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith("mmlspark-torch-")}


def _wait_threads_gone(before, timeout=8.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        leaked = {t for t in _named_threads() - before if t.is_alive()}
        if not leaked:
            return set()
        time.sleep(0.05)
    return leaked


# --- the fleet ------------------------------------------------------------------

def test_registry_lists_workers_and_aggregates_health():
    fleet = serve_distributed(_ScaleModel(2.0), num_servers=2,
                              max_latency_ms=2.0)
    try:
        assert _get(fleet.registry_url)["workers"] == fleet.worker_urls
        health = _get(f"http://{fleet.registry_host}:"
                      f"{fleet.registry_port}/healthz")
        assert health["status"] == "ok" and len(health["workers"]) == 2
        for url in fleet.worker_urls:
            assert _post(url, {"x": 3.0})["scaled"] == 6.0
        grown = fleet.spawn_worker()
        assert grown.url in _get(fleet.registry_url)["workers"]
        assert _post(grown.url, {"x": 1.5})["scaled"] == 3.0
        assert fleet.remove_worker(grown)
        assert not fleet.remove_worker(grown)
        assert grown.url not in _get(fleet.registry_url)["workers"]
        grown.stop()
        with pytest.raises(urllib.error.HTTPError):
            _get(f"http://{fleet.registry_host}:{fleet.registry_port}/nope")
    finally:
        fleet.stop()


class _StubFleet:
    """What ``FleetSupervisor`` reads of a fleet, for decision replay."""

    def __init__(self, n):
        self.servers = []
        self._servers_lock = threading.Lock()
        self.worker_urls = [f"http://127.0.0.1:{i}/score" for i in range(n)]


def test_scale_decisions_equal_jax():
    """The same health sequences through both supervisors' ``_decide``:
    the same target, streaks and scale counters after every step (the
    hysteresis: streaks, the dead band, the cooldown)."""
    hot = {"p99_ms": 500.0, "queueDepth": 0, "maxQueue": 256}
    calm = {"p99_ms": 0.5, "queueDepth": 0, "maxQueue": 256}
    mid = {"p99_ms": 50.0, "queueDepth": 0, "maxQueue": 256}
    full = {"p99_ms": None, "queueDepth": 200, "maxQueue": 256}
    idle = {"p99_ms": None, "queueDepth": 0, "maxQueue": 256}
    script = [hot, calm, hot, calm, hot, mid, hot, hot, hot, calm, calm,
              calm, full, full, full, idle, idle, idle, idle, mid, mid]

    def run(module, cooldown_s):
        sup = module.FleetSupervisor(
            _StubFleet(1), min_workers=1, max_workers=3, scale_p99_ms=100.0,
            cooldown_s=cooldown_s, scale_streak=2)
        out = []
        for h in script:
            sup._decide([h, calm])
            out.append((sup.target, sup._up_streak, sup._down_streak,
                        sup.stats()["scale_ups"],
                        sup.stats()["scale_downs"]))
        return out

    for cooldown_s in (0.0, 120.0):
        got = run(port_fleet, cooldown_s)
        assert got == run(jax_fleet, cooldown_s)
    assert max(t for t, *_ in got) == 2       # cooldown held it at one
    with pytest.raises(ValueError, match="envelope is empty"):
        FleetSupervisor(_StubFleet(1), min_workers=3, max_workers=2)


class _StubServer:
    def __init__(self, port):
        self.host, self.port = "127.0.0.1", port
        self.drained = self.stopped = 0

    def drain(self, timeout_s=0.0):
        self.drained += 1
        return True

    def stop(self):
        self.stopped += 1


def test_gray_verdicts_equal_jax():
    """``_gray_sweep`` over the same p99 sequences: the same workers
    recycled on the same sweep (streak, factor, absolute floor)."""
    seq = [[10.0, 12.0, 90.0], [11.0, 10.0, 95.0], [9.0, 10.0, 30.0],
           [10.0, 10.0, 200.0], [10.0, 11.0, 220.0], [10.0, 11.0, 230.0],
           [None, 10.0, 400.0], [10.0, 10.0, 45.0]]

    def run(module):
        servers = [_StubServer(p) for p in (1, 2, 3)]
        fleet = _StubFleet(3)
        fleet.servers = list(servers)
        removed = []
        fleet.remove_worker = lambda s: removed.append(s.port) or True
        sup = module.FleetSupervisor(fleet, min_workers=1, max_workers=3,
                                     gray_factor=4.0, gray_min_p99_ms=50.0,
                                     gray_streak=2)
        out = []
        for p99s in seq:
            healths = [(s, {"p99_ms": v}) for s, v in zip(servers, p99s)
                       if s.port not in removed]
            recycled = sup._gray_sweep(healths)
            out.append((len(recycled), sorted(removed),
                        sup.stats()["gray_recycles"]))
        return out, [(s.drained, s.stopped) for s in servers]

    got = run(port_fleet)
    assert got == run(jax_fleet)
    assert got[0][-1] == (0, [3], 1)          # the third worker, once


def test_scale_up_under_load():
    fleet = ServingFleet(_ScaleModel(2.0), num_servers=1,
                         max_latency_ms=5.0).start()
    sup = FleetSupervisor(fleet, min_workers=1, max_workers=3,
                          scale_p99_ms=2.0, heartbeat_s=0.1,
                          cooldown_s=0.0, scale_streak=1)
    try:
        url = fleet.worker_urls[0]
        for i in range(6):  # batching waits ~5 ms -> p99 >> 2 ms
            assert _post(url, {"x": float(i)})["scaled"] == 2.0 * i
        sup.tick()
        assert len(fleet.worker_urls) == 2
        sup.tick()
        assert len(fleet.worker_urls) == 3
        sup.tick()
        assert len(fleet.worker_urls) == 3
        assert sup.stats()["scale_ups"] == 2 and sup.target == 3
        assert [n for _, n in sup.history] == [2, 3, 3]
    finally:
        sup.stop()
        fleet.stop()


def test_scale_down_drains_gracefully():
    before = _named_threads()
    fleet = ServingFleet(_ScaleModel(2.0), num_servers=2,
                         max_latency_ms=1.0).start()
    sup = FleetSupervisor(fleet, min_workers=1, max_workers=2,
                          heartbeat_s=0.1, cooldown_s=0.0,
                          scale_streak=1, drain_timeout_s=5.0)
    try:
        sup.tick()
        assert len(fleet.worker_urls) == 1
        assert sup.stats()["scale_downs"] == 1
        assert sup.stats()["drained"] == 1
        sup.tick()
        assert len(fleet.worker_urls) == 1
        assert _post(fleet.worker_urls[0], {"x": 4.0})["scaled"] == 8.0
    finally:
        sup.stop()
        fleet.stop()
    assert _wait_threads_gone(before) == set()


def test_kill_mid_batch_failover_and_respawn():
    """An armed ``serving.worker_kill`` kills one worker mid-batch; the
    client fails over and every reply is bitwise a single worker's; the
    supervisor sees the death within ``dead_after_misses`` sweeps and
    brings the fleet back to two workers, which serve."""
    model = _ScaleModel(1.5)
    payloads = [{"x": float(i) + 0.25} for i in range(8)]
    with ServingServer(model, max_latency_ms=1.0) as single:
        reference = [_post(single.url, dict(p)) for p in payloads]
    fleet = ServingFleet(model, num_servers=2, max_latency_ms=1.0).start()
    sup = FleetSupervisor(fleet, min_workers=2, max_workers=2,
                          heartbeat_s=0.1, cooldown_s=60.0,
                          dead_after_misses=2)
    client = FleetClient(fleet.registry_url, timeout=5.0)
    try:
        client.refresh()
        faults.arm("serving.worker_kill", "raise", count=1)
        replies = [client.score(dict(p)) for p in payloads]
        faults.disarm("serving.worker_kill")
        assert replies == reference
        dead = [s for s in fleet.servers if s._killed]
        assert len(dead) == 1
        for _ in range(sup.dead_after_misses):
            sup.tick()
        stats = sup.stats()
        assert stats["deaths"] == 1 and stats["workers"] == 2
        assert dead[0].url not in fleet.worker_urls
        client.refresh()
        for p, ref in zip(payloads, reference):
            assert client.score(dict(p)) == ref
    finally:
        sup.stop()
        fleet.stop()


def test_supervisor_restarts_crashed_worker_with_spawn_backoff():
    fleet = ServingFleet(_ScaleModel(2.0), num_servers=2,
                         max_latency_ms=1.0).start()
    sup = FleetSupervisor(fleet, min_workers=2, max_workers=2,
                          heartbeat_s=0.1, dead_after_misses=2)
    try:
        dead_url = fleet.servers[1].url
        fleet.servers[1].kill()
        faults.arm("fleet.spawn", "raise", count=1)
        for _ in range(sup.dead_after_misses):
            sup.tick()
        stats = sup.stats()
        assert stats["deaths"] == 1 and stats["workers"] == 2
        assert stats["spawn_failures"] == 0
        urls = fleet.worker_urls
        assert dead_url not in urls and len(urls) == 2
        for u in urls:
            assert _post(u, {"x": 2.0})["scaled"] == 4.0
    finally:
        sup.stop()
        fleet.stop()


def test_heartbeat_fault_marks_worker_dead():
    fleet = ServingFleet(_ScaleModel(2.0), num_servers=1,
                         max_latency_ms=1.0).start()
    sup = FleetSupervisor(fleet, min_workers=1, max_workers=1,
                          heartbeat_s=0.1, dead_after_misses=3)
    try:
        old_url = fleet.worker_urls[0]
        faults.arm("fleet.heartbeat", "raise", count=3)
        sup.tick()
        sup.tick()
        assert sup.stats()["deaths"] == 0
        sup.tick()
        assert sup.stats()["deaths"] == 1
        assert sup.stats()["workers"] == 1
        assert fleet.worker_urls[0] != old_url
    finally:
        sup.stop()
        fleet.stop()


def test_supervisor_loop_starts_and_stops():
    before = _named_threads()
    fleet = ServingFleet(_ScaleModel(2.0), num_servers=1,
                         max_latency_ms=1.0).start()
    sup = FleetSupervisor(fleet, min_workers=2, max_workers=2,
                          heartbeat_s=0.05)
    try:
        with sup:
            assert len(fleet.worker_urls) == 2   # converged at start
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline and not sup.history:
                time.sleep(0.01)
            assert sup.history
    finally:
        fleet.stop()
    assert _wait_threads_gone(before) == set()


def test_fleet_stop_survives_worker_stop_failure():
    before = _named_threads()
    fleet = ServingFleet(_ScaleModel(2.0), num_servers=3,
                         max_latency_ms=1.0).start()
    bad = fleet.servers[1]
    orig_stop = bad.stop

    def exploding_stop():
        orig_stop()
        raise RuntimeError("injected stop failure")

    bad.stop = exploding_stop
    with pytest.raises(RuntimeError, match="injected stop failure"):
        fleet.stop()
    with pytest.raises(Exception):
        _get(fleet.registry_url, timeout=1.0)
    assert _wait_threads_gone(before) == set()


def test_fleet_stop_idempotent_after_chaos():
    before = _named_threads()
    fleet = ServingFleet(_ScaleModel(2.0), num_servers=2,
                         max_latency_ms=1.0).start()
    fleet.servers[0].kill()
    fleet.stop()
    fleet.stop()
    assert _wait_threads_gone(before) == set()


# --- fleet-wide two-phase swap --------------------------------------------------

def _pred(model, x_row, frame=DataFrame):
    return float(model.transform(frame({"features": x_row[None, :]}))
                 .col("prediction")[0])


def test_fleet_swap_commits_on_every_worker(base):
    jold, jnew, old, new, x = base
    with ServingFleet(old, num_servers=2, max_batch_size=8,
                      max_latency_ms=2.0) as fleet:
        sup = FleetSupervisor(fleet, min_workers=2, max_workers=2)
        servers = list(fleet.servers)
        want_old, want_new = _pred(old, x[0]), _pred(new, x[0])
        assert want_old == _pred(jold, x[0], JaxFrame)
        assert want_new == _pred(jnew, x[0], JaxFrame)
        for server in servers:
            assert _post(server.url, {"features": x[0].tolist()})[
                "prediction"] == want_old
        result = sup.swap_model_fleet(
            "default", new, probe_payload={"features": x[0].tolist()})
        assert result["workers"] == 2 and len(result["per_worker"]) == 2
        for timing in result["per_worker"].values():
            assert result["swap_s"] >= timing["downtime_s"] >= 0.0
        assert sup.stats()["fleet_swaps"] == 1
        for server in servers:
            for i in range(4):
                assert _post(server.url, {"features": x[i].tolist()})[
                    "prediction"] == _pred(jnew, x[i], JaxFrame)
            health = _health(server)
            assert health["status"] == "ok" and health["swaps"] == 1


@pytest.mark.parametrize("point,action,nth", [
    ("registry.swap_fanout", "raise", 3),
    ("registry.swap", "raise", 2),
    ("registry.swap", "corrupt", 3)])
def test_fleet_swap_rolls_back_when_any_worker_fails_prepare(
        base, point, action, nth):
    jold, _, old, new, x = base
    with ServingFleet(old, num_servers=3, max_batch_size=8,
                      max_latency_ms=2.0) as fleet:
        sup = FleetSupervisor(fleet, min_workers=3, max_workers=3)
        servers = list(fleet.servers)

        def corrupt(served):
            served.plane = None
            served.binned_supported = False
            served.model = _ScaleModel()     # reads a column rows lack
            return served

        kw = {"corrupt": corrupt} if action == "corrupt" else {}
        faults.arm(point, action, nth=nth, count=1, **kw)
        with pytest.raises(SwapFailed) as ei:
            sup.swap_model_fleet("default", new, probe_payload={
                "features": x[0].tolist()})
        failing = servers[nth - 1]
        assert f"{failing.host}:{failing.port}" in str(ei.value)
        assert "rolled back" in str(ei.value)
        assert sup.stats()["fleet_swap_rollbacks"] == 1
        assert sup.stats()["fleet_swaps"] == 0
        for server in servers:
            for i in range(3):
                assert _post(server.url, {"features": x[i].tolist()})[
                    "prediction"] == _pred(jold, x[i], JaxFrame)
            with server._lock:
                assert not server._swapping
            health = _health(server)
            assert health["status"] == "ok" and health["swaps"] == 0


def test_fleet_swap_with_no_workers_is_attributed(base):
    _, _, old, new, _ = base
    fleet = ServingFleet(old, num_servers=1, max_batch_size=8,
                         max_latency_ms=2.0).start()
    lone = fleet.servers[0]
    try:
        sup = FleetSupervisor(fleet, min_workers=0, max_workers=1)
        assert fleet.remove_worker(lone)
        with pytest.raises(SwapFailed, match="no workers"):
            sup.swap_model_fleet("default", new)
    finally:
        lone.stop()
        fleet.stop()


# --- the client: failover, readmission, gray failures ---------------------------

def test_fleet_client_readmits_recovered_worker():
    with ServingFleet(_ScaleModel(2.0), num_servers=3,
                      max_latency_ms=1.0) as fleet:
        client = FleetClient(fleet.registry_url, timeout=5.0)
        client.refresh()
        assert len(client._workers) == 3
        with client._lock:
            evicted = client._workers.pop(0)
        client._last_refresh -= 5.0
        assert client.score({"x": 4.0})["scaled"] == 8.0
        assert evicted in client._workers and len(client._workers) == 3
        with client._lock:
            client._workers = list(client._workers)[:2]
            client._registry_count = 2
        client._last_refresh -= 100.0
        assert client.score({"x": 4.0})["scaled"] == 8.0
        assert len(client._workers) == 3


def test_client_deadline_propagates_and_sheds_attributed():
    fleet = ServingFleet(_ScaleModel(), num_servers=1, max_batch_size=1,
                         max_latency_ms=1.0).start()
    try:
        worker = fleet.servers[0]
        worker.gray_delay_ms = 250.0
        client = FleetClient(fleet.registry_url, timeout=5.0,
                             deadline_ms=150.0)
        results = []

        def req():
            try:
                results.append(("ok", client.score({"x": 2.0})["scaled"]))
            except TimeoutError as e:
                results.append(("deadline", str(e)))
            except Exception as e:
                results.append(("error", f"{type(e).__name__}: {e}"))

        threads = [threading.Thread(target=req, daemon=True)
                   for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        assert sorted(k for k, _ in results) == ["deadline", "ok"], results
        assert "deadline exceeded" in next(
            m for k, m in results if k == "deadline")
        assert client.stats["deadline_shed"] == 1
        assert _health(worker)["shed_deadline"] >= 1
    finally:
        fleet.stop()


@pytest.mark.parametrize("point", ["net.half_open", "net.slow_reply"])
def test_stalled_worker_hedge_covers(point):
    fleet = ServingFleet(_ScaleModel(), num_servers=2,
                         max_latency_ms=1.0).start()
    try:
        client = FleetClient(fleet.registry_url, timeout=5.0,
                             hedging=True, deadline_ms=4000.0,
                             hedge_delay_ms=50.0)
        faults.arm(point, "delay", delay_s=1.5, count=1)
        t0 = time.monotonic()
        reply = client.score({"x": 4.0})
        assert reply["scaled"] == 8.0
        assert time.monotonic() - t0 < 1.2
        assert client.stats["hedges_fired"] == 1
        assert client.stats["hedges_won"] == 1
    finally:
        fleet.stop()


@pytest.mark.parametrize("point", ["net.half_open", "net.latency"])
def test_dropped_connection_fails_over(point):
    fleet = ServingFleet(_ScaleModel(), num_servers=2,
                         max_latency_ms=1.0).start()
    try:
        client = FleetClient(fleet.registry_url, timeout=5.0,
                             deadline_ms=3000.0)
        faults.arm(point, "raise", count=1)
        t0 = time.monotonic()
        assert client.score({"x": 5.0})["scaled"] == 10.0
        assert time.monotonic() - t0 < 2.0
        assert client.stats["retries"] == 1
    finally:
        fleet.stop()


def test_breaker_skips_dead_worker_without_connecting():
    fleet = ServingFleet(_ScaleModel(), num_servers=2,
                         max_latency_ms=1.0).start()
    try:
        victim = fleet.servers[1]
        client = FleetClient(fleet.registry_url, timeout=5.0,
                             breaker_threshold=1, breaker_open_s=30.0)
        client._min_refresh_gap_s = 0.0
        victim.stop()
        for i in range(6):
            client.refresh()
            assert client.score({"x": float(i)})["scaled"] == 2.0 * i
        assert client.stats["breaker_skips"] >= 1
        assert client.stats["retries"] <= 1
    finally:
        fleet.stop()


def test_retry_budget_sheds_to_caller():
    fleet = ServingFleet(_ScaleModel(), num_servers=2,
                         max_latency_ms=1.0).start()
    try:
        client = FleetClient(fleet.registry_url, timeout=2.0,
                             retry_budget_pct=0.0)
        client._retry_budget = FractionBudget(0.0, burst=1.0)
        client.refresh()
        for s in list(fleet.servers):
            s.stop()
        with pytest.raises(RuntimeError, match="retry budget exhausted"):
            client.score({"x": 1.0})
        assert client.stats["retries_shed"] == 1
        assert client.stats["retries"] == 1
    finally:
        fleet.stop()


def test_client_ejects_slow_worker():
    fleet = ServingFleet(_ScaleModel(), num_servers=3,
                         max_latency_ms=1.0).start()
    try:
        gray = fleet.servers[0]
        gray.gray_delay_ms = 150.0
        client = FleetClient(fleet.registry_url, timeout=5.0,
                             hedging=True, deadline_ms=5000.0,
                             hedge_delay_ms=30.0)
        for i in range(20):
            assert client.score({"x": float(i)})["scaled"] == 2.0 * i
        assert client.stats["slow_ejections"] >= 1
        t0 = time.monotonic()
        for i in range(6):
            client.score({"x": float(i)})
        assert time.monotonic() - t0 < 1.5
    finally:
        fleet.stop()


def test_supervisor_recycles_gray_worker():
    fleet = ServingFleet(_ScaleModel(), num_servers=2,
                         max_latency_ms=1.0).start()
    sup = FleetSupervisor(fleet, min_workers=2, max_workers=2,
                          gray_factor=3.0, gray_min_p99_ms=20.0,
                          gray_streak=2, drain_timeout_s=5.0)
    try:
        gray, fast = list(fleet.servers)
        gray.gray_delay_ms = 80.0
        for i in range(4):
            _post(gray.url, {"x": float(i)})
            _post(fast.url, {"x": float(i)})
        sup.tick()
        assert sup.stats()["gray_recycles"] == 0
        sup.tick()
        assert sup.stats()["gray_recycles"] == 1
        assert len(fleet.worker_urls) == 2
        assert gray not in fleet.servers and fast in fleet.servers
        for url in fleet.worker_urls:
            assert _post(url, {"x": 3.0})["scaled"] == 6.0
        assert sup.stats()["deaths"] == 0
    finally:
        sup.stop()
        fleet.stop()
