"""The port's server lifecycle (``ServingServer.swap_model``, the
two-phase ``prepare_swap`` / ``commit_swap`` / ``abort_swap``,
``observe_log``, ``drain`` and ``kill``) against the JAX package's
contracts (``tests/io/test_refresh.py``, ``test_fleet_elastic.py``,
``test_online_platform.py``, ``test_net_gray.py``), on the CPU.

The GBDT models are fitted in JAX (histogram formulation pinned to
``per_feature``, EFB and out-of-core off) and carried over with
``convert.model_from_jax``. Tolerances:

  - replies across a swap, a rollback and a two-phase swap are bitwise
    the serving generation's ``transform`` (JSON carries a float64 repr
    exactly), and the JAX model's ``transform``;
  - ``/healthz`` goes ok -> degraded (``swap-in-progress``) -> ok, and
    after the same script of swaps and rollbacks its status, reason and
    swap counters equal the JAX server's;
  - drain loses no accepted request, also across a swap's probation;
    kill resets connections and errors pending requests out.
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
from mmlspark_tpu.io import serving as jax_serving
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core import faults
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.io.serving import ServingServer, SwapFailed
from mmlspark_tpu_torch.models.gbdt.convert import model_from_jax

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

N, F = 600, 6
JAX_PINS = {"MMLSPARK_TPU_HIST_FORMULATION": "per_feature",
            "MMLSPARK_TPU_EFB": "off", "MMLSPARK_TPU_OOC": "off"}


@pytest.fixture(autouse=True)
def _clean_faults():
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
            numIterations=6, numLeaves=7, maxBin=15, seed=0).fit(
            JaxFrame({"features": x, "label": y}))


def _to_port(ref):
    state = {k: (np.asarray(v) if hasattr(v, "shape") else v)
             for k, v in ref._get_state().items()}
    return model_from_jax(type(ref).__name__, state,
                          ref.simple_param_values()).set_device("cpu")


@pytest.fixture(scope="module")
def models():
    """(JAX old, JAX new, port old, port new, rows)."""
    x, y = _make_data(0)
    x2, y2 = _make_data(2, shift=0.5)
    old, new = _jax_fit(x, y), _jax_fit(x2, y2)
    return old, new, _to_port(old), _to_port(new), x


def _post(url, payload, timeout=30, headers=None):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", **(headers or {})})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _health(server):
    return _get(f"http://{server.host}:{server.port}/healthz")


def _wait_log(server, key, count, timeout=10.0):
    """Wait until the server's request-log counter ``key`` (``log_rows``
    or ``log_tap_errors``) reaches ``count``: the scoring thread sets a
    reply's event before it calls the taps, so a reply can arrive before
    its tap has run."""
    deadline = time.monotonic() + timeout
    while _health(server)[key] < count and time.monotonic() < deadline:
        time.sleep(0.005)


def _pred(model, x_row, frame=DataFrame):
    return float(model.transform(frame({"features": x_row[None, :]}))
                 .col("prediction")[0])


class _Boom(Transformer):
    def _transform(self, df):
        raise RuntimeError("corrupted swap payload")


class _ScaleModel(Transformer):
    def __init__(self, factor):
        super().__init__()
        self.factor = factor

    def _transform(self, df):
        return df.with_column(
            "scaled", np.asarray(df.col("x"), np.float64) * self.factor)


class _SlowFirstScore(_ScaleModel):
    """Scales by ``factor``; its first transform (the swap's probe)
    sleeps, which holds the swap's probation window open."""

    def __init__(self, factor, first_delay_s):
        super().__init__(factor)
        self.first_delay_s = first_delay_s
        self._calls = 0

    def _transform(self, df):
        self._calls += 1
        if self._calls == 1:
            time.sleep(self.first_delay_s)
        return super()._transform(df)


def _corrupt(served):
    served.plane = None
    served.binned_supported = False
    served.model = _Boom()
    return served


# --- swap -----------------------------------------------------------------------

def test_swap_commits_and_serves_new_model_bitwise(models):
    jold, jnew, old, new, x = models
    with ServingServer(old, max_batch_size=8, max_latency_ms=2.0) as server:
        before = _post(server.url, {"features": x[1].tolist()})
        assert before["prediction"] == _pred(old, x[1]) == \
            _pred(jold, x[1], JaxFrame)
        timing = server.swap_model(server._default, new,
                                   probe_payload={"features": x[0].tolist()})
        assert timing["swap_s"] >= timing["downtime_s"] >= 0.0
        health = _health(server)
        assert health["status"] == "ok" and health["swaps"] == 1
        # counters carry over the swap
        assert health["served"] == 1 and health["binned"]["active"]
        for i in range(1, 6):
            reply = _post(server.url, {"features": x[i].tolist()})
            assert reply["prediction"] == _pred(new, x[i]) == \
                _pred(jnew, x[i], JaxFrame)
        assert server.model is new


@pytest.mark.parametrize("action", ["raise", "corrupt"])
def test_registry_swap_fault_rolls_back(models, action):
    """An armed ``registry.swap`` (a crash before the flip, or a mangled
    entry that the probe catches after it) rolls back: ``SwapFailed``,
    ``/healthz`` degraded with ``swap-in-progress`` inside the window
    and ok after it, the rollback counted, the old model's replies
    bitwise unchanged."""
    jold, _, old, new, x = models
    with ServingServer(old, max_batch_size=8, max_latency_ms=2.0) as server:
        assert _health(server)["status"] == "ok"
        before = _post(server.url, {"features": x[0].tolist()})
        inside = []

        def corrupt(served):
            inside.append(_health(server))
            return _corrupt(served)

        arm = dict(corrupt=corrupt) if action == "corrupt" else {}
        with faults.injected("registry.swap", action, **arm):
            with pytest.raises(SwapFailed, match="rolled back"):
                server.swap_model(server._default, new,
                                  probe_payload={"features": x[0].tolist()})
        if action == "corrupt":
            assert inside[0]["status"] == "degraded"
            assert "swap-in-progress" in inside[0]["reason"]
        health = _health(server)
        assert health["status"] == "ok"
        assert health["swap_rollbacks"] == 1 and health["swaps"] == 0
        assert server.model is old
        after = _post(server.url, {"features": x[0].tolist()})
        assert after == before
        assert after["prediction"] == _pred(jold, x[0], JaxFrame)


def test_health_and_counters_follow_the_jax_server(models):
    """The same script on both packages' servers — a swap, a corrupted
    swap, a prepared swap aborted, one committed, each beside a request
    — gives the same status, reason and swap counters at every step."""
    jold, jnew, old, new, x = models
    payload = {"features": x[3].tolist()}

    def script(server, fault_mod, old_model, new_model):
        out = []

        def note(tag):
            h = _health(server)
            out.append((tag, h["status"], h["reason"], h["swaps"],
                        h["swap_rollbacks"], h["served"]))

        _post(server.url, dict(payload))
        note("start")
        server.swap_model("default", new_model, probe_payload=payload)
        note("swapped")
        with fault_mod.injected("registry.swap", "corrupt",
                                corrupt=_corrupt):
            with pytest.raises(Exception, match="rolled back"):
                server.swap_model("default", old_model,
                                  probe_payload=payload)
        note("rolled back")
        prepared = server.prepare_swap("default", old_model,
                                       probe_payload=payload)
        note("prepared")
        server.abort_swap(prepared)
        note("aborted")
        server.commit_swap(server.prepare_swap("default", old_model,
                                               probe_payload=payload))
        _post(server.url, dict(payload))
        note("committed")
        return out

    with ServingServer(old, max_batch_size=8, max_latency_ms=2.0) as p:
        got = script(p, faults, old, new)
    with jax_serving.ServingServer(jold, max_batch_size=8,
                                   max_latency_ms=2.0) as j:
        want = script(j, jax_faults, jold, jnew)
    assert got == want
    assert got[3][1] == "degraded" and "swap-in-progress" in got[3][2]


def test_two_phase_swap_serves_old_through_prepare(models):
    jold, jnew, old, new, x = models
    with ServingServer(old, max_batch_size=8, max_latency_ms=2.0) as server:
        prepared = server.prepare_swap("default", new,
                                       probe_payload={"features":
                                                      x[0].tolist()})
        # the registry has not flipped: the old model serves, degraded
        assert _post(server.url, {"features": x[1].tolist()})[
            "prediction"] == _pred(jold, x[1], JaxFrame)
        assert _health(server)["status"] == "degraded"
        with pytest.raises(SwapFailed, match="already in progress"):
            server.swap_model("default", new)
        timing = server.commit_swap(prepared)
        assert timing["swap_s"] >= timing["downtime_s"] >= 0.0
        assert _post(server.url, {"features": x[1].tolist()})[
            "prediction"] == _pred(jnew, x[1], JaxFrame)
        assert _health(server)["status"] == "ok"
        # a prepare that fails closes its window
        with faults.injected("registry.swap", "raise"):
            with pytest.raises(SwapFailed):
                server.prepare_swap("default", old)
        health = _health(server)
        assert health["status"] == "ok" and health["swap_rollbacks"] == 1
        with pytest.raises(KeyError, match="not a served model"):
            server.swap_model("nope", old)


def test_swap_frees_the_old_scorer_after_a_clean_probe(models):
    """The old plane's staged batches and its booster's scorer tables
    are dropped at commit, never before the probe (``clear_jit_cache``
    in the reference)."""
    _, _, old, new, x = models
    with ServingServer(old.copy().set_device("cpu"), max_batch_size=8,
                       max_latency_ms=2.0) as server:
        served_old = server._models["default"]
        plane = served_old.plane
        assert plane is not None and plane._batches
        booster = served_old.model.booster
        assert booster.__dict__.get("_scorers")
        probe = {"features": x[0].tolist()}
        with faults.injected("registry.swap", "corrupt", corrupt=_corrupt):
            with pytest.raises(SwapFailed):
                server.swap_model("default", new, probe_payload=probe)
        assert server._models["default"] is served_old
        assert served_old.plane is plane and plane._batches
        server.swap_model("default", new.copy().set_device("cpu"),
                          probe_payload=probe)
        assert served_old.plane is None and not plane._batches
        assert not booster.__dict__.get("_scorers")


# --- request-log taps -----------------------------------------------------------

def test_observe_log_taps_and_absorbs_a_dying_tap():
    with ServingServer(_ScaleModel(2.0), max_batch_size=8,
                       max_latency_ms=1.0) as server:
        seen, other = [], []
        server.observe_log(lambda name, payloads, cols: seen.append(
            (name, [p["x"] for p in payloads], list(cols["scaled"]))))
        server.observe_log(lambda *a: other.append(a), model_name="other")
        for i in range(3):
            assert _post(server.url, {"x": float(i), "id": i})["id"] == i
        _wait_log(server, "log_rows", 3)
        assert [s[1] for s in seen] == [[0.0], [1.0], [2.0]]
        assert [s[2] for s in seen] == [[0.0], [2.0], [4.0]]
        assert seen[0][0] == "default" and not other
        assert _health(server)["log_rows"] == 3
        faults.arm("serving.observe_log", "raise", count=1)
        assert _post(server.url, {"x": 5.0})["scaled"] == 10.0
        _wait_log(server, "log_tap_errors", 1)
        health = _health(server)
        assert health["log_tap_errors"] == 1 and health["log_rows"] == 3


# --- drain and kill -------------------------------------------------------------

def _wait_queued(server, n, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with server._lock:
            depth = sum(len(m.queue) for m in server._models.values())
        if depth + server._inflight_batches >= n:
            return
        time.sleep(0.002)
    raise AssertionError(f"{n} requests never queued")


def test_drain_loses_zero_accepted_requests():
    server = ServingServer(_ScaleModel(3.0), max_latency_ms=300.0,
                           max_batch_size=64).start()
    try:
        results = [None] * 8

        def call(i):
            try:
                results[i] = _post(server.url, {"x": float(i)})
            except Exception as e:  # pragma: no cover - failure detail
                results[i] = e

        threads = [threading.Thread(target=call, args=(i,), daemon=True)
                   for i in range(8)]
        for t in threads:
            t.start()
        _wait_queued(server, 8)
        assert server.drain(timeout_s=10.0)
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(server.url, {"x": 99.0})
        assert err.value.code == 503
        assert int(err.value.headers["Retry-After"]) >= 1
        health = _health(server)
        assert health["draining"] and "draining" in health["reason"]
        for t in threads:
            t.join(timeout=10)
        for i, out in enumerate(results):
            assert isinstance(out, dict) and out["scaled"] == 3.0 * i, \
                f"request {i} lost in drain: {out!r}"
    finally:
        server.stop()


def test_drain_flushes_swap_holding_queue():
    """Requests accepted while a swap holds the queue in probation
    survive a drain whose deadline expires inside the swap window: drain
    outlives the swap, restarts its budget once, and every request is
    scored by the new model."""
    srv = ServingServer(_ScaleModel(2.0), max_latency_ms=20.0,
                        max_batch_size=8).start()
    swap_result = {}
    results = [None] * 4

    def do_swap():
        swap_result["r"] = srv.swap_model(
            "default", _SlowFirstScore(5.0, first_delay_s=0.8),
            probe_payload={"x": 1.0})

    def call(i):
        try:
            results[i] = _post(srv.url, {"x": float(i)}, timeout=15.0)
        except Exception as e:  # pragma: no cover - failure detail
            results[i] = e

    swapper = threading.Thread(target=do_swap, daemon=True)
    try:
        swapper.start()
        deadline = time.monotonic() + 5.0
        held = False
        while time.monotonic() < deadline and not held:
            with srv._lock:
                held = srv._models["default"].held
            time.sleep(0.002)
        assert held, "swap never reached its probation window"
        threads = [threading.Thread(target=call, args=(i,), daemon=True)
                   for i in range(4)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with srv._lock:
                if len(srv._models["default"].queue) >= 4:
                    break
            time.sleep(0.002)
        assert srv.drain(timeout_s=0.3)
        swapper.join(timeout=10)
        for t in threads:
            t.join(timeout=10)
        assert swap_result["r"]["model"] == "default"
        for i, out in enumerate(results):
            assert isinstance(out, dict) and out["scaled"] == 5.0 * i, \
                f"request {i} lost across drain-during-swap: {out!r}"
    finally:
        srv.stop()


def _serving_threads():
    return {t for t in threading.enumerate()
            if t.name.startswith("mmlspark-torch-")}


def test_kill_resets_connections_and_errors_pendings():
    before = _serving_threads()
    server = ServingServer(_ScaleModel(2.0), max_latency_ms=2000.0,
                           max_batch_size=64).start()
    outcome = []

    def call():
        try:
            outcome.append(_post(server.url, {"x": 1.0}, timeout=10))
        except (urllib.error.URLError, ConnectionError, OSError) as e:
            outcome.append(type(e).__name__)

    t = threading.Thread(target=call, daemon=True)
    t.start()
    _wait_queued(server, 1)
    server.kill()
    t.join(timeout=10)
    assert not t.is_alive() and len(outcome) == 1
    # a reset connection, or the flushed request's 503
    assert not isinstance(outcome[0], dict)
    assert server._killed
    server.kill()
    server.stop()          # both no-ops after a kill
    with pytest.raises(Exception):
        _post(server.url, {"x": 1.0}, timeout=2)
    deadline = time.monotonic() + 8.0
    while time.monotonic() < deadline and _serving_threads() - before:
        time.sleep(0.05)
    assert not {t for t in _serving_threads() - before if t.is_alive()}


def test_worker_kill_fault_kills_mid_batch():
    server = ServingServer(_ScaleModel(2.0), max_latency_ms=1.0).start()
    try:
        faults.arm("serving.worker_kill", "raise", count=1)
        with pytest.raises(Exception):
            _post(server.url, {"x": 1.0}, timeout=10)
        assert server._killed
    finally:
        server.stop()


def test_score_fault_surfaces_as_500():
    with ServingServer(_ScaleModel(2.0), max_latency_ms=1.0) as server:
        with faults.injected("serving.score", "raise"):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(server.url, {"x": 1.0})
        assert err.value.code == 500
        assert _post(server.url, {"x": 2.0})["scaled"] == 4.0
        assert _health(server)["errors"] == 1


def test_deadline_zero_budget_shed_at_dequeue_inbudget_completes():
    server = ServingServer(_ScaleModel(2.0), max_batch_size=8,
                           max_latency_ms=50.0).start()
    try:
        outcome = {}

        def expired():
            try:
                _post(server.url, {"x": 1.0}, headers={"X-Deadline-Ms": "0"})
                outcome["error"] = "0-budget request was served"
            except urllib.error.HTTPError as e:
                outcome["code"] = e.code
                outcome["body"] = json.loads(e.read())

        t = threading.Thread(target=expired, daemon=True)
        t.start()
        reply = _post(server.url, {"x": 3.0},
                      headers={"X-Deadline-Ms": "5000"})
        t.join(timeout=10)
        assert "error" not in outcome, outcome
        assert outcome["code"] == 504
        assert outcome["body"]["shed"] == "deadline"
        assert reply["scaled"] == 6.0
        health = _health(server)
        assert health["shed_deadline"] == 1 and health["served"] == 1
    finally:
        server.stop()


def test_swaps_under_concurrent_load_lose_nothing():
    """A stress test of the swap's shared state: more client threads
    than cores, a short switch interval, and 30 swaps (single and two
    phase) between two models while they post. Every reply is one of the
    two models' (bitwise), none is lost, and the served counter equals
    the replies."""
    import os
    import sys

    clients = (os.cpu_count() or 4) + 4
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    server = ServingServer(_ScaleModel(2.0), max_latency_ms=1.0,
                           max_batch_size=8).start()
    stop = threading.Event()
    replies, errors = [], []

    def client(k):
        i = 0
        while not stop.is_set():
            x = float(k * 1000 + i)
            i += 1
            try:
                got = _post(server.url, {"x": x}, timeout=10)["scaled"]
            except Exception as e:  # pragma: no cover - failure detail
                errors.append(repr(e))
                continue
            replies.append((x, got))

    threads = [threading.Thread(target=client, args=(k,), daemon=True)
               for k in range(clients)]
    try:
        for t in threads:
            t.start()
        models = (_ScaleModel(3.0), _ScaleModel(2.0))
        for n in range(30):
            nxt = models[n % 2]
            if n % 3:
                server.swap_model("default", nxt, probe_payload={"x": 1.0})
            else:
                server.commit_swap(server.prepare_swap(
                    "default", nxt, probe_payload={"x": 1.0}))
        stop.set()
        for t in threads:
            t.join(timeout=15)
        assert not any(t.is_alive() for t in threads)
    finally:
        stop.set()
        sys.setswitchinterval(interval)
        server.stop()
    assert not errors, errors[:3]
    assert replies and all(got in (2.0 * x, 3.0 * x) for x, got in replies)
    health = server._health()
    assert health["served"] == len(replies) and health["swaps"] == 30
