"""The port's streaming refresh loop (``io/refresh.py``: ``StreamBuffer``,
``RefreshController``, ``RefreshResult``) against the JAX package's, on
the CPU, mirroring ``tests/io/test_refresh.py`` and the refresh half of
``tests/io/test_online_platform.py``, and example 11's flow end to end.

Every fit here runs on the q8 plane on both sides (as
``test_torch_checkpoint.py``'s cross-package cases do: XLA's CPU
``exp2`` is not a power of two at some q16 exponents, ROADMAP C), so the
tolerances are bitwise:

  - a refreshed generation's model string equals the JAX controller's
    on the same window, and so does its directory listing;
  - a refit killed at its entry (``refresh.fit``) or mid-segment
    (``gbdt.train_step``) and retried equals the unkilled run;
  - a generation committed by either package is resumed by the other's
    controller, and the next generation equals the other's;
  - served replies after a refresh's hot swap are bitwise the new
    generation's ``transform``; after a rolled-back swap, the old one's.
"""

import json
import os
import shutil
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import faults as jax_faults
from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
from mmlspark_tpu.io import refresh as jax_refresh
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core import env, faults
from mmlspark_tpu_torch.core.faults import FaultInjected
from mmlspark_tpu_torch.core.pipeline import Transformer
from mmlspark_tpu_torch.exploratory.drift import DriftDetector
from mmlspark_tpu_torch.io import refresh as port_refresh
from mmlspark_tpu_torch.io.fleet import FleetSupervisor
from mmlspark_tpu_torch.io.refresh import (RefreshController, RefreshResult,
                                           StreamBuffer)
from mmlspark_tpu_torch.io.serving import ServingFleet, ServingServer
from mmlspark_tpu_torch.models.gbdt.estimators import LightGBMRegressor
from mmlspark_tpu_torch.models.gbdt.trainer import HIST_QUANT_ENV

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

N, F = 600, 6
PARAMS = dict(numIterations=6, numLeaves=7, maxBin=15, seed=0)
ENV = {"MMLSPARK_TPU_HIST_FORMULATION": "per_feature",
       "MMLSPARK_TPU_EFB": "off", "MMLSPARK_TPU_OOC": "off",
       "MMLSPARK_TPU_HIST_QUANT": "q8", HIST_QUANT_ENV: "q8"}


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for k, v in ENV.items():
        monkeypatch.setenv(k, v)
    for k in ("MMLSPARK_TPU_HIST_SUB", "MMLSPARK_TORCH_HIST_SUB",
              env.SPILL_VERIFY, "MMLSPARK_TPU_SPILL_VERIFY",
              env.REFRESH_PRIORITY, env.REFRESH_YIELD_S,
              env.STREAM_BUFFER, env.REFRESH_INTERVAL_S):
        monkeypatch.delenv(k, raising=False)
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


def _estimator(**kw):
    return LightGBMRegressor(**{**PARAMS, **kw}).set_device("cpu")


def _jax_estimator(**kw):
    return jax_est.LightGBMRegressor(**{**PARAMS, **kw})


@pytest.fixture(scope="module")
def base():
    """(port generation 0, JAX generation 0, its rows), fitted alike."""
    x, y = _make_data(0)
    with pytest.MonkeyPatch.context() as mp:
        for k, v in ENV.items():
            mp.setenv(k, v)
        port = _estimator().fit(DataFrame({"features": x, "label": y}))
        ref = _jax_estimator().fit(JaxFrame({"features": x, "label": y}))
    return port, ref, x


def _post(url, payload, timeout=30):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _get(url, timeout=10):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def _wait_log(server, key, count, timeout=10.0):
    """Wait until the server's request-log counter ``key`` (``log_rows``
    or ``log_tap_errors``) reaches ``count``: the scoring thread sets a
    reply's event before it calls the taps, so a reply can arrive before
    its tap has run."""
    deadline = time.monotonic() + timeout
    while (server._health()[key] < count
           and time.monotonic() < deadline):
        time.sleep(0.005)


def _pred(model, x_row):
    return float(model.transform(DataFrame({"features": x_row[None, :]}))
                 .col("prediction")[0])


def _controller(module, est, model, ckpt_dir, **kw):
    kw.setdefault("refresh_interval_s", 10_000)
    kw.setdefault("min_refit_rows", 32)
    return module.RefreshController(est, model, str(ckpt_dir), **kw)


def _run_refresh(base_model, ckpt_dir, kill=None):
    """One port refresh over a fixed window; ``kill`` arms a fault
    before the first call, which is then retried once."""
    ctrl = _controller(port_refresh,
                       _estimator(), base_model, ckpt_dir,
                       segment_interval=2)
    x, y = _make_data(1, shift=0.5)
    ctrl.observe(x, y)
    if kill is not None:
        point, nth = kill
        faults.arm(point, "raise", nth=nth, count=1)
        with pytest.raises(FaultInjected):
            ctrl.refresh(swap=False)
        faults.disarm(point)
        assert ctrl.stats["refresh_failures"] == 1
    result = ctrl.refresh(swap=False)
    assert isinstance(result, RefreshResult)
    assert (result.generation, result.rows, result.trigger) == \
        (1, N, "forced")
    assert not result.swapped
    return result.model


# --- generations against the JAX package ------------------------------------------

def test_generation_zero_equals_jax(base):
    port, ref, _ = base
    assert port.get_model_string() == ref.get_model_string()


def test_refresh_generation_equals_jax(base, tmp_path):
    port, ref, _ = base
    x, y = _make_data(1, shift=0.5)
    pc = _controller(port_refresh, _estimator(), port,
                     tmp_path / "p", segment_interval=2)
    jc = _controller(jax_refresh, _jax_estimator(), ref, tmp_path / "j",
                     segment_interval=2)
    pc.observe(x, y)
    jc.observe(x, y)
    got, want = pc.refresh(swap=False), jc.refresh(swap=False)
    assert got.model.get_model_string() == want.model.get_model_string()
    assert got.model.booster.num_trees == 12
    assert (got.generation, got.rows, got.trigger) == \
        (want.generation, want.rows, want.trigger)
    assert sorted(os.listdir(tmp_path / "p")) == \
        sorted(os.listdir(tmp_path / "j"))
    assert sorted(os.listdir(tmp_path / "p" / "gen_00000001_segments")) == \
        sorted(os.listdir(tmp_path / "j" / "gen_00000001_segments"))
    assert pc._config_hash() == jc._config_hash()
    assert got.model._device == "cpu"


@pytest.mark.parametrize("kill", [("refresh.fit", 1), ("gbdt.train_step", 4)])
def test_killed_refit_resumes_bitwise(base, tmp_path, kill):
    """Killed at the refit's entry, or at hit 4 of ``gbdt.train_step``
    (the second segment of 2 trees, after ``checkpoint_2.txt``): the
    retry trains on the retained window and resumes the segments, and
    its model string equals the unkilled run's."""
    port, _, _ = base
    clean = _run_refresh(port, tmp_path / "clean")
    killed = _run_refresh(port, tmp_path / "killed", kill=kill)
    if kill[0] == "gbdt.train_step":
        assert (tmp_path / "killed" / "gen_00000001_segments" /
                "checkpoint_2.txt").exists()
    assert killed.get_model_string() == clean.get_model_string()


def test_generation_dirs_cross_both_ways(base, tmp_path):
    """A JAX controller's committed generation resumes in the port's
    controller (on the estimator's device) and the next generation of
    each equals the other's; a port generation resumes in the JAX
    controller."""
    port, ref, _ = base
    x1, y1 = _make_data(1, shift=0.5)
    x2, y2 = _make_data(2, shift=1.0)
    jc = _controller(jax_refresh, _jax_estimator(), ref, tmp_path / "a")
    jc.observe(x1, y1)
    gen1 = jc.refresh(swap=False).model
    shutil.copytree(tmp_path / "a", tmp_path / "b")
    pc = _controller(port_refresh, _estimator(), port, tmp_path / "a")
    assert pc.generation == 1
    assert pc.model.get_model_string() == gen1.get_model_string()
    assert pc.model._device == "cpu"
    jc2 = _controller(jax_refresh, _jax_estimator(), ref, tmp_path / "b")
    for c in (pc, jc2):
        c.observe(x2, y2)
    got, want = pc.refresh(swap=False), jc2.refresh(swap=False)
    assert got.generation == want.generation == 2
    assert got.model.get_model_string() == want.model.get_model_string()
    # and the reverse: the port's generations resume in JAX
    back = _controller(jax_refresh, _jax_estimator(), ref, tmp_path / "a")
    assert back.generation == 2
    assert back.model.get_model_string() == got.model.get_model_string()


def test_controller_restart_resumes_and_skips_a_rotten_generation(
        base, tmp_path, monkeypatch):
    port, _, _ = base
    ckdir = tmp_path / "gens"
    ctrl = _controller(port_refresh, _estimator(), port, ckdir)
    gens = []
    for seed in (1, 2):
        ctrl.observe(*_make_data(seed, shift=0.5))
        gens.append(ctrl.refresh(swap=False).model)
    restarted = RefreshController(_estimator(), port, str(ckdir),
                                  refresh_interval_s=10_000)
    assert restarted.generation == 2
    assert restarted.model.get_model_string() == gens[1].get_model_string()
    # a changed byte in generation 2's model directory (one that keeps
    # it loadable): the manifest's digest no longer matches, so the
    # restart falls back to generation 1 ...
    victim = ckdir / "gen_00000002_model" / "metadata.json"
    victim.write_bytes(victim.read_bytes() + b" ")
    restarted = RefreshController(_estimator(), port, str(ckdir),
                                  refresh_interval_s=10_000)
    assert restarted.generation == 1
    assert restarted.model.get_model_string() == gens[0].get_model_string()
    # ... unless verification is off
    monkeypatch.setenv(env.SPILL_VERIFY, "off")
    assert RefreshController(_estimator(), port, str(ckdir)).generation == 2
    # a changed refit configuration refuses the directory
    with pytest.raises(ValueError, match="different config"):
        RefreshController(_estimator(numLeaves=5), port, str(ckdir))


def test_estimator_without_fit_incremental_raises_naming_a12(base, tmp_path):
    class _NoRefit(Transformer):
        pass

    with pytest.raises(NotImplementedError, match=r"ROADMAP A12\b"):
        RefreshController(_NoRefit(), base[0], str(tmp_path))


# --- serving: swaps, rollback, drift --------------------------------------------

class _Boom(Transformer):
    def _transform(self, df):
        raise RuntimeError("corrupted swap payload")


def test_drift_arms_refit_and_hot_swaps(base, tmp_path):
    port, _, x = base
    with ServingServer(port, max_batch_size=8, max_latency_ms=2.0) as server:
        detector = DriftDetector(metric="psi", threshold=0.2, window=512,
                                 min_rows=64)
        ctrl = RefreshController(
            _estimator(), port, str(tmp_path), server=server,
            detector=detector, refresh_interval_s=10_000,
            min_refit_rows=64, reference_rows=x)
        ctrl.observe(*_make_data(3))
        trigger, report = ctrl.poll()
        assert trigger is None and not report.drifted
        assert ctrl.maybe_refresh() is None
        x_new, y_new = _make_data(4, shift=2.0)
        ctrl.observe(x_new, y_new)
        trigger, report = ctrl.poll()
        assert trigger == "drift" and report.drifted
        result = ctrl.maybe_refresh()
        assert result is not None and result.trigger == "drift"
        assert result.swapped and result.swap_error is None
        assert result.swap["swap_s"] >= result.swap["downtime_s"] >= 0.0
        assert ctrl.generation == 1 and ctrl.stats["drift_arms"] == 1
        for i in range(4):
            reply = _post(server.url, {"features": x_new[i].tolist()})
            assert reply["prediction"] == _pred(result.model, x_new[i])
        assert not ctrl.detector.check().drifted
        health = _get(f"http://{server.host}:{server.port}/healthz")
        assert health["status"] == "ok" and health["swaps"] == 1


def test_controller_reports_swap_rollback(base, tmp_path):
    port, _, x = base
    with ServingServer(port, max_batch_size=8, max_latency_ms=2.0) as server:
        ctrl = RefreshController(_estimator(), port, str(tmp_path),
                                 server=server, refresh_interval_s=10_000,
                                 min_refit_rows=32)
        ctrl.observe(*_make_data(5, shift=0.5))

        def corrupt(served):
            served.plane = None
            served.binned_supported = False
            served.model = _Boom()
            return served

        with faults.injected("registry.swap", "corrupt", corrupt=corrupt):
            result = ctrl.refresh()
        assert result.generation == 1 and not result.swapped
        assert "rolled back" in result.swap_error
        assert ctrl.stats["swap_failures"] == 1
        for i in range(3):
            assert _post(server.url, {"features": x[i].tolist()})[
                "prediction"] == _pred(port, x[i])


def test_serving_tap_feeds_refresh_buffer(base, tmp_path):
    port, _, x = base
    with ServingServer(port, max_batch_size=8, max_latency_ms=2.0) as server:
        ctrl = RefreshController(_estimator(), port, str(tmp_path),
                                 server=server, refresh_interval_s=10_000,
                                 min_refit_rows=32)
        labels = {x[i].tobytes(): 10.0 + i for i in range(4)}
        ctrl.tap_serving(label_fn=lambda payload, reply: labels.get(
            np.asarray(payload["features"], dtype=np.float64).tobytes()))
        for i in range(5):
            _post(server.url, {"features": x[i].tolist()})
        _wait_log(server, "log_rows", 5)
        # row 4 has no label: the labeler abstains
        assert ctrl.buffer.rows == 4 and ctrl.stats["tap_rows"] == 4
        bx, by = ctrl.buffer.drain()
        np.testing.assert_array_equal(bx, x[:4])
        np.testing.assert_array_equal(by, 10.0 + np.arange(4))
        assert server._health()["log_rows"] == 5
        faults.arm("serving.observe_log", "raise", count=1)
        reply = _post(server.url, {"features": x[0].tolist()})
        assert reply["prediction"] == _pred(port, x[0])
        _wait_log(server, "log_tap_errors", 1)
        assert server._health()["log_tap_errors"] == 1
        # the default label is the served prediction
        ctrl2 = RefreshController(_estimator(), port, str(tmp_path / "b"))
        with pytest.raises(ValueError, match="needs a server"):
            ctrl2.tap_serving()
        ctrl2.tap_serving(server=server)
        _post(server.url, {"features": x[1].tolist()})
        # both taps took the row: 5 before, the faulted one none
        _wait_log(server, "log_rows", 7)
        assert ctrl2.buffer.drain()[1].tolist() == [_pred(port, x[1])]


def _refit_under_parked_load(model, tmp_path, priority):
    """Refit while 3 requests sit parked past the queue high-water mark
    (the batcher waits 1 s, longer than the whole refit)."""
    with ServingServer(model, max_batch_size=8, max_latency_ms=1000.0,
                       queue_high_water=1) as server:
        ctrl = RefreshController(_estimator(numIterations=4), model,
                                 str(tmp_path), server=server,
                                 priority=priority,
                                 refresh_interval_s=10_000,
                                 min_refit_rows=32)
        x1, y1 = _make_data(2, shift=0.5)
        ctrl.observe(x1, y1)
        results = [None] * 3

        def call(i):
            try:
                results[i] = _post(server.url, {"features": x1[i].tolist()})
            except Exception as e:  # pragma: no cover - failure detail
                results[i] = e

        threads = [threading.Thread(target=call, args=(i,), daemon=True)
                   for i in range(3)]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            with server._lock:
                if sum(len(m.queue) for m in server._models.values()) >= 2:
                    break
            time.sleep(0.002)
        with env.env_override(env.REFRESH_YIELD_S, "0.02"):
            result = ctrl.refresh(swap=False)
        assert result.generation == 1
        for t in threads:
            t.join(timeout=10)
        return ctrl.stats, results


@pytest.mark.parametrize("priority", ["low", "high"])
def test_refit_priority_yields_to_serving(base, tmp_path, priority):
    stats, results = _refit_under_parked_load(base[0], tmp_path, priority)
    if priority == "low":
        assert stats["refit_yields"] > 0 and stats["refit_yield_s"] > 0.0
    else:
        assert stats["refit_yields"] == 0 and stats["refit_yield_s"] == 0.0
    for out in results:
        assert isinstance(out, dict) and "prediction" in out, \
            f"request starved by co-located refit: {out!r}"


# --- ingestion ------------------------------------------------------------------

def test_stream_buffer_backpressure_and_teardown():
    buf = StreamBuffer(capacity=64)
    high_water = []
    done = threading.Event()

    def producer():
        for i in range(10):
            buf.put(np.full((32, F), float(i)), np.zeros(32))
            high_water.append(buf.rows)
        done.set()

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    time.sleep(0.2)
    assert not done.is_set() and buf.rows <= 64
    total, firsts = 0, []
    while not done.is_set() or buf.rows:
        x, _ = buf.drain()
        # the producer may not have refilled the buffer yet: an empty
        # drain is a (0, 0) array, with no column to index
        if len(x):
            total += len(x)
            firsts += list(x[::32, 0])
        if not done.is_set():
            time.sleep(0.01)
    assert max(high_water) <= 64 and total == 320
    assert firsts == [float(i) for i in range(10)]
    assert buf.total_rows == 320
    buf.close()
    t.join(timeout=5)
    assert not t.is_alive() and buf.closed
    with pytest.raises(RuntimeError):
        buf.put(np.zeros((1, F)), np.zeros(1))
    # a block larger than the capacity enters an empty buffer only;
    # a timed-out put buffers nothing
    big = StreamBuffer(capacity=4)
    assert big.put(np.zeros((6, F)), np.zeros(6))
    assert not big.put(np.zeros((1, F)), np.zeros(1), timeout=0.05)
    assert big.rows == 6
    with pytest.raises(ValueError, match="mismatch"):
        big.put(np.zeros((2, F)), np.zeros(3))


def test_stream_buffer_knob(monkeypatch):
    monkeypatch.setenv(env.STREAM_BUFFER, "128")
    assert StreamBuffer().capacity == 128
    with pytest.raises(ValueError):
        StreamBuffer(capacity=0)


def test_pump_joins_producer_thread(base, tmp_path):
    ctrl = RefreshController(_estimator(), base[0], str(tmp_path),
                             buffer=StreamBuffer(capacity=4096),
                             refresh_interval_s=10_000)

    def stream():
        for i in range(5):
            yield _make_data(10 + i, n=64)

    assert ctrl.pump(stream(), depth=2) == 320
    assert ctrl.buffer.rows == 320
    assert not [t for t in threading.enumerate()
                if "refresh-ingest" in t.name], "leaked producer thread"
    assert ctrl.stats["leaked_thread"] is None
    ctrl.close()


def test_pump_joins_producer_on_ingest_fault(base, tmp_path):
    ctrl = RefreshController(_estimator(), base[0], str(tmp_path),
                             buffer=StreamBuffer(capacity=4096),
                             refresh_interval_s=10_000)

    def stream():
        for i in range(5):
            yield _make_data(20 + i, n=64)

    faults.arm("stream.ingest", "raise", nth=2, count=1)
    with pytest.raises(FaultInjected):
        ctrl.pump(stream(), depth=2)
    assert not [t for t in threading.enumerate()
                if "refresh-ingest" in t.name], "leaked producer thread"
    assert ctrl.stats["leaked_thread"] is None
    assert ctrl.buffer.rows == 64
    ctrl.close()


def test_interval_trigger_and_zero_disables(base, tmp_path, monkeypatch):
    x, y = _make_data(6)
    ctrl = RefreshController(_estimator(), base[0], str(tmp_path / "a"),
                             refresh_interval_s=0.001, min_refit_rows=32)
    ctrl.observe(x, y)
    time.sleep(0.01)
    assert ctrl.poll()[0] == "interval"
    result = ctrl.maybe_refresh(swap=False)
    assert result.trigger == "interval" and ctrl.stats["interval_arms"] == 1
    ctrl0 = RefreshController(_estimator(), base[0], str(tmp_path / "b"),
                              refresh_interval_s=0, min_refit_rows=32)
    ctrl0.observe(x, y)
    ctrl0._last_refresh -= 1e6
    assert ctrl0.poll()[0] is None
    # too few rows never arms; an empty window refuses to refit
    few = RefreshController(_estimator(), base[0], str(tmp_path / "c"),
                            refresh_interval_s=0.001)
    few.observe(x[:8], y[:8])
    time.sleep(0.01)
    assert few.poll()[0] is None
    with pytest.raises(RuntimeError, match="empty window"):
        RefreshController(_estimator(), base[0],
                          str(tmp_path / "d")).refresh()
    monkeypatch.setenv(env.REFRESH_INTERVAL_S, "7")
    monkeypatch.setenv(env.REFRESH_PRIORITY, "urgent")
    knobs = RefreshController(_estimator(), base[0], str(tmp_path / "e"))
    assert knobs.refresh_interval_s == 7.0 and knobs.priority == "low"


def test_ingest_fault_point_fires():
    buf = StreamBuffer(capacity=64)
    with faults.injected("stream.ingest", "raise"):
        with pytest.raises(FaultInjected):
            buf.put(np.zeros((1, F)), np.zeros(1))
    assert buf.rows == 0
    buf.put(np.zeros((1, F)), np.zeros(1))
    assert buf.rows == 1


# --- example 11 on the port -----------------------------------------------------

def test_online_platform_flow_on_the_port(tmp_path):
    """``examples/11_online_platform.py``'s flow on the port: a 2-worker
    fleet taps its own traffic into the refresh buffer, drift arms, a
    refit killed mid-segment resumes bitwise a clean control refit, and
    the supervisor's
    fleet-wide swap under client load drops nothing: every reply is one
    of the two generations', the per-worker counters agree, and after
    the swap both workers serve the new generation bitwise."""
    n, tapped = 800, 256
    est = dict(numIterations=8, numLeaves=15, maxBin=31, seed=7)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(n, F))
    w = rng.normal(size=F)
    y = X @ w + 0.1 * rng.normal(size=n)
    model = _estimator(**est).fit(DataFrame({"features": X, "label": y}))
    X2 = rng.normal(size=(n, F)) + 1.5
    y2 = X2 @ w + 0.1 * rng.normal(size=n)
    labels = {X2[i].tobytes(): float(y2[i]) for i in range(n)}
    fleet = ServingFleet(model, num_servers=2, max_batch_size=8,
                         max_latency_ms=2.0).start()
    sup = FleetSupervisor(fleet, min_workers=2, max_workers=2)
    w0, w1 = fleet.servers
    try:
        ctrl = RefreshController(
            _estimator(**est), model, str(tmp_path / "ckpt"), server=w0,
            detector=DriftDetector(metric="psi", threshold=0.2, window=512,
                                   min_rows=64),
            refresh_interval_s=10_000, min_refit_rows=tapped,
            segment_interval=2, reference_rows=X)
        assert ctrl.priority == "low"
        ctrl.tap_serving(label_fn=lambda payload, reply: labels.get(
            np.asarray(payload["features"], dtype=np.float64).tobytes()))
        for i in range(tapped):
            _post(w0.url, {"features": X2[i].tolist()})
        _wait_log(w0, "log_rows", tapped)
        trigger, report = ctrl.poll()
        assert trigger == "drift" and report.drifted
        control = RefreshController(_estimator(**est), model,
                                    str(tmp_path / "control"),
                                    refresh_interval_s=10_000,
                                    min_refit_rows=tapped,
                                    segment_interval=2)
        control.observe(X2[:tapped], y2[:tapped])
        clean = control.refresh(swap=False).model

        faults.arm("gbdt.train_step", "raise", nth=4, count=1)
        with pytest.raises(FaultInjected):
            ctrl.refresh(swap=False)
        faults.disarm("gbdt.train_step")
        refreshed = ctrl.refresh(swap=False)
        assert refreshed.generation == 1
        new_model = refreshed.model
        assert new_model.get_model_string() == clean.get_model_string()

        probe = {"features": X2[0].tolist()}
        want = {_pred(model, X2[0]), _pred(new_model, X2[0])}
        served_before = sum(s._health()["served"] for s in (w0, w1))
        stop_load = threading.Event()
        replies, failures = [], []

        def hammer(worker):
            while not stop_load.is_set():
                try:
                    replies.append(_post(worker.url, dict(probe))[
                        "prediction"])
                except Exception as e:  # any drop breaks the invariant
                    failures.append(e)

        loaders = [threading.Thread(target=hammer, args=(srv,), daemon=True)
                   for srv in (w0, w1) for _ in range(2)]
        for t in loaders:
            t.start()
        time.sleep(0.2)
        result = sup.swap_model_fleet(w0._default, new_model,
                                      probe_payload=probe)
        time.sleep(0.1)
        stop_load.set()
        for t in loaders:
            t.join(timeout=10)
        assert result["workers"] == 2
        assert not failures, f"dropped requests across swap: {failures!r}"
        assert replies and all(r in want for r in replies)
        served_after = sum(s._health()["served"] for s in (w0, w1))
        assert served_after - served_before == len(replies)
        for srv in (w0, w1):
            for i in range(3):
                assert _post(srv.url, {"features": X2[i].tolist()})[
                    "prediction"] == _pred(new_model, X2[i])
            assert srv._health()["status"] == "ok"
        ctrl.close()
        control.close()
    finally:
        fleet.stop()
