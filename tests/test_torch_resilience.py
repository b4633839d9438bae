"""Training resilience in the port (``parallel/resilience.py``): the ports
of the JAX package's ``tests/parallel/test_resilience.py`` that run in one
process, held to the reference where it runs its package.

The pinned contracts (the reference's):
  - an armed ``mesh.collective_hang`` delay aborts the fit within the
    watchdog budget with a collective-stall classification, and with the
    watchdog off (the default) the same delay completes normally,
    bitwise the undelayed fit;
  - the disabled step hooks cost one ``is None`` check each;
  - ``stall_guard`` bounds one blocking call, and is inert at budget 0.

Where the reference's test drives its package, the JAX function runs on
the same inputs beside the port's, and the classification, the budget,
the marked boundary and the recovery records are held equal. The
multi-process halves (``fit_resilient``, ``shrink_mesh``, a real loss
and a real hang over gloo) are ``tests/test_torch_dist_resilience.py``.
"""

import logging
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import faults as jax_faults
from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
from mmlspark_tpu.core.retries import RetryPolicy as JaxRetryPolicy
from mmlspark_tpu.core.retries import with_retries as jax_with_retries
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu.parallel import resilience as jax_resilience
from mmlspark_tpu_torch.core import faults
from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.env import env_override
from mmlspark_tpu_torch.core.retries import RetryPolicy, with_retries
from mmlspark_tpu_torch.models.gbdt.estimators import LightGBMRegressor
from mmlspark_tpu_torch.parallel import resilience
from mmlspark_tpu_torch.parallel.prefetch import BatchPrefetcher
from mmlspark_tpu_torch.parallel.resilience import (TrainStalled,
                                                    TrainWatchdog,
                                                    stall_guard)

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    for name in ("MMLSPARK_TORCH_WATCHDOG_MULT",
                 "MMLSPARK_TORCH_WATCHDOG_MIN_S",
                 "MMLSPARK_TORCH_WATCHDOG_INIT_S",
                 "MMLSPARK_TPU_WATCHDOG_MULT", "MMLSPARK_TPU_WATCHDOG_MIN_S"):
        monkeypatch.delenv(name, raising=False)
    faults.reset()
    resilience.reset()
    jax_faults.reset()
    jax_resilience.reset()
    yield
    faults.reset()
    resilience.reset()
    jax_faults.reset()
    jax_resilience.reset()


def _cols(n=256, f=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = x @ rng.normal(size=f) + 0.1 * rng.normal(size=n)
    return {"features": x, "label": y}


def _est(iters=4):
    return LightGBMRegressor(numIterations=iters, numLeaves=7, maxBin=32,
                             seed=3).set_device("cpu")


def _jax_est(iters=4):
    return jax_est.LightGBMRegressor(numIterations=iters, numLeaves=7,
                                     maxBin=32, seed=3)


def _watchdog_threads():
    return [t for t in threading.enumerate()
            if t.name.startswith("mmlspark-watchdog-") and t.is_alive()]


def _hang_abort(fit, arm, stalled, env_prefix):
    """(the ``stalled`` error, the wall seconds) of ``fit()`` with a 30 s
    ``mesh.collective_hang`` delay armed (``arm``) and the watchdog at
    MULT 4, MIN_S 0.3 (``env_prefix``'s knobs)."""
    t0 = time.monotonic()
    with env_override(f"{env_prefix}_WATCHDOG_MULT", "4"), \
            env_override(f"{env_prefix}_WATCHDOG_MIN_S", "0.3"):
        with arm("mesh.collective_hang", "delay", delay_s=30.0):
            with pytest.raises(stalled) as ei:
                fit()
    return ei.value, time.monotonic() - t0


class TestWatchdog:
    def test_disabled_overhead_is_noise(self):
        """The step hooks ride every train iteration; disabled they must
        be one module-global check (well under 5 µs a call)."""
        assert resilience._active is None
        reps = 50_000
        t0 = time.perf_counter()
        for _ in range(reps):
            resilience.step_start(0)
            resilience.step_end()
        per_call_ns = (time.perf_counter() - t0) / reps * 1e9
        assert per_call_ns < 5_000
        # and every other hook of an unarmed fit returns at once
        assert resilience.mark_boundary("collective", "x") is None
        resilience.restore_boundary(None)
        resilience.wait_for_device(torch.device("cpu"))
        assert not resilience.armed()

    def test_collective_hang_aborts_within_budget(self):
        """A 30 s collective hang aborts well inside 15 s once the 0.3 s
        budget expires, classified from the marked boundary; the JAX
        package's fit of the same rows classifies it alike."""
        cols = _cols()
        df = DataFrame(cols)
        # warm first: the budget floor covers steady-state spans only
        _est().fit(df)
        err, wall = _hang_abort(lambda: _est().fit(df), faults.injected,
                                TrainStalled, "MMLSPARK_TORCH")
        assert wall < 15.0, f"abort took {wall:.1f}s against a 0.3s budget"
        assert err.classification == "collective-stall"
        assert err.budget_s == pytest.approx(0.3)
        assert err.elapsed_s >= 0.3
        assert "collective-stall" in str(err)
        assert err.report["boundary"] == "collective"
        assert err.report["span_tag"] == "drain"
        assert err.report["rank"] == 0
        assert err.label == "gbdt.train"
        assert resilience.stall_count() == 1
        # the monitor thread must not linger past the fit
        time.sleep(0.05)
        assert not _watchdog_threads()

        jdf = JaxFrame(cols)
        _jax_est().fit(jdf)
        jerr, _ = _hang_abort(lambda: _jax_est().fit(jdf),
                              jax_faults.injected,
                              jax_resilience.TrainStalled, "MMLSPARK_TPU")
        assert (err.classification, err.budget_s, err.label,
                err.report["boundary"]) == (
            jerr.classification, jerr.budget_s, jerr.label,
            jerr.report["boundary"])
        assert jerr.report["span_tag"] == "drain"

    def test_watchdog_off_delay_completes_bitwise(self):
        """Default env (MULT=0): the same armed delay merely slows the
        fit; the model is bitwise the undelayed fit's."""
        df = DataFrame(_cols())
        ref = _est().fit(df).get_model_string()
        with faults.injected("mesh.collective_hang", "delay",
                             delay_s=0.2):
            slow = _est().fit(df).get_model_string()
            assert faults.fired("mesh.collective_hang") == 1
        assert slow == ref
        assert resilience.stall_count() == 0
        assert not _watchdog_threads()

    def test_armed_watchdog_without_a_stall_keeps_the_bits(self):
        """An armed watchdog that never fires changes nothing."""
        df = DataFrame(_cols())
        ref = _est().fit(df).get_model_string()
        with env_override("MMLSPARK_TORCH_WATCHDOG_MULT", "4"):
            got = _est().fit(df).get_model_string()
        assert got == ref
        assert resilience.stall_count() == 0
        assert not _watchdog_threads()

    def test_stall_guard_fixed_budget(self):
        """stall_guard bounds a single blocking call (the
        distributed_init shape) with a backend-hang classification, as
        the reference's does."""
        got = []
        for guard, stalled in ((stall_guard, TrainStalled),
                               (jax_resilience.stall_guard,
                                jax_resilience.TrainStalled)):
            t0 = time.monotonic()
            with pytest.raises(stalled) as ei:
                with guard("init-probe", budget_s=0.2):
                    time.sleep(30.0)
            assert time.monotonic() - t0 < 10.0
            got.append((ei.value.classification, ei.value.label,
                        ei.value.budget_s))
        assert got[0] == got[1] == ("backend-hang", "init-probe", 0.2)

    def test_disabled_guard_is_inert(self):
        """budget 0 (the default WATCHDOG_INIT_S) arms nothing."""
        with stall_guard("noop") as wd:
            assert not wd.enabled
        assert resilience._active is None

    def test_knobs_keep_the_reference_defaults(self, monkeypatch):
        """The port's knobs read as the reference's twins do, defaults
        and the below-minimum fallback included."""
        for env in ({}, {"WATCHDOG_MULT": "2.5", "WATCHDOG_MIN_S": "7"},
                    {"WATCHDOG_MIN_S": "0"}):
            for k, v in env.items():
                monkeypatch.setenv(f"MMLSPARK_TORCH_{k}", v)
                monkeypatch.setenv(f"MMLSPARK_TPU_{k}", v)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                mine = TrainWatchdog("x")
                ref = jax_resilience.TrainWatchdog("x")
            assert (mine.mult, mine.min_s, mine.enabled) == (
                ref.mult, ref.min_s, ref.enabled)

    def test_budget_follows_the_rolling_p99(self):
        """MIN_S until 8 spans, then max(p99 * MULT, MIN_S) over the last
        64, as the reference's."""
        wd = TrainWatchdog("b", mult=4.0, min_s=0.01)
        ref = jax_resilience.TrainWatchdog("b", mult=4.0, min_s=0.01)
        budgets = []
        for i in range(70):
            for w in (wd, ref):
                w._window.append(0.002 * (i % 5 + 1) + 0.05 * (i == 3))
            budgets.append((wd.budget_s(), ref.budget_s()))
        assert all(a == b for a, b in budgets)
        # 8 spans: their p99 is the largest, 0.008 + 0.05
        assert budgets[6][0] == 0.01
        assert budgets[7][0] == pytest.approx(4.0 * 0.058)
        # the outlier aged out of the window: 4 * 0.010
        assert budgets[-1][0] == pytest.approx(4.0 * 0.01)
        assert len(wd._window) == 64

    def test_stall_on_another_thread_is_delivered(self):
        """A fit on a thread other than the main one is interrupted by
        an async exception, classified from its boundary."""
        out = {}

        def fit():
            try:
                with TrainWatchdog("thread", mult=1.0, min_s=0.2):
                    resilience.step_start(0)
                    with resilience.boundary("host_callback", "probe"):
                        for _ in range(3000):   # 30 s of short sleeps
                            time.sleep(0.01)
            except TrainStalled as e:
                out["err"] = e

        t = threading.Thread(target=fit)
        t0 = time.monotonic()
        t.start()
        t.join(20.0)
        assert not t.is_alive() and time.monotonic() - t0 < 15.0
        err = out["err"]
        assert err.classification == "host-callback-stall"
        assert err.report["boundary_detail"] == "probe"
        time.sleep(0.05)
        assert not _watchdog_threads()

    def test_input_wait_is_input_starvation(self):
        """A consumer starved by the prefetcher's producer stalls at the
        ``input_wait`` boundary, with the queue and producer state."""
        release = threading.Event()

        def slow_source():
            yield 1
            release.wait(20.0)
            yield 2

        with BatchPrefetcher(slow_source(), None, depth=2,
                             label="starve") as pf:
            assert next(pf) == 1
            with pytest.raises(TrainStalled) as ei:
                with TrainWatchdog("input", mult=1.0, min_s=0.2):
                    resilience.step_start(0)
                    next(pf)
            release.set()
        err = ei.value
        assert err.classification == "input-starvation"
        assert err.report["boundary_detail"] == \
            "starve: queue 0/2 staged, producer alive"

    def test_ooc_loop_runs_under_its_watchdog(self, monkeypatch):
        """The out-of-core tree loop is watched as ``gbdt.train_ooc``."""
        from mmlspark_tpu_torch.models.gbdt import trainer
        monkeypatch.setenv("MMLSPARK_TORCH_OOC", "on")
        cols = _cols(n=600)
        binned = np.clip((cols["features"] * 4 + 16), 0, 31).astype(
            np.uint8)
        cfg = trainer.TrainConfig(objective="regression", num_iterations=3,
                                  num_leaves=7, max_bin=32)
        assert trainer.train(binned, cols["label"], cfg,
                             device="cpu").hist_stats["ooc"]
        with env_override("MMLSPARK_TORCH_WATCHDOG_MULT", "4"), \
                env_override("MMLSPARK_TORCH_WATCHDOG_MIN_S", "0.3"), \
                faults.injected("gbdt.train_step", "delay", nth=2,
                                delay_s=30.0):
            t0 = time.monotonic()
            with pytest.raises(TrainStalled) as ei:
                trainer.train(binned, cols["label"], cfg, device="cpu")
        assert time.monotonic() - t0 < 15.0
        assert ei.value.label == "gbdt.train_ooc"
        assert ei.value.classification == "backend-hang"
        assert ei.value.report["span_tag"] == 1


class TestSatellites:
    def test_with_retries_exhaustion_attribution(self):
        """The re-raised error carries attempts / elapsed / deadline —
        why a retried init gave up — worded as the reference's."""
        def boom():
            raise ConnectionError("coordinator unreachable")

        msgs = []
        for retry, policy in ((with_retries, RetryPolicy),
                              (jax_with_retries, JaxRetryPolicy)):
            with pytest.raises(ConnectionError) as ei:
                retry(boom, policy=policy(max_attempts=3, base_delay=0.001,
                                          deadline=5.0),
                      describe="unit.init", seed=0)
            msgs.append(str(ei.value))
        for msg in msgs:
            assert "coordinator unreachable" in msg
            assert "gave up after 3/3 attempts" in msg
            assert "deadline 5.00s" in msg
        strip = [m.split(" in ")[0] for m in msgs]
        assert strip[0] == strip[1]

    def test_prefetch_leaked_thread_surfaced(self, caplog):
        """close() joining past its timeout names the leaked producer in
        stats and warns — it does not silently drop the handle."""
        release = threading.Event()

        def blocking_place(b):
            release.wait(20.0)
            return b

        pf = BatchPrefetcher(iter([1, 2, 3]), blocking_place, depth=2,
                             label="leaktest")
        assert pf.async_mode
        pf._join_timeout = 0.05
        with caplog.at_level(logging.WARNING, logger="mmlspark_tpu_torch"):
            pf.close()
        stats = pf.stats()
        assert stats["leaked_thread"] == "mmlspark-torch-leaktest"
        assert any("did not stop" in r.getMessage()
                   for r in caplog.records)
        # unwedge the producer so no thread outlives this test
        release.set()
        time.sleep(0.3)
        assert not [t for t in threading.enumerate()
                    if t.name == "mmlspark-torch-leaktest" and t.is_alive()]

    def test_prefetch_clean_close_reports_no_leak(self):
        with BatchPrefetcher(iter([1, 2]), None, depth=2,
                             label="cleantest") as pf:
            assert list(pf) == [1, 2]
        assert pf.stats()["leaked_thread"] is None

    def test_fault_points_registered(self):
        for name in ("mesh.collective_hang", "train.participant_loss",
                     "allreduce"):
            assert name in faults.KNOWN_POINTS
            assert faults.KNOWN_POINTS[name] == jax_faults.KNOWN_POINTS[name]

    def test_module_surface_is_the_reference_surface(self):
        import mmlspark_tpu_torch
        from mmlspark_tpu_torch import parallel
        assert resilience.__all__ == jax_resilience.__all__
        for name in ("fit_resilient", "TrainStalled", "ParticipantLost",
                     "shrink_mesh"):
            assert getattr(parallel, name) is getattr(mmlspark_tpu_torch,
                                                      name)
        assert [f.name for f in
                resilience.FitRecovery.__dataclass_fields__.values()] == [
            f.name for f in
            jax_resilience.FitRecovery.__dataclass_fields__.values()]
