"""The port's host-side helpers of the model lifecycle against the JAX
package's, on the same seeded inputs, bit for bit:

  - ``exploratory/drift.py``: ``psi``, ``ks_statistic``, the seeded
    ``ReservoirWindow`` (snapshot, seen, count) and ``DriftDetector``
    verdicts before and after ``promote``;
  - ``core/retries.py``: ``RetryPolicy.delay`` under a seeded
    ``random.Random``, ``backoff_schedule``, ``with_retries``' sleeps and
    its exhaustion message, and the ``CircuitBreaker`` /
    ``FractionBudget`` state sequences under one stepped clock;
  - ``parallel/prefetch.py``: the items ``BatchPrefetcher`` delivers, a
    producer error re-raised, the join and the leak verdict;
  - ``parallel/resilience.py``: the step throttle, and the boosting loop
    calling it once per iteration with the iteration (a resumed
    segment's offset included), as the JAX trainer does.
"""

import random
import threading
import time

import numpy as np
import pytest
import torch

from mmlspark_tpu.core import retries as jax_retries
from mmlspark_tpu.exploratory import drift as jax_drift
from mmlspark_tpu.parallel import prefetch as jax_prefetch
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core import env, retries
from mmlspark_tpu_torch.exploratory import drift
from mmlspark_tpu_torch.models.gbdt.estimators import LightGBMRegressor
from mmlspark_tpu_torch.parallel import prefetch, resilience

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)


def _rows(seed, n, f=4, shift=0.0):
    return np.random.default_rng(seed).normal(size=(n, f)) + shift


# --- drift ----------------------------------------------------------------------

@pytest.mark.parametrize("shift", [0.0, 0.3, 2.0])
@pytest.mark.parametrize("bins", [4, 16])
def test_psi_and_ks_equal_jax(shift, bins):
    a = _rows(1, 700, 1)[:, 0]
    b = _rows(2, 450, 1, shift)[:, 0]
    assert drift.psi(a, b, bins) == jax_drift.psi(a, b, bins)
    assert drift.ks_statistic(a, b) == jax_drift.ks_statistic(a, b)
    # ties and an empty side behave alike too
    t = np.round(a, 1)
    assert drift.psi(t, t[:50], bins) == jax_drift.psi(t, t[:50], bins)
    assert drift.ks_statistic(t, b[:0]) == jax_drift.ks_statistic(t, b[:0])


@pytest.mark.parametrize("capacity,seed", [(64, 0), (300, 7)])
def test_reservoir_window_equals_jax(capacity, seed):
    port, ref = (drift.ReservoirWindow(capacity, seed=seed),
                 jax_drift.ReservoirWindow(capacity, seed=seed))
    assert port.snapshot().shape == ref.snapshot().shape == (0, 0)
    for i, n in enumerate((10, 200, 1, 333)):
        block = _rows(10 + i, n, 3)
        port.add(block)
        ref.add(block)
        assert (port.seen, port.count) == (ref.seen, ref.count)
        np.testing.assert_array_equal(port.snapshot(), ref.snapshot())
    port.clear()
    ref.clear()
    port.add(_rows(99, 5, 3))
    ref.add(_rows(99, 5, 3))
    np.testing.assert_array_equal(port.snapshot(), ref.snapshot())
    with pytest.raises(ValueError):
        drift.ReservoirWindow(0)


@pytest.mark.parametrize("metric,threshold", [("psi", 0.2), ("ks", 0.12)])
def test_drift_detector_verdicts_equal_jax(metric, threshold):
    kw = dict(metric=metric, threshold=threshold, window=256, bins=8,
              min_rows=64, seed=3)
    port, ref = drift.DriftDetector(**kw), jax_drift.DriftDetector(**kw)
    ref_rows = _rows(0, 400)
    port.set_reference(ref_rows)
    ref.set_reference(ref_rows)
    for seed, n, shift in ((1, 30, 0.0), (2, 200, 0.0), (3, 300, 1.5)):
        block = _rows(seed, n, shift=shift)
        port.update(block)
        ref.update(block)
        got, want = port.check(), ref.check()
        for field in ("drifted", "score", "feature", "metric", "threshold",
                      "rows_reference", "rows_current"):
            assert getattr(got, field) == getattr(want, field), field
        np.testing.assert_array_equal(got.per_feature, want.per_feature)
    assert got.drifted
    port.promote()
    ref.promote()
    assert port.check().drifted == ref.check().drifted is False
    with pytest.raises(ValueError):
        drift.DriftDetector(metric="l2")


def test_drift_threshold_knob(monkeypatch):
    monkeypatch.setenv(env.DRIFT_THRESHOLD, "0.35")
    monkeypatch.setenv("MMLSPARK_TPU_DRIFT_THRESHOLD", "0.35")
    assert drift.DriftDetector().threshold == 0.35
    assert jax_drift.DriftDetector().threshold == 0.35
    monkeypatch.delenv(env.DRIFT_THRESHOLD)
    assert drift.DriftDetector().threshold == 0.2


# --- retries --------------------------------------------------------------------

def test_retry_policy_delays_equal_jax():
    for kw in ({}, {"base_delay": 0.05, "multiplier": 3.0, "max_delay": 0.4,
                    "jitter": 0.5}, {"jitter": 0.0}):
        port, ref = retries.RetryPolicy(**kw), jax_retries.RetryPolicy(**kw)
        assert port == retries.RetryPolicy(**kw)
        rp, rr = random.Random(5), random.Random(5)
        assert [port.delay(k, rp) for k in range(1, 9)] == \
            [ref.delay(k, rr) for k in range(1, 9)]
    port = retries.backoff_schedule([0.1, 0.5, 2.0], deadline=3.0)
    ref = jax_retries.backoff_schedule([0.1, 0.5, 2.0], deadline=3.0)
    assert (port.max_attempts, port.jitter, port.deadline, port._fixed) == \
        (ref.max_attempts, ref.jitter, ref.deadline, ref._fixed)


def _run_with_retries(module, failures, **kw):
    """with_retries over a function failing ``failures`` times; returns
    (outcome, calls, the sleeps asked for)."""
    calls, sleeps = [0], []

    def fn():
        calls[0] += 1
        if calls[0] <= failures:
            raise ConnectionError(f"attempt {calls[0]}")
        return "done"

    try:
        out = module.with_retries(fn, sleep=sleeps.append, seed=11, **kw)
    except ConnectionError as e:
        out = f"raised: {e}"
    return out, calls[0], sleeps


@pytest.mark.parametrize("failures,kw", [
    (2, {}),
    (5, {}),
    (9, {"policy_kw": {"max_attempts": 6, "base_delay": 0.01}}),
    (3, {"fixed": [0.2, 0.1, 0.3]}),
    (4, {"should_retry": True}),
    (2, {"min_delay": 1.5}),
])
def test_with_retries_equals_jax(failures, kw):
    def args(module):
        out = {"describe": "test.op"}
        if "policy_kw" in kw:
            out["policy"] = module.RetryPolicy(**kw["policy_kw"])
        if "fixed" in kw:
            out["policy"] = module.backoff_schedule(kw["fixed"])
        if kw.get("should_retry"):
            out["should_retry"] = lambda e: "3" not in str(e)
        if "min_delay" in kw:
            out["min_delay_override"] = lambda e: kw["min_delay"]
        return out

    got = _run_with_retries(retries, failures, **args(retries))
    want = _run_with_retries(jax_retries, failures, **args(jax_retries))
    # the exhaustion note carries the elapsed time: hold the rest
    strip = (lambda s: s.split(" in ")[0]) if failures >= 3 else str
    assert (strip(str(got[0])), got[1], got[2]) == \
        (strip(str(want[0])), want[1], want[2])


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_breaker_and_budget_sequences_equal_jax(monkeypatch):
    """One script of calls against both packages' breakers under a
    stepped clock, and both budgets: every state and answer equal."""
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    script = ["allow", "fail", "allow", "fail", "fail", "allow", "+1.0",
              "allow", "allow", "+0.6", "fail", "allow", "+2.1", "allow",
              "allow", "fail", "+2.5", "allow", "ok", "allow", "fail",
              "ok", "fail", "fail", "fail", "allow"]

    def run(module):
        br = module.CircuitBreaker(failure_threshold=3, open_s=2.0)
        out = []
        for step in script:
            if step.startswith("+"):
                clock.t += float(step[1:])
            elif step == "allow":
                out.append(("allow", br.allow(), br.state))
            elif step == "fail":
                br.record_failure()
                out.append(("fail", br.state))
            else:
                br.record_success()
                out.append(("ok", br.state))
        return out

    t0 = clock.t
    got = run(retries)
    clock.t = t0
    assert got == run(jax_retries)

    def budget(module):
        b = module.FractionBudget(30.0, burst=2.0)
        out = []
        for i in range(25):
            if i % 3:
                b.note_request()
            out.append((b.take(), b.taken, b.denied, b.noted, b._tokens))
        return out

    assert budget(retries) == budget(jax_retries)
    assert retries.FractionBudget(-5.0, burst=0.0).burst == 1.0


# --- prefetch -------------------------------------------------------------------

@pytest.mark.parametrize("depth", [0, 1, 3])
def test_prefetcher_delivers_what_jax_delivers(depth):
    def items():
        return ({"i": i, "x": np.arange(i)} for i in range(7))

    def collect(module):
        with module.BatchPrefetcher(items(), place_fn=lambda b: b["i"] * 2,
                                    depth=depth, label="t") as pf:
            assert pf.async_mode == (depth > 0)
            return list(pf)

    assert collect(prefetch) == collect(jax_prefetch) == \
        [2 * i for i in range(7)]


def test_prefetcher_reraises_producer_error_and_joins():
    def bad():
        yield 1
        raise RuntimeError("source died")

    pf = prefetch.BatchPrefetcher(bad(), depth=2, label="bad-src")
    assert next(pf) == 1
    with pytest.raises(RuntimeError, match="source died"):
        next(pf)
    assert pf.stats()["leaked_thread"] is None
    assert not [t for t in threading.enumerate() if "bad-src" in t.name]


def test_prefetcher_names_a_leaked_producer():
    release = threading.Event()

    def stuck(b):
        release.wait(5.0)
        return b

    pf = prefetch.BatchPrefetcher(iter(range(3)), place_fn=stuck, depth=1,
                                  label="stuck")
    pf._join_timeout = 0.05
    pf.close()
    try:
        assert pf.stats()["leaked_thread"] == "mmlspark-torch-stuck"
    finally:
        release.set()


def test_prefetch_depth_knob(monkeypatch):
    monkeypatch.setenv(env.PREFETCH_DEPTH, "4")
    assert prefetch.resolve_prefetch_depth() == 4
    assert prefetch.resolve_prefetch_depth(0) == 0
    monkeypatch.setenv(env.PREFETCH_DEPTH, "-1")
    assert prefetch.resolve_prefetch_depth() == 2


# --- step hooks -----------------------------------------------------------------

def test_step_throttle_install_and_restore():
    seen = []
    assert resilience.install_step_throttle(seen.append) is None
    try:
        resilience.step_start(3)
        resilience.step_end()
        prev = resilience.install_step_throttle(None)
        assert prev == seen.append
        resilience.step_start(4)
    finally:
        resilience.install_step_throttle(None)
    assert seen == [3]


def test_boosting_loop_calls_the_throttle_per_iteration(tmp_path):
    """A checkpointed fit of 5 trees in segments of 2: the loop calls
    the throttle before each iteration with its number, counting the
    trees of earlier segments (``iteration_offset``), as the JAX trainer
    calls ``step_start(it + iteration_offset)``."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(300, 4))
    y = x[:, 0] - x[:, 1] + rng.normal(size=300) * 0.1
    tags = []
    prev = resilience.install_step_throttle(tags.append)
    try:
        LightGBMRegressor(numIterations=5, numLeaves=4, maxBin=15,
                          checkpointDir=str(tmp_path),
                          checkpointInterval=2).set_device("cpu").fit(
            DataFrame({"features": x, "label": y}))
    finally:
        resilience.install_step_throttle(prev)
    assert tags == [0, 1, 2, 3, 4]
