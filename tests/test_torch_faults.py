"""The port's fault registry (``core/faults.py``) against the JAX
package's, and the training-path points it places: ``gbdt.train_step``
and ``train.participant_loss`` once per iteration, ``gbdt.level_hist`` on
both histogram planes' output, ``checkpoint.write`` / ``io.disk_full`` in
the checkpoint store, ``io.disk_full`` / ``spill.read`` in the
out-of-core spill plane, ``allreduce`` / ``mesh.collective_hang`` at the
trainer's host syncs and the mesh's collectives.
"""

import pathlib
import re
import time

import numpy as np
import pytest
import torch

import mmlspark_tpu_torch
from mmlspark_tpu.core import faults as jax_faults
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core import faults
from mmlspark_tpu_torch.core.faults import FaultInjected
from mmlspark_tpu_torch.models.gbdt import hist_cuda, trainer
from mmlspark_tpu_torch.models.gbdt.estimators import LightGBMRegressor
from mmlspark_tpu_torch.ops.binning import BinMapper

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

TRAINING_POINTS = {"gbdt.train_step", "gbdt.level_hist", "checkpoint.write",
                   "io.disk_full", "spill.read", "train.participant_loss"}
# placed with the serving fleet, the model lifecycle and the refresh loop
LIFECYCLE_POINTS = {"serving.score", "serving.worker_kill",
                    "serving.observe_log", "registry.swap",
                    "registry.swap_fanout", "fleet.spawn", "fleet.heartbeat",
                    "net.half_open", "net.slow_reply", "net.latency",
                    "stream.ingest", "refresh.fit"}
# placed with the multi-device rendezvous and collectives
# (parallel/mesh.py) and the trainer's host syncs
DISTRIBUTED_POINTS = {"distributed.init", "allreduce",
                      "mesh.collective_hang"}


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    for name in (trainer.HIST_QUANT_ENV, trainer.HIST_SUB_ENV):
        monkeypatch.delenv(name, raising=False)
    faults.reset()
    yield
    faults.reset()


def _sites():
    root = pathlib.Path(mmlspark_tpu_torch.__file__).parent
    sites = {}
    for p in root.rglob("*.py"):
        if p.name == "faults.py":        # the harness's own docs
            continue
        for name in re.findall(r'fault_point\(\s*"([^"]+)"', p.read_text()):
            sites.setdefault(name, set()).add(p.name)
    return sites


def test_every_fault_point_site_is_registered():
    """Every ``fault_point("...")`` call site of the port names a
    registered point, and the training-path, serving, fleet and refresh
    points are threaded where the reference has them."""
    sites = _sites()
    assert not set(sites) - set(faults.KNOWN_POINTS), sites
    assert set(sites) == TRAINING_POINTS | LIFECYCLE_POINTS \
        | DISTRIBUTED_POINTS
    assert sites["distributed.init"] == {"mesh.py"}
    # the out-of-core loop's tree loop and spill plane: where the
    # reference's ooc.py and ops/ingest.py have them
    assert sites["gbdt.train_step"] == {"trainer.py", "ooc.py"}
    # the reference's two step loops are the port's one
    assert sites["train.participant_loss"] == {"trainer.py"}
    # the trainer's metric syncs and drain, and every mesh collective
    for name in ("allreduce", "mesh.collective_hang"):
        assert sites[name] == {"trainer.py", "mesh.py"}, name
    assert sites["gbdt.level_hist"] == {"hist_cuda.py"}
    assert sites["checkpoint.write"] == {"serialize.py"}
    assert sites["io.disk_full"] == {"serialize.py", "ingest.py"}
    assert sites["spill.read"] == {"ingest.py"}
    for name in ("serving.score", "serving.worker_kill", "serving.observe_log",
                 "registry.swap", "fleet.spawn", "net.half_open",
                 "net.slow_reply", "net.latency"):
        assert sites[name] == {"serving.py"}, name
    for name in ("registry.swap_fanout", "fleet.heartbeat"):
        assert sites[name] == {"fleet.py"}, name
    assert sites["stream.ingest"] == sites["refresh.fit"] == {"refresh.py"}


def test_registry_is_the_reference_registry():
    assert faults.KNOWN_POINTS == jax_faults.KNOWN_POINTS
    assert faults.__all__ == jax_faults.__all__
    assert faults._VALID_ACTIONS == jax_faults._VALID_ACTIONS


def test_disarmed_point_returns_its_value_and_counts_nothing():
    value = object()
    assert faults.fault_point("gbdt.train_step", value) is value
    assert faults.hits("gbdt.train_step") == 0
    t = torch.arange(4.0)
    assert faults.fault_point("gbdt.level_hist", t) is t


@pytest.mark.parametrize("nth,count,want", [
    (1, 1, [1, 0, 0, 0, 0]), (3, 1, [0, 0, 1, 0, 0]),
    (2, 2, [0, 1, 1, 0, 0]), (4, None, [0, 0, 0, 1, 1])])
def test_nth_and_count_match_the_reference(nth, count, want):
    """The same arming fires on the same hits in both packages."""
    def fired_on(module):
        module.reset()
        out = []
        with module.injected("gbdt.train_step", "raise", nth=nth,
                             count=count):
            for _ in range(5):
                try:
                    module.fault_point("gbdt.train_step")
                    out.append(0)
                except module.FaultInjected:
                    out.append(1)
        module.reset()
        return out
    assert fired_on(faults) == fired_on(jax_faults) == want


def test_delay_corrupt_and_custom_exceptions():
    with faults.injected("checkpoint.write", "delay", delay_s=0.05):
        t0 = time.perf_counter()
        faults.fault_point("checkpoint.write")
        assert time.perf_counter() - t0 >= 0.05
    h = torch.ones(2, 3)
    with faults.injected("gbdt.level_hist", "corrupt", count=None,
                         corrupt=lambda x: x * 2):
        out = faults.fault_point("gbdt.level_hist", h)
        assert torch.equal(out, h * 2) and out.device == h.device
        assert faults.fired("gbdt.level_hist") == 1
    with faults.injected("io.disk_full", "raise", exc=OSError("full")):
        with pytest.raises(OSError, match="full"):
            faults.fault_point("io.disk_full")
    with pytest.raises(ValueError, match="unknown fault point"):
        faults.arm("no.such.point")
    with pytest.raises(ValueError, match="action must be one of"):
        faults.arm("gbdt.train_step", "explode")
    assert not faults._enabled                 # injected always disarms


def test_arm_from_env_reads_the_port_variable(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_FAULTS", "gbdt.train_step:raise:1")
    faults.arm_from_env()
    assert not faults._enabled                 # the JAX knob is not read
    monkeypatch.setenv("MMLSPARK_TORCH_FAULTS",
                       "gbdt.train_step:raise:2,checkpoint.write:delay:1:0")
    faults.arm_from_env()
    faults.fault_point("gbdt.train_step")
    with pytest.raises(FaultInjected):
        faults.fault_point("gbdt.train_step")
    with pytest.raises(FaultInjected):         # count=None: every hit on
        faults.fault_point("gbdt.train_step")
    with pytest.raises(ValueError, match="MMLSPARK_TORCH_FAULTS"):
        faults.arm_from_env("gbdt.train_step")


def _small_fit_case(n=400, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 3))
    y = 2.0 * x[:, 0] + rng.normal(size=n) * 0.1
    return x, y


def test_train_step_fires_once_per_iteration():
    x, y = _small_fit_case()
    binned = BinMapper.fit(x, max_bin=15).transform(x)
    cfg = trainer.TrainConfig(num_iterations=7, max_bin=15, num_leaves=4,
                              max_depth=2)
    with faults.injected("gbdt.train_step", "delay", nth=10**9):
        trainer.train(binned, y, cfg, device="cpu")
        assert faults.hits("gbdt.train_step") == 7
        # and each of the two levels of its tree passes gbdt.level_hist
        assert faults.hits("gbdt.level_hist") == 7 * 2
    with faults.injected("gbdt.train_step", "raise", nth=4):
        with pytest.raises(FaultInjected, match="hit 4"):
            trainer.train(binned, y, cfg, device="cpu")


@pytest.mark.parametrize("quant", ["off", "q16"])
def test_level_hist_corruption_reaches_the_model(monkeypatch, quant):
    """A corrupting callable on ``gbdt.level_hist`` changes the trained
    model on both planes — the point sits on the real data path (a
    zeroed histogram kills every split, leaving the base score)."""
    monkeypatch.setenv(trainer.HIST_QUANT_ENV, quant)
    x, y = _small_fit_case()
    df = DataFrame({"features": x, "label": y})
    kw = dict(numIterations=3, numLeaves=4, maxBin=16)
    clean = LightGBMRegressor(**kw).set_device("cpu").fit(df)
    with faults.injected("gbdt.level_hist", "corrupt", count=None,
                         corrupt=torch.zeros_like):
        broken = LightGBMRegressor(**kw).set_device("cpu").fit(df)
    clean_pred = clean.transform(df)["prediction"]
    broken_pred = broken.transform(df)["prediction"]
    assert not np.array_equal(clean_pred, broken_pred)
    assert np.allclose(broken_pred, broken_pred[0])


def test_level_hist_point_passes_both_wrappers():
    n, f, b = 32, 2, 4
    binned = torch.zeros((n, f), dtype=torch.uint8)
    local = torch.zeros(n, dtype=torch.int64)
    ones = torch.ones(n)
    seen = []

    def spy(h):
        seen.append(tuple(h.shape))
        return h
    with faults.injected("gbdt.level_hist", "corrupt", count=None,
                         corrupt=spy):
        hist_cuda.level_histogram(binned, ones, ones, ones, local, 1, f, b)
        q = torch.ones(n, dtype=torch.int16)
        hist_cuda.level_histogram_quant(binned, q, q, ones, local, 1, f, b,
                                        0.5, 0.5)
    assert seen == [(1, f, b, 3)] * 2
