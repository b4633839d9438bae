"""The port's sanitizer end to end on the CPU (``device="cpu"``): the
reference's integration cases (``tests/gbdt/test_sanitizer_integration.py``)
ported, and the port's own boundaries.

  - the fault harness writes a NaN into the histogram
    (``gbdt.level_hist:corrupt``): with the sanitizer on the fit aborts
    naming that boundary; off, the same corruption completes silently (a
    NaN gain disables the split);
  - a clean sanitized fit (the step, and DART's host loop) gives the
    unsanitized fit's trees bit for bit, and its boundaries recorded
    their contracts;
  - the voting learner's divergence drill on a one-rank gloo mesh: two
    recorders, two ``top_k``, the candidate reduction's shapes differ;
  - two gloo ranks in processes of their own (this file is their
    script: ``python test_torch_sanitizer_integration.py RANK WORLD
    STORE OUT``): ``step_boundary`` agrees after a clean data-learner
    fit, and a forced extra event on rank 1 is named on every rank;
  - the serving plane's recompile budget holds the bucket ladder
    (``tests/io/test_serving_binned.py``'s drill), ``ShardedScorer``
    counts its rungs, and a NaN served batch raises at ``serving.score``;
  - the out-of-core loop's three boundaries fire on an injected NaN.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from mmlspark_tpu_torch import DataFrame  # noqa: E402
from mmlspark_tpu_torch.core import env, faults  # noqa: E402
from mmlspark_tpu_torch.core import sanitizer as san  # noqa: E402
from mmlspark_tpu_torch.models.gbdt import trainer as T  # noqa: E402
from mmlspark_tpu_torch.models.gbdt.estimators import (  # noqa: E402
    LightGBMClassifier, LightGBMRegressor)
from mmlspark_tpu_torch.ops.binning import BinMapper  # noqa: E402

torch.set_num_threads(1)

pytestmark = pytest.mark.faults

SPAWN_TIMEOUT_S = 120
ARRAYS = ("split_feature", "threshold_bin", "threshold_value", "node_value",
          "count", "tree_weights")


@pytest.fixture(autouse=True)
def _clean_state(monkeypatch):
    for name in (T.HIST_QUANT_ENV, T.HIST_SUB_ENV, T.GROW_POLICY_ENV,
                 env.OOC, env.EFB, env.SAN, env.SERVE_BINNED):
        monkeypatch.delenv(name, raising=False)
    faults.reset()
    san.disable()
    san.reset()
    san.set_recompile_budget(0)
    yield
    faults.reset()
    san.refresh_from_env()
    san.reset()
    san.set_recompile_budget(0)


def _df(n=400, f=3, seed=5):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = 2.0 * x[:, 0] + rng.normal(size=n) * 0.1
    return DataFrame({"features": x, "label": y})


def _nan_corrupt(h):
    h = h.clone()
    h.view(-1)[0] = float("nan")
    return h


_KW = dict(numIterations=3, numLeaves=4, maxBin=16)


# --- the reference's cases ----------------------------------------------------

def test_injected_hist_nan_caught_at_named_boundary():
    """Sanitizer on + an armed NaN corruption of the histogram: the fit
    aborts with a diagnostic naming the boundary."""
    san.enable()
    with faults.injected("gbdt.level_hist", "corrupt", count=None,
                         corrupt=_nan_corrupt):
        with pytest.raises(san.NonFiniteError) as ei:
            LightGBMRegressor(**_KW).set_device("cpu").fit(_df())
    msg = str(ei.value)
    assert "graftsan" in msg, msg
    assert "gbdt.level_hist" in msg, msg
    assert "NaN" in msg, msg


def test_injected_hist_nan_is_silent_with_sanitizer_off():
    """The control arm: without the sanitizer the NaN histogram is
    absorbed (NaN gain -> no split) and the fit completes."""
    assert not san.enabled()
    with faults.injected("gbdt.level_hist", "corrupt", count=None,
                         corrupt=_nan_corrupt):
        model = LightGBMRegressor(**_KW).set_device("cpu").fit(_df())
        assert faults.fired("gbdt.level_hist") > 0
    assert model is not None


def test_clean_fit_has_no_false_positives():
    """Sanitizer on over an uncorrupted fit: every boundary guard
    (entry, histogram, metrics sync, exit) sees finite data."""
    san.enable()
    model = LightGBMRegressor(**_KW).set_device("cpu").fit(_df())
    pred = np.asarray(model.transform(_df())["prediction"])
    assert np.isfinite(pred).all()
    assert {"gbdt.train_scan.entry", "gbdt.train_scan.exit",
            "gbdt.level_hist"} <= set(san.dtype_contracts())


@pytest.fixture(scope="module")
def one_rank_mesh(tmp_path_factory):
    """A one-rank gloo mesh in this process."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.parallel.mesh import create_mesh

    store = tmp_path_factory.mktemp("san_world1") / "store"
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=1, rank=0)
    try:
        yield create_mesh()
    finally:
        dist.destroy_process_group()


def _run_voting(mesh, recorder, top_k, seed=0):
    """Fit the voting learner with ``recorder`` active (the port records
    each collective as it is issued)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(512, 8))
    y = (1.5 * x[:, 0] - x[:, 1] > 0).astype(np.float64)
    mapper = BinMapper.fit(x, max_bin=32)
    cfg = T.TrainConfig(objective="binary", num_iterations=2,
                        num_leaves=7, max_depth=3, min_data_in_leaf=5,
                        max_bin=32, tree_learner="voting", top_k=top_k)
    with san.use_recorder(recorder):
        T.train(mapper.transform(x), y, cfg,
                bin_upper=mapper.bin_upper_values(32), mesh=mesh,
                device="cpu")
    return recorder


def test_divergence_detector_flags_rank_divergent_protocol(one_rank_mesh):
    """Two simulated ranks run the voting learner with different top_k:
    the candidate-histogram reduction's shapes differ, so the recorded
    collective protocols diverge and the cross-check names rank 1."""
    san.enable()
    rank0 = _run_voting(one_rank_mesh, san.CollectiveRecorder(), top_k=8)
    rank1 = _run_voting(one_rank_mesh, san.CollectiveRecorder(), top_k=2)
    assert len(rank0) > 0 and len(rank1) > 0
    assert {e[0] for e in rank0.events} <= san.KNOWN_COLLECTIVES
    with pytest.raises(san.CollectiveDivergence) as ei:
        san.crosscheck_hashes([rank0.sequence_hash(),
                               rank1.sequence_hash()])
    assert "rank 1" in str(ei.value)


def test_divergence_detector_clean_on_identical_ranks(one_rank_mesh):
    """No false positive: ranks running the same fit record the same
    (op, axis, shape, dtype) sequence, and the hashes agree."""
    san.enable()
    rank0 = _run_voting(one_rank_mesh, san.CollectiveRecorder(), top_k=8)
    rank1 = _run_voting(one_rank_mesh, san.CollectiveRecorder(), top_k=8)
    assert len(rank0) == len(rank1) > 0
    assert rank0.events == rank1.events
    san.crosscheck_hashes([rank0.sequence_hash(),
                           rank1.sequence_hash()])


def test_recompiles_are_counted_through_the_mesh_scorer(one_rank_mesh):
    """The port's builds under a mesh: ``ShardedScorer``'s first call on
    each rung counts once, however many calls follow; with the budget at
    the rungs used, a new rung raises."""
    from mmlspark_tpu_torch.parallel.shard_rules import ShardedScorer

    san.enable()
    w = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    scorer = ShardedScorer(lambda xb: torch.from_numpy(xb) @ w,
                           one_rank_mesh, max_batch=64)
    before = san.recompile_count()
    rng = np.random.default_rng(0)
    for n in rng.integers(1, 33, size=40):
        out = scorer(np.ones((int(n), 4), np.float32))
        assert out.shape == (int(n), 3)
    used = len(scorer.rungs_used)
    assert san.recompile_count() - before == used > 0
    san.set_recompile_budget(san.recompile_count())
    scorer(np.ones((8, 4), np.float32))         # a used rung: no build
    with pytest.raises(san.RecompileBudgetExceeded):
        scorer(np.ones((40, 4), np.float32))    # rung 64: a new build


# --- a sanitized fit is the unsanitized fit ----------------------------------

def _data(n=600, f=6, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = 2.0 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3] \
        + rng.normal(size=n) * 0.1
    mapper = BinMapper.fit(x, max_bin=32)
    return mapper.transform(x), y, mapper.bin_upper_values(32)


def _same_trees(a, b):
    for name in ARRAYS:
        want, got = getattr(a, name), getattr(b, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.mark.parametrize("boosting", ["gbdt", "dart"])
def test_sanitized_fit_gives_the_unsanitized_trees(boosting):
    """``MMLSPARK_TORCH_SAN=1`` over a clean fit (the step; DART's host
    loop) grows the trees of the same fit with it off, bit for bit, and
    its boundaries were crossed (contracts recorded, metrics synced)."""
    binned, y, upper = _data()
    cfg = T.TrainConfig(objective="regression", boosting_type=boosting,
                        num_iterations=6, num_leaves=8, max_depth=3,
                        max_bin=32, min_data_in_leaf=10,
                        learning_rate=0.3, bagging_fraction=0.8,
                        bagging_freq=1)
    off = T.train(binned, y, cfg, bin_upper=upper, device="cpu")
    with env.env_override(env.SAN, "1"):
        san.refresh_from_env()
        assert san.enabled()
        on = T.train(binned, y, cfg, bin_upper=upper, device="cpu")
    _same_trees(off.booster, on.booster)
    assert [e["train_l2"] for e in on.evals] == \
        [e["train_l2"] for e in off.evals]
    contracts = san.dtype_contracts()
    assert contracts["gbdt.level_hist"] == {"value": "float32"}
    assert contracts["gbdt.train_scan.exit"]["value[0]"] == "float32"
    if boosting == "gbdt":
        assert contracts["gbdt.train_scan.entry"]["value['binned']"] \
            == "uint8"
    else:
        assert "gbdt.train_scan.entry" not in contracts


def test_train_loop_entry_guard_names_its_boundary():
    """A NaN starting score reaches DART's host loop: its entry guard
    names ``gbdt.train_loop.entry`` (the step's names
    ``gbdt.train_scan.entry`` for a NaN label)."""
    binned, y, upper = _data(n=200)
    san.enable()
    cfg = T.TrainConfig(objective="regression", boosting_type="dart",
                        num_iterations=2, max_depth=2, max_bin=32)
    init = np.zeros(len(y))
    init[3] = np.nan
    with pytest.raises(san.NonFiniteError, match="gbdt.train_loop.entry"):
        T.train(binned, y, cfg, bin_upper=upper, init_raw=init,
                device="cpu")
    bad = y.copy()
    bad[0] = np.nan
    with pytest.raises(san.NonFiniteError,
                       match=r"'gbdt.train_scan.entry'.*value\['labels'\]"):
        T.train(binned, bad, cfg.__class__(**{**cfg.__dict__,
                                              "boosting_type": "gbdt"}),
                bin_upper=upper, device="cpu")


# --- two gloo ranks ---------------------------------------------------------

def _worker(rank: int, world: int, store: str, out: str) -> None:
    """One rank: a clean data-learner fit with the sanitizer on (its
    ``gbdt.metrics_sync`` cross-check runs inside), the agreed hash, then
    a forced extra event on rank 1 and every rank's error."""
    from datetime import timedelta

    import torch.distributed as dist

    from mmlspark_tpu_torch.parallel.mesh import create_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        mesh = create_mesh()
        san.enable()
        binned, y, upper = _data(n=256)
        cfg = T.TrainConfig(objective="regression", num_iterations=3,
                            num_leaves=8, max_depth=3, max_bin=32,
                            min_data_in_leaf=10, tree_learner="data")
        T.train(binned, y, cfg, bin_upper=upper, mesh=mesh, device="cpu")
        res = {"events": len(san.recorder()),
               "hash": san.step_boundary("after the fit", mesh)}
        if rank == 1:
            san.record_collective("psum", "dp", (1,), "float32")
        try:
            san.step_boundary("forced", mesh)
            res["error"] = None
        except san.CollectiveDivergence as e:
            res["error"] = str(e)
        pathlib.Path(out, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


def test_two_gloo_ranks_agree_then_name_the_forced_divergence(tmp_path):
    world = 2
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(rank), str(world),
         str(tmp_path / "store"), str(tmp_path)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    try:
        logs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in procs]
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank ran past {SPAWN_TIMEOUT_S} s: a hang")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {rank}:\n{log}"
    res = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(world)]
    assert res[0]["events"] == res[1]["events"] > 0
    assert res[0]["hash"] == res[1]["hash"] != ""
    for r in res:
        assert r["error"] is not None
        assert "rank 1" in r["error"] and "'forced'" in r["error"]


# --- serving ------------------------------------------------------------------

@pytest.fixture(scope="module")
def served_model():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(600, 8))
    y = (x[:, 0] - x[:, 1] + rng.normal(size=600) * 0.5 > 0).astype(float)
    model = LightGBMClassifier(numIterations=5, numLeaves=7, maxBin=31) \
        .set_device("cpu").fit(DataFrame({"features": x, "label": y}))
    return model, x


def _pending_batch(plane, rows):
    from mmlspark_tpu_torch.io.serving import _Pending

    batch = []
    for row in rows:
        p = _Pending({"features": row.tolist()})
        p.binned = plane.bin_row(p.payload)
        batch.append(p)
    return batch


def test_bucket_ladder_holds_recompile_budget(served_model, monkeypatch):
    """Requests at every batch size 1..32 build at most ladder-many
    scorer shapes; with the budget armed at exactly that, a shape leak
    raises (proven by forcing an off-ladder shape at the end)."""
    from mmlspark_tpu_torch.io.serving import ServingServer

    model, x = served_model
    monkeypatch.setenv(env.SERVE_BINNED, "on")
    san.enable()
    server = ServingServer(model, max_batch_size=32,
                           max_latency_ms=1.0).start()
    try:
        served = server._models["default"]
        plane = served.plane
        assert plane is not None
        assert server._ladder == [1, 2, 4, 8, 16, 32]
        warm = san.recompile_count()
        assert 0 < warm <= len(server._ladder)
        san.set_recompile_budget(len(server._ladder))
        rng = np.random.default_rng(3)
        total = size = 0
        while total < 300:
            b = (size % 32) + 1
            size += 1
            batch = _pending_batch(plane,
                                   x[rng.integers(0, len(x), size=b)])
            server._score(batch, served)
            assert all(q.reply is not None for q in batch)
            total += b
        assert served.stats["binned_batches"] > 0
        assert served.stats["generic_batches"] == 0
        assert san.recompile_count() == warm
        assert "serving.score.default" in san.dtype_contracts()
        with pytest.raises(san.RecompileBudgetExceeded):
            plane._mark_shape(np.zeros((99, x.shape[1]), np.uint8))
    finally:
        server.stop()


def test_nan_served_batch_raises_at_serving_score(served_model,
                                                  monkeypatch):
    """A model whose leaves are NaN serves NaN margins: with the
    sanitizer on the batch raises at ``serving.score`` (off, it would
    reply NaN)."""
    from mmlspark_tpu_torch.io.serving import ServingServer

    model, x = served_model
    good = model.booster
    model.booster = good.from_state_dict(
        {**good.state_dict(),
         "node_value": np.full_like(good.node_value, np.nan)})
    monkeypatch.setenv(env.SERVE_BINNED, "on")
    server = ServingServer(model, max_batch_size=4,
                           max_latency_ms=1.0).start()
    try:
        served = server._models["default"]
        batch = _pending_batch(served.plane, x[:3])
        server._score(batch, served)
        assert all(np.isnan(q.reply["probability"]).any() for q in batch)
        san.enable()
        batch = _pending_batch(served.plane, x[:3])
        with pytest.raises(san.NonFiniteError, match="'serving.score'"):
            server._score(batch, served)
    finally:
        server.stop()
        model.booster = good


# --- out of core --------------------------------------------------------------

def _ooc_fit(monkeypatch, y=None, lr=0.3):
    monkeypatch.setattr(T, "OOC_CHUNK_ROWS", 128)
    monkeypatch.setenv(env.OOC, "on")
    monkeypatch.setenv(T.HIST_QUANT_ENV, "q16")
    monkeypatch.setenv(T.HIST_SUB_ENV, "1")
    binned, y0, upper = _data(n=400)
    cfg = T.TrainConfig(objective="regression", num_iterations=2,
                        num_leaves=8, max_depth=3, max_bin=32,
                        min_data_in_leaf=10, learning_rate=lr)
    return T.train(binned, y0 if y is None else y, cfg, bin_upper=upper,
                   device="cpu")


def test_ooc_boundaries_fire_on_injected_nan(monkeypatch):
    """Each of the out-of-core loop's three guards names itself: a NaN
    label's base score (``gbdt.ooc.entry``), a derived sibling's NaN
    histogram (``gbdt.ooc.level_hist``), a NaN shrinkage's leaf values
    (``gbdt.ooc.carry``); the clean streamed fit passes."""
    san.enable()
    assert _ooc_fit(monkeypatch).hist_stats["ooc"] is True
    _, y, _ = _data(n=400)
    y = y.copy()
    y[5] = np.nan
    with pytest.raises(san.NonFiniteError, match="'gbdt.ooc.entry'"):
        _ooc_fit(monkeypatch, y=y)
    with pytest.raises(san.NonFiniteError, match="'gbdt.ooc.carry'"):
        _ooc_fit(monkeypatch, lr=float("nan"))
    derive = T._derive_sibling_hist
    monkeypatch.setattr(T, "_derive_sibling_hist",
                        lambda *a: _nan_corrupt(derive(*a)))
    with pytest.raises(san.NonFiniteError,
                       match="'gbdt.ooc.level_hist'"):
        _ooc_fit(monkeypatch)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
