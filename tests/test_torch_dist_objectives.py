"""The mesh objectives on ``torch.distributed`` (gloo, on the CPU): DART,
GOSS, lambdarank with query groups (and an ``ndcg`` validation set),
custom objectives and a multiclass DART fit, on the data, data_sharded,
voting and feature learners (``models/gbdt/parallel_modes.py``) at world
sizes 1, 2 and 4.

The harness is ``test_torch_dist_gbdt.py``'s: worlds 2 and 4 run once
each, in P processes started from this file (``python
test_torch_dist_objectives.py RANK WORLD INIT_FILE OUT_DIR``), world 1 in
the test process; the ranks join through a ``file://`` store, build a
``dp`` mesh and an ``fp`` mesh, run every case with the same full arrays,
and each writes what it got. The tests hold every rank's trees, tree
weights, raw scores and metrics bitwise against the port's serial fit of
the same case (voting at ``top_k >= F``), the ranks' DART weights equal,
a custom objective's calls the serial fit's (every row's scores, the
weights as passed), the estimators (``LightGBMRanker``, DART, GOSS and
``fobj`` classifiers) through ``set_mesh(mesh).fit`` and ``transform``
bitwise their unmeshed models, and a checkpointed ranker killed and
re-fit under the mesh bitwise the serial checkpointed fit.

Each fit is also held to the JAX package's own fit on its 8-device CPU
mesh (``tests/conftest.py``'s ``mesh8``), under the criterion of the
port's serial parity test of that objective: DART (and the multiclass
DART fit, and ``fobj``, which run the float32 plane under a mesh) as
``test_torch_dart.py::test_dart_fit_on_float32_plane_keeps_the_drops``;
lambdarank as ``test_torch_ranking.py::
test_lambdarank_fit_with_its_own_grads_tracks_jax``; GOSS as
``test_torch_step.py::test_benchmark_fixtures_track_jax`` (ROADMAP C13).
Where the JAX mesh fit differs from the JAX serial fit, the gap is pinned
at its size. The workers import torch and the port only, and are killed
past their timeout.
"""

import json
import os
import pathlib
import pickle
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORLDS = (1, 2, 4)
SPAWNED = (2, 4)             # world 1 runs in the test process
SPAWN_TIMEOUT_S = 150
N, F = 503, 8                # dp = 2 and 4 pad the rows; fp divides F


# --- the data ---------------------------------------------------------------

def _binary(n=N, f=F, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    logit = 1.5 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
    y = (logit + rng.normal(size=n) * 0.3 > 0).astype(np.float64)
    return x, y


def _multiclass():
    x, _ = _binary(seed=1)
    return x, np.clip(np.round(x[:, 0] + 1), 0, 2)


def _ranking(seed=2, queries=18):
    """Graded labels 0-4 and shuffled query ids of 8-40 rows (the port's
    ranking tests' ``uniform`` profile at F = 8): 459 rows at seed 2,
    which neither dp pads away."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(8, 41, size=queries)
    gid = rng.permutation(np.repeat(rng.permutation(10_000)[:queries],
                                    sizes))
    x = rng.normal(size=(len(gid), F))
    rel = x[:, 0] + 0.5 * x[:, 1] - 0.3 * x[:, 2] + 0.5 * rng.normal(
        size=len(gid))
    return x, np.clip(np.round(rel + 1.5), 0, 4), gid


def _bins(x, max_bin=32):
    from mmlspark_tpu_torch.ops.binning import BinMapper
    mapper = BinMapper.fit(x, max_bin=max_bin)
    return mapper.transform(x), mapper.bin_upper_values(max_bin)


# --- the cases ----------------------------------------------------------------

BASE = dict(objective="binary", num_iterations=4, num_leaves=15, max_depth=4,
            min_data_in_leaf=5, max_bin=32)
OBJECTIVES = {
    "dart": dict(BASE, boosting_type="dart", num_iterations=6,
                 learning_rate=0.3, skip_drop=0.0, drop_rate=0.5),
    "goss": dict(BASE, boosting_type="goss", top_rate=0.2, other_rate=0.2),
    "rank": dict(BASE, objective="lambdarank", eval_at=(3, 5)),
    "fobj": dict(BASE, num_iterations=3),
    "dart_multiclass": dict(BASE, objective="multiclass", num_class=3,
                            boosting_type="dart", skip_drop=0.0,
                            drop_rate=0.5),
}
# learner -> (config, environment)
LEARNERS = {"data": ({}, {"HIST_SHARD": "off"}),
            "data_sharded": ({}, {"HIST_SHARD": "on"}),
            "voting": (dict(tree_learner="voting", top_k=F), {}),
            "feature": (dict(tree_learner="feature"), {})}
CASES = [(o, lr) for o in OBJECTIVES for lr in LEARNERS]


def _inputs(objective):
    """(x, y, fit keywords) of ``objective``'s case."""
    if objective == "rank":
        x, y, gid = _ranking()
        vx, vy, vgid = _ranking(seed=3, queries=8)
        return x, y, {"group_ids": gid, "valid": (vx, vy, vgid)}
    if objective == "dart_multiclass":
        x, y = _multiclass()
        return x, y, {}
    x, y = _binary()
    return x, y, {}


def _logistic(calls):
    """A host-side (numpy) binary logloss ``fobj`` that records each call's
    row count and whether it was given weights."""
    def fobj(preds, labels, weights):
        calls.append((len(preds), weights is None))
        p = 1.0 / (1.0 + np.exp(-np.asarray(preds, np.float64)))
        y = np.asarray(labels, np.float64)
        return (p - y).astype(np.float32), (p * (1 - p)).astype(np.float32)
    return fobj


def _fit(objective, learner, mesh):
    """The record of one fit: its trees, tree weights, raw scores on the
    training rows, evals and the custom objective's calls."""
    from mmlspark_tpu_torch.models.gbdt import trainer as T
    cfg_kw, env_kw = LEARNERS[learner]
    cfg = T.TrainConfig(**dict(OBJECTIVES[objective], **cfg_kw))
    x, y, kw = _inputs(objective)
    binned, upper = _bins(x)
    fit_kw = {}
    if "valid" in kw:
        vx, vy, vgid = kw["valid"]
        from mmlspark_tpu_torch.ops.binning import BinMapper
        vb = BinMapper.fit(x, max_bin=32).transform(vx)
        fit_kw = dict(group_ids=kw["group_ids"],
                      valid_sets=[(vb, vy, None, vgid)])
    calls = []
    if objective == "fobj":
        fit_kw["custom_objective"] = _logistic(calls)
    saved = {k: os.environ.get(f"MMLSPARK_TORCH_{k}") for k in env_kw}
    os.environ.update({f"MMLSPARK_TORCH_{k}": v for k, v in env_kw.items()})
    try:
        r = T.train(binned, y, cfg, bin_upper=upper, device="cpu",
                    mesh=mesh, **fit_kw)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(f"MMLSPARK_TORCH_{k}", None)
            else:
                os.environ[f"MMLSPARK_TORCH_{k}"] = v
    b = r.booster
    return {"trees": [np.asarray(a) for a in (
                b.split_feature, b.threshold_bin, b.node_value, b.count,
                b.tree_weights)],
            "raw": b.predict(x, device="cpu").numpy(),
            "evals": r.evals, "best": r.best_iteration, "calls": calls,
            "hist_stats": r.hist_stats}


def _frame(objective):
    from mmlspark_tpu_torch import DataFrame
    x, y, kw = _inputs(objective)
    cols = {"features": x, "label": y}
    if "group_ids" in kw:
        cols["query"] = kw["group_ids"]
    return DataFrame(cols)


# estimator -> (class name, params, parallelism)
ESTIMATORS = {
    "ranker": ("LightGBMRanker", dict(groupCol="query", evalAt=[3, 5]),
               "data_parallel", "rank"),
    "dart": ("LightGBMClassifier", dict(boostingType="dart", dropRate=0.5,
                                        skipDrop=0.0), "data_parallel",
             "dart"),
    "goss": ("LightGBMClassifier", dict(boostingType="goss"),
             "voting_parallel", "goss"),
    "fobj": ("LightGBMClassifier", {}, "feature_parallel", "fobj"),
}


def _estimator(name, mesh, **extra):
    from mmlspark_tpu_torch.models.gbdt import estimators as E
    cls, params, par, objective = ESTIMATORS[name]
    if name == "fobj":
        extra = dict(extra, fobj=_logistic([]))
    est = getattr(E, cls)(numIterations=4, numLeaves=7, maxBin=32, topK=F,
                          parallelism=par, **params, **extra
                          ).set_device("cpu")
    if mesh is not None:
        est.set_mesh(mesh)
    return est, _frame(objective)


def _estimator_case(name, mesh):
    est, frame = _estimator(name, mesh)
    model = est.fit(frame)
    out = model.transform(frame)
    return {"model": model.get_model_string(),
            "raw": np.asarray(out.col("rawPrediction"
                                      if name != "ranker" else
                                      "prediction"))}


def _checkpointed(mesh, rank, tmp):
    """{the checkpointed ranker killed at the first iteration of segment
    2 and re-fit (the mesh's first rank resumes its directory, the other
    ranks name empty ones), its ``gbdt.train_step`` hits; the checkpointed
    DART classifier's refusal}."""
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.core.faults import FaultInjected
    ck = os.path.join(tmp, "ranker")
    est, frame = _estimator("ranker", mesh, checkpointInterval=2,
                            checkpointDir=ck)
    with faults.injected("gbdt.train_step", "raise", nth=3):
        try:
            est.fit(frame)
            killed = None
        except FaultInjected as e:
            killed = str(e)
    refit_dir = ck if rank == 0 else os.path.join(tmp, "empty")
    os.makedirs(refit_dir, exist_ok=True)
    faults.reset()
    with faults.injected("gbdt.train_step", "delay", nth=10 ** 9):
        model = est.copy(checkpointDir=refit_dir).fit(frame)
        hits = faults.hits("gbdt.train_step")
    faults.reset()
    est, frame = _estimator("dart", mesh, checkpointInterval=2,
                            checkpointDir=os.path.join(tmp, "dart"))
    try:
        est.fit(frame)
        dart = None
    except ValueError as e:
        dart = str(e)
    return {"killed": killed, "model": model.get_model_string(),
            "hits": hits, "dart": dart}


def _run_cases(world: int, rank: int = 0):
    """Every case on this rank of a ``world``-rank default process group."""
    from mmlspark_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    mesh = create_mesh()
    fp_mesh = create_mesh(MeshConfig(dp=1, fp=world))
    res = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for objective, learner in CASES:
            res[(objective, learner)] = _fit(
                objective, learner, fp_mesh if learner == "feature" else mesh)
        res["estimator"] = {
            name: _estimator_case(name, fp_mesh if ESTIMATORS[name][2]
                                  == "feature_parallel" else mesh)
            for name in ESTIMATORS}
        with tempfile.TemporaryDirectory() as tmp:
            res["checkpointed"] = _checkpointed(mesh, rank, tmp)
    return res


def _worker(rank: int, world: int, init_file: str, out_dir: str) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        res = _run_cases(world, rank)
        with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: [per-rank results]}, every world run once: 2 and 4 in
    processes of their own, 1 in this process while they run."""
    import torch.distributed as dist

    results, procs = {}, {}
    for world in SPAWNED:
        out_dir = tmp_path_factory.mktemp(f"objectives_world{world}")
        procs[world] = (out_dir, [subprocess.Popen(
            [sys.executable, __file__, str(rank), str(world),
             str(out_dir / "store"), str(out_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for rank in range(world)])
    try:
        store = tmp_path_factory.mktemp("objectives_world1") / "store"
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=1, rank=0)
        try:
            results[1] = [_run_cases(1)]
        finally:
            dist.destroy_process_group()
        for world, (out_dir, ps) in procs.items():
            logs = [p.communicate(timeout=SPAWN_TIMEOUT_S)[0] for p in ps]
            for rank, (p, log) in enumerate(zip(ps, logs)):
                assert p.returncode == 0, f"world {world} rank {rank}:\n{log}"
            results[world] = [pickle.loads(
                (out_dir / f"rank{r}.pkl").read_bytes())
                for r in range(world)]
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank ran past {SPAWN_TIMEOUT_S} s")
    finally:
        for _, ps in procs.values():
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return results


@pytest.fixture(scope="module")
def serial():
    """The port's serial fits of every objective (the learner does not
    matter without a mesh), estimators and checkpointed fits."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fits = {o: _fit(o, "data", None) for o in OBJECTIVES}
        est = {name: _estimator_case(name, None) for name in ESTIMATORS}
        with tempfile.TemporaryDirectory() as tmp:
            ck = _checkpointed(None, 0, tmp)
            uninterrupted, frame = _estimator(
                "ranker", None, checkpointInterval=2,
                checkpointDir=os.path.join(tmp, "whole"))
            ck["uninterrupted"] = uninterrupted.fit(frame).get_model_string()
    return {"fits": fits, "estimator": est, "checkpointed": ck}


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def _same_fit(got, want):
    for a, b in zip(got["trees"], want["trees"]):
        assert a.shape == b.shape and _bits(a) == _bits(b)
    assert _bits(got["raw"]) == _bits(want["raw"])
    assert json.dumps(got["evals"]) == json.dumps(want["evals"])
    assert got["best"] == want["best"]


# --- the contract: bitwise the serial fit, on every rank ----------------------

@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("objective,learner", CASES)
def test_objective_under_a_learner_is_the_serial_fit(worlds, serial, world,
                                                     objective, learner):
    want = serial["fits"][objective]
    for rank, res in enumerate(worlds[world]):
        got = res[(objective, learner)]
        _same_fit(got, want)
        assert got["hist_stats"]["grad_shard"] == (
            "off" if learner == "feature" else "dp"), rank
    if objective.startswith("dart"):
        assert (want["trees"][4] < 1).any()      # trees were dropped
    if objective == "rank":
        assert set(want["evals"][-1]) == {
            "iteration", "train_ndcg@3", "valid0_ndcg@3", "train_ndcg@5",
            "valid0_ndcg@5"}


@pytest.mark.parametrize("world", SPAWNED)
def test_ranks_drop_the_same_dart_trees(worlds, world):
    """The drops come from the same numpy stream on every rank (ROADMAP
    C22): the ranks' tree weights are equal, under every learner."""
    for objective in ("dart", "dart_multiclass"):
        for learner in LEARNERS:
            weights = [res[(objective, learner)]["trees"][4]
                       for res in worlds[world]]
            assert all(_bits(w) == _bits(weights[0]) for w in weights)


@pytest.mark.parametrize("world", WORLDS)
def test_custom_objective_sees_the_serial_call(worlds, serial, world):
    """Every rank calls ``fobj`` once per iteration with every row's
    scores and the weights as passed (None), as the serial fit does."""
    want = serial["fits"]["fobj"]["calls"]
    assert want == [(N, True)] * OBJECTIVES["fobj"]["num_iterations"]
    for res in worlds[world]:
        for learner in LEARNERS:
            assert res[("fobj", learner)]["calls"] == want


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(ESTIMATORS))
def test_estimators_under_a_mesh_are_the_unmeshed_models(worlds, serial,
                                                         world, name):
    """``set_mesh(mesh).fit`` and ``transform`` of the ranker and of the
    DART, GOSS and ``fobj`` classifiers: the unmeshed model's string and
    scores, bit for bit."""
    want = serial["estimator"][name]
    for res in worlds[world]:
        got = res["estimator"][name]
        assert got["model"] == want["model"]
        assert _bits(got["raw"]) == _bits(want["raw"])


@pytest.mark.parametrize("world", WORLDS)
def test_checkpointed_ranker_resumes_bitwise_under_a_mesh(worlds, serial,
                                                          world):
    """Killed at the first iteration of segment 2 and re-fit: every rank
    resumes at the first rank's checkpoint 2 and ends bitwise the serial
    uninterrupted checkpointed fit (the fingerprint covers the query
    ids, ROADMAP C17). A checkpointed DART fit raises the reference's
    ``ValueError`` on every rank, as serially."""
    want = serial["checkpointed"]
    assert want["model"] == want["uninterrupted"]
    for res in worlds[world]:
        got = res["checkpointed"]
        assert "injected fault at 'gbdt.train_step'" in got["killed"]
        assert got["model"] == want["uninterrupted"]
        assert got["hits"] == 2
        assert got["dart"] == want["dart"]
        assert "checkpointing does not compose with DART" in got["dart"]


# --- the JAX package's mesh fits (8-device CPU mesh) --------------------------

def _jax_fit(objective, mesh, monkeypatch, calls=None):
    from mmlspark_tpu.models.gbdt.trainer import TrainConfig, train
    from mmlspark_tpu.ops.binning import BinMapper
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")
    x, y, kw = _inputs(objective)
    mapper = BinMapper.fit(x, max_bin=32)
    fit_kw = {}
    if "valid" in kw:
        vx, vy, vgid = kw["valid"]
        fit_kw = dict(group_ids=kw["group_ids"], valid_sets=[
            (mapper.transform(vx), vy, None, vgid)])
    if objective == "fobj":
        fit_kw["custom_objective"] = _logistic(
            calls if calls is not None else [])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return train(mapper.transform(x), y,
                     TrainConfig(**OBJECTIVES[objective]),
                     bin_upper=mapper.bin_upper_values(32), mesh=mesh,
                     **fit_kw)


def _structure_and_values(jax_booster, got):
    """``test_dart_fit_on_float32_plane_keeps_the_drops``: the tree
    weights bit for bit, split features, bins and counts exact, node
    values within ``rtol=1e-5`` (``atol=1e-7``)."""
    jb = jax_booster
    np.testing.assert_array_equal(np.asarray(jb.tree_weights), got[4])
    for j, name in ((0, "split_feature"), (1, "threshold_bin"),
                    (3, "count")):
        np.testing.assert_array_equal(np.asarray(getattr(jb, name)), got[j])
    np.testing.assert_allclose(np.asarray(jb.node_value), got[2], rtol=1e-5,
                               atol=1e-7)


def test_reference_mesh_dart_criterion(worlds, mesh8, monkeypatch):
    """DART: the port's fits at P = 4 under every learner (each its
    serial fit) against the JAX package's dp = 8 mesh fit, under the
    float32-plane criterion of the port's serial DART parity test (a
    mesh runs the float32 plane on both sides)."""
    jr = _jax_fit("dart", mesh8, monkeypatch)
    for learner in LEARNERS:
        _structure_and_values(jr.booster,
                              worlds[4][0][("dart", learner)]["trees"])


def test_reference_mesh_custom_objective_gap(worlds, serial, mesh8,
                                             monkeypatch):
    """A custom objective: the port's serial parity test
    (``test_torch_dart.py::test_custom_objective_under_dart``) holds it
    bit for bit on q8, and a mesh runs the float32 plane. There the JAX
    mesh fit is its serial fit's trees, and the port's fits at P = 4
    under every learner (each the port's serial fit) differ from it at
    one split slot of 93 (0.989 agree), where the fixed-point sums pick
    another of two near-tied gains (as ROADMAP C27), ending 6.0e-8 from
    its training logloss: the same gap as between the two packages'
    serial fits. Pinned at its size."""
    from mmlspark_tpu.models.gbdt.trainer import TrainConfig, train
    from mmlspark_tpu.ops.binning import BinMapper
    loss = "train_binary_logloss"
    jr = _jax_fit("fobj", mesh8, monkeypatch)
    x, y, _ = _inputs("fobj")
    mapper = BinMapper.fit(x, max_bin=32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = train(mapper.transform(x), y,
                   TrainConfig(**OBJECTIVES["fobj"]),
                   bin_upper=mapper.bin_upper_values(32),
                   custom_objective=_logistic([]))
    jsf = np.asarray(jr.booster.split_feature)
    np.testing.assert_array_equal(jsf, np.asarray(js.booster.split_feature))
    assert jr.evals[-1][loss] == js.evals[-1][loss]
    want_gap = abs(js.evals[-1][loss] - serial["fits"]["fobj"]["evals"][-1][
        loss])
    for learner in LEARNERS:
        got = worlds[4][0][("fobj", learner)]
        np.testing.assert_array_equal(np.asarray(jr.booster.tree_weights),
                                      got["trees"][4])
        assert (jsf == got["trees"][0]).mean() >= 0.989
        gap = abs(got["evals"][-1][loss] - jr.evals[-1][loss])
        assert gap == want_gap <= 6.0e-8


def test_reference_mesh_multiclass_dart_gap(worlds, mesh8, monkeypatch):
    """Multiclass DART on the float32 plane: the port's serial parity
    test holds it bit for bit on q8 only, with XLA's ``exp`` patched in
    (ROADMAP C10), and a mesh runs the float32 plane. There the JAX mesh
    fit is not its own serial fit: near-tied gains of three classes'
    trees split apart (0.844 of the split slots agree), ending 4.8e-7
    from its training multi_logloss. The port's fit, at P = 4 under
    every learner, drops the JAX mesh fit's trees with its weights bit
    for bit; its splits agree on 0.793 of the slots and it ends 3.0e-7
    from the JAX mesh fit's multi_logloss. The gaps are pinned at their
    sizes so that they cannot grow unseen."""
    from mmlspark_tpu.models.gbdt.trainer import TrainConfig, train
    from mmlspark_tpu.ops.binning import BinMapper
    loss = "train_multi_logloss"
    jr = _jax_fit("dart_multiclass", mesh8, monkeypatch)
    x, y, _ = _inputs("dart_multiclass")
    mapper = BinMapper.fit(x, max_bin=32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        js = train(mapper.transform(x), y,
                   TrainConfig(**OBJECTIVES["dart_multiclass"]),
                   bin_upper=mapper.bin_upper_values(32))
    jsf = np.asarray(jr.booster.split_feature)
    np.testing.assert_array_equal(np.asarray(js.booster.tree_weights),
                                  np.asarray(jr.booster.tree_weights))
    assert (jsf == np.asarray(js.booster.split_feature)).mean() < 0.85
    assert abs(jr.evals[-1][loss] - js.evals[-1][loss]) <= 5e-7
    for learner in LEARNERS:
        got = worlds[4][0][("dart_multiclass", learner)]
        np.testing.assert_array_equal(np.asarray(jr.booster.tree_weights),
                                      got["trees"][4])
        assert (jsf == got["trees"][0]).mean() >= 0.79
        assert abs(got["evals"][-1][loss] - jr.evals[-1][loss]) <= 3.1e-7


def test_reference_mesh_custom_objective_sees_padded_rows(mesh8,
                                                          monkeypatch):
    """A stated difference (ROADMAP C): under a mesh the JAX package calls
    ``fobj`` on the rows padded to a multiple of dp, with the pad rows
    at weight 0 and weights filled in; serially, and in the port under
    any mesh, it sees the N rows and the weights as passed."""
    calls = []
    _jax_fit("fobj", mesh8, monkeypatch, calls)
    n_pad = -(-N // 8) * 8
    assert calls == [(n_pad, False)] * OBJECTIVES["fobj"]["num_iterations"]
    calls = []
    _jax_fit("fobj", None, monkeypatch, calls)
    assert calls == [(N, True)] * OBJECTIVES["fobj"]["num_iterations"]


def test_reference_mesh_lambdarank_criterion(worlds, mesh8, monkeypatch):
    """``test_lambdarank_fit_with_its_own_grads_tracks_jax``: the first
    tree's root split is the JAX mesh fit's, the final training NDCG@5
    within 1e-4 of it, and it improves on the first iteration's."""
    jr = _jax_fit("rank", mesh8, monkeypatch)
    for learner in LEARNERS:
        got = worlds[4][0][("rank", learner)]
        assert got["trees"][0][0, 0] == np.asarray(
            jr.booster.split_feature)[0, 0]
        g, w = got["evals"][-1]["train_ndcg@5"], jr.evals[-1]["train_ndcg@5"]
        assert abs(g - w) <= 1e-4, (learner, g, w)
        assert g > got["evals"][0]["train_ndcg@5"]


def test_reference_mesh_goss_criterion(worlds, mesh8, monkeypatch):
    """``test_benchmark_fixtures_track_jax``'s classifier tolerance: the
    training AUC of the port's GOSS fits at P = 4 within 0.01 of the JAX
    package's dp = 8 GOSS fit's (ROADMAP C13: the port draws GOSS's
    sample from its counter hash; the reference's mesh fit also takes
    its quantile and draws over the padded rows)."""
    from sklearn.metrics import roc_auc_score
    jr = _jax_fit("goss", mesh8, monkeypatch)
    x, y, _ = _inputs("goss")
    want = roc_auc_score(y, np.asarray(jr.booster.predict_fn()(
        x.astype(np.float32))))
    for learner in LEARNERS:
        got = roc_auc_score(y, worlds[4][0][("goss", learner)]["raw"])
        assert abs(got - want) <= 0.01, (learner, got, want)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
