"""Multi-device GBDT on ``torch.distributed`` (gloo, on the CPU): the
port's data, data_sharded, voting and feature learners
(``models/gbdt/parallel_modes.py``) at world sizes 1, 2 and 4.

Each world size runs once: 2 and 4 in P processes started from this
file (``python test_torch_dist_gbdt.py RANK WORLD INIT_FILE OUT_DIR``),
1 in the test process; the ranks join through a ``file://`` store, build
a mesh
(``parallel.mesh.create_mesh``), run every case of :data:`CASES` with the
same full arrays, and each writes what it got. The tests hold every
rank's trees, raw scores and metrics bitwise against the port's serial
fit of the same case (the contract of ``parallel_modes``: voting at
``top_k >= F``), the histogram traffic against ``hist_reduction_bytes``,
the downgrades and refusals against the reference's words, and the
fits against the JAX package's own fits on its 8-device CPU mesh under
the criteria of its mesh tests (``tests/gbdt/test_distributed.py``,
``test_parallel_modes.py``, ``test_hist_shard.py``). The workers import
torch and the port only, and are killed past their timeout.

The plain versions of the float32 kernel's sums entries
(``hist_cuda.level_histogram_amax`` / ``level_histogram_sums`` /
``fixed_point_round``) are held here too, in this process: shards'
sums under the global exponents, rounded, are ``level_histogram`` on
the whole rows, bit for bit.
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


# --- the cases ------------------------------------------------------------

def _binary(n, f, seed=0):
    """The reference mesh tests' data: a logistic signal on 3 features."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    logit = 1.5 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2]
    y = (logit + rng.normal(size=n) * 0.3 > 0).astype(np.float64)
    return x, y


def _separated(n=4096, seed=42):
    """``test_distributed.py``'s well-separated gains (XOR on x0, x1)."""
    rng = np.random.default_rng(seed)
    x = np.stack([rng.normal(size=n), rng.normal(size=n) + 3.0,
                  rng.uniform(-1, 1, size=n)], axis=1)
    logit = np.where(x[:, 0] > 0.5, 4.0 * (x[:, 1] <= 3.0) - 2.0,
                     4.0 * (x[:, 1] > 3.0) - 2.0)
    y = (logit + rng.normal(size=n) * 0.2 > 0).astype(np.float64)
    return x, y


# the spawned ranks read the breast-cancer rows from this file, which the
# fixture writes (importing sklearn in every rank would cost seconds each)
BC_ENV = "MMLSPARK_TORCH_TEST_BREAST_CANCER"


def _breast_cancer():
    if os.environ.get(BC_ENV):
        with np.load(os.environ[BC_ENV]) as z:
            return z["x"], z["y"]
    from sklearn.datasets import load_breast_cancer
    x, y = load_breast_cancer(return_X_y=True)
    n8 = (len(x) // 8) * 8
    return x[:n8], y[:n8].astype(np.float64)


BASE = dict(objective="binary", num_iterations=3, num_leaves=15, max_depth=4,
            min_data_in_leaf=5, max_bin=32)
# name -> (data, max_bin, config, environment, fit keywords): N = 503 and
# F = 10 divide neither world, so rows are padded and data_sharded pads
# its feature slices
CASES = {
    "data": ("b503x10", 32, dict(BASE), {"HIST_SHARD": "off"}, {}),
    "data_sharded": ("b503x10", 32, dict(BASE), {"HIST_SHARD": "on"}, {}),
    "voting": ("b503x10", 32, dict(BASE, tree_learner="voting", top_k=10),
               {}, {}),
    "feature": ("b503x8", 32, dict(BASE, tree_learner="feature"), {}, {}),
    "bag_ff": ("b503x10", 32, dict(BASE, bagging_fraction=0.7,
                                   bagging_freq=1, feature_fraction=0.6),
               {"HIST_SHARD": "on"}, {}),
    "feature_bag": ("b503x8", 32, dict(BASE, tree_learner="feature",
                                       bagging_fraction=0.7, bagging_freq=1,
                                       feature_fraction=0.6), {}, {}),
    "voting_bag": ("b503x10", 32, dict(BASE, tree_learner="voting", top_k=5,
                                       bagging_fraction=0.7, bagging_freq=2),
                   {}, {}),
    "l2_valid": ("b503x10", 32, dict(BASE, objective="regression",
                                     num_iterations=8,
                                     early_stopping_round=2),
                 {"HIST_SHARD": "off", "HIST_SUB": "1"}, {"valid": True}),
    "multiclass": ("m503x10", 32, dict(BASE, objective="multiclass",
                                       num_class=3, num_iterations=2),
                   {"HIST_SHARD": "on"}, {}),
    "u16": ("b503x10", 300, dict(BASE, max_bin=300, num_iterations=2), {},
            {}),
    "i32": ("b503x4", 70_000, dict(BASE, max_bin=70_000, num_iterations=2,
                                   num_leaves=4, max_depth=2), {}, {}),
    # the general split branch under the data learner (the reduce-scatter
    # refuses it: categorical_features), rf with pos/neg bagging, and
    # per-row offsets
    "cat_mono": ("b503x10", 32, dict(BASE, categorical_features=(3,),
                                     monotone_constraints=(1,),
                                     min_data_per_group=5), {},
                 {"no_upper": True}),
    "rf_posneg": ("b503x10", 32, dict(BASE, boosting_type="rf",
                                      bagging_freq=1,
                                      pos_bagging_fraction=0.8,
                                      neg_bagging_fraction=0.6), {}, {}),
    "offset": ("b503x10", 32, dict(BASE), {"HIST_SHARD": "on"},
               {"init_raw": True}),
    # the reference mesh tests' fits
    # (binned to 63 bins, the config's max_bin the default 255, as there)
    "ref_bc": ("bc", 63, dict(objective="binary", num_iterations=5,
                              num_leaves=15, max_depth=4, min_data_in_leaf=5),
               {}, {}),
    "ref_sep": ("sep", 63, dict(objective="binary", num_iterations=5,
                                num_leaves=4, max_depth=2,
                                min_data_in_leaf=20), {}, {}),
    "ref_feature": ("b512x8", 32, dict(BASE, num_iterations=5,
                                       tree_learner="feature"), {}, {}),
    "ref_voting": ("b512x8", 32, dict(BASE, num_iterations=5,
                                      tree_learner="voting", top_k=8), {},
                   {}),
    "ref_voting_k2": ("b1024x16s3", 32, dict(BASE, num_iterations=5,
                                             tree_learner="voting", top_k=2),
                      {}, {}),
}


def _data(key):
    if key == "bc":
        return _breast_cancer()
    if key == "sep":
        return _separated()
    if key.startswith("m"):
        x, y = _binary(503, 10)
        return x, np.clip(np.round(x[:, 0] + 1), 0, 2)
    n, rest = key[1:].split("x")
    f, seed = (rest.split("s") + ["0"])[:2]
    return _binary(int(n), int(f), int(seed))


def _binned(key, max_bin, total_bins=None):
    """(x, y, bin ids, bin upper edges) of data ``key`` binned to
    ``max_bin`` bins, for a config of ``total_bins`` (``max_bin`` where
    None)."""
    from mmlspark_tpu_torch.ops.binning import BinMapper
    from mmlspark_tpu_torch.ops.ingest import binned_ingest_dtype
    total_bins = total_bins or max_bin
    x, y = _data(key)
    mapper = BinMapper.fit(x, max_bin=max_bin)
    return x, y, mapper.transform(x, binned_ingest_dtype(total_bins)), \
        mapper.bin_upper_values(total_bins)


def _fit_case(name, mesh):
    """(result record, the mesh's histogram bytes over the fit) of case
    ``name``, on ``mesh`` or serially."""
    from mmlspark_tpu_torch.models.gbdt import trainer as T
    key, max_bin, cfg_kw, env_kw, fit_kw = CASES[name]
    cfg = T.TrainConfig(**cfg_kw)
    x, y, binned, upper = _binned(key, max_bin, cfg.max_bin)
    valid = ([(binned[:150], y[:150], None)] if fit_kw.get("valid")
             else None)
    saved = {k: os.environ.get(f"MMLSPARK_TORCH_{k}") for k in env_kw}
    os.environ.update({f"MMLSPARK_TORCH_{k}": v for k, v in env_kw.items()})
    before = dict(mesh.bytes) if mesh is not None else {}
    try:
        r = T.train(binned, y, cfg,
                    bin_upper=None if fit_kw.get("no_upper") else upper,
                    valid_sets=valid, device="cpu", mesh=mesh,
                    init_raw=(np.linspace(-0.5, 0.5, len(y))
                              if fit_kw.get("init_raw") else None))
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(f"MMLSPARK_TORCH_{k}", None)
            else:
                os.environ[f"MMLSPARK_TORCH_{k}"] = v
    b = r.booster
    hist = (mesh.bytes.get("hist", 0) - before.get("hist", 0)
            if mesh is not None else 0)
    return {"trees": [np.asarray(a) for a in (
                b.split_feature, b.threshold_bin, b.node_value, b.count)],
            "raw": b.predict(x, device="cpu").numpy(),
            "evals": r.evals, "best": r.best_iteration,
            "hist_stats": r.hist_stats, "hist_bytes": hist,
            "num_trees": b.num_trees}


def _estimator_case(mesh, parallelism):
    from mmlspark_tpu_torch import DataFrame, LightGBMClassifier
    x, y = _binary(503, 8)
    est = LightGBMClassifier(numIterations=3, numLeaves=7, maxBin=32,
                             parallelism=parallelism, topK=8).set_device("cpu")
    if mesh is not None:
        est.set_mesh(mesh)
    model = est.fit(DataFrame({"features": x, "label": y}))
    out = model.transform(DataFrame({"features": x, "label": y}))
    return {"model": model.get_model_string(),
            "raw": np.asarray(out.col("rawPrediction")),
            "meta": model.shard_metadata()}


# the settings that raised under a mesh before the mesh objectives were
# ported (DART, GOSS, lambdarank with query groups, a custom objective):
# name -> (config, whether the fit takes group ids, a custom objective)
LIFTED = {"dart": (dict(boosting_type="dart"), False, False),
          "goss": (dict(boosting_type="goss"), False, False),
          "lambdarank": (dict(objective="lambdarank"), True, False),
          "custom": ({}, False, True)}


def _lifted_fit(name, mesh):
    """(trees, raw scores) of ``LIFTED[name]``'s two-iteration fit of the
    downgrades' rows, on ``mesh`` or serially."""
    from mmlspark_tpu_torch.models.gbdt import trainer as T
    cfg_kw, groups, custom = LIFTED[name]
    x, y, binned, upper = _binned("b503x8", 32)
    r = T.train(binned, y, T.TrainConfig(**dict(BASE, num_iterations=2,
                                                **cfg_kw)),
                bin_upper=upper, device="cpu", mesh=mesh,
                group_ids=np.arange(len(y)) // 16 if groups else None,
                custom_objective=(lambda p, lab, w: (p - lab, p * 0 + 1))
                if custom else None)
    b = r.booster
    return ([np.asarray(a) for a in (b.split_feature, b.threshold_bin,
                                     b.node_value, b.count, b.tree_weights)],
            b.predict(x, device="cpu").numpy())


def _downgrades(mesh, fp_mesh):
    """The reference's downgrades and refusals under a mesh: {case:
    (hist_stats or the exception's type and message, warnings)}; the
    lifted settings' fits (``_lifted_fit``)."""
    from mmlspark_tpu_torch.models.gbdt import trainer as T
    x, y, binned, upper = _binned("b503x8", 32)
    out = {}

    def run(name, env_kw, **cfg_kw):
        saved = {k: os.environ.get(k) for k in env_kw}
        os.environ.update(env_kw)
        with warnings.catch_warnings(record=True) as rec:
            warnings.simplefilter("always")
            try:
                r = T.train(binned, y, T.TrainConfig(
                    **dict(BASE, num_iterations=1, **cfg_kw)),
                    device="cpu", mesh=mesh)
                got = r.hist_stats
            except (NotImplementedError, ValueError) as e:
                got = (type(e).__name__, str(e))
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
        out[name] = (got, [str(w.message) for w in rec])

    run("quant", {"MMLSPARK_TORCH_HIST_QUANT": "q16"})
    run("leafwise", {"MMLSPARK_TORCH_GROW_POLICY": "leafwise"})
    run("ooc", {"MMLSPARK_TORCH_OOC": "on"})
    run("shard_on_cat", {"MMLSPARK_TORCH_HIST_SHARD": "on"},
        categorical_features=(3,))
    run("shard_off", {"MMLSPARK_TORCH_HIST_SHARD": "off"})
    run("shard_bad", {"MMLSPARK_TORCH_HIST_SHARD": "sideways"})
    for what in ("categorical", "monotone", "extra_trees", "by_node"):
        kw = {"categorical": dict(categorical_features=(0,)),
              "monotone": dict(monotone_constraints=(1,)),
              "extra_trees": dict(extra_trees=True),
              "by_node": dict(feature_fraction_by_node=0.5)}[what]
        for learner in ("voting", "feature"):
            run(f"{learner}_{what}", {}, tree_learner=learner, **kw)
    for name in LIFTED:
        out[name] = _lifted_fit(name, mesh)
    # three columns over the fp ranks: divisible by neither 2 nor 4
    x3 = binned[:, :3]
    try:
        T.train(x3, y, T.TrainConfig(**dict(BASE, tree_learner="feature")),
                device="cpu", mesh=fp_mesh)
        out["feature_indivisible"] = None
    except ValueError as e:
        out["feature_indivisible"] = str(e)
    # a checkpointed estimator fit: only the mesh's first rank writes
    # (each rank names a directory of its own; hits of checkpoint.write
    # are counted under a fault armed never to fire)
    out["checkpoint"] = _checkpointed_fit(mesh, x, y)
    return out


def _checkpointed_fit(mesh, x, y):
    """{model string, this rank's ``checkpoint.write`` hits, the files of
    its checkpoint directory (None where it was never made)} of a
    checkpointed ``LightGBMClassifier`` fit, on ``mesh`` or serially."""
    from mmlspark_tpu_torch import DataFrame, LightGBMClassifier
    from mmlspark_tpu_torch.core import faults
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = os.path.join(tmp, "ckpt")
        est = LightGBMClassifier(numIterations=2, numLeaves=7, maxBin=32,
                                 checkpointInterval=1, checkpointDir=ckpt
                                 ).set_device("cpu").set_mesh(mesh)
        faults.reset()
        with faults.injected("checkpoint.write", "delay", nth=10 ** 9):
            model = est.fit(DataFrame({"features": x, "label": y}))
            hits = faults.hits("checkpoint.write")
        faults.reset()
        return {"model": model.get_model_string(), "hits": hits,
                "files": (sorted(os.listdir(ckpt)) if os.path.isdir(ckpt)
                          else None)}


def _run_cases(world: int, downgrades: bool = True):
    """Every case on this rank of a ``world``-rank default process group:
    {case: record}, the estimators', and (``downgrades``) the
    downgrades'."""
    from mmlspark_tpu_torch.parallel.mesh import MeshConfig, create_mesh
    mesh = create_mesh()
    fp_mesh = create_mesh(MeshConfig(dp=1, fp=world))
    res = {}
    for name, case in CASES.items():
        learner = case[2].get("tree_learner")
        res[name] = _fit_case(name, fp_mesh if learner == "feature" else mesh)
    res["estimator"] = {p: _estimator_case(
        fp_mesh if p == "feature_parallel" else mesh, p)
        for p in ("data_parallel", "voting_parallel", "feature_parallel")}
    if downgrades:
        res["downgrades"] = _downgrades(mesh, fp_mesh)
    return res


def _worker(rank: int, world: int, init_file: str, out_dir: str) -> None:
    from datetime import timedelta

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=60))
    try:
        res = _run_cases(world)
        with open(pathlib.Path(out_dir) / f"rank{rank}.pkl", "wb") as fh:
            pickle.dump(res, fh)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """{world: [per-rank results]}, every world run once: 2 and 4 in
    processes of their own, 1 in this process while they run (without
    the downgrades, whose once-per-process warnings would be spent
    here)."""
    import torch.distributed as dist

    results = {}
    procs = {}
    bc = tmp_path_factory.mktemp("gbdt_data") / "breast_cancer.npz"
    x, y = _breast_cancer()
    np.savez(bc, x=x, y=y)
    for world in SPAWNED:
        out_dir = tmp_path_factory.mktemp(f"gbdt_world{world}")
        procs[world] = (out_dir, [subprocess.Popen(
            [sys.executable, __file__, str(rank), str(world),
             str(out_dir / "store"), str(out_dir)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env={**os.environ, BC_ENV: str(bc)})
            for rank in range(world)])
    try:
        store = tmp_path_factory.mktemp("gbdt_world1") / "store"
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                world_size=1, rank=0)
        try:
            results[1] = [_run_cases(1, downgrades=False)]
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
    """The port's serial fits of every case, in this process."""
    return {name: _fit_case(name, None) for name in CASES}


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8).tobytes()


def _same_fit(got, want):
    for a, b in zip(got["trees"], want["trees"]):
        assert a.shape == b.shape and _bits(a) == _bits(b)
    assert _bits(got["raw"]) == _bits(want["raw"])
    assert json.dumps(got["evals"]) == json.dumps(want["evals"])
    assert got["best"] == want["best"]


# --- the contract: bitwise the serial fit, on every rank ----------------------

CONTRACT = [n for n in CASES if not n.startswith("ref_")] + [
    "ref_feature", "ref_voting", "ref_bc", "ref_sep"]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", CONTRACT)
def test_learner_is_the_serial_fit_bit_for_bit(worlds, serial, world, name):
    for rank, res in enumerate(worlds[world]):
        _same_fit(res[name], serial[name])
    stats = worlds[world][0][name]["hist_stats"]
    learner = CASES[name][2].get("tree_learner")
    assert stats["grad_shard"] == ("off" if learner == "feature" else "dp")
    assert stats["hist_quant"] == "off" and stats["efb_bundles"] == 0
    # auto (unset) reduce-scatters the data learner's sums at dp > 1
    assert stats["hist_shard"] == (
        "off" if learner or world == 1 or name == "cat_mono"
        or CASES[name][3].get("HIST_SHARD") == "off" else "on")


@pytest.mark.parametrize("world", WORLDS)
def test_early_stopping_and_subtraction_under_a_mesh(worlds, serial, world):
    got = worlds[world][0]["l2_valid"]
    assert got["hist_stats"]["subtract"] is True        # data subtracts
    assert got["best"] == serial["l2_valid"]["best"] >= 0
    assert got["num_trees"] == serial["l2_valid"]["num_trees"]
    # the sharded learners never subtract
    assert worlds[world][0]["data_sharded"]["hist_stats"]["subtract"] is False


@pytest.mark.parametrize("world", WORLDS)
def test_histogram_traffic_is_hist_reduction_bytes(worlds, world):
    from mmlspark_tpu_torch.models.gbdt.parallel_modes import (
        hist_reduction_bytes)
    for name, sharded in (("data", False), ("data_sharded", True),
                          ("u16", True), ("multiclass", True)):
        key, max_bin, cfg_kw, _, _ = CASES[name]
        f = int(key.split("x")[1])
        per_tree = hist_reduction_bytes(f, max_bin, cfg_kw["max_depth"],
                                        world, sharded and world > 1,
                                        cell_bytes=8)
        for res in worlds[world]:
            assert res[name]["hist_bytes"] == \
                per_tree * res[name]["num_trees"]


def test_hist_reduction_bytes_keeps_the_reference_numbers():
    from mmlspark_tpu.models.gbdt.parallel_modes import (
        hist_reduction_bytes as jax_bytes)
    from mmlspark_tpu_torch.models.gbdt.parallel_modes import (
        hist_reduction_bytes)
    for args in ((28, 255, 6, 2, False), (28, 255, 6, 4, True),
                 (10, 32, 4, 4, True), (7, 1023, 5, 8, True)):
        assert hist_reduction_bytes(*args) == jax_bytes(*args)


@pytest.mark.parametrize("world", WORLDS)
def test_estimators_under_a_mesh(worlds, world):
    """``set_mesh(mesh).fit`` and ``transform`` through ``ShardedScorer``:
    the unmeshed model's string and scores, bit for bit."""
    want = _estimator_case(None, "serial")
    for res in worlds[world]:
        for par, got in res["estimator"].items():
            assert got["model"] == want["model"], par
            assert _bits(got["raw"]) == _bits(want["raw"]), par
            assert got["meta"]["shard_rules"] == "rules"
            assert got["meta"]["shard_rules_dp"] == (
                1 if par == "feature_parallel" else world)
    assert want["meta"]["shard_rules"] == "serial"


# --- downgrades and refusals ------------------------------------------------

def test_downgrades_and_refusals(worlds):
    d = worlds[2][0]["downgrades"]
    stats, warned = d["quant"]
    assert stats["hist_quant"] == "off"
    assert any("single-program only" in w for w in warned)
    stats, warned = d["leafwise"]
    assert stats["grow_policy"] == "depthwise"
    assert any("a device mesh is attached (leafwise is single-program)" in w
               for w in warned)
    stats, warned = d["ooc"]
    assert stats["ooc"] is False and stats["ooc_reason"] == \
        "a device mesh is attached (out-of-core is single-program)"
    stats, warned = d["shard_on_cat"]
    assert stats["hist_shard"] == "off"
    assert stats["hist_shard_reason"] == "categorical_features"
    assert any("cannot shard the histogram reduction" in w for w in warned)
    assert d["shard_off"][0]["hist_shard"] == "off"
    assert "hist_shard_reason" not in d["shard_off"][0]
    stats, warned = d["shard_bad"]
    assert stats["hist_shard"] == "on"
    assert any("'sideways' is not one of auto|off|on" in w for w in warned)
    ref = {"categorical": "categorical splits are implemented",
           "monotone": "monotone constraints are implemented",
           "extra_trees": "extra_trees is implemented",
           "by_node": "feature_fraction_by_node is implemented for the "
                      "serial/data tree learners — use tree_learner='data'"}
    for what, text in ref.items():
        for learner in ("voting", "feature"):
            kind, msg = d[f"{learner}_{what}"][0]
            assert kind == "NotImplementedError" and text in msg
            assert "ROADMAP" not in msg
    # DART, GOSS, lambdarank with query groups and a custom objective,
    # which raised naming ROADMAP A8b, fit: the serial fit bit for bit
    for what in LIFTED:
        trees, raw = d[what]
        want_trees, want_raw = _lifted_fit(what, None)
        for a, b in zip(trees, want_trees):
            assert a.shape == b.shape and _bits(a) == _bits(b), what
        assert _bits(raw) == _bits(want_raw), what
    assert "divisible by fp" in d["feature_indivisible"]
    # a checkpointed fit under a mesh fits, bitwise the serial
    # checkpointed fit, and writes once: on the mesh's first rank only
    x, y, _, _ = _binned("b503x8", 32)
    want = _checkpointed_fit(None, x, y)
    files = ["checkpoint_1.txt", "checkpoint_1.txt.crc32",
             "checkpoint_2.txt", "checkpoint_2.txt.crc32",
             "checkpoint_meta.json"]
    assert want["files"] == files and want["hits"] == 5
    for rank, res in enumerate(worlds[2]):
        got = res["downgrades"]["checkpoint"]
        assert got["model"] == want["model"], rank
        assert (got["hits"], got["files"]) == ((5, files) if rank == 0
                                               else (0, None)), rank


# --- the reference's mesh fits (JAX, 8-device CPU mesh) ---------------------

def _jax_fit(name, mesh, monkeypatch):
    from mmlspark_tpu.models.gbdt.trainer import TrainConfig, train
    from mmlspark_tpu.ops.binning import BinMapper
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    key, max_bin, cfg_kw, _, _ = CASES[name]
    x, y = _data(key)
    mapper = BinMapper.fit(x, max_bin=max_bin)
    cfg = TrainConfig(**cfg_kw)
    return train(mapper.transform(x), y, cfg,
                 bin_upper=mapper.bin_upper_values(cfg.max_bin),
                 mesh=mesh), x, y


def test_reference_data_parallel_criteria(worlds, serial, mesh8,
                                          monkeypatch):
    """``test_distributed.py:18-37`` (split agreement > 0.9, final
    logloss within 1e-4) and ``:51-`` (exact structure on well-separated
    gains), the port's data-parallel fits at P = 4 against the JAX
    package's on its 8-device mesh. The logloss clause is missed by
    1.3e-6 (ROADMAP C27), and the miss is the float32 plane's, not the
    learner's: the port's mesh fit is its serial fit bit for bit, the
    JAX mesh fit ends where the JAX serial fit does, and the port's
    serial fit ends the same 1.013e-4 from both (its fixed point sums
    pick another of two near-tied splits at tree 0's node 4). The gap is
    pinned so that it cannot grow unseen."""
    loss = "train_binary_logloss"
    jr, _, _ = _jax_fit("ref_bc", mesh8, monkeypatch)
    js, _, _ = _jax_fit("ref_bc", None, monkeypatch)
    got = worlds[4][0]["ref_bc"]
    agree = (np.asarray(jr.booster.split_feature) == got["trees"][0]).mean()
    assert agree > 0.9
    _same_fit(got, serial["ref_bc"])
    mesh_ll, serial_ll = jr.evals[-1][loss], js.evals[-1][loss]
    assert abs(mesh_ll - serial_ll) <= 1e-4   # the criterion, on the JAX side
    gap = abs(mesh_ll - got["evals"][-1][loss])
    assert gap == abs(serial_ll - serial["ref_bc"]["evals"][-1][loss])
    assert gap <= 1.013e-4
    jr, _, _ = _jax_fit("ref_sep", mesh8, monkeypatch)
    got = worlds[4][0]["ref_sep"]
    np.testing.assert_array_equal(np.asarray(jr.booster.split_feature),
                                  got["trees"][0])
    np.testing.assert_array_equal(np.asarray(jr.booster.threshold_bin),
                                  got["trees"][1])


def test_reference_parallel_modes_criteria(worlds, monkeypatch):
    """``test_parallel_modes.py:44`` (feature: identical splits, values
    within 1e-4), ``:64`` (voting at top_k = F: identical splits) and
    ``:75`` (voting at top_k = 2 still learns, accuracy > 0.85), the
    port's learners at P = 2 and 4 against the JAX package's on its
    fp = 8 / dp = 8 meshes."""
    from mmlspark_tpu.parallel.mesh import MeshConfig, create_mesh
    jf, _, _ = _jax_fit("ref_feature", create_mesh(MeshConfig(dp=1, fp=8)),
                        monkeypatch)
    jv, _, _ = _jax_fit("ref_voting", create_mesh(MeshConfig(dp=8)),
                        monkeypatch)
    for world in WORLDS:
        got = worlds[world][0]
        for jr, name in ((jf, "ref_feature"), (jv, "ref_voting")):
            np.testing.assert_array_equal(
                np.asarray(jr.booster.split_feature), got[name]["trees"][0])
            np.testing.assert_array_equal(
                np.asarray(jr.booster.threshold_bin), got[name]["trees"][1])
        np.testing.assert_allclose(np.asarray(jf.booster.node_value),
                                   got["ref_feature"]["trees"][2], atol=1e-4)
        _, y = _data(CASES["ref_voting_k2"][0])
        acc = ((got["ref_voting_k2"]["raw"] > 0) == (y > 0)).mean()
        assert acc > 0.85


def test_reference_hist_shard_criterion(worlds):
    """``test_hist_shard.py:72``: the reduce-scatter fit's trees and
    predictions are the full all-reduce's bit for bit at every dp, with
    a feature count (10) that dp = 4 does not divide."""
    for world in (2, 4):
        for res in worlds[world]:
            assert res["data_sharded"]["hist_stats"]["hist_shard"] == "on"
            assert res["data"]["hist_stats"]["hist_shard"] == "off"
            _same_fit(res["data_sharded"], res["data"])


# --- the mesh (this process) ----------------------------------------------

@pytest.mark.parametrize("config,devices", [
    ({}, 8), ({"dp": 2, "fp": 4}, 8), ({"fp": 2}, 8), ({"fp": 3}, 8),
    ({"dp": 2, "fp": 2}, 8), ({"dp": 1, "fp": 1}, 1)])
def test_mesh_config_resolves_as_the_reference(config, devices):
    from mmlspark_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
    from mmlspark_tpu_torch.parallel.mesh import MeshConfig

    def resolve(cls):
        try:
            return cls(**config).resolve(devices)
        except ValueError as e:
            return str(e)

    assert resolve(MeshConfig) == resolve(JaxMeshConfig)


def test_distributed_init_retries_a_failed_rendezvous(tmp_path):
    """A rendezvous that fails once (the ``distributed.init`` fault
    point) is retried; the one-rank gloo mesh then has its axes, and a
    mesh needs a process group."""
    import torch.distributed as dist

    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.parallel import mesh as M

    with pytest.raises(RuntimeError, match="initialized"):
        M.create_mesh()
    with faults.injected("distributed.init", "raise", nth=1, count=1):
        M.distributed_init(f"file://{tmp_path}/store", world_size=1, rank=0,
                           backend="gloo")
    try:
        mesh = M.create_mesh(M.MeshConfig(dp=1, fp=1))
        assert (M.axis_size(mesh, "dp"), M.axis_size(mesh, "fp")) == (1, 1)
        assert (M.process_index(), M.process_count(),
                M.is_multiprocess()) == (0, 1, False)
        t = torch.arange(6, dtype=torch.int64)
        assert torch.equal(M.all_reduce(mesh, t), t)
        assert torch.equal(M.all_gather(mesh, t), t)
        assert torch.equal(M.reduce_scatter(mesh, t), t)
        assert mesh.bytes == {"other": 3 * 6 * 8}
        with pytest.raises(ValueError, match="!= 1 devices"):
            M.create_mesh(M.MeshConfig(dp=2))
    finally:
        dist.destroy_process_group()


# --- the sums entries' plain versions (this process) ------------------------

def _ids(rng, n, f, b):
    ids = torch.from_numpy(rng.integers(0, b, (n, f)).astype(np.int32))
    if b <= 256:
        return ids.to(torch.uint8)
    if b <= 65_536:
        return ids.to(torch.int16).view(torch.uint16)
    return ids


@pytest.mark.parametrize("b", [63, 1023, 70_000])
def test_shard_sums_round_to_the_one_pass_histogram(b):
    """Shards' int64 sums under the exponents of the global maxima and
    row count, added and rounded once, are ``level_histogram`` on the
    whole rows bit for bit (uint8, uint16 and int32 ids), with a
    channel whose maximum lies on one shard only and an empty shard."""
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    rng = np.random.default_rng(b)
    n, f, width = 600, 5, 4
    binned = _ids(rng, n, f, b)
    grad = torch.from_numpy(rng.normal(size=n).astype(np.float32))
    hess = torch.from_numpy(rng.uniform(0.1, 1, size=n).astype(np.float32))
    grad[517] = 1e4                       # the grad maximum: last shard only
    live = torch.from_numpy((rng.uniform(size=n) > 0.2).astype(np.float32))
    live[517] = 1.0
    local = torch.from_numpy(rng.integers(0, width, n))
    want = H.level_histogram(binned, grad, hess, live, local, width, f, b)
    cuts = [0, 0, 250, 251, n]            # an empty shard, a one-row one
    spans = list(zip(cuts, cuts[1:]))
    amaxes = [H.level_histogram_amax(grad[a:z], hess[a:z], live[a:z])
              for a, z in spans]
    assert float(amaxes[-1][0]) == 1e4 and all(
        float(m[0]) < 1e4 for m in amaxes[:-1])
    exps = H.fixed_point_exponents(torch.stack(amaxes).amax(0), n)
    acc = torch.zeros((width, f, b, 3), dtype=torch.int64)
    for a, z in spans:
        H.level_histogram_sums(binned[a:z], grad[a:z], hess[a:z], live[a:z],
                               local[a:z], width, f, b, exps, acc)
    got = H.fixed_point_round(acc, exps)
    assert got.is_contiguous() and want.is_contiguous()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    # the exponents of a shard's own rows and count would not do
    own = H.fixed_point_exponents(amaxes[1], 250)
    assert not torch.equal(own, exps)


def test_sums_entries_refuse_bad_buffers():
    from mmlspark_tpu_torch.models.gbdt import hist_cuda as H
    binned = torch.zeros((4, 2), dtype=torch.uint8)
    v = torch.ones(4)
    exps = torch.zeros(3, dtype=torch.int64)
    with pytest.raises(ValueError, match="acc must be"):
        H.level_histogram_sums(binned, v, v, v, torch.zeros(4,
                               dtype=torch.int64), 1, 2, 4, exps,
                               torch.zeros((1, 2, 4, 3), dtype=torch.int32))
    with pytest.raises(ValueError, match="exps must be"):
        H.fixed_point_round(torch.zeros((1, 2, 4, 3), dtype=torch.int64),
                            exps.to(torch.int32))
    assert torch.equal(H.level_histogram_amax(v[:0], v[:0], v[:0]),
                       torch.zeros(3))


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
