"""The port's estimator layer (``LightGBMClassifier`` / ``LightGBMRegressor``
over ``DataFrame``, validation sets and early stopping, warm starts,
model strings, the JAX-model converter; ``set_device("cpu")``) against
the JAX package's estimators on the same seeded numpy inputs.

The JAX side pins its histogram formulation to ``per_feature`` (EFB and
out-of-core off), the path the port mirrors. Tolerances, by case:

  - integer-label L2, one tree, no boost-from-average: every histogram
    sum is an exact integer on both sides, so the booster and the
    ``prediction`` column are bit for bit equal;
  - many-tree L2 on the quantized plane (q16 on both sides, the data of
    ``test_torch_gbdt_quant``: bin-axis sums exact in float32), with a
    validation set and early stopping: trees bit for bit, the same
    ``best_iteration``, tree count and evals keys, eval values within
    ``rtol=1e-6`` (float32 metric sums in another order);
  - binary, float32 plane: splits, thresholds and counts equal, node
    values within ``rtol=1e-5, atol=1e-7`` and probabilities within
    ``atol=1e-5`` (``test_torch_gbdt_train._assert_close_fit``);
  - scoring: raw and binned transforms of one model bitwise equal; a
    JAX-fitted model carried across (model string, converter, saved
    directory) transforms bit for bit as it does in JAX;
  - the sklearn-anchored checks of ``tests/gbdt/test_golden_parity.py``
    (breast-cancer AUC, diabetes L2) hold for the port;
  - a custom objective (``fobj``) or a checkpointed fit on q16 (the data
    of ``test_torch_gbdt_quant``): the booster bit for bit.
"""

import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu.models.gbdt.booster import BoosterArrays as JaxBooster
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core.pipeline import PipelineStage
from mmlspark_tpu_torch.models.gbdt import estimators, trainer
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
from mmlspark_tpu_torch.models.gbdt.convert import (booster_from_jax_state,
                                                    model_from_jax)
from mmlspark_tpu_torch.ops.binning import BinMapper
from tests.test_torch_gbdt_quant import _fit_data

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

ARRAYS = ("split_feature", "threshold_bin", "threshold_value", "node_value",
          "count", "tree_weights")
MAX_BIN = 63


@pytest.fixture(autouse=True)
def _pin_reference(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")
    for name in ("MMLSPARK_TPU_PALLAS_HIST", "MMLSPARK_TPU_HIST_QUANT",
                 "MMLSPARK_TPU_HIST_SUB", "MMLSPARK_TPU_GROW_POLICY",
                 trainer.HIST_QUANT_ENV, trainer.HIST_SUB_ENV):
        monkeypatch.delenv(name, raising=False)


def _quant(monkeypatch, quant):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_QUANT", quant)
    monkeypatch.setenv(trainer.HIST_QUANT_ENV, quant)


def _data(n=3000, f=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < 0.03] = np.nan
    logit = 1.5 * np.nan_to_num(x[:, 0]) - np.nan_to_num(x[:, 1]) \
        + 0.5 * np.nan_to_num(x[:, 2] * x[:, 3])
    y_bin = (logit + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    y_int = np.clip(np.round(logit + 2), 0, 5)
    return x, y_bin, y_int


def _frames(cols):
    return DataFrame(cols), JaxFrame(cols)


def _fit_both(kind, cols, **params):
    """(port model, JAX model) of ``kind`` fitted on the same columns."""
    port_df, jax_df = _frames(cols)
    port = getattr(estimators, kind)(**params).set_device("cpu").fit(port_df)
    ref = getattr(jax_est, kind)(**params).fit(jax_df)
    return port, ref


def _assert_boosters_equal(a, b):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.init_score == b.init_score and a.max_depth == b.max_depth


def _assert_evals_match(port_evals, jax_evals):
    assert [list(e) for e in port_evals] == [list(e) for e in jax_evals]
    for pe, je in zip(port_evals, jax_evals):
        for k in je:
            np.testing.assert_allclose(pe[k], je[k], rtol=1e-6)


# --- train: validation sets and early stopping --------------------------------

def _es_case(n=2500):
    x, y, _ = _fit_data(n=n)
    mapper = BinMapper.fit(x, max_bin=MAX_BIN)
    binned = mapper.transform(x)
    cut = int(0.8 * n)
    return (binned[:cut], y[:cut], (binned[cut:], y[cut:], None),
            mapper.bin_upper_values(MAX_BIN))


@pytest.mark.parametrize("lr,esr,trees", [(0.3, 3, 40), (0.3, 0, 8),
                                          (1.0, 3, 40), (0.3, 10, 40)])
def test_train_with_early_stopping_is_bitwise_on_q16(monkeypatch, lr, esr,
                                                     trees):
    _quant(monkeypatch, "q16")
    binned, y, valid, bin_upper = _es_case()
    kw = dict(objective="regression", num_iterations=trees, learning_rate=lr,
              max_bin=MAX_BIN, max_depth=4, num_leaves=15,
              early_stopping_round=esr)
    jr = jax_trainer.train(binned, y, jax_trainer.TrainConfig(**kw),
                           bin_upper=bin_upper, valid_sets=[valid])
    pr = trainer.train(binned, y, trainer.TrainConfig(**kw),
                       bin_upper=bin_upper, valid_sets=[valid], device="cpu")
    assert pr.best_iteration == jr.best_iteration
    assert pr.booster.num_trees == jr.booster.num_trees
    if esr:
        assert 0 <= pr.best_iteration < trees - 1  # the rule fired
        assert pr.booster.num_trees == pr.best_iteration + 1
    else:
        assert pr.best_iteration == -1 and pr.booster.num_trees == trees
    _assert_boosters_equal(pr.booster, jr.booster)
    _assert_evals_match(pr.evals, jr.evals)
    assert list(pr.evals[0]) == ["iteration", "train_l2", "valid0_l2"]


def test_early_stopping_cuts_after_the_best_iteration_when_the_rule_never_fires(
        monkeypatch):
    """A stop round longer than the fit: the rule never fires, every
    iteration runs, and the trees are still cut after the best one, as
    in the reference."""
    _quant(monkeypatch, "q16")
    binned, y, valid, bin_upper = _es_case()
    trees = 30
    kw = dict(objective="regression", num_iterations=trees, learning_rate=1.0,
              max_bin=MAX_BIN, max_depth=4, num_leaves=15,
              early_stopping_round=trees)
    jr = jax_trainer.train(binned, y, jax_trainer.TrainConfig(**kw),
                           bin_upper=bin_upper, valid_sets=[valid])
    pr = trainer.train(binned, y, trainer.TrainConfig(**kw),
                       bin_upper=bin_upper, valid_sets=[valid], device="cpu")
    vals = [e["valid0_l2"] for e in pr.evals]
    assert len(pr.evals) == len(jr.evals) == trees  # the rule never fired
    assert trainer.stop_iteration(vals, trees, 0.0, False) == (
        pr.best_iteration, None)
    assert 0 <= pr.best_iteration == jr.best_iteration < trees - 1
    assert pr.booster.num_trees == jr.booster.num_trees == \
        pr.best_iteration + 1
    _assert_boosters_equal(pr.booster, jr.booster)
    _assert_evals_match(pr.evals, jr.evals)


def test_train_with_early_stopping_on_the_f32_plane_matches():
    """Binary on the float32 plane, AUC on two validation sets, learning
    rate 1.0 so the metric turns: the same stop, splits and counts; node
    values drift in float32 over the trees (each tree's gradients start
    from the last one's scores), so they are held to ``rtol=1e-4,
    atol=1e-5``."""
    x, y_bin, _ = _data()
    mapper = BinMapper.fit(x, max_bin=MAX_BIN)
    binned = mapper.transform(x)
    kw = dict(objective="binary", num_iterations=40, learning_rate=1.0,
              max_bin=MAX_BIN, max_depth=4, num_leaves=15,
              early_stopping_round=4, metric="auc")
    sets = [(binned[2000:], y_bin[2000:], None),
            (binned[:500], y_bin[:500], None)]
    jr = jax_trainer.train(binned[:2000], y_bin[:2000],
                           jax_trainer.TrainConfig(**kw), valid_sets=sets)
    pr = trainer.train(binned[:2000], y_bin[:2000], trainer.TrainConfig(**kw),
                       valid_sets=sets, device="cpu")
    assert 0 <= pr.best_iteration == jr.best_iteration < 35
    assert pr.booster.num_trees == jr.booster.num_trees == \
        pr.best_iteration + 1
    assert list(pr.evals[0]) == ["iteration", "train_auc", "valid0_auc",
                                 "valid1_auc"]
    for name in ("split_feature", "threshold_bin", "count"):
        np.testing.assert_array_equal(getattr(pr.booster, name),
                                      getattr(jr.booster, name))
    np.testing.assert_allclose(pr.booster.node_value, jr.booster.node_value,
                               rtol=1e-4, atol=1e-5)
    _assert_evals_match(pr.evals, jr.evals)


@pytest.mark.parametrize("tol", [0.0, 1e-3])
def test_stop_rule_matches_a_replay(tol):
    rng = np.random.default_rng(0)
    vals = list(np.cumsum(rng.normal(size=60)))
    for higher in (False, True):
        best, stop = trainer.stop_iteration(vals, 4, tol, higher)
        sign = 1 if higher else -1
        run, best_v, best_j = 0, -np.inf, -1
        for j, v in enumerate(vals):
            if sign * v - best_v > (tol if higher else -tol):
                best_v, best_j, run = sign * v, j, 0
            else:
                run += 1
                if run >= 4:
                    break
        assert (best, stop) == (best_j, j + 1)


def test_warm_start_continues_the_booster_bitwise(monkeypatch):
    _quant(monkeypatch, "q16")
    x, y, _ = _fit_data(n=2000)
    mapper = BinMapper.fit(x, max_bin=MAX_BIN)
    binned, bin_upper = mapper.transform(x), mapper.bin_upper_values(MAX_BIN)
    kw = dict(objective="regression", num_iterations=3, max_bin=MAX_BIN,
              max_depth=4, num_leaves=15)
    first = trainer.train(binned, y, trainer.TrainConfig(**kw),
                          bin_upper=bin_upper, device="cpu").booster
    jfirst = jax_trainer.train(binned, y, jax_trainer.TrainConfig(**kw),
                               bin_upper=bin_upper).booster
    _assert_boosters_equal(first, jfirst)
    init = trainer.warm_start_scores(first, x, device="cpu")
    np.testing.assert_array_equal(init,
                                  jax_trainer.warm_start_scores(jfirst, x))
    pr = trainer.train(binned, y, trainer.TrainConfig(**kw),
                       bin_upper=bin_upper, init_model=first, init_raw=init,
                       device="cpu")
    jr = jax_trainer.train(binned, y, jax_trainer.TrainConfig(**kw),
                           bin_upper=bin_upper, init_model=jfirst,
                           init_raw=init)
    assert pr.booster.num_trees == 6
    _assert_boosters_equal(pr.booster, jr.booster)
    with pytest.raises(ValueError, match="init_raw"):
        trainer.train(binned, y, trainer.TrainConfig(**kw), init_model=first,
                      device="cpu")


# --- the estimators ------------------------------------------------------------

def test_regressor_fit_and_transform_are_bitwise_on_integer_l2():
    x, _, y_int = _data()
    port, ref = _fit_both("LightGBMRegressor", {"features": x, "label": y_int},
                          numIterations=1, maxBin=MAX_BIN, numLeaves=15,
                          maxDepth=4, boostFromAverage=False)
    assert (ref.booster.split_feature >= 0).sum() > 3       # a real tree
    _assert_boosters_equal(port.booster, ref.booster)
    got = port.transform(DataFrame({"features": x}))
    want = ref.transform(JaxFrame({"features": x}))
    assert got.columns == want.columns == ["features", "prediction"]
    assert got["prediction"].dtype == np.float64
    np.testing.assert_array_equal(got["prediction"], want["prediction"])
    assert port.evals_result == ref.evals_result


def test_regressor_with_validation_and_early_stopping_is_bitwise(
        monkeypatch):
    _quant(monkeypatch, "q16")
    x, y, _ = _fit_data(n=2500)
    valid = np.arange(len(y)) >= 2000
    params = dict(numIterations=40, learningRate=0.3, maxBin=MAX_BIN,
                  numLeaves=15, maxDepth=4, earlyStoppingRound=3,
                  validationIndicatorCol="is_valid")
    port, ref = _fit_both("LightGBMRegressor",
                          {"features": x, "label": y, "is_valid": valid},
                          **params)
    assert port.best_iteration == ref.best_iteration >= 0
    assert port.booster.num_trees == port.best_iteration + 1
    _assert_boosters_equal(port.booster, ref.booster)
    _assert_evals_match(port.evals_result, ref.evals_result)
    np.testing.assert_array_equal(
        port.transform(DataFrame({"features": x}))["prediction"],
        ref.transform(JaxFrame({"features": x}))["prediction"])
    assert set(port.get_all_instrumentation()) >= {
        "extract", "binning", "dataPreparation", "training", "validation"}


@pytest.mark.parametrize("params", [
    {},
    {"isUnbalance": True},
    {"scalePosWeight": 3.0, "weightCol": "w"},
    {"thresholds": [0.3, 0.7], "lambdaL2": 1.0, "pathSmooth": 2.0},
    {"numBatches": 2, "metric": "binary_error"},
    {"initScoreCol": "init", "validationIndicatorCol": "v",
     "earlyStoppingRound": 2, "metric": "auc"},
])
def test_classifier_matches_jax(params):
    x, y_bin, _ = _data(seed=3)
    rng = np.random.default_rng(5)
    cols = {"features": x, "label": np.where(y_bin > 0, 7.0, -1.0),
            "w": rng.uniform(0.5, 2.0, size=len(y_bin)),
            "init": rng.normal(size=len(y_bin)) * 0.1,
            "v": rng.random(len(y_bin)) < 0.2}
    port, ref = _fit_both("LightGBMClassifier", cols, numIterations=8,
                          maxBin=MAX_BIN, numLeaves=15, **params)
    pb, jb = port.booster, ref.booster
    assert pb.num_trees == jb.num_trees and pb.init_score == jb.init_score
    for name in ("split_feature", "threshold_bin", "count"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(jb, name))
    np.testing.assert_array_equal(pb.threshold_value, jb.threshold_value)
    np.testing.assert_allclose(pb.node_value, jb.node_value, rtol=1e-5,
                               atol=1e-7)
    assert port.best_iteration == ref.best_iteration
    np.testing.assert_array_equal(port.classes_, ref.classes_)
    got = port.transform(DataFrame({"features": x}))
    want = ref.transform(JaxFrame({"features": x}))
    assert got.columns == want.columns
    np.testing.assert_allclose(got["probability"], want["probability"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["rawPrediction"], want["rawPrediction"],
                               rtol=0, atol=1e-5)
    close = np.abs(want["probability"][:, 1] - 0.5) < 1e-4
    if params.get("thresholds"):
        close = np.ones(len(close), bool)    # thresholds shift the cut
        np.testing.assert_array_equal(
            got["prediction"], np.where(got["probability"][:, 1] / 0.7
                                        > got["probability"][:, 0] / 0.3,
                                        7.0, -1.0))
    np.testing.assert_array_equal(got["prediction"][~close],
                                  want["prediction"][~close])
    assert set(np.unique(got["prediction"])) <= {7.0, -1.0}


def test_reply_columns_are_the_numpy_tail_of_predict():
    x, y_bin, _ = _data(n=1500, seed=4)
    model = estimators.LightGBMClassifier(
        numIterations=6, maxBin=MAX_BIN, numLeaves=15).set_device("cpu").fit(
        DataFrame({"features": x, "label": y_bin}))
    raw = model.booster.predict(x, device="cpu").numpy()
    out = model.transform(DataFrame({"features": x}))
    prob = 1.0 / (1.0 + np.exp(-raw))
    np.testing.assert_array_equal(out["rawPrediction"],
                                  np.stack([-raw, raw], 1))
    np.testing.assert_array_equal(out["probability"],
                                  np.stack([1 - prob, prob], 1))
    np.testing.assert_array_equal(out["prediction"],
                                  (prob > 1 - prob).astype(np.float64))
    binned = model.copy(binnedScoring=True).transform(
        DataFrame({"features": x}))
    for col in out.columns:
        np.testing.assert_array_equal(binned[col], out[col])


@pytest.mark.parametrize("start,num", [(0, 3), (2, -1), (4, 2)])
def test_iteration_slices_match_jax(start, num):
    x, y_bin, _ = _data(n=1200, seed=6)
    port, ref = _fit_both("LightGBMClassifier",
                          {"features": x, "label": y_bin}, numIterations=6,
                          maxBin=MAX_BIN, numLeaves=7)
    got = port.copy(startIteration=start, numIteration=num).transform(
        DataFrame({"features": x}))["rawPrediction"]
    sliced = ref.booster.slice_iterations(start, num)
    want = np.asarray(sliced.predict_jit()(x))
    np.testing.assert_allclose(got[:, 1], want, rtol=0, atol=1e-5)
    assert port.booster.slice_iterations(start, num).num_trees == \
        sliced.num_trees


def test_fit_incremental_matches_jax(monkeypatch):
    _quant(monkeypatch, "q16")
    x, y, _ = _fit_data(n=2000)
    params = dict(numIterations=2, maxBin=MAX_BIN, numLeaves=15, maxDepth=4)
    port, ref = _fit_both("LightGBMRegressor", {"features": x, "label": y},
                          **params)
    p2 = estimators.LightGBMRegressor(**params).set_device("cpu") \
        .fit_incremental(DataFrame({"features": x, "label": y}), port,
                         num_new_trees=3)
    j2 = jax_est.LightGBMRegressor(**params).fit_incremental(
        JaxFrame({"features": x, "label": y}), ref, num_new_trees=3)
    assert p2.booster.num_trees == 5
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(p2.booster, name),
                                      getattr(j2.booster, name))
    np.testing.assert_array_equal(
        p2.transform(DataFrame({"features": x}))["prediction"],
        j2.transform(JaxFrame({"features": x}))["prediction"])


def test_feature_importances_match_jax():
    x, y_bin, _ = _data(n=1500, seed=7)
    port, ref = _fit_both("LightGBMClassifier",
                          {"features": x, "label": y_bin}, numIterations=5,
                          maxBin=MAX_BIN, numLeaves=15)
    for kind in ("split", "gain"):
        np.testing.assert_allclose(port.get_feature_importances(kind),
                                   ref.get_feature_importances(kind),
                                   rtol=1e-4)


# --- model strings, the converter, saved models --------------------------------

def _jax_model(seed=8, trees=6):
    x, y_bin, _ = _data(n=1500, seed=seed)
    model = jax_est.LightGBMClassifier(numIterations=trees, maxBin=MAX_BIN,
                                       numLeaves=15).fit(
        JaxFrame({"features": x, "label": y_bin}))
    return x, model


def test_model_strings_cross_both_ways():
    x, ref = _jax_model()
    text = ref.get_model_string()
    port = BoosterArrays.load_model_string(text)
    jax_loaded = JaxBooster.load_model_string(text)
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(jax_loaded, name))
    assert (port.max_depth, port.init_score, port.num_features,
            port.objective) == (jax_loaded.max_depth, jax_loaded.init_score,
                                jax_loaded.num_features, jax_loaded.objective)
    assert port.decision_type is None
    # the same booster writes the same text in both packages
    state = {k: (np.asarray(v) if k != "booster_meta" else v)
             for k, v in ref.booster.state_dict().items()}
    carried = booster_from_jax_state(state)
    assert carried.save_model_string() == text
    # port -> JAX: the JAX package scores the port's string as the port
    # scores its own booster
    back = JaxBooster.load_model_string(carried.save_model_string())
    np.testing.assert_array_equal(
        np.asarray(back.predict_jit()(x)),
        carried.predict(x, device="cpu").numpy())
    np.testing.assert_array_equal(
        port.predict(x, device="cpu").numpy(),
        np.asarray(jax_loaded.predict_jit()(x)))
    with pytest.raises(ValueError, match="no binned thresholds"):
        port.predict_binned(np.zeros((2, x.shape[1]), np.uint8),
                            device="cpu")


def test_native_model_files_round_trip(tmp_path):
    x, ref = _jax_model(seed=9, trees=3)
    ref.save_native_model(str(tmp_path / "m.txt"))
    port = estimators.LightGBMClassificationModel \
        .load_native_model_from_file(str(tmp_path / "m.txt")) \
        .set_device("cpu")
    got = port.transform(DataFrame({"features": x}))
    want = ref.transform(JaxFrame({"features": x}))
    np.testing.assert_array_equal(got["rawPrediction"], want["rawPrediction"])


@pytest.mark.parametrize("binned", [False, True])
@pytest.mark.parametrize("kind,est", [
    ("LightGBMClassificationModel", "LightGBMClassifier"),
    ("LightGBMRegressionModel", "LightGBMRegressor")])
def test_jax_fitted_models_transform_bitwise_through_the_converter(
        kind, est, binned):
    x, y_bin, y_int = _data(n=1500, seed=11)
    ref = getattr(jax_est, est)(numIterations=7, maxBin=MAX_BIN,
                                numLeaves=15).fit(
        JaxFrame({"features": x,
                  "label": y_bin if "Class" in est else y_int}))
    ref.set("binnedScoring", binned)
    state = {k: (np.asarray(v) if hasattr(v, "shape") else v)
             for k, v in ref._get_state().items()}
    port = model_from_jax(kind, state, ref.simple_param_values())
    assert type(port).__name__ == kind and port.get("binnedScoring") == binned
    assert port._device is None                  # the card by default
    got = port.set_device("cpu").transform(DataFrame({"features": x}))
    want = ref.transform(JaxFrame({"features": x}))
    assert got.columns == want.columns
    for col in got.columns:
        np.testing.assert_array_equal(got[col], want[col])


def test_saved_model_round_trip(tmp_path):
    x, y_bin, _ = _data(n=1200, seed=12)
    model = estimators.LightGBMClassifier(
        numIterations=4, maxBin=MAX_BIN, numLeaves=15).set_device("cpu").fit(
        DataFrame({"features": x, "label": 2 * y_bin + 1}))
    model.save(str(tmp_path / "clf"))
    loaded = PipelineStage.load(str(tmp_path / "clf"))
    assert loaded._device is None                # a loaded model: the card
    got = loaded.set_device("cpu").transform(DataFrame({"features": x}))
    want = model.transform(DataFrame({"features": x}))
    for col in want.columns:
        np.testing.assert_array_equal(got[col], want[col])
    np.testing.assert_array_equal(loaded.classes_, [1.0, 3.0])
    assert loaded.bin_mapper.to_dict() == model.bin_mapper.to_dict()


# --- the sklearn anchors (tests/gbdt/test_golden_parity.py:154-224) -----------

def _auc(scores, labels):
    order = np.argsort(scores, kind="stable")
    ranks = np.empty(len(scores))
    ranks[order] = np.arange(1, len(scores) + 1)
    pos = labels == 1
    n1, n0 = pos.sum(), (~pos).sum()
    return (ranks[pos].sum() - n1 * (n1 + 1) / 2) / (n1 * n0)


def _one_openmp_thread():
    """sklearn's histogram GBDT on one OpenMP thread: its OpenMP runtime
    (not torch's, which the module pins) starts a thread per core, and
    under pytest-xdist beside busy workers each of its barriers waits
    for descheduled threads (a 200-tree fit took minutes instead of a
    fraction of a second). Its model does not depend on the count."""
    from threadpoolctl import threadpool_limits

    return threadpool_limits(limits=1, user_api="openmp")


def test_breast_cancer_auc_matches_sklearn_hgb():
    from sklearn.datasets import load_breast_cancer
    from sklearn.ensemble import HistGradientBoostingClassifier

    d = load_breast_cancer()
    idx = np.random.default_rng(0).permutation(len(d.target))
    cut = int(0.75 * len(idx))
    xtr, ytr = d.data[idx[:cut]], d.target[idx[:cut]].astype(np.float64)
    xte, yte = d.data[idx[cut:]], d.target[idx[cut:]].astype(np.float64)
    model = estimators.LightGBMClassifier(
        numIterations=100, numLeaves=31, learningRate=0.1) \
        .set_device("cpu").fit(DataFrame({"features": xtr, "label": ytr}))
    probs = model.transform(DataFrame({"features": xte, "label": yte}))
    ours = _auc(probs["probability"][:, 1], yte)
    with _one_openmp_thread():
        ref = HistGradientBoostingClassifier(
            max_iter=100, learning_rate=0.1, max_leaf_nodes=31,
            early_stopping=False, random_state=0).fit(xtr, ytr)
    theirs = _auc(ref.predict_proba(xte)[:, 1], yte)
    assert ours > 0.95
    assert ours >= theirs - 0.02, (ours, theirs)


def test_diabetes_l2_matches_sklearn_hgb():
    from sklearn.datasets import load_diabetes
    from sklearn.ensemble import HistGradientBoostingRegressor

    d = load_diabetes()
    idx = np.random.default_rng(1).permutation(len(d.target))
    cut = int(0.75 * len(idx))
    xtr, ytr = d.data[idx[:cut]], d.target[idx[:cut]]
    xte, yte = d.data[idx[cut:]], d.target[idx[cut:]]
    model = estimators.LightGBMRegressor(
        numIterations=200, numLeaves=15, learningRate=0.05) \
        .set_device("cpu").fit(DataFrame({"features": xtr, "label": ytr}))
    pred = model.transform(
        DataFrame({"features": xte, "label": yte}))["prediction"]
    ours = float(np.mean((pred - yte) ** 2))
    with _one_openmp_thread():
        ref = HistGradientBoostingRegressor(
            max_iter=200, learning_rate=0.05, max_leaf_nodes=15,
            early_stopping=False, random_state=0).fit(xtr, ytr)
    theirs = float(np.mean((ref.predict(xte) - yte) ** 2))
    assert ours <= theirs * 1.25, (ours, theirs)


# --- what the slice does not take ----------------------------------------------

@pytest.mark.parametrize("kind,params,item", [
    # without a mesh voting_parallel and feature_parallel train serially,
    # as the JAX estimators do: each setting beside them fits as it does
    # beside parallelism="serial" (the cases that raised for maxBin past
    # 65,536 keep their ids; ``item`` names the ROADMAP item that brought
    # the learners, A8; under a mesh they are tests/test_torch_dist_gbdt.py's)
    ("LightGBMClassifier", {"boostingType": "goss", "extraTrees": True,
                            "parallelism": "voting_parallel"}, "A8"),
    pytest.param("LightGBMClassifier", {
        "boostingType": "dart", "maxBin": 70_000,
        "parallelism": "feature_parallel"}, "A8",
        id="LightGBMClassifier-params1-A7"),
    pytest.param("LightGBMClassifier", {
        "featureFraction": 0.5, "featureFractionByNode": 0.5,
        "boostingType": "dart", "maxBin": 70_000,
        "parallelism": "voting_parallel"}, "A8",
        id="LightGBMClassifier-params2-A7"),
    ("LightGBMClassifier", {"featureFractionByNode": 0.5,
                            "boostingType": "dart",
                            "parallelism": "voting_parallel"}, "A8"),
    pytest.param("LightGBMClassifier", {
        "baggingFraction": 0.5, "baggingFreq": 1, "boostingType": "dart",
        "maxBin": 70_000, "parallelism": "voting_parallel"}, "A8",
        id="LightGBMClassifier-params4-A7"),
    ("LightGBMClassifier", {"posBaggingFraction": 0.5,
                            "boostingType": "dart",
                            "parallelism": "feature_parallel"}, "A8"),
    pytest.param("LightGBMClassifier", {
        "extraTrees": True, "maxBin": 70_000,
        "parallelism": "feature_parallel"}, "A8",
        id="LightGBMClassifier-params6-A7"),
    ("LightGBMClassifier", {"monotoneConstraints": [1, 0, 0, 0, 0, 0],
                            "parallelism": "feature_parallel"}, "A8"),
    ("LightGBMClassifier", {"parallelism": "voting_parallel"}, "A8"),
    ("LightGBMClassifier", {"parallelism": "feature_parallel"}, "A8"),
    pytest.param("LightGBMRegressor", {
        "passThroughArgs": "bagging_fraction=0.5 bagging_freq=1 "
                           "boosting_type=dart max_bin=70000 "
                           "tree_learner=voting"}, "A8",
        id="LightGBMRegressor-params10-A7"),
])
def test_settings_outside_the_slice_raise(kind, params, item):
    x, y_bin, _ = _data(n=300)
    frame = DataFrame({"features": x, "label": y_bin})

    def fit(**over):
        return getattr(estimators, kind)(
            **{"numIterations": 2, **params, **over}).set_device("cpu").fit(
                frame).get_model_string()

    serial = ({"passThroughArgs": params["passThroughArgs"].replace(
        "tree_learner=voting", "tree_learner=serial")}
        if "passThroughArgs" in params else {"parallelism": "serial"})
    assert item == "A8" and fit() == fit(**serial)


def test_multiclass_ranker_mesh_and_serving_raise():
    """Multiclass labels and the ranker fit (their parity tests are
    ``tests/test_torch_multiclass.py`` and ``tests/test_torch_ranking.py``);
    ``set_mesh`` takes a ``parallel.mesh.Mesh`` (multi-device fits are
    tests/test_torch_dist_gbdt.py's), and the binned plane refuses the
    leaf column."""
    x, _, y_int = _data(n=300)
    model = estimators.LightGBMClassifier(numIterations=2).set_device(
        "cpu").fit(DataFrame({"features": x, "label": y_int}))
    k = len(np.unique(y_int))
    assert k > 2 and model.booster.num_class == k
    assert model.booster.num_trees == 2 * k
    assert isinstance(estimators.LightGBMRanker(),
                      estimators.LightGBMRanker)
    with pytest.raises(TypeError, match="Mesh"):
        estimators.LightGBMClassifier().set_mesh(object())
    model = estimators.LightGBMRegressor(numIterations=1).set_device(
        "cpu").fit(DataFrame({"features": x, "label": y_int}))
    with pytest.raises(estimators.BinnedServingUnsupported,
                       match="leafPredictionCol"):
        model.copy(leafPredictionCol="l").serving_binned_plan()
    # such a model is served through transform, which takes the column
    leaves = model.copy(leafPredictionCol="l").transform(
        DataFrame({"features": x}))["l"]
    np.testing.assert_array_equal(
        leaves, model.booster.leaf_index(x, device="cpu").numpy())


def test_regressor_lambdarank_needs_group_ids():
    """Lambdarank without query groups raises the JAX package's
    ``ValueError``, in both packages."""
    x, _, y_int = _data(n=300)
    with pytest.raises(ValueError, match="lambdarank requires group_ids"):
        jax_est.LightGBMRegressor(objective="lambdarank").fit(
            JaxFrame({"features": x, "label": y_int}))
    with pytest.raises(ValueError, match="lambdarank requires group_ids"):
        estimators.LightGBMRegressor(objective="lambdarank").set_device(
            "cpu").fit(DataFrame({"features": x, "label": y_int}))


# --- custom objectives, checkpoints and the other objectives -------------------

def _l2_fobj(preds, labels, weights):
    return preds - labels, torch.ones_like(preds)


def test_regressor_fobj_equals_the_named_objective():
    x, _, y_int = _data(n=400)
    df = DataFrame({"features": x, "label": y_int})
    params = dict(numIterations=4, maxBin=MAX_BIN, numLeaves=8)
    named = estimators.LightGBMRegressor(**params).set_device("cpu").fit(df)
    custom = estimators.LightGBMRegressor(fobj=_l2_fobj, **params) \
        .set_device("cpu").fit(df)
    _assert_boosters_equal(custom.booster, named.booster)
    assert custom.evals_result == named.evals_result


def test_regressor_fobj_matches_the_jax_fobj(monkeypatch):
    """The same numpy fobj (``np.asarray`` on its inputs) through both
    estimators, on q16 with the quantization tests' data (bin sums exact
    in float32): the booster bit for bit."""
    _quant(monkeypatch, "q16")
    x, y, _ = _fit_data(n=800)

    def fobj(p, yy, w):
        p = np.asarray(p, dtype=np.float32)
        return p - np.asarray(yy, dtype=np.float32), np.ones_like(p)
    port, ref = _fit_both("LightGBMRegressor", {"features": x, "label": y},
                          fobj=fobj, numIterations=5, maxBin=MAX_BIN,
                          numLeaves=15, maxDepth=4)
    _assert_boosters_equal(port.booster, ref.booster)
    _assert_evals_match(port.evals_result, ref.evals_result)


def test_checkpoint_interval_without_dir_is_a_value_error():
    x, y_bin, _ = _data(n=300)
    with pytest.raises(ValueError, match="requires checkpointDir"):
        estimators.LightGBMRegressor(checkpointInterval=2).set_device(
            "cpu").fit(DataFrame({"features": x, "label": y_bin}))


def test_checkpointed_regressor_matches_jax(monkeypatch, tmp_path):
    _quant(monkeypatch, "q16")
    x, y, _ = _fit_data(n=800)
    port_df, jax_df = _frames({"features": x, "label": y})
    params = dict(numIterations=6, maxBin=MAX_BIN, numLeaves=15, maxDepth=4,
                  checkpointInterval=4)
    port = estimators.LightGBMRegressor(
        checkpointDir=str(tmp_path / "port"), **params).set_device(
            "cpu").fit(port_df)
    ref = jax_est.LightGBMRegressor(checkpointDir=str(tmp_path / "jax"),
                                    **params).fit(jax_df)
    _assert_boosters_equal(port.booster, ref.booster)
    for d in ("port", "jax"):
        names = sorted(p.name for p in (tmp_path / d).iterdir())
        assert names == ["checkpoint_4.txt", "checkpoint_4.txt.crc32",
                         "checkpoint_6.txt", "checkpoint_6.txt.crc32",
                         "checkpoint_meta.json"]
        assert (tmp_path / d / "checkpoint_6.txt").read_text() == \
            port.get_model_string()


@pytest.mark.parametrize("objective", ["quantile", "poisson", "huber"])
def test_regressor_takes_the_other_objectives(objective):
    rng = np.random.default_rng(2)
    x, _, y_int = _data(n=400)
    y = y_int + rng.random(400)
    model = estimators.LightGBMRegressor(
        objective=objective, numIterations=3, maxBin=MAX_BIN,
        numLeaves=8).set_device("cpu").fit(
            DataFrame({"features": x, "label": y}))
    assert model.booster.objective == objective
    pred = model.transform(DataFrame({"features": x}))["prediction"]
    raw = model.booster.predict(x, device="cpu").numpy()
    want = np.exp(raw) if objective == "poisson" else raw
    np.testing.assert_array_equal(pred, want.astype(np.float64))
    loaded = estimators.LightGBMRegressionModel \
        .load_native_model_from_string(model.get_model_string())
    assert loaded.booster.objective == objective


def test_fit_incremental_takes_checkpoint_arguments(tmp_path):
    x, _, y_int = _data(n=400)
    df = DataFrame({"features": x, "label": y_int})
    est = estimators.LightGBMRegressor(numIterations=3, maxBin=MAX_BIN,
                                       numLeaves=8).set_device("cpu")
    base = est.fit(df)
    ckdir = str(tmp_path / "ck")
    got = est.fit_incremental(df, base, num_new_trees=4,
                              checkpoint_dir=ckdir, checkpoint_interval=2)
    want = est.copy(modelString=base.get_model_string(), numIterations=4,
                    checkpointDir=str(tmp_path / "b"),
                    checkpointInterval=2).fit(df)
    assert got.booster.num_trees == 7
    assert got.get_model_string() == want.get_model_string()
    assert sorted(n for n in os.listdir(ckdir)
                  if n.endswith(".txt")) == ["checkpoint_2.txt",
                                             "checkpoint_4.txt"]


def test_the_card_unless_asked_for_the_cpu():
    x, y_bin, _ = _data(n=300)
    df = DataFrame({"features": x, "label": y_bin})
    est = estimators.LightGBMClassifier(numIterations=2)
    assert est._device is None
    model = est.copy().set_device("cpu").fit(df)
    assert model._device == "cpu"            # a fitted model inherits it
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        est.fit(df)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.set_device(None).transform(df)


def test_raw_scoring_rounds_bin_edges_to_float32_as_jax_does():
    """Raw-threshold scoring compares float32(x) with float32(edge), in
    both packages; training (and binned scoring) compare x with the
    float64 edge. Where the float64 midpoint of two adjacent float32
    values rounds up to the upper one, rows holding it route left in raw
    scoring and right in binned scoring — in the port as in JAX."""
    a = np.nextafter(np.float32(1.0), np.float32(2.0))
    b = np.nextafter(a, np.float32(2.0))
    assert np.float32((np.float64(a) + np.float64(b)) / 2) == b
    n = 400
    x = np.where(np.arange(n) % 2 == 0, a, b).astype(np.float64)[:, None]
    y = (x[:, 0] == b).astype(np.float64)
    port, ref = _fit_both("LightGBMRegressor", {"features": x, "label": y},
                          numIterations=1, maxBin=MAX_BIN, numLeaves=2,
                          maxDepth=1, minDataInLeaf=1, boostFromAverage=False,
                          learningRate=1.0)
    ref.set("binnedScoring", True)
    for binned in (False, True):
        got = port.copy(binnedScoring=binned).transform(
            DataFrame({"features": x}))["prediction"]
        want = ref.copy(binnedScoring=binned).transform(
            JaxFrame({"features": x}))["prediction"]
        np.testing.assert_array_equal(got, want)
        # binned: each value its own leaf; raw: b rows routed with a's
        assert (got[y == 1] == (1.0 if binned else 0.0)).all()
