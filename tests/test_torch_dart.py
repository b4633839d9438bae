"""DART in the port (``boosting_type="dart"`` through the host loop,
``models/gbdt/host_loop.py``) against the JAX package's ``_train_loop``
on the same seeded numpy inputs, on the CPU.

The JAX side pins its histogram formulation to ``per_feature`` (ROADMAP
C1), EFB and out-of-core training off. Tolerances, by case:

  - on the q8 plane on both sides (ROADMAP C3), regression labels: every
    booster array bit for bit, the tree weights (Python floats in both
    loops, float32 in the booster) included, so the drops are the
    reference's; evals within ``rtol=1e-6`` (torch and XLA reduce a
    metric's sum in other orders);
  - on the float32 plane: the drops and the float32 tree weights bit for
    bit, split features, bins and counts exact, node values within
    ``rtol=1e-5`` (bin sums are reduced in other orders);
  - multiclass on q8 with XLA's ``exp`` values (ROADMAP C10): bit for
    bit, tree i a tree of class i % K;
  - early stopping on q8: the reference's stop iteration, best
    iteration and kept weights bit for bit, its validation metrics
    within ``rtol=1e-6`` (validation scores take each new tree times its
    weight and are never rescaled for dropped trees, ROADMAP C21);
  - scoring a DART booster: ``predict_binned`` as the JAX booster scores
    it, within ``atol=1e-6``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.models.gbdt import estimators, trainer
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
from mmlspark_tpu_torch.ops.binning import BinMapper

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

ARRAYS = ("split_feature", "threshold_bin", "threshold_value", "node_value",
          "count", "tree_weights")
MAX_BIN = 32
BASE = dict(objective="regression", boosting_type="dart", num_iterations=10,
            num_leaves=8, max_depth=3, max_bin=MAX_BIN, min_data_in_leaf=10,
            learning_rate=0.3)


@pytest.fixture(autouse=True)
def _pin_reference(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")
    for name in ("MMLSPARK_TPU_PALLAS_HIST", "MMLSPARK_TPU_HIST_QUANT",
                 "MMLSPARK_TPU_HIST_SUB", "MMLSPARK_TPU_GROW_POLICY",
                 trainer.HIST_QUANT_ENV, trainer.HIST_SUB_ENV,
                 trainer.GROW_POLICY_ENV):
        monkeypatch.delenv(name, raising=False)


def _q8(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_QUANT", "q8")
    monkeypatch.setenv(trainer.HIST_QUANT_ENV, "q8")


def _data(n=800, f=5, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = 2.0 * x[:, 0] - x[:, 1] + 0.5 * x[:, 2] * x[:, 3] \
        + rng.normal(size=n) * 0.1
    return x, y


def _binned(x):
    m = BinMapper.fit(x, max_bin=MAX_BIN)
    return m.transform(x), m.bin_upper_values(MAX_BIN)


def _fit_both(binned, y, bin_upper, **kw):
    cfg = dict(BASE, **kw)
    jr = jax_trainer.train(binned.astype(np.int32), y,
                           jax_trainer.TrainConfig(**cfg),
                           bin_upper=bin_upper)
    pr = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                       bin_upper=bin_upper, device="cpu")
    return pr, jr


def _assert_boosters_equal(got, want):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.init_score == want.init_score


def _assert_evals_match(port_evals, jax_evals):
    assert [list(e) for e in port_evals] == [list(e) for e in jax_evals]
    for pe, je in zip(port_evals, jax_evals):
        for k in je:
            np.testing.assert_allclose(pe[k], je[k], rtol=1e-6)


DROPS = {
    "lightgbm_defaults": {},
    "skip_drop_0": dict(skip_drop=0.0, drop_rate=0.3),
    "skip_drop_1": dict(skip_drop=1.0, drop_rate=0.3),
    "uniform_drop": dict(skip_drop=0.0, drop_rate=0.4, uniform_drop=True),
    "max_drop_1": dict(skip_drop=0.0, drop_rate=0.9, max_drop=1),
    "drop_seed": dict(skip_drop=0.0, drop_rate=0.3, drop_seed=11),
    "bagged": dict(skip_drop=0.2, drop_rate=0.3, bagging_fraction=0.6,
                   bagging_freq=2, feature_fraction=0.6, seed=3),
}


@pytest.mark.parametrize("case", sorted(DROPS))
def test_dart_fit_is_jax_bitwise_on_q8(monkeypatch, case):
    """Every drop setting, and the host loop's numpy bagging and
    feature-fraction streams (the reference's bits, ROADMAP C22)."""
    _q8(monkeypatch)
    x, y = _data()
    binned, bin_upper = _binned(x)
    pr, jr = _fit_both(binned, y, bin_upper, **DROPS[case])
    _assert_boosters_equal(pr.booster, jr.booster)
    _assert_evals_match(pr.evals, jr.evals)
    assert pr.hist_stats["grow_policy"] == "depthwise"
    assert pr.step_stats == {"captured": False, "capture_s": None,
                             "host_loop": {}}
    weights = pr.booster.tree_weights
    if case == "skip_drop_1":
        np.testing.assert_array_equal(weights, np.ones(10, np.float32))
    else:
        assert (weights < 1).any()           # some iteration dropped
    if case == "max_drop_1":
        # one tree dropped per iteration: new trees weigh 1/2
        assert set(np.round(weights[1:], 6)) <= {0.5, 0.25, 0.125,
                                                 0.0625, 0.03125,
                                                 0.015625, 0.007812}
    want = np.asarray(jr.booster.predict_binned_jit()(
        binned.astype(np.uint8)))
    got = pr.booster.predict_binned(binned.astype(np.uint8),
                                    device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_drop_settings_change_the_ensemble(monkeypatch):
    """As the reference's ``test_dart_drop_controls``: other drop seeds,
    ``uniform_drop`` and ``max_drop`` give other weights."""
    _q8(monkeypatch)
    x, y = _data()
    binned, bin_upper = _binned(x)
    kw = dict(BASE, skip_drop=0.0, drop_rate=0.5)
    fits = {name: trainer.train(binned, y, trainer.TrainConfig(
        **dict(kw, **extra)), bin_upper=bin_upper, device="cpu").booster
        for name, extra in (("s1", {"drop_seed": 11}),
                            ("s2", {"drop_seed": 12}),
                            ("uni", {"uniform_drop": True}),
                            ("cap", {"max_drop": 1}))}
    assert not np.allclose(fits["s1"].tree_weights, fits["s2"].tree_weights)
    for name in ("uni", "cap"):
        assert not np.array_equal(fits[name].tree_weights,
                                  fits["s1"].tree_weights)


def test_dart_fit_on_float32_plane_keeps_the_drops():
    x, y = _data()
    binned, bin_upper = _binned(x)
    pr, jr = _fit_both(binned, y, bin_upper, skip_drop=0.0, drop_rate=0.3)
    pb, jb = pr.booster, jr.booster
    np.testing.assert_array_equal(pb.tree_weights, jb.tree_weights)
    for name in ("split_feature", "threshold_bin", "count"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(jb, name))
    np.testing.assert_allclose(pb.node_value, jb.node_value, rtol=1e-5,
                               atol=1e-7)
    assert pr.hist_stats["hist_quant"] == "off"


def test_dart_multiclass_trees_by_class(monkeypatch):
    """K = 3 trees per iteration; tree i is class i % K, its drops and
    rescales on that class's column."""
    _q8(monkeypatch)
    monkeypatch.setattr(torch, "exp", lambda t: torch.from_numpy(
        np.array(jnp.exp(t.numpy()))))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(600, 5))
    y = np.argmax(x[:, :3] + 0.3 * rng.normal(size=(600, 3)), axis=1) \
        .astype(np.float64)
    binned, bin_upper = _binned(x)
    pr, jr = _fit_both(binned, y, bin_upper, objective="multiclass",
                       num_class=3, num_iterations=6, skip_drop=0.0,
                       drop_rate=0.4)
    _assert_boosters_equal(pr.booster, jr.booster)
    assert pr.booster.num_class == 3 and pr.booster.num_trees == 18
    assert (pr.booster.tree_weights < 1).any()
    for je, pe in zip(jr.evals, pr.evals):
        for k in je:
            np.testing.assert_allclose(pe[k], je[k], rtol=1e-5)


@pytest.mark.parametrize("esr", [2, 4])
def test_dart_early_stopping_is_the_references(monkeypatch, esr):
    """The stop iteration, the best iteration and the kept trees'
    weights (rescaled by the drops up to the stop) are the reference's;
    so are the validation metrics (ROADMAP C21)."""
    _q8(monkeypatch)
    x, y = _data(n=1000)
    binned, bin_upper = _binned(x)
    cut = 700
    cfg = dict(BASE, num_iterations=40, learning_rate=1.0, skip_drop=0.0,
               drop_rate=0.3, early_stopping_round=esr)
    valid = (binned[cut:], y[cut:], None)
    jr = jax_trainer.train(
        binned[:cut].astype(np.int32), y[:cut],
        jax_trainer.TrainConfig(**cfg), bin_upper=bin_upper,
        valid_sets=[(valid[0].astype(np.int32),) + valid[1:]])
    pr = trainer.train(binned[:cut], y[:cut], trainer.TrainConfig(**cfg),
                       bin_upper=bin_upper, valid_sets=[valid],
                       device="cpu")
    assert len(jr.evals) < 40                  # the rule fired
    assert pr.best_iteration == jr.best_iteration
    _assert_evals_match(pr.evals, jr.evals)
    _assert_boosters_equal(pr.booster, jr.booster)
    assert pr.booster.num_trees == jr.best_iteration + 1


def test_custom_objective_under_dart(monkeypatch):
    """A numpy ``fobj`` (L2) under DART: the reference's fit with the same
    ``fobj`` bit for bit, and the port's named-objective DART fit."""
    _q8(monkeypatch)
    x, y = _data()
    binned, bin_upper = _binned(x)

    def l2(preds, labels, weights):
        p = np.asarray(preds, np.float32)
        return p - np.asarray(labels, np.float32), np.ones_like(p)

    cfg = dict(BASE, skip_drop=0.0, drop_rate=0.3)
    jr = jax_trainer.train(binned.astype(np.int32), y,
                           jax_trainer.TrainConfig(**cfg),
                           bin_upper=bin_upper, custom_objective=l2)
    pr = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                       bin_upper=bin_upper, custom_objective=l2,
                       device="cpu")
    named = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                          bin_upper=bin_upper, device="cpu")
    _assert_boosters_equal(pr.booster, jr.booster)
    _assert_boosters_equal(pr.booster, named.booster)


def test_dart_model_string_keeps_tree_weights(monkeypatch):
    """The string is the JAX booster's, and a load keeps the weights bit
    for bit. Leaves are written as value times weight (LightGBM's
    ``leaf_value``) and divided by it on load, in both packages, so the
    loaded node values and scores lie within float32 rounding
    (``rtol=1e-6``, ``atol=1e-6``) of the fitted ones."""
    _q8(monkeypatch)
    x, y = _data()
    binned, bin_upper = _binned(x)
    pr, jr = _fit_both(binned, y, bin_upper, skip_drop=0.0, drop_rate=0.3)
    booster = pr.booster
    text = booster.save_model_string()
    assert text == jr.booster.save_model_string()
    back = BoosterArrays.load_model_string(text)
    np.testing.assert_array_equal(back.tree_weights, booster.tree_weights)
    assert (back.tree_weights < 1).any()
    np.testing.assert_allclose(back.node_value, booster.node_value,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(back.predict(x, device="cpu").numpy(),
                               booster.predict(x, device="cpu").numpy(),
                               rtol=0, atol=1e-6)


def test_dart_estimator_matches_the_reference_estimator(monkeypatch):
    _q8(monkeypatch)
    x, y = _data(n=1000)
    params = dict(numIterations=8, numLeaves=8, maxBin=MAX_BIN,
                  boostingType="dart", dropRate=0.3, skipDrop=0.0,
                  learningRate=0.3)
    cols = {"features": x, "label": y}
    port = estimators.LightGBMRegressor(**params).set_device("cpu").fit(
        DataFrame(cols))
    ref = jax_est.LightGBMRegressor(**params).fit(JaxFrame(cols))
    _assert_boosters_equal(port.booster, ref.booster)
    np.testing.assert_array_equal(
        port.transform(DataFrame({"features": x}))["prediction"],
        ref.transform(JaxFrame({"features": x}))["prediction"])


def test_dart_classifier_with_early_stopping_and_pass_through(monkeypatch):
    """``LightGBMClassifier(boostingType="dart")`` with a validation
    indicator and early stopping fits and transforms; ``drop_seed=7``
    through ``passThroughArgs`` parses as an int and fits, as the
    reference's ``test_pass_through_binning_and_none_default_keys``."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1500, 6))
    y = (x[:, 0] - x[:, 1] + 0.3 * rng.normal(size=1500) > 0).astype(
        np.float64)
    frame = DataFrame({"features": x, "label": y,
                       "v": rng.random(1500) < 0.2})
    model = estimators.LightGBMClassifier(
        numIterations=30, numLeaves=8, boostingType="dart", dropRate=0.3,
        skipDrop=0.0, learningRate=0.5, validationIndicatorCol="v",
        earlyStoppingRound=3).set_device("cpu").fit(frame)
    assert model.booster.num_trees == model.best_iteration + 1
    prob = model.transform(frame)["probability"][:, 1]
    assert np.isfinite(prob).all() and ((prob > 0.5) == (y > 0)).mean() > 0.9
    m2 = estimators.LightGBMRegressor(
        passThroughArgs="drop_seed=7", boostingType="dart", numIterations=3,
        numLeaves=8).set_device("cpu").fit(DataFrame({"features": x,
                                                      "label": y}))
    assert m2.booster.num_trees == 3


@pytest.mark.parametrize("grow", ["depthwise", "leafwise"])
def test_dart_ranker_fits_and_transforms(monkeypatch, grow):
    """``LightGBMRanker(boostingType="dart")``: lambdarank over the
    groups' layout through the host loop, depthwise and leaf-wise; NDCG
    recorded per iteration and rising from the first tree."""
    monkeypatch.setenv(trainer.GROW_POLICY_ENV, grow)
    rng = np.random.default_rng(4)
    sizes = rng.integers(5, 30, size=60)
    gid = np.repeat(np.arange(60), sizes)
    x = rng.normal(size=(len(gid), 5))
    y = np.clip(np.round(x[:, 0] + 0.5 * x[:, 1]
                         + 0.5 * rng.normal(size=len(gid)) + 1.5), 0, 4)
    frame = DataFrame({"features": x, "label": y, "query": gid})
    model = estimators.LightGBMRanker(
        groupCol="query", evalAt=[5], numIterations=8, numLeaves=8,
        boostingType="dart", dropRate=0.3, skipDrop=0.0).set_device(
            "cpu").fit(frame)
    ndcg = [e["train_ndcg@5"] for e in model.evals_result]
    assert len(ndcg) == 8 and ndcg[-1] > ndcg[0]
    assert (model.booster.tree_weights < 1).any()
    pred = model.transform(DataFrame({"features": x}))["prediction"]
    assert pred.shape == (len(gid),) and np.isfinite(pred).all()


def test_unknown_boosting_type_raises():
    x, y = _data(n=100)
    binned, _ = _binned(x)
    with pytest.raises(ValueError, match="boosting_type='lambdamart'"):
        trainer.train(binned, y, trainer.TrainConfig(
            **dict(BASE, boosting_type="lambdamart")), device="cpu")
