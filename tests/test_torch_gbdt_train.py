"""The port's GBDT slice (binning -> train -> scoring, ``device="cpu"``)
against the JAX package's ``train`` on the same numpy inputs.

The JAX reference pins its histogram formulation to ``per_feature``
(and turns EFB and out-of-core training off), the path the port
mirrors. Tolerances, by case:

  - integer-label L2, one tree, no boost-from-average: every histogram
    sum is an exact integer, so every ``BoosterArrays`` array must be
    bit for bit equal;
  - binary, 5 trees: split features and bins equal per tree,
    ``node_value`` / ``count`` to ``rtol=1e-5`` (counts exact), raw
    predictions to ``atol=1e-5`` (root sums and bin sums are reduced in
    another order);
  - scoring a JAX-fitted booster in the port: bit for bit (same float32
    ops in the same per-tree order).
"""

import dataclasses

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt import metrics as jax_metrics
from mmlspark_tpu.models.gbdt import objectives as jax_objectives
from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu.ops.binning import BinMapper as JaxBinMapper
from mmlspark_tpu_torch.models.gbdt import metrics, objectives, trainer
from mmlspark_tpu_torch.models.gbdt.convert import booster_from_jax_state
from mmlspark_tpu_torch.ops.binning import BinMapper

ARRAYS = ("split_feature", "threshold_bin", "threshold_value", "node_value",
          "count", "tree_weights")
MAX_BIN = 63


@pytest.fixture(autouse=True)
def _pin_reference(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")
    for name in ("MMLSPARK_TPU_PALLAS_HIST", "MMLSPARK_TPU_HIST_QUANT",
                 "MMLSPARK_TPU_HIST_SUB", "MMLSPARK_TPU_GROW_POLICY"):
        monkeypatch.delenv(name, raising=False)


def _data(n=3000, f=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < 0.03] = np.nan
    logit = 1.5 * np.nan_to_num(x[:, 0]) - np.nan_to_num(x[:, 1]) \
        + 0.5 * np.nan_to_num(x[:, 2] * x[:, 3])
    y_bin = (logit + 0.5 * rng.normal(size=n) > 0).astype(np.float64)
    y_int = np.clip(np.round(logit + 2), 0, 5)
    return x, y_bin, y_int


def _fit_both(x, y, cfg_kw, weights=None):
    mapper = BinMapper.fit(x, max_bin=MAX_BIN)
    binned = mapper.transform(x)
    bin_upper = mapper.bin_upper_values(MAX_BIN)
    jax_res = jax_trainer.train(binned, y, jax_trainer.TrainConfig(**cfg_kw),
                                weights=weights, bin_upper=bin_upper)
    port_res = trainer.train(binned, y, trainer.TrainConfig(**cfg_kw),
                             weights=weights, bin_upper=bin_upper,
                             device="cpu")
    return binned, jax_res, port_res


def _cfg(**kw):
    base = dict(max_bin=MAX_BIN, max_depth=4, num_leaves=15,
                min_data_in_leaf=20)
    return {**base, **kw}


@pytest.mark.parametrize("extra", [
    {},
    {"lambda_l2": 1.0, "min_sum_hessian_in_leaf": 5.0},
    {"lambda_l1": 2.0, "min_gain_to_split": 1.0},
    {"num_leaves": 6, "min_data_in_leaf": 50},
    {"path_smooth": 3.0, "max_delta_step": 0.7},
])
def test_one_tree_integer_l2_fit_is_bitwise(extra):
    x, _, y_int = _data()
    cfg = _cfg(objective="regression", num_iterations=1,
               boost_from_average=False, **extra)
    _, jr, pr = _fit_both(x, y_int, cfg)
    assert (jr.booster.split_feature >= 0).sum() > 3   # a real tree
    for name in ARRAYS:
        want, got = getattr(jr.booster, name), getattr(pr.booster, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert pr.booster.decision_type is None and jr.booster.decision_type is None
    assert pr.booster.init_score == jr.booster.init_score
    assert pr.booster.max_depth == jr.booster.max_depth


def _assert_close_fit(jr, pr, binned):
    jb, pb = jr.booster, pr.booster
    assert pb.num_trees == jb.num_trees
    np.testing.assert_array_equal(pb.split_feature, jb.split_feature)
    np.testing.assert_array_equal(pb.threshold_bin, jb.threshold_bin)
    np.testing.assert_array_equal(pb.threshold_value, jb.threshold_value)
    np.testing.assert_array_equal(pb.count, jb.count)
    np.testing.assert_allclose(pb.node_value, jb.node_value, rtol=1e-5,
                               atol=1e-7)
    assert pb.init_score == jb.init_score
    want = np.asarray(jb.predict_binned_jit()(binned.astype(np.uint8)))
    got = pb.predict_binned(binned.astype(np.uint8), device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for je, pe in zip(jr.evals, pr.evals):
        np.testing.assert_allclose(pe["train_binary_logloss"],
                                   je["train_binary_logloss"], rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_five_tree_binary_fit_matches(weighted):
    x, y_bin, _ = _data()
    w = (np.random.default_rng(9).uniform(0.5, 2.0, size=len(y_bin))
         if weighted else None)
    cfg = _cfg(objective="binary", num_iterations=5)
    binned, jr, pr = _fit_both(x, y_bin, cfg, weights=w)
    _assert_close_fit(jr, pr, binned)
    lls = [e["train_binary_logloss"] for e in pr.evals]
    assert lls[-1] < lls[0]


def test_fit_matches_jax_through_the_pallas_kernel(monkeypatch):
    """The JAX fit's histograms go through the Pallas kernel in
    interpret mode — the TPU kernel the port's CUDA kernel replaces."""
    monkeypatch.setenv("MMLSPARK_TPU_PALLAS_HIST", "1")
    assert jax_trainer.resolve_histogram_formulation(MAX_BIN) == "pallas"
    x, y_bin, _ = _data(n=700, f=4, seed=5)
    cfg = _cfg(objective="binary", num_iterations=3, max_depth=3,
               num_leaves=8)
    binned, jr, pr = _fit_both(x, y_bin, cfg)
    _assert_close_fit(jr, pr, binned)


def test_jax_fitted_booster_scores_bitwise_in_the_port():
    x, y_bin, _ = _data(seed=2)
    mapper = JaxBinMapper.fit(x, max_bin=MAX_BIN)
    binned = mapper.transform(x).astype(np.uint8)
    res = jax_trainer.train(
        binned, y_bin, jax_trainer.TrainConfig(**_cfg(objective="binary",
                                                      num_iterations=8)),
        bin_upper=mapper.bin_upper_values(MAX_BIN))
    state = {k: (np.asarray(v) if k != "booster_meta" else v)
             for k, v in res.booster.state_dict().items()}
    port = booster_from_jax_state(state)
    want_b = np.asarray(res.booster.predict_binned_jit()(binned))
    got_b = port.predict_binned(binned, device="cpu").numpy()
    np.testing.assert_array_equal(got_b, want_b)
    want_r = np.asarray(res.booster.predict_jit()(x))
    got_r = port.predict(x, device="cpu").numpy()
    np.testing.assert_array_equal(got_r, want_r)
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(res.booster, name))


def test_booster_with_decision_bits_is_a_later_slice():
    x, y_bin, _ = _data(n=500)
    mapper = BinMapper.fit(x, max_bin=MAX_BIN)
    res = trainer.train(mapper.transform(x), y_bin,
                        trainer.TrainConfig(**_cfg(objective="binary",
                                                   num_iterations=1)),
                        device="cpu")
    stamped = dataclasses.replace(
        res.booster, decision_type=np.zeros_like(res.booster.split_feature,
                                                 dtype=np.int8))
    with pytest.raises(NotImplementedError):
        stamped.predict(x, device="cpu")


@pytest.mark.parametrize("name", ["binary", "regression", "l2", "mse"])
def test_objectives_match_jax(name):
    rng = np.random.default_rng(4)
    raw = rng.normal(size=500).astype(np.float32) * 3
    labels = (rng.random(500) < 0.4).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=500).astype(np.float32)
    for w in (None, weights):
        jw = None if w is None else w
        jg, jh = jax_objectives.get_objective(name)(raw, labels, jw)
        pg, ph = objectives.get_objective(name)(
            torch.from_numpy(raw), torch.from_numpy(labels),
            None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(pg.numpy(), np.asarray(jg), rtol=1e-6,
                                   atol=1e-7)
        np.testing.assert_allclose(ph.numpy(), np.asarray(jh), rtol=1e-6,
                                   atol=1e-7)
        assert objectives.init_score(name, labels, w) == \
            jax_objectives.init_score(name, labels, w)


@pytest.mark.parametrize("name", ["binary_logloss", "l2", "mse"])
def test_metrics_match_jax(name):
    rng = np.random.default_rng(6)
    raw = rng.normal(size=400).astype(np.float32) * 2
    labels = (rng.random(400) < 0.5).astype(np.float32)
    want = float(jax_metrics.METRICS[name][0](raw, labels))
    got = float(metrics.METRICS[name][0](torch.from_numpy(raw),
                                         torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert metrics.METRICS[name][1] == jax_metrics.METRICS[name][1]
    for obj in ("binary", "regression"):
        assert metrics.default_metric(obj) == jax_metrics.default_metric(obj)


def test_train_config_mirrors_jax():
    port = {f.name: f.default for f in dataclasses.fields(trainer.TrainConfig)}
    ref = {f.name: f.default
           for f in dataclasses.fields(jax_trainer.TrainConfig)}
    assert port == ref


@pytest.mark.parametrize("num_leaves,max_depth", [
    (31, 5), (63, 6), (63, -1), (2, 0), (1000, 4), (0, 3), (7, 10)])
def test_effective_depth_matches_jax(num_leaves, max_depth):
    kw = dict(num_leaves=num_leaves, max_depth=max_depth)
    assert trainer.TrainConfig(**kw).effective_depth == \
        jax_trainer.TrainConfig(**kw).effective_depth


@pytest.mark.parametrize("bad", [-1, MAX_BIN])
def test_bin_ids_outside_max_bin_raise(bad):
    x, y_bin, _ = _data(n=200)
    binned = BinMapper.fit(x, max_bin=MAX_BIN).transform(x)
    binned[7, 2] = bad
    cfg = trainer.TrainConfig(**_cfg(objective="binary", num_iterations=1))
    with pytest.raises(ValueError, match="bin ids"):
        trainer.train(binned, y_bin, cfg, device="cpu")


@pytest.mark.parametrize("setting", [
    {"boosting_type": "goss"}, {"feature_fraction": 0.5},
    {"bagging_fraction": 0.8, "bagging_freq": 1}, {"num_class": 3},
    {"categorical_features": (1,)}, {"monotone_constraints": (1, 0)},
    {"extra_trees": True}, {"zero_as_missing": True},
    {"tree_learner": "voting"}, {"early_stopping_round": 5},
    {"feature_fraction_by_node": 0.5}, {"objective": "multiclass"},
    {"metric": "auc"}, {"max_bin": 1000},
])
def test_settings_outside_the_slice_raise(setting):
    x, y_bin, _ = _data(n=200)
    binned = BinMapper.fit(x, max_bin=MAX_BIN).transform(x)
    cfg = trainer.TrainConfig(**{"objective": "binary", "num_iterations": 1,
                                 **setting})
    with pytest.raises(NotImplementedError):
        trainer.train(binned, y_bin, cfg, device="cpu")
