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
    # without a mesh the voting and feature-parallel learners train
    # serially, as the JAX package's do (``_resolve_mode``): each setting
    # beside them fits (or raises) as it does beside the serial learner;
    # under a mesh they are tests/test_torch_dist_gbdt.py's
    {"boosting_type": "goss", "extra_trees": True, "tree_learner": "voting"},
    {"feature_fraction": 0.5, "feature_fraction_by_node": 0.5,
     "boosting_type": "dart", "tree_learner": "voting"},
    {"bagging_fraction": 0.8, "bagging_freq": 1, "boosting_type": "dart",
     "max_bin": 70_000, "tree_learner": "feature"},
    {"monotone_constraints": (1, 0), "boosting_type": "dart",
     "tree_learner": "voting"},
    {"extra_trees": True, "tree_learner": "feature"},
    {"tree_learner": "voting"},
    {"boosting_type": "dart", "max_bin": 70_000, "tree_learner": "voting"},
    {"feature_fraction_by_node": 0.5, "tree_learner": "voting"},
    # bin ids past 65,536 (the reference's int32 ids)
    {"max_bin": 70_000, "tree_learner": "feature"},
    # multiclass; ndcg raises without query ids, as beside the serial
    # learner
    {"objective": "multiclass", "num_class": 3, "extra_trees": True,
     "boosting_type": "dart", "tree_learner": "voting"},
    {"metric": "ndcg", "boosting_type": "dart", "max_bin": 70_000,
     "tree_learner": "voting"},
])
def test_settings_outside_the_slice_raise(setting):
    x, y_bin, y_int = _data(n=200)
    binned = BinMapper.fit(x, max_bin=MAX_BIN).transform(x)
    y = (np.minimum(y_int, 2) if setting.get("objective") == "multiclass"
         else y_bin)

    def outcome(tree_learner):
        cfg = trainer.TrainConfig(**{"objective": "binary",
                                     "num_iterations": 1, **setting,
                                     "tree_learner": tree_learner})
        try:
            b = trainer.train(binned, y, cfg, device="cpu").booster
        except (NotImplementedError, ValueError) as e:
            return type(e), str(e)
        return tuple(np.asarray(a).tobytes() for a in (
            b.split_feature, b.threshold_bin, b.node_value, b.count))

    assert outcome(setting["tree_learner"]) == outcome("serial")


# --- custom objectives (fobj) ---------------------------------------------------

def _q8(monkeypatch):
    """The q8 plane on both sides: these labels keep every quantization
    exponent where XLA's ``exp2`` is a power of two (ROADMAP C, closed
    list) and q8 bin sums exact in float32, so fits are bit for bit."""
    monkeypatch.setenv("MMLSPARK_TPU_HIST_QUANT", "q8")
    monkeypatch.setenv(trainer.HIST_QUANT_ENV, "q8")


def _torch_huber(alpha):
    def fobj(preds, labels, weights):
        assert isinstance(preds, torch.Tensor) and preds.dtype == torch.float32
        assert labels.dtype == torch.float32 and weights is None
        return objectives.huber(preds, labels, weights, alpha=alpha)
    return fobj


def _numpy_l2(preds, labels, weights):
    """A custom objective written for the JAX package: numpy on whatever
    arrays it is given, float64 out."""
    p = np.asarray(preds, dtype=np.float64)
    return p - np.asarray(labels), np.ones_like(p)


@pytest.mark.parametrize("objective", ["regression", "huber"])
def test_custom_objective_matches_jax(monkeypatch, objective):
    """A torch fobj in the port and a numpy fobj in the JAX package (its
    eager ``_train_loop``) make the same booster and evals; the named
    objective only picks the metric and the base score, and none of its
    settings reach the fobj."""
    _q8(monkeypatch)
    x, _, y = _data(n=600)
    cfg_kw = _cfg(objective=objective, num_iterations=6, alpha=0.4)

    def jax_fobj(p, yy, w):
        g, h = jax_objectives.huber(p, yy, w, alpha=0.9)
        return np.asarray(g), np.asarray(h)
    mapper = BinMapper.fit(x, max_bin=MAX_BIN)
    binned = mapper.transform(x)
    bin_upper = mapper.bin_upper_values(MAX_BIN)
    jr = jax_trainer.train(binned, y, jax_trainer.TrainConfig(**cfg_kw),
                           bin_upper=bin_upper, custom_objective=jax_fobj)
    pr = trainer.train(binned, y, trainer.TrainConfig(**cfg_kw),
                       bin_upper=bin_upper, device="cpu",
                       custom_objective=_torch_huber(0.9))
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(pr.booster, name),
                                      getattr(jr.booster, name),
                                      err_msg=name)
    assert pr.booster.init_score == jr.booster.init_score
    assert [list(e) for e in pr.evals] == [list(e) for e in jr.evals]
    for pe, je in zip(pr.evals, jr.evals):
        for k in je:
            np.testing.assert_allclose(pe[k], je[k], rtol=1e-6)


def test_numpy_custom_objective_runs_unchanged_on_the_cpu(monkeypatch):
    """A JAX-package fobj (``np.asarray`` on its inputs, float64 out)
    runs in the port on CPU tensors, its output cast to float32 on the
    fit's device: the fit equals the named L2 fit and a torch fobj's."""
    x, _, y = _data(n=600)
    binned = BinMapper.fit(x, max_bin=MAX_BIN).transform(x)
    cfg = trainer.TrainConfig(**_cfg(objective="regression",
                                     num_iterations=4))
    named = trainer.train(binned, y, cfg, device="cpu").booster
    for fobj in (_numpy_l2, lambda p, yy, w: objectives.l2(p, yy, w)):
        got = trainer.train(binned, y, cfg, device="cpu",
                            custom_objective=fobj).booster
        for name in ARRAYS:
            np.testing.assert_array_equal(getattr(got, name),
                                          getattr(named, name))


@pytest.mark.parametrize("bad,match", [
    (lambda p, y, w: (p[:-1] - y[:-1], torch.ones_like(p[:-1])),
     r"grad has shape \(599,\)"),
    (lambda p, y, w: (p - y, np.ones((600, 1))), r"hess has shape"),
    (lambda p, y, w: p - y, r"must return \(grad, hess\)"),
])
def test_custom_objective_output_is_checked(bad, match):
    x, _, y = _data(n=600)
    binned = BinMapper.fit(x, max_bin=MAX_BIN).transform(x)
    cfg = trainer.TrainConfig(**_cfg(num_iterations=2))
    with pytest.raises(ValueError, match=match):
        trainer.train(binned, y, cfg, device="cpu", custom_objective=bad)


def test_custom_objective_gets_the_weights_as_float32():
    x, _, y = _data(n=300)
    w = np.random.default_rng(3).uniform(0.5, 2.0, size=300)
    binned = BinMapper.fit(x, max_bin=MAX_BIN).transform(x)
    seen = []

    def fobj(p, yy, ww):
        seen.append((p.dtype, yy.dtype, ww.dtype, p.device.type))
        return objectives.l2(p, yy, ww)
    cfg = trainer.TrainConfig(**_cfg(num_iterations=3))
    got = trainer.train(binned, y, cfg, weights=w, device="cpu",
                        custom_objective=fobj).booster
    want = trainer.train(binned, y, cfg, weights=w, device="cpu").booster
    assert seen == [(torch.float32,) * 3 + ("cpu",)] * 3
    np.testing.assert_array_equal(got.node_value, want.node_value)
