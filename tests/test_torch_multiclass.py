"""Multiclass in the port (softmax grads, K trees per iteration in the
boosting step, the K-class booster, ``LightGBMClassifier`` on labels of
more than two values) against the JAX package on the same seeded numpy
inputs, on the CPU.

The JAX side pins its histogram formulation to ``per_feature`` (ROADMAP
C1), EFB and out-of-core training off. Tolerances, by case:

  - grad / hess: bit for bit once the port's ``exp`` is given XLA's
    values; with torch's own ``exp`` (an ulp from XLA's, ROADMAP C10)
    within ``rtol=1e-6`` of the terms (1 for grad, 2 for hess, times the
    row weight) plus ``atol=1e-7``;
  - fits on the q8 plane on both sides (ROADMAP C3, C4), with XLA's
    ``exp`` values and, for the sampled fits, the reference's draws
    (``tests.test_torch_sampling.jax_draw``): every booster array bit
    for bit, ``num_class`` and the class interleaving included, evals
    within ``rtol=1e-6``; with the port's own ``exp``, the roots equal
    and ``multi_logloss`` within ``1e-5``;
  - scoring (``predict``, ``predict_binned``, ``leaf_index``,
    ``contrib``) of one booster: bit for bit as the JAX booster scores
    it, contributions within ``1e-5``; model strings equal both ways;
  - estimators: a JAX-fitted multiclass model carried across
    (``model_from_jax``) transforms bit for bit as in JAX.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu.models.gbdt import objectives as jax_objectives
from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu.models.gbdt.booster import BoosterArrays as JaxBooster
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.models.gbdt import (estimators, objectives, sampling,
                                            step, trainer)
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
from mmlspark_tpu_torch.models.gbdt.convert import model_from_jax
from mmlspark_tpu_torch.ops.binning import BinMapper
from tests.test_torch_sampling import jax_draw

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

ARRAYS = ("split_feature", "threshold_bin", "threshold_value", "node_value",
          "count", "tree_weights")
MAX_BIN = 32
K = 4


@pytest.fixture(autouse=True)
def _pin_reference(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")
    for name in ("MMLSPARK_TPU_PALLAS_HIST", "MMLSPARK_TPU_HIST_QUANT",
                 "MMLSPARK_TPU_HIST_SUB", "MMLSPARK_TPU_GROW_POLICY",
                 trainer.HIST_QUANT_ENV, trainer.HIST_SUB_ENV):
        monkeypatch.delenv(name, raising=False)


def _q8(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_QUANT", "q8")
    monkeypatch.setenv(trainer.HIST_QUANT_ENV, "q8")


def _xla_exp(monkeypatch):
    """The port's ``exp`` with XLA's values: the one op of the softmax
    whose bits differ (ROADMAP C10)."""
    monkeypatch.setattr(torch, "exp", lambda t: torch.from_numpy(
        np.array(jnp.exp(t.numpy()))))


def _data(n=600, f=5, k=K, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, max(f, k)))
    logits = x[:, :k] * 1.5 + 0.5 * rng.normal(size=(n, k))
    return x, np.argmax(logits, axis=1).astype(np.float64)


def _binned(x):
    m = BinMapper.fit(x, max_bin=MAX_BIN)
    return m.transform(x), m.bin_upper_values(MAX_BIN)


def _assert_boosters_equal(got, want):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.num_class == want.num_class
    assert got.init_score == want.init_score


def _assert_evals_close(got, want, rtol=1e-6):
    assert [sorted(e) for e in got] == [sorted(e) for e in want]
    for ge, we in zip(got, want):
        for k in we:
            np.testing.assert_allclose(ge[k], we[k], rtol=rtol)


# --- grads ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["multiclass", "softmax", "multiclassova"])
@pytest.mark.parametrize("weighted", [False, True])
def test_multiclass_grads_match_jax(name, weighted, monkeypatch):
    rng = np.random.default_rng(1)
    n = 3000
    raw = (rng.normal(size=(n, K)) * 3).astype(np.float32)
    labels = rng.integers(0, K, size=n).astype(np.float32)
    labels[:5] = [K, -1, 1.7, 0, 2]       # out of range: a zero one-hot row
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32) if weighted \
        else None

    def both():
        jg, jh = jax_objectives.get_objective(name)(
            jnp.asarray(raw), jnp.asarray(labels),
            None if w is None else jnp.asarray(w), num_class=K)
        pg, ph = objectives.get_objective(name)(
            torch.from_numpy(raw), torch.from_numpy(labels),
            None if w is None else torch.from_numpy(w), num_class=K)
        return np.asarray(jg), np.asarray(jh), pg.numpy(), ph.numpy()

    jg, jh, pg, ph = both()
    assert pg.shape == ph.shape == (n, K) and pg.dtype == np.float32
    scale = 1.0 if w is None else w.astype(np.float64)[:, None]
    assert np.all(np.abs(pg - jg) <= 1e-6 * scale + 1e-7)
    assert np.all(np.abs(ph - jh) <= 2e-6 * scale + 1e-7)
    # the only difference is exp
    _xla_exp(monkeypatch)
    jg, jh, pg, ph = both()
    np.testing.assert_array_equal(pg, jg)
    np.testing.assert_array_equal(ph, jh)


# --- fits ------------------------------------------------------------------------------

BASE = dict(objective="multiclass", num_class=K, num_iterations=4,
            num_leaves=8, max_depth=3, max_bin=MAX_BIN, min_data_in_leaf=10)
SAMPLED = {
    "plain": {},
    "bagging": dict(bagging_fraction=0.5, bagging_freq=1),
    "feature_fraction": dict(feature_fraction=0.6),
    "goss": dict(boosting_type="goss", top_rate=0.3, other_rate=0.2),
    "rf": dict(boosting_type="rf", bagging_fraction=0.7, bagging_freq=1),
}


@pytest.mark.parametrize("case", sorted(SAMPLED))
def test_multiclass_fit_is_jax_bitwise_given_its_draws(case, monkeypatch):
    """K trees per iteration from the named objective, under the
    iteration's shared bag and feature masks (GOSS ranks rows by the sum
    over classes of |g|), against the JAX fused step."""
    _q8(monkeypatch)
    _xla_exp(monkeypatch)
    monkeypatch.setattr(sampling, "draw", jax_draw)
    x, y = _data()
    binned, bin_upper = _binned(x)
    cfg = dict(BASE, **SAMPLED[case])
    want = jax_trainer.train(binned.astype(np.int32), y,
                             jax_trainer.TrainConfig(**cfg),
                             bin_upper=bin_upper)
    got = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                        bin_upper=bin_upper, device="cpu")
    assert got.booster.num_class == K and got.booster.num_trees == 4 * K
    _assert_boosters_equal(got.booster, want.booster)
    _assert_evals_close(got.evals, want.evals)
    if case == "rf":
        np.testing.assert_array_equal(got.booster.tree_weights,
                                      np.full(4 * K, 1 / 4, np.float32))
    # tree i belongs to class i % K: each class's trees score its column
    raw = got.booster.predict_binned(binned.astype(np.uint8),
                                     device="cpu").numpy()
    want_raw = np.asarray(want.booster.predict_binned_jit()(
        binned.astype(np.uint8)))
    assert raw.shape == (len(y), K)
    np.testing.assert_allclose(raw, want_raw, rtol=0, atol=1e-6)


def test_multiclass_fit_given_jax_grads_as_a_custom_objective(monkeypatch):
    """A custom objective takes and returns (N, K), as the reference's
    ``_train_loop`` passes them; given the JAX grads the trees are
    JAX's."""
    _q8(monkeypatch)
    x, y = _data(seed=2)
    binned, bin_upper = _binned(x)

    def jax_side(preds, labels, weights):
        g, h = jax_objectives.multiclass(jnp.asarray(np.asarray(preds)),
                                         jnp.asarray(np.asarray(labels)),
                                         num_class=K)
        return np.asarray(g), np.asarray(h)

    def port_side(preds, labels, weights):
        assert tuple(preds.shape) == (len(y), K)
        return jax_side(preds.numpy(), labels.numpy(), None)

    want = jax_trainer.train(binned.astype(np.int32), y,
                             jax_trainer.TrainConfig(**BASE),
                             bin_upper=bin_upper, custom_objective=jax_side)
    got = trainer.train(binned, y, trainer.TrainConfig(**BASE),
                        bin_upper=bin_upper, custom_objective=port_side,
                        device="cpu")
    _assert_boosters_equal(got.booster, want.booster)
    _assert_evals_close(got.evals, want.evals)
    with pytest.raises(ValueError, match="expected \\(600, 4\\)"):
        trainer.train(binned, y, trainer.TrainConfig(**BASE), device="cpu",
                      custom_objective=lambda p, lab, w: (p[:, 0], p[:, 0]))


def test_multiclass_fit_with_its_own_exp_tracks_jax():
    x, y = _data(n=800, seed=3)
    binned, bin_upper = _binned(x)
    cfg = dict(BASE, num_iterations=6)
    want = jax_trainer.train(binned.astype(np.int32), y,
                             jax_trainer.TrainConfig(**cfg),
                             bin_upper=bin_upper)
    got = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                        bin_upper=bin_upper, device="cpu")
    np.testing.assert_array_equal(got.booster.split_feature[:K, 0],
                                  want.booster.split_feature[:K, 0])
    g = got.evals[-1]["train_multi_logloss"]
    w = want.evals[-1]["train_multi_logloss"]
    assert abs(g - w) <= 1e-5 * abs(w)
    assert g < got.evals[0]["train_multi_logloss"]


def test_early_stopping_on_multi_logloss_keeps_whole_iterations(monkeypatch):
    _q8(monkeypatch)
    _xla_exp(monkeypatch)
    x, y = _data(n=900, seed=4)
    binned, bin_upper = _binned(x)
    tr, va = slice(0, 600), slice(600, 900)
    cfg = dict(BASE, num_iterations=40, learning_rate=0.8,
               early_stopping_round=3, min_data_in_leaf=3, num_leaves=16,
               max_depth=4)
    want = jax_trainer.train(
        binned[tr].astype(np.int32), y[tr], jax_trainer.TrainConfig(**cfg),
        bin_upper=bin_upper,
        valid_sets=[(binned[va].astype(np.int32), y[va], None)])
    got = trainer.train(binned[tr], y[tr], trainer.TrainConfig(**cfg),
                        bin_upper=bin_upper,
                        valid_sets=[(binned[va], y[va], None)], device="cpu")
    assert 0 <= got.best_iteration == want.best_iteration < 39
    assert got.booster.num_trees == (got.best_iteration + 1) * K
    _assert_boosters_equal(got.booster, want.booster)
    _assert_evals_close(got.evals, want.evals)


def test_packed_rows_unpack_in_class_order():
    slots = 7
    rows = []
    for t in range(3):
        blocks = []
        for c in range(K):
            tag = 10 * t + c
            blocks += [np.full(slots, tag, np.int32).view(np.float32),
                       np.full(slots, -tag, np.int32).view(np.float32),
                       np.full(slots, tag, np.float32),
                       np.full(slots, 2 * tag, np.float32)]
        rows.append(np.concatenate(blocks + [np.array([t, -t], np.float32)]))
    sf, tb, nv, cnt, met = step.unpack(np.stack(rows), slots, 0, K)
    tags = [10 * t + c for t in range(3) for c in range(K)]
    assert sf[:, 0].tolist() == tags and tb[:, 0].tolist() == [-t for t in
                                                               tags]
    assert nv[:, 3].tolist() == tags and cnt[:, 6].tolist() == [
        2 * t for t in tags]
    assert met.tolist() == [[0, 0], [1, -1], [2, -2]]


def test_categorical_multiclass_fit_carries_k_mask_blocks(monkeypatch):
    _q8(monkeypatch)
    _xla_exp(monkeypatch)
    rng = np.random.default_rng(5)
    n = 700
    x = rng.normal(size=(n, 4))
    x[:, 0] = rng.integers(0, 9, size=n)
    y = ((x[:, 0] % 3) + (x[:, 1] > 0.8)).astype(np.float64)   # 4 classes
    m = BinMapper.fit(x, max_bin=MAX_BIN, categorical_features=[0])
    binned, bin_upper = m.transform(x), m.bin_upper_values(MAX_BIN)
    cfg = dict(BASE, categorical_features=(0,), num_iterations=3,
               min_data_per_group=20)
    want = jax_trainer.train(binned.astype(np.int32), y,
                             jax_trainer.TrainConfig(**cfg),
                             bin_upper=bin_upper)
    got = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                        bin_upper=bin_upper, device="cpu")
    _assert_boosters_equal(got.booster, want.booster)
    np.testing.assert_array_equal(got.booster.decision_type,
                                  want.booster.decision_type)
    np.testing.assert_array_equal(got.booster.cat_bitset,
                                  want.booster.cat_bitset)
    assert (got.booster.decision_type == 1).any()


# --- the booster ------------------------------------------------------------------------

def _fitted(monkeypatch, n=600, seed=6, k=K, **kw):
    """A multiclass fit in both packages, bitwise equal (q8, XLA's exp),
    and its raw rows."""
    _q8(monkeypatch)
    _xla_exp(monkeypatch)
    x, y = _data(n=n, k=k, seed=seed)
    x[::17, 1] = np.nan
    binned, bin_upper = _binned(x)
    cfg = dict(BASE, num_class=k, **kw)
    want = jax_trainer.train(binned.astype(np.int32), y,
                             jax_trainer.TrainConfig(**cfg),
                             bin_upper=bin_upper)
    got = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                        bin_upper=bin_upper, device="cpu")
    _assert_boosters_equal(got.booster, want.booster)
    monkeypatch.undo()
    return got.booster, want.booster, x, binned


def test_multiclass_booster_scores_as_jax(monkeypatch):
    pb, jb, x, binned = _fitted(monkeypatch)
    np.testing.assert_array_equal(
        pb.predict(x, device="cpu").numpy(), np.asarray(jb.predict_jit()(x)))
    np.testing.assert_array_equal(
        pb.predict_binned(binned.astype(np.uint8), device="cpu").numpy(),
        np.asarray(jb.predict_binned_jit()(binned.astype(np.uint8))))
    np.testing.assert_array_equal(pb.leaf_index(x, device="cpu").numpy(),
                                  np.asarray(jb.leaf_index_jit()(x)))
    got = pb.contrib(x[:50], device="cpu").numpy()
    want = np.asarray(jb.contrib_jit()(x[:50]))
    assert got.shape == want.shape == (50, K * (x.shape[1] + 1))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_multiclass_model_strings_cross_both_ways(monkeypatch):
    pb, jb, x, _ = _fitted(monkeypatch, k=7, n=900)
    text = pb.save_model_string()
    assert text == jb.save_model_string()
    assert "num_class=7" in text and "num_tree_per_iteration=7" in text
    assert "objective=multiclass" in text
    port_back = BoosterArrays.load_model_string(jb.save_model_string())
    jax_back = JaxBooster.load_model_string(text)
    assert port_back.num_class == jax_back.num_class == 7
    assert port_back.save_model_string() == jax_back.save_model_string()
    np.testing.assert_array_equal(
        port_back.predict(x, device="cpu").numpy(),
        np.asarray(jax_back.predict_jit()(x)))


def test_multiclass_warm_start_concats_as_jax(monkeypatch):
    pb, jb, x, binned = _fitted(monkeypatch)
    _q8(monkeypatch)
    _xla_exp(monkeypatch)
    y = _data(seed=6)[1]
    bin_upper = BinMapper.fit(x, max_bin=MAX_BIN).bin_upper_values(MAX_BIN)
    init_p = trainer.warm_start_scores(pb, x, device="cpu")
    init_j = jax_trainer.warm_start_scores(jb, x)
    assert init_p.shape == (len(y), K)
    np.testing.assert_array_equal(init_p, np.asarray(init_j))
    cfg = dict(BASE, num_iterations=2)
    want = jax_trainer.train(binned.astype(np.int32), y,
                             jax_trainer.TrainConfig(**cfg),
                             bin_upper=bin_upper, init_model=jb,
                             init_raw=init_j)
    got = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                        bin_upper=bin_upper, init_model=pb, init_raw=init_p,
                        device="cpu")
    assert got.booster.num_trees == 6 * K
    _assert_boosters_equal(got.booster, want.booster)


# --- estimators --------------------------------------------------------------------------

CLF = dict(numIterations=4, numLeaves=8, maxDepth=3, maxBin=MAX_BIN,
           minDataInLeaf=10)


def _labels_of(y):
    # original label values need not be 0..K-1
    return np.array([3.0, 5.0, 8.0, 13.0])[y.astype(int)]


def test_multiclass_classifier_transform_through_model_from_jax():
    x, y = _data(seed=7)
    ref = jax_est.LightGBMClassifier(**CLF).fit(
        JaxFrame({"features": x, "label": _labels_of(y)}))
    state = {k: (np.asarray(v) if hasattr(v, "shape") else v)
             for k, v in ref._get_state().items()}
    port = model_from_jax("LightGBMClassificationModel", state,
                          ref.simple_param_values())
    assert port.num_classes == K and port.booster.num_class == K
    for binned in (False, True):
        port.set("binnedScoring", binned)
        ref.set("binnedScoring", binned)
        got = port.set_device("cpu").transform(DataFrame({"features": x}))
        want = ref.transform(JaxFrame({"features": x}))
        assert got.columns == want.columns
        for col in got.columns:
            np.testing.assert_array_equal(got[col], want[col])


def test_multiclass_classifier_fits_scores_and_serves(monkeypatch):
    """The port's own multiclass fit: K trees per iteration, the
    probability rows summing to 1, labels decoded, a checkpointed fit
    killed and resumed bitwise, and the binned serving plan's replies
    bitwise ``transform``'s."""
    _q8(monkeypatch)
    x, y = _data(n=800, seed=8)
    frame = DataFrame({"features": x, "label": _labels_of(y)})
    model = estimators.LightGBMClassifier(**CLF).set_device("cpu").fit(frame)
    assert model.booster.num_class == K and model.num_classes == K
    assert model.booster.num_trees == 4 * K
    assert model.booster.objective == "multiclass"
    out = model.transform(DataFrame({"features": x}))
    probs = out["probability"]
    assert probs.shape == (len(y), K)
    # softmax of float32 margins: the rows sum to 1 within float32 ulps
    np.testing.assert_allclose(probs.sum(axis=1), 1.0, rtol=0, atol=1e-6)
    assert set(np.unique(out["prediction"])) <= {3.0, 5.0, 8.0, 13.0}
    assert np.mean(out["prediction"] == _labels_of(y)) > 0.6
    plan = model.serving_binned_plan()
    replies = plan.finish(plan.score(plan.bin_rows(x)).numpy())
    want = model.copy(binnedScoring=True).set_device("cpu").transform(
        DataFrame({"features": x}))
    for col, vals in replies.items():
        np.testing.assert_array_equal(vals, want[col])


def test_multiclass_checkpointed_fit_resumes_bitwise(tmp_path, monkeypatch):
    from mmlspark_tpu_torch.core import faults
    from mmlspark_tpu_torch.core.faults import FaultInjected

    _q8(monkeypatch)
    x, y = _data(n=500, seed=9)
    frame = DataFrame({"features": x, "label": y})
    params = dict(CLF, numIterations=6, checkpointInterval=2)
    whole = estimators.LightGBMClassifier(
        **params, checkpointDir=str(tmp_path / "a")).set_device("cpu").fit(
            frame)
    est = estimators.LightGBMClassifier(
        **params, checkpointDir=str(tmp_path / "b")).set_device("cpu")
    faults.reset()
    try:
        with faults.injected("gbdt.train_step", "raise", nth=5):
            with pytest.raises(FaultInjected):
                est.fit(frame)
    finally:
        faults.reset()
    assert sorted(p.name for p in (tmp_path / "b").glob("checkpoint_*.txt")) \
        == ["checkpoint_2.txt", "checkpoint_4.txt"]
    resumed = est.fit(frame)
    assert resumed.booster.num_trees == 6 * K
    assert resumed.get_model_string() == whole.get_model_string()


def test_initscore_must_be_per_class():
    x, y = _data(n=200, seed=10)
    frame = DataFrame({"features": x, "label": y, "init": np.zeros(200)})
    with pytest.raises(ValueError, match=r"\(N, 4\) per-class scores"):
        estimators.LightGBMClassifier(**CLF, initScoreCol="init") \
            .set_device("cpu").fit(frame)
    cfg = trainer.TrainConfig(objective="softmax", num_class=3)
    assert cfg.num_trees_per_iteration == 3
    assert dataclasses.replace(cfg, objective="binary") \
        .num_trees_per_iteration == 1
