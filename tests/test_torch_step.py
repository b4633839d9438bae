"""The port's boosting step (``models/gbdt/step.py``) and the sampled
fits it runs (bagging, pos/neg bagging, ``feature_fraction``, GOSS, rf)
against the JAX package, on the CPU (``device="cpu"``: the step runs
uncaptured; the captured graph is held to it on the card by
``chip_smoke.py``'s ``main_path`` and ``sampling_path``).

The JAX side pins its histogram formulation to ``per_feature`` (ROADMAP
C1), EFB and out-of-core training off. Tolerances, by case:

  - given ``jax.random``'s draws (``sampling.draw`` replaced), a sampled
    fit is the JAX package's bit for bit on the q8 plane (every array of
    the booster, rf's tree weights included); the training metric
    within ``rtol=1e-6`` (torch and XLA reduce the metric's sum in other
    orders); binary fits take XLA's ``sigmoid`` values, which differ
    from torch's by an ulp (ROADMAP C10);
  - the step on the CPU is the loop it replaced, bit for bit;
  - a custom objective takes the same masks as the named one: bit for
    bit;
  - a checkpointed bagged fit killed and resumed is the uninterrupted
    one, model strings equal;
  - with the port's own draws, the reference's metric fixtures
    (``tests/benchmarks/test_benchmarks.py``, ``tests/gbdt/
    test_golden_parity.py::test_breast_cancer_goss_tracks_gbdt``) are
    held to the JAX package's metric on the same data at the tolerance
    of the fixture's CSV row (AUC 0.01, L2 0.05) or of the JAX test
    (GOSS within 0.03 AUC of gbdt, above 0.95).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch
from sklearn.metrics import roc_auc_score

from mmlspark_tpu.core import faults as jax_faults
from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.core import faults
from mmlspark_tpu_torch.core.faults import FaultInjected
from mmlspark_tpu_torch.models.gbdt import (
    estimators,
    hist_cuda,
    objectives,
    sampling,
    step,
    trainer,
)
from mmlspark_tpu_torch.ops.binning import BinMapper
from tests.test_torch_sampling import jax_draw

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

ARRAYS = ("split_feature", "threshold_bin", "threshold_value", "node_value",
          "count", "tree_weights")
MAX_BIN = 32


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")
    for name in ("MMLSPARK_TPU_PALLAS_HIST", "MMLSPARK_TPU_HIST_QUANT",
                 "MMLSPARK_TPU_HIST_SUB", "MMLSPARK_TPU_GROW_POLICY",
                 trainer.HIST_QUANT_ENV, trainer.HIST_SUB_ENV):
        monkeypatch.delenv(name, raising=False)
    faults.reset()
    jax_faults.reset()
    yield
    faults.reset()
    jax_faults.reset()


def _q8(monkeypatch):
    """q8 on both sides: these data keep every quantization exponent
    where XLA's ``exp2`` is a power of two and q8 bin sums exact in
    float32 (ROADMAP C, closed list), so fits compare bit for bit."""
    monkeypatch.setenv("MMLSPARK_TPU_HIST_QUANT", "q8")
    monkeypatch.setenv(trainer.HIST_QUANT_ENV, "q8")


def _data(n=800, f=5, seed=7):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = 2.0 * x[:, 0] - x[:, 1] + rng.normal(size=n) * 0.1
    return x, y, (y > 0).astype(np.float64)


def _binned(x):
    m = BinMapper.fit(x, max_bin=MAX_BIN)
    return m.transform(x), m.bin_upper_values(MAX_BIN)


def _assert_boosters_equal(got, want):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.init_score == want.init_score


BASE = dict(num_iterations=6, num_leaves=8, max_depth=3, max_bin=MAX_BIN,
            min_data_in_leaf=10)
SAMPLED = {
    "bagging": dict(objective="regression", bagging_fraction=0.5,
                    bagging_freq=1),
    "bagging_every_3": dict(objective="regression", bagging_fraction=0.6,
                            bagging_freq=3, bagging_seed=9, seed=4),
    "pos_neg": dict(objective="binary", pos_bagging_fraction=0.6,
                    neg_bagging_fraction=0.3, bagging_freq=1),
    "feature_fraction": dict(objective="regression", feature_fraction=0.6),
    "goss": dict(objective="regression", boosting_type="goss"),
    "goss_binary": dict(objective="binary", boosting_type="goss",
                        top_rate=0.3, other_rate=0.2),
    "goss_bagged": dict(objective="regression", boosting_type="goss",
                        bagging_fraction=0.8, bagging_freq=1,
                        feature_fraction=0.8),
    "rf": dict(objective="regression", boosting_type="rf"),
    "rf_bagged": dict(objective="regression", boosting_type="rf",
                      bagging_fraction=0.7, bagging_freq=1,
                      feature_fraction=0.8),
    "rf_binary": dict(objective="binary", boosting_type="rf",
                      bagging_fraction=0.5, bagging_freq=2),
}


def _xla_sigmoid(t):
    return torch.from_numpy(np.array(jax.nn.sigmoid(t.numpy())))


@pytest.mark.parametrize("case", sorted(SAMPLED))
def test_sampled_fit_is_jax_bitwise_given_its_draws(case, monkeypatch):
    _q8(monkeypatch)
    monkeypatch.setattr(sampling, "draw", jax_draw)
    monkeypatch.setattr(torch, "sigmoid", _xla_sigmoid)
    kw = SAMPLED[case]
    x, y, y_bin = _data()
    y = y_bin if kw["objective"] == "binary" else y
    binned, bin_upper = _binned(x)
    cfg = dict(BASE, **kw)
    jr = jax_trainer.train(binned.astype(np.int32), y,
                           jax_trainer.TrainConfig(**cfg),
                           bin_upper=bin_upper)
    pr = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                       bin_upper=bin_upper, device="cpu")
    _assert_boosters_equal(pr.booster, jr.booster)
    assert pr.step_stats == {"captured": False, "capture_s": None}
    for je, pe in zip(jr.evals, pr.evals):
        for k in je:
            np.testing.assert_allclose(pe[k], je[k], rtol=1e-6)
    if kw.get("boosting_type") == "rf":
        np.testing.assert_array_equal(
            pr.booster.tree_weights, np.full(6, 1 / 6, np.float32))
    # the trees differ from the unsampled fit's: the masks took effect
    plain = trainer.train(binned, y, trainer.TrainConfig(
        **dict(BASE, objective=kw["objective"])), bin_upper=bin_upper,
        device="cpu")
    assert not np.array_equal(plain.booster.node_value, pr.booster.node_value)
    # scoring the rf / sampled booster: tree_score's plain version
    want = np.asarray(jr.booster.predict_binned_jit()(binned.astype(np.uint8)))
    got = pr.booster.predict_binned(binned.astype(np.uint8),
                                    device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("quant", ["q8", "off"])
@pytest.mark.parametrize("sub", [False, True])
@pytest.mark.parametrize("masks", ["rows", "features", "both"])
def test_build_tree_under_masks_is_the_reference_builder(monkeypatch, quant,
                                                         sub, masks):
    """``build_tree`` with a row mask (a bag, GOSS's kept rows) and a
    feature mask against the reference's ``make_build_tree``: bit for
    bit on q8; on the float32 plane the split features, bins and counts
    exact and node values within ``rtol=1e-5`` (root and bin sums are
    reduced in other orders), as the unsampled tree tests hold them."""
    monkeypatch.setenv("MMLSPARK_TPU_HIST_QUANT", quant)
    monkeypatch.setenv(trainer.HIST_QUANT_ENV, quant)
    x, y, _ = _data(n=900, f=6)
    binned, _ = _binned(x)
    rng = np.random.default_rng(5)
    g = (0.3 * y - rng.normal(size=900)).astype(np.float32)
    h = np.ones(900, np.float32)
    valid = (rng.random(900) < (0.6 if masks != "features" else 1.1)) \
        .astype(np.float32)
    fmask = np.array([1, 0, 1, 1, 0, 1] if masks != "rows" else [1] * 6,
                     np.float32)
    cfg_kw = dict(objective="regression", max_depth=4, num_leaves=12,
                  max_bin=MAX_BIN, min_data_in_leaf=8)
    # jitted, as the reference's _get_builder runs it
    jb = jax.jit(jax_trainer.make_build_tree(
        6, MAX_BIN, jax_trainer.TrainConfig(**cfg_kw), subtract=sub,
        allow_pallas=False))
    want = [np.asarray(a) for a in jb(
        binned.astype(np.int32), g, h, valid, fmask, np.int32(12))[:4]]
    got = [t.numpy() for t in trainer.build_tree(
        torch.from_numpy(binned.astype(np.uint8)), torch.from_numpy(g),
        torch.from_numpy(h), 12, trainer.TrainConfig(**cfg_kw), MAX_BIN,
        quant, sub, valid=torch.from_numpy(valid),
        feat_mask=torch.from_numpy(fmask))]
    assert (got[0] >= 0).sum() > 4                      # a real tree
    if masks != "rows":                                 # masked features
        assert not np.isin(got[0], [1, 4]).any()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[3], want[3])
    if quant == "q8":
        np.testing.assert_array_equal(got[2], want[2])
    else:
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-7)


def _old_loop(binned, y, cfg, hist_quant="off", subtract=False):
    """The boosting loop the step replaced (named objective, no
    sampling): objective, tree, shrinkage, raw update, one iteration at
    a time on fresh tensors."""
    b = torch.from_numpy(binned.astype(np.uint8))
    labels = torch.from_numpy(y.astype(np.float32))
    base = objectives.init_score(cfg.objective, y, None)
    raw = torch.full((len(y),), base, dtype=torch.float32)
    fn = objectives.get_objective(cfg.objective)
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32)
    trees = []
    for _ in range(cfg.num_iterations):
        g, h = fn(raw, labels, None, **trainer._objective_kwargs(cfg))
        sf, tb, nv, cnt = trainer.build_tree(b, g, h, cfg.num_leaves, cfg,
                                             cfg.max_bin, hist_quant,
                                             subtract)
        nv = nv * lr
        raw = raw + trainer._predict_tree(sf, tb, nv, b,
                                          cfg.effective_depth)
        trees.append([t.numpy() for t in (sf, tb, nv, cnt)])
    return [np.stack(a) for a in zip(*trees)], raw


@pytest.mark.parametrize("quant,sub", [("off", "0"), ("off", "1"),
                                       ("q8", "0"), ("q16", "1")])
@pytest.mark.parametrize("objective", ["regression", "binary"])
def test_step_is_the_loop_it_replaced(monkeypatch, quant, sub, objective):
    monkeypatch.setenv(trainer.HIST_QUANT_ENV, quant)
    monkeypatch.setenv(trainer.HIST_SUB_ENV, sub)
    x, y, y_bin = _data(n=600)
    y = y_bin if objective == "binary" else y
    binned, bin_upper = _binned(x)
    cfg = trainer.TrainConfig(objective=objective, **BASE)
    res = trainer.train(binned, y, cfg, bin_upper=bin_upper, device="cpu")
    (sf, tb, nv, cnt), _ = _old_loop(binned, y, cfg, quant, sub == "1")
    for got, want in zip((res.booster.split_feature,
                          res.booster.threshold_bin, res.booster.node_value,
                          res.booster.count), (sf, tb, nv, cnt)):
        np.testing.assert_array_equal(got, want)
    # capture=False names the same step on the CPU
    again = trainer.train(binned, y, cfg, bin_upper=bin_upper, device="cpu",
                          capture=False)
    _assert_boosters_equal(again.booster, res.booster)


@pytest.mark.parametrize("sampled", ["bagging", "goss_bagged", "rf_bagged"])
def test_custom_objective_takes_the_same_masks(sampled):
    kw = dict(SAMPLED[sampled])
    x, y, _ = _data(n=600)
    binned, bin_upper = _binned(x)
    cfg = trainer.TrainConfig(**dict(BASE, **kw))
    named = trainer.train(binned, y, cfg, bin_upper=bin_upper, device="cpu")
    seen = []

    def fobj(preds, labels, weights):
        seen.append(preds.clone())
        return preds - labels, torch.ones_like(preds)

    custom = trainer.train(binned, y, cfg, bin_upper=bin_upper,
                           device="cpu", custom_objective=fobj)
    _assert_boosters_equal(custom.booster, named.booster)
    assert len(seen) == BASE["num_iterations"]
    if kw.get("boosting_type") == "rf":     # every tree on the base score
        assert all(torch.all(p == p[0]) for p in seen)


def test_checkpointed_bagged_fit_resumes_bitwise(tmp_path):
    """Killed by an armed ``gbdt.train_step`` raise at the first
    iteration of the third segment and resumed: the bags, feature sets
    and GOSS draws are keyed by the global iteration, so the resumed fit
    is the uninterrupted one."""
    x, y, _ = _data(n=700)
    kw = dict(numIterations=12, numLeaves=8, maxBin=MAX_BIN,
              baggingFraction=0.6, baggingFreq=2, featureFraction=0.7,
              boostingType="goss", checkpointInterval=4)
    df = DataFrame({"features": x, "label": y})

    def fit(ckdir):
        return estimators.LightGBMRegressor(checkpointDir=ckdir, **kw) \
            .set_device("cpu").fit(df)

    ref = fit(str(tmp_path / "a"))
    ckb = str(tmp_path / "b")
    with faults.injected("gbdt.train_step", "raise", nth=9):
        with pytest.raises(FaultInjected):
            fit(ckb)
    resumed = fit(ckb)
    assert resumed.booster.num_trees == 12
    assert resumed.get_model_string() == ref.get_model_string()
    # and the sampling took effect
    plain = estimators.LightGBMRegressor(
        checkpointDir=str(tmp_path / "c"), numIterations=12, numLeaves=8,
        maxBin=MAX_BIN, checkpointInterval=4).set_device("cpu").fit(df)
    assert plain.get_model_string() != ref.get_model_string()


def test_estimators_fit_every_sampled_setting():
    x, y, y_bin = _data(n=500)
    frame = DataFrame({"features": x, "label": y_bin})
    for params in ({"baggingFraction": 0.8, "baggingFreq": 1},
                   {"posBaggingFraction": 0.5, "negBaggingFraction": 0.7,
                    "baggingFreq": 1},
                   {"featureFraction": 0.5}, {"boostingType": "goss"},
                   {"boostingType": "rf", "baggingFraction": 0.6,
                    "baggingFreq": 1}):
        model = estimators.LightGBMClassifier(
            numIterations=4, numLeaves=8, **params).set_device("cpu").fit(
            frame)
        prob = model.transform(frame)["probability"][:, 1]
        assert prob.shape == (500,) and np.all(np.isfinite(prob))
        assert roc_auc_score(y_bin, prob) > 0.8, params


@pytest.mark.parametrize("setting,item", [
    ({"boosting_type": "dart"}, "dart"),
    ({"feature_fraction_by_node": 0.5}, "feature_fraction_by_node"),
    ({"extra_trees": True}, "extra_trees"),
])
def test_dart_and_per_node_sampling_still_raise(setting, item, monkeypatch):
    """dart (tests/test_torch_dart.py) with per-node sampling (``item``,
    tests/test_torch_breadth.py) at ``max_bin`` past 65,536, which raised
    before int32 bin ids were ported: it trains, and on q8 with the
    reference's draws the booster is the JAX package's bit for bit."""
    from tests.test_torch_breadth import jax_tree_draw

    x, y, _ = _data(n=200)
    mapper = BinMapper.fit(x, max_bin=70_000)
    binned, upper = mapper.transform(x), mapper.bin_upper_values(70_000)
    assert item == "dart" or item in setting
    _q8(monkeypatch)
    monkeypatch.setattr(sampling, "draw", jax_tree_draw(70_000))
    kw = dict(objective="regression", num_iterations=2, num_leaves=8,
              max_depth=3, max_bin=70_000,
              **{**setting, "boosting_type": "dart"})
    got = trainer.train(binned, y, trainer.TrainConfig(**kw),
                        bin_upper=upper, device="cpu")
    want = jax_trainer.train(binned.astype(np.int32), y,
                             jax_trainer.TrainConfig(**kw), bin_upper=upper)
    _assert_boosters_equal(got.booster, want.booster)


def test_pos_neg_bagging_needs_the_binary_objective():
    x, y, _ = _data(n=200)
    binned, _ = _binned(x)
    cfg = trainer.TrainConfig(objective="regression", num_iterations=1,
                              pos_bagging_fraction=0.5, bagging_freq=1)
    with pytest.raises(ValueError, match="binary objective only"):
        trainer.train(binned, y, cfg, device="cpu")
    with pytest.raises(ValueError, match="binary objective only"):
        jax_trainer.train(binned.astype(np.int32), y,
                          jax_trainer.TrainConfig(**dataclasses.asdict(cfg)))


# --- the step's capture bookkeeping (CPU-testable parts) ---------------------

def test_launch_counters_count_each_replay(monkeypatch):
    """A launch recorded while the stream captures counts into the
    capture's tally, not the counter; each replay adds the tally."""
    monkeypatch.setattr(hist_cuda, "hist_kernel_launches", 0)
    monkeypatch.setattr(hist_cuda, "hist_quant_kernel_launches", 0)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: True)
    with hist_cuda.captured_launches() as tally:
        for _ in range(6):
            hist_cuda._count_launch("hist_kernel_launches")
        hist_cuda._count_launch("hist_quant_kernel_launches")
    assert tally == {"hist_kernel_launches": 6,
                     "hist_quant_kernel_launches": 1}
    assert hist_cuda.hist_kernel_launches == 0
    for _ in range(19):
        hist_cuda.count_replay(tally)
    assert hist_cuda.hist_kernel_launches == 6 * 19
    assert hist_cuda.hist_quant_kernel_launches == 19
    # outside a capture (or on a stream that is not capturing) a launch
    # counts at once
    hist_cuda._count_launch("hist_kernel_launches")
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: False)
    with hist_cuda.captured_launches() as tally:
        hist_cuda._count_launch("hist_kernel_launches")
    assert tally == {} and hist_cuda.hist_kernel_launches == 6 * 19 + 2


def test_step_cache_key_ignores_what_the_loop_alone_reads():
    x, _, _ = _data(n=100)
    b = torch.from_numpy(_binned(x)[0].astype(np.uint8))
    cfg = trainer.TrainConfig(objective="binary", bagging_fraction=0.5,
                              bagging_freq=1)

    def key(c, quant="off", weights=None, valids=()):
        return step._cache_key(c, b, weights, list(valids), quant, False)

    same = [dataclasses.replace(cfg, num_iterations=3),
            dataclasses.replace(cfg, learning_rate=0.3),
            dataclasses.replace(cfg, early_stopping_round=5,
                                improvement_tolerance=0.1)]
    assert all(key(c) == key(cfg) for c in same)
    other = [dataclasses.replace(cfg, bagging_fraction=0.6),
             dataclasses.replace(cfg, seed=1),
             dataclasses.replace(cfg, boosting_type="goss")]
    assert all(key(c) != key(cfg) for c in other)
    assert key(cfg, "q8") != key(cfg)
    assert key(cfg, weights=torch.ones(100)) != key(cfg)
    vs = {"binned": b, "labels": None, "weights": None, "raw": None}
    assert key(cfg, valids=[vs]) != key(cfg)


def test_cpu_step_is_never_captured_or_cached():
    x, y, _ = _data(n=200)
    binned, _ = _binned(x)
    step.clear_step_cache()
    res = trainer.train(binned, y, trainer.TrainConfig(
        objective="regression", num_iterations=2), device="cpu")
    assert res.step_stats == {"captured": False, "capture_s": None}
    assert step.cached_steps() == []
    # the packed row round-trips the int32 arrays bit for bit
    slots = step.num_slots(trainer.TrainConfig())
    sf = np.arange(-1, slots - 1, dtype=np.int32)[None]
    packed = np.concatenate([sf.view(np.float32), (sf * 3).view(np.float32),
                             np.ones((1, 2 * slots), np.float32),
                             np.full((1, 2), 7, np.float32)], axis=1)
    usf, utb, unv, ucnt, met = step.unpack(packed, slots)
    np.testing.assert_array_equal(usf, sf)
    np.testing.assert_array_equal(utb, sf * 3)
    assert met.tolist() == [[7.0, 7.0]]


# --- metric fixtures of the reference, with the port's own draws -------------

def _bench_frames(kind, n=400):
    """``tests/benchmarks/test_benchmarks.py``'s ``_cls_data`` (seed 11)
    and ``_reg_data`` (seed 13) as numpy arrays."""
    rng = np.random.default_rng(11 if kind == "cls" else 13)
    x = rng.normal(size=(n, 6))
    if kind == "cls":
        logit = 1.2 * x[:, 0] - 0.8 * x[:, 1] + 0.5 * x[:, 2] * x[:, 3]
        y = (logit + rng.normal(size=n) * 0.4 > 0).astype(np.float64)
    else:
        y = 2.0 * x[:, 0] - x[:, 1] + 0.3 * x[:, 2] ** 2 \
            + rng.normal(size=n) * 0.2
    return x, y


# (fixture, boosting) -> the CSV row's tolerance
BENCH_TOL = {"cls": 0.01, "reg": 0.05}


@pytest.mark.parametrize("boosting", ["gbdt", "rf", "goss"])
@pytest.mark.parametrize("kind", ["cls", "reg"])
def test_benchmark_fixtures_track_jax(kind, boosting):
    x, y = _bench_frames(kind)
    params = dict(numIterations=10, numLeaves=15, maxBin=64,
                  boostingType=boosting, seed=3, baggingFraction=0.8,
                  baggingFreq=1)
    name = "LightGBMClassifier" if kind == "cls" else "LightGBMRegressor"
    port = getattr(estimators, name)(**params).set_device("cpu").fit(
        DataFrame({"features": x, "label": y}))
    ref = getattr(jax_est, name)(**params).fit(
        JaxFrame({"features": x, "label": y}))
    if kind == "cls":
        got = roc_auc_score(y, port.transform(DataFrame({"features": x}))[
            "probability"][:, 1])
        want = roc_auc_score(y, np.asarray(ref.transform(JaxFrame(
            {"features": x}))["probability"])[:, 1])
    else:
        got = float(np.mean((port.transform(DataFrame({"features": x}))[
            "prediction"] - y) ** 2))
        want = float(np.mean((np.asarray(ref.transform(JaxFrame(
            {"features": x}))["prediction"]) - y) ** 2))
    assert abs(got - want) <= BENCH_TOL[kind], (got, want)


def test_breast_cancer_goss_tracks_gbdt():
    """The port of ``test_golden_parity.py::
    test_breast_cancer_goss_tracks_gbdt`` (the same split and params),
    with the JAX package's GOSS AUC beside it."""
    from sklearn.datasets import load_breast_cancer
    d = load_breast_cancer()
    idx = np.random.default_rng(0).permutation(len(d.target))
    cut = int(0.75 * len(idx))
    xtr, ytr = d.data[idx[:cut]], d.target[idx[:cut]].astype(np.float64)
    xte, yte = d.data[idx[cut:]], d.target[idx[cut:]].astype(np.float64)
    aucs = {}
    for boosting in ("gbdt", "goss"):
        model = estimators.LightGBMClassifier(
            numIterations=60, numLeaves=31, boostingType=boosting
        ).set_device("cpu").fit(DataFrame({"features": xtr, "label": ytr}))
        aucs[boosting] = roc_auc_score(yte, model.transform(DataFrame(
            {"features": xte}))["probability"][:, 1])
    assert aucs["goss"] > 0.95
    assert abs(aucs["goss"] - aucs["gbdt"]) < 0.03, aucs
    ref = jax_est.LightGBMClassifier(
        numIterations=60, numLeaves=31, boostingType="goss").fit(
        JaxFrame({"features": xtr, "label": ytr}))
    jax_auc = roc_auc_score(yte, np.asarray(ref.transform(JaxFrame(
        {"features": xte}))["probability"])[:, 1])
    assert abs(aucs["goss"] - jax_auc) < 0.03, (aucs, jax_auc)


def test_a_dropped_step_is_freed_without_the_collector():
    """A step holds no reference back to itself, so dropping it frees it
    (and, on the card, its graph) at once: a garbage-collector pass that
    freed a graph could fall inside another step's capture and
    invalidate it."""
    import gc
    import weakref

    x, y, _ = _data(n=100)
    b = torch.from_numpy(_binned(x)[0].astype(np.uint8))
    labels = torch.from_numpy(y.astype(np.float32))
    cfg = trainer.TrainConfig(objective="regression", num_iterations=1)
    gc.disable()
    try:
        for custom in (None, lambda p, lab, w: (p - lab, torch.ones_like(p))):
            st = step.open_step(cfg, b, labels, None, torch.zeros(100), [],
                                lr=0.1, base=0.0, hist_quant="off",
                                subtract=False, custom_objective=custom)
            step.run_step(st, 0)
            step.close_step(st)
            ref = weakref.ref(st)
            del st
            assert ref() is None
    finally:
        gc.enable()
