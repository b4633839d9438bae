"""The port's objectives (``models/gbdt/objectives.py``: binary and the
regression family, every alias) against the JAX package's on the same
seeded inputs, and fits under each objective, through ``train`` and
through ``LightGBMRegressor``, against the JAX package's fits.
Multiclass and lambdarank, whose grads take (N, K) scores or query
groups, are held in ``tests/test_torch_multiclass.py`` and
``tests/test_torch_ranking.py``.

Tolerances, by case:

  - grad / hess of L2, L1, huber, fair, quantile and mape: bit for bit,
    with and without weights;
  - poisson, gamma and tweedie: bit for bit once the port's ``exp`` is
    given XLA's values (the rest of the arithmetic is the reference's,
    op for op); with torch's own ``exp`` (it and XLA's differ by an ulp,
    ROADMAP C10) within ``rtol=1e-6`` of the larger of the two terms
    that grad and hess subtract (times the row weight), plus
    ``atol=1e-7``; binary, whose ``sigmoid`` differs in the same way,
    within the same bound with terms of 1;
  - ``init_score``: exact;
  - fits, on the q8 plane on both sides (every quantization exponent of
    these data lies where XLA's ``exp2`` is a power of two, which the
    port's ``_pow2_scale`` always is: ROADMAP C, closed list; and q8 bin
    sums are exact in float32): every ``BoosterArrays`` array
    bit for bit and evals within ``rtol=1e-6`` where the grads are bit for
    bit; for poisson, gamma and tweedie the trees' roots equal and the
    final metric within ``rtol=1e-5``.

The JAX side pins ``MMLSPARK_TPU_HIST_FORMULATION=per_feature`` (ROADMAP
C1), EFB and out-of-core training off.
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
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.models.gbdt import estimators, objectives, trainer

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

ARRAYS = ("split_feature", "threshold_bin", "threshold_value", "node_value",
          "count", "tree_weights")
MAX_BIN = 31
EXP_OBJECTIVES = ("poisson", "gamma", "tweedie")
# objectives whose grads go through exp or sigmoid
ULP_OBJECTIVES = EXP_OBJECTIVES + ("binary",)
# objective -> the labels it is fitted to
LABELS = {"regression_l1": "continuous", "huber": "continuous",
          "fair": "continuous", "poisson": "counts",
          "quantile": "continuous", "mape": "continuous",
          "gamma": "positive", "tweedie": "counts"}
# the objectives of (N,) scores and no groups
ALIASES = sorted(set(objectives.OBJECTIVES) - {
    "multiclass", "softmax", "multiclassova", "lambdarank"})
# the settings each named objective reads, at non-default values
SETTINGS = dict(alpha=0.7, fair_c=0.5, tweedie_variance_power=1.3,
                poisson_max_delta_step=0.4, sigmoid=2.0)


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


def _labels(kind, n, core, rng):
    if kind == "continuous":
        return core + 0.3 * rng.normal(size=n)
    if kind == "counts":
        return rng.poisson(np.exp(0.5 * np.clip(core, -3, 3))).astype(float)
    return rng.gamma(2.0, np.exp(0.3 * np.clip(core, -3, 3)) / 2.0)


def _grad_inputs(kind, n=4000, seed=4):
    rng = np.random.default_rng(seed)
    raw = (rng.normal(size=n) * 2).astype(np.float32)
    if kind == "binary":
        labels = (rng.random(n) < 0.4).astype(np.float32)
    else:
        labels = _labels(kind, n, rng.normal(size=n), rng).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return raw, labels, weights


def _kind(name):
    return {"binary": "binary", "poisson": "counts", "tweedie": "counts",
            "gamma": "positive"}.get(objectives.OBJECTIVES[name].__name__,
                                     "continuous")


def _terms(name, raw, labels):
    """The magnitudes of the two terms grad and hess subtract, for the
    objectives whose grads go through ``exp`` or ``sigmoid``."""
    raw64, y = raw.astype(np.float64), labels.astype(np.float64)
    if name == "binary":
        return np.ones_like(raw64), np.ones_like(raw64)
    if name == "poisson":
        return np.maximum(np.exp(raw64), np.abs(y)), np.exp(raw64 + 0.7)
    if name == "gamma":
        ey = np.abs(y) * np.exp(-raw64)
        return np.maximum(ey, 1.0), ey
    a, b = np.abs(y) * np.exp(-0.5 * raw64), np.exp(0.5 * raw64)
    return np.maximum(a, b), np.maximum(a, b)


def _call_both(name, raw, labels, w, **kw):
    jg, jh = jax_objectives.get_objective(name)(raw, labels, w, **kw)
    pg, ph = objectives.get_objective(name)(
        torch.from_numpy(raw), torch.from_numpy(labels),
        None if w is None else torch.from_numpy(w), **kw)
    return (np.asarray(jg), np.asarray(jh)), (pg.numpy(), ph.numpy())


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ALIASES)
def test_grad_hess_match_jax(name, weighted):
    raw, labels, weights = _grad_inputs(_kind(name))
    w = weights if weighted else None
    (jg, jh), (pg, ph) = _call_both(name, raw, labels, w)
    assert pg.dtype == ph.dtype == np.float32
    if objectives.OBJECTIVES[name].__name__ not in ULP_OBJECTIVES:
        np.testing.assert_array_equal(pg, jg)
        np.testing.assert_array_equal(ph, jh)
        return
    scale = 1.0 if w is None else w.astype(np.float64)
    tg, th = _terms(objectives.OBJECTIVES[name].__name__, raw, labels)
    assert np.all(np.abs(pg - jg) <= 1e-6 * tg * scale + 1e-7)
    assert np.all(np.abs(ph - jh) <= 1e-6 * th * scale + 1e-7)


@pytest.mark.parametrize("name", EXP_OBJECTIVES)
def test_exp_objectives_are_bitwise_given_xlas_exp(name, monkeypatch):
    """With XLA's ``exp`` values in place of torch's, poisson, gamma and
    tweedie are the JAX package's bits: the only difference is ``exp``."""
    monkeypatch.setattr(torch, "exp", lambda t: torch.from_numpy(
        np.array(jnp.exp(t.numpy()))))
    raw, labels, weights = _grad_inputs(_kind(name), n=20000)
    kw = {"tweedie": [{}, {"tweedie_variance_power": 1.2},
                      {"tweedie_variance_power": 1.8}],
          "poisson": [{}, {"max_delta_step": 0.3}]}.get(name, [{}])
    for w in (None, weights):
        for k in kw:
            (jg, jh), (pg, ph) = _call_both(name, raw, labels, w, **k)
            np.testing.assert_array_equal(pg, jg)
            np.testing.assert_array_equal(ph, jh)


@pytest.mark.parametrize("name", ["huber", "quantile", "fair"])
def test_objective_settings_match_jax_bitwise(name):
    raw, labels, weights = _grad_inputs("continuous")
    key = {"fair": "fair_c"}.get(name, "alpha")
    for value in (0.1, 0.5, 0.95, 2.0):
        (jg, jh), (pg, ph) = _call_both(name, raw, labels, weights,
                                        **{key: value})
        np.testing.assert_array_equal(pg, jg)
        np.testing.assert_array_equal(ph, jh)


@pytest.mark.parametrize("name", ALIASES + ["lambdarank", "unknown"])
def test_init_score_matches_jax_exactly(name):
    kind = _kind(name) if name in objectives.OBJECTIVES else "continuous"
    raw, labels, weights = _grad_inputs(kind, n=1001)
    for w in (None, weights):
        assert objectives.init_score(name, labels, w) == \
            jax_objectives.init_score(name, labels, w)


def test_l1_and_quantile_init_is_the_unweighted_median():
    y = np.array([0.0, 1.0, 2.0, 10.0, 11.0])
    w = np.array([100.0, 1.0, 1.0, 1.0, 1.0])
    for name in ("l1", "mae", "regression_l1", "quantile"):
        assert objectives.init_score(name, y, w) == 2.0


def test_objective_table_matches_jax():
    """Every name of the JAX table is the same objective here, multiclass
    (softmax, multiclassova: the same softmax in both) and lambdarank
    included."""
    assert set(objectives.OBJECTIVES) == set(jax_objectives.OBJECTIVES)
    for name, fn in objectives.OBJECTIVES.items():
        assert fn.__name__ == jax_objectives.OBJECTIVES[name].__name__
        assert objectives.get_objective(name) is fn
    for name in ("softmax", "multiclassova"):
        assert objectives.get_objective(name) is objectives.multiclass
    with pytest.raises(ValueError, match="unknown objective"):
        objectives.get_objective("no_such_objective")

    def fobj(p, y, w):
        return p - y, torch.ones_like(p)
    assert objectives.get_objective(fobj) is fobj
    assert jax_objectives.get_objective(fobj) is fobj


@pytest.mark.parametrize("name", ALIASES + ["multiclass", "lambdarank"])
def test_objective_kwargs_match_jax(name):
    kw = dict(objective=name, **SETTINGS)
    if name == "multiclass":
        kw["num_class"] = 5
    if name == "lambdarank":
        kw.update(lambdarank_truncation_level=12, label_gain=[0, 1, 3, 9])
    want = jax_trainer._objective_kwargs(jax_trainer.TrainConfig(**kw))
    got = trainer._objective_kwargs(trainer.TrainConfig(**kw))
    assert got == want


# --- fits under each objective -------------------------------------------------

def _fit_case(kind, n=500, f=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    x[rng.random((n, f)) < 0.03] = np.nan
    core = np.nan_to_num(0.8 * x[:, 0] + 0.4 * x[:, 1] * x[:, 2])
    return x, _labels(kind, n, core, rng)


def _assert_same_fit(port, ref, port_evals, ref_evals, exact):
    if exact:
        for name in ARRAYS:
            np.testing.assert_array_equal(getattr(port, name),
                                          getattr(ref, name), err_msg=name)
        assert [list(e) for e in port_evals] == [list(e) for e in ref_evals]
        for pe, je in zip(port_evals, ref_evals):
            for k in je:
                np.testing.assert_allclose(pe[k], je[k], rtol=1e-6)
    else:
        np.testing.assert_array_equal(port.split_feature[:, 0],
                                      ref.split_feature[:, 0])
        np.testing.assert_array_equal(port.threshold_bin[:, 0],
                                      ref.threshold_bin[:, 0])
        key = [k for k in ref_evals[-1] if k != "iteration"][0]
        np.testing.assert_allclose(port_evals[-1][key], ref_evals[-1][key],
                                   rtol=1e-5)
    assert port.init_score == ref.init_score
    assert port.objective == ref.objective


@pytest.mark.parametrize("objective", sorted(LABELS))
def test_fit_per_objective_matches_jax(objective, monkeypatch):
    """``LightGBMRegressor`` under each objective against the JAX
    estimator, and the port's ``train`` on the estimator's bins against
    the JAX ``train`` (the same compiled step, so one JAX compile)."""
    _q8(monkeypatch)
    x, y = _fit_case(LABELS[objective])
    params = dict(objective=objective, numIterations=8, numLeaves=8,
                  maxBin=MAX_BIN, minDataInLeaf=10, alpha=0.7,
                  tweedieVariancePower=1.4)
    port = estimators.LightGBMRegressor(**params).set_device("cpu").fit(
        DataFrame({"features": x, "label": y}))
    ref = jax_est.LightGBMRegressor(**params).fit(
        JaxFrame({"features": x, "label": y}))
    exact = objective not in EXP_OBJECTIVES
    _assert_same_fit(port.booster, ref.booster, port.evals_result,
                     ref.evals_result, exact)
    if objective not in ("gamma", "tweedie"):
        # the metric falls (gamma's and tweedie's default metric is l2 of
        # the log-scale score against the labels, which need not fall)
        first, last = (port.evals_result[i] for i in (0, -1))
        key = [k for k in first if k != "iteration"][0]
        assert last[key] < first[key]
    got = port.transform(DataFrame({"features": x}))["prediction"]
    want = np.asarray(ref.transform(JaxFrame({"features": x}))["prediction"])
    if exact:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    if objective in EXP_OBJECTIVES:                # log link
        raw = port.booster.predict(x, device="cpu").numpy()
        np.testing.assert_array_equal(got, np.exp(raw).astype(np.float64))
        assert np.all(got > 0)

    # train on the estimator's bins, port and JAX
    binned = port.bin_mapper.transform(x)
    bin_upper = port.bin_mapper.bin_upper_values(MAX_BIN)
    cfg = dict(objective=objective, num_iterations=8, num_leaves=8,
               max_depth=16, max_bin=MAX_BIN, min_data_in_leaf=10,
               alpha=0.7, tweedie_variance_power=1.4)
    pt = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                       bin_upper=bin_upper, device="cpu")
    # the JAX estimator's config (its data_parallel learner is the serial
    # one without a mesh), so the JAX train reuses the estimator's step
    jt = jax_trainer.train(binned.astype(np.int32), y,
                           jax_trainer.TrainConfig(**cfg, tree_learner="data"),
                           bin_upper=bin_upper)
    _assert_same_fit(pt.booster, jt.booster, pt.evals, jt.evals, exact)
    for name in ARRAYS:                 # the estimator is a direct train
        np.testing.assert_array_equal(getattr(pt.booster, name),
                                      getattr(port.booster, name))


def test_regressor_passes_alpha_and_tweedie_power():
    x, y = _fit_case("counts", n=300)
    df = DataFrame({"features": x, "label": y})
    fits = {}
    for rho in (1.2, 1.8):
        fits[rho] = estimators.LightGBMRegressor(
            objective="tweedie", numIterations=3, numLeaves=4,
            maxBin=MAX_BIN, tweedieVariancePower=rho).set_device(
                "cpu").fit(df)
    assert not np.array_equal(fits[1.2].booster.node_value,
                              fits[1.8].booster.node_value)
    cfg = trainer.TrainConfig(objective="huber", alpha=0.3)
    assert trainer._objective_kwargs(cfg) == {"alpha": 0.3}
    assert trainer._objective_kwargs(
        dataclasses.replace(cfg, objective="mape")) == {}
