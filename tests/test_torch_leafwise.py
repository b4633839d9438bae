"""Leaf-wise growth in the port (``MMLSPARK_TORCH_GROW_POLICY=leafwise``:
``models/gbdt/leafwise.py`` through the host loop) against the JAX
package's (``MMLSPARK_TPU_GROW_POLICY=leafwise``) on the same seeded
numpy inputs, on the CPU.

The JAX side pins its histogram formulation to ``per_feature`` (ROADMAP
C1), EFB and out-of-core training off. Tolerances, by case:

  - on data whose histogram sums are exact in float32 (a custom
    objective whose gradients are multiples of 1/8, hessians 1): every
    booster array bit for bit, the root's float64 sums included, and
    evals within ``rtol=1e-6``;
  - on float data (binary, with XLA's ``sigmoid`` values, ROADMAP C10):
    split features, bins and counts exact, node values within
    ``rtol=1e-5`` (the reference sums bins in float32 in its own order
    and the root in numpy's pairwise float64 order; the port's sums are
    exact-rounded, order-free);
  - ``best_split`` against the reference's on one float64 histogram:
    the same candidate, ties and the last bin included.
"""

import warnings

import jax
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt import leafwise as jax_leafwise
from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu_torch.core import env
from mmlspark_tpu_torch.models.gbdt import leafwise, sampling, trainer
from mmlspark_tpu_torch.ops.binning import BinMapper
from tests.test_torch_sampling import jax_draw

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

ARRAYS = ("split_feature", "threshold_bin", "threshold_value", "node_value",
          "count", "tree_weights")


@pytest.fixture(autouse=True)
def _leafwise_both(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")
    for name in ("MMLSPARK_TPU_PALLAS_HIST", "MMLSPARK_TPU_HIST_QUANT",
                 "MMLSPARK_TPU_HIST_SUB", trainer.HIST_QUANT_ENV,
                 trainer.HIST_SUB_ENV):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("MMLSPARK_TPU_GROW_POLICY", "leafwise")
    monkeypatch.setenv(trainer.GROW_POLICY_ENV, "leafwise")
    env.reset_warnings()
    yield
    env.reset_warnings()


def _fit_case(n=6000, f=7, seed=17, max_bin=64):
    """The reference's ``tests/gbdt/test_leafwise.py`` data: a strong
    interaction on one side of the root split, so leaf-wise growth
    diverges from depth-wise."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    left = x[:, 0] < 0
    signal = np.where(left, x[:, 1] * x[:, 2] + x[:, 3], 0.2 * x[:, 4])
    y = (signal + 0.1 * rng.normal(size=n) > 0).astype(np.float64)
    m = BinMapper.fit(x, max_bin=max_bin)
    return m.transform(x), y, m.bin_upper_values(max_bin)


def _cfg(**kw):
    base = dict(objective="binary", num_iterations=8, num_leaves=10,
                max_depth=8, min_data_in_leaf=20, seed=4)
    base.update(kw)
    return base


def dyadic_objective(preds, labels, weights):
    """L2 gradients rounded to multiples of 1/8 (hessians 1), for preds
    of shape (N,) or (N, K) against class ids: every histogram sum is
    exact in float32, so both packages sum to the same bits."""
    p = np.asarray(preds, np.float64)
    y = np.asarray(labels, np.float64)
    if p.ndim == 2:
        y = np.eye(p.shape[1])[y.astype(int)]
    g = np.round((p - y) * 8.0) / 8.0
    return g.astype(np.float32), np.ones(p.shape, np.float32)


def _fit_both(binned, y, bin_upper, fobj=None, valid=None, **kw):
    cfg = _cfg(**kw)
    jr = jax_trainer.train(
        binned.astype(np.int32), y, jax_trainer.TrainConfig(**cfg),
        bin_upper=bin_upper, custom_objective=fobj,
        valid_sets=None if valid is None else [
            (valid[0].astype(np.int32),) + tuple(valid[1:])])
    pr = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                       bin_upper=bin_upper, custom_objective=fobj,
                       valid_sets=None if valid is None else [valid],
                       device="cpu")
    return pr, jr


def _assert_boosters_equal(got, want):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.init_score == want.init_score


def _assert_evals_match(port_evals, jax_evals, rtol=1e-6):
    assert [list(e) for e in port_evals] == [list(e) for e in jax_evals]
    for pe, je in zip(port_evals, jax_evals):
        for k in je:
            np.testing.assert_allclose(pe[k], je[k], rtol=rtol)


def _xla_sigmoid(monkeypatch):
    monkeypatch.setattr(torch, "sigmoid", lambda t: torch.from_numpy(
        np.array(jax.nn.sigmoid(t.numpy()))))


EXACT = {
    "plain": {},
    "regularized": dict(lambda_l1=0.5, lambda_l2=2.0, min_gain_to_split=0.1),
    "path_smooth": dict(path_smooth=5.0, max_delta_step=0.4),
    "deep": dict(num_leaves=40, max_depth=-1, min_data_in_leaf=5),
    "bagged": dict(bagging_fraction=0.6, bagging_freq=2, feature_fraction=0.6,
                   seed=9),
    "pos_neg": dict(pos_bagging_fraction=0.7, neg_bagging_fraction=0.4,
                    bagging_freq=1),
    "rf": dict(boosting_type="rf", bagging_fraction=0.7, bagging_freq=1),
    "dart": dict(boosting_type="dart", skip_drop=0.0, drop_rate=0.3),
}


@pytest.mark.parametrize("case", sorted(EXACT))
def test_leafwise_fit_is_jax_bitwise_on_exact_sums(case):
    """Every booster array, with the reference's numpy bagging and
    feature-fraction draws (ROADMAP C22), rf's weights and DART's drops
    grown leaf-wise."""
    binned, y, bin_upper = _fit_case(n=3000)
    pr, jr = _fit_both(binned, y, bin_upper, fobj=dyadic_objective,
                       **EXACT[case])
    _assert_boosters_equal(pr.booster, jr.booster)
    _assert_evals_match(pr.evals, jr.evals)
    assert pr.hist_stats["grow_policy"] == "leafwise"
    loop = pr.step_stats["host_loop"]
    assert loop["hist_calls"] >= 8 and loop["host_reads"] > loop["hist_calls"]
    if case == "deep":
        leaves = (pr.booster.split_feature >= 0).sum(axis=1) + 1
        assert leaves.max() == 40 and pr.booster.max_depth == 6


def test_leafwise_fit_on_float_data_matches_splits(monkeypatch):
    _xla_sigmoid(monkeypatch)
    binned, y, bin_upper = _fit_case()
    pr, jr = _fit_both(binned, y, bin_upper)
    pb, jb = pr.booster, jr.booster
    for name in ("split_feature", "threshold_bin", "count", "tree_weights"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(jb, name))
    np.testing.assert_allclose(pb.node_value, jb.node_value, rtol=1e-5,
                               atol=1e-7)
    _assert_evals_match(pr.evals, jr.evals, rtol=1e-5)


def test_repeated_fits_bit_identical():
    binned, y, bin_upper = _fit_case()
    cfg = trainer.TrainConfig(**_cfg())
    r1 = trainer.train(binned, y, cfg, bin_upper=bin_upper, device="cpu")
    r2 = trainer.train(binned, y, cfg, bin_upper=bin_upper, device="cpu")
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(r1.booster, name),
                                      getattr(r2.booster, name))


def test_num_leaves_cap_and_divergence_from_depthwise(monkeypatch):
    binned, y, bin_upper = _fit_case(seed=23)
    cfg = trainer.TrainConfig(**_cfg(num_leaves=10, max_depth=8))
    leaf = trainer.train(binned, y, cfg, bin_upper=bin_upper, device="cpu")
    monkeypatch.delenv(trainer.GROW_POLICY_ENV)
    depth = trainer.train(binned, y, cfg, bin_upper=bin_upper, device="cpu")
    leaves = (leaf.booster.split_feature >= 0).sum(axis=1) + 1
    assert (leaves <= 10).all() and leaves.max() == 10
    assert depth.hist_stats["grow_policy"] == "depthwise"
    assert not np.array_equal(leaf.booster.split_feature,
                              depth.booster.split_feature)


@pytest.mark.parametrize("setting,reason", [
    (dict(monotone_constraints=(1, 0, 0, 0, 0)), "monotone_constraints"),
    (dict(categorical_features=(4,)), "categorical_features"),
    (dict(extra_trees=True), "extra_trees"),
    (dict(feature_fraction_by_node=0.5), "feature_fraction_by_node"),
])
def test_unsupported_config_downgrades_with_warning(setting, reason):
    """One warning in the reference's words, then depthwise: the fit is
    the depthwise fit, and a second downgraded fit is silent."""
    binned, y, _ = _fit_case(n=2000, f=5)
    binned[:, 4] %= 6                   # a small categorical feature
    bin_upper = None
    cfg = trainer.TrainConfig(**_cfg(num_iterations=3, **setting))
    with pytest.warns(UserWarning, match=(
            rf"{trainer.GROW_POLICY_ENV}=leafwise does not support {reason}; "
            "growing depthwise — label A/B measurements accordingly")):
        r = trainer.train(binned, y, cfg, bin_upper=bin_upper, device="cpu")
    assert r.hist_stats["grow_policy"] == "depthwise"
    assert "host_loop" not in r.step_stats
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        r2 = trainer.train(binned, y, cfg, bin_upper=bin_upper, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(trainer.GROW_POLICY_ENV)
        plain = trainer.train(binned, y, cfg, bin_upper=bin_upper,
                              device="cpu")
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(r.booster, name),
                                      getattr(r2.booster, name))
        np.testing.assert_array_equal(getattr(r.booster, name),
                                      getattr(plain.booster, name))


def test_bad_grow_policy_value_warns_once(monkeypatch):
    monkeypatch.setenv(trainer.GROW_POLICY_ENV, "lossguide")
    with pytest.warns(UserWarning, match="GROW_POLICY"):
        assert trainer.resolve_grow_policy() == "depthwise"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert trainer.resolve_grow_policy() == "depthwise"
    monkeypatch.setenv(trainer.GROW_POLICY_ENV, " LeafWise ")
    assert trainer.resolve_grow_policy() == "leafwise"


def test_leafwise_ignores_quant_and_efb(monkeypatch):
    """Leaf-wise histograms run the float32 plane on the rows' own
    matrix: quantization and EFB requests are recorded off, and the fit
    is the fit without them."""
    binned, y, bin_upper = _fit_case(n=3000, f=5)
    cfg = trainer.TrainConfig(**_cfg(num_iterations=4))
    plain = trainer.train(binned, y, cfg, bin_upper=bin_upper, device="cpu")
    monkeypatch.setenv(trainer.HIST_QUANT_ENV, "q16")
    monkeypatch.setenv("MMLSPARK_TORCH_EFB", "on")
    r = trainer.train(binned, y, cfg, bin_upper=bin_upper, device="cpu")
    assert r.hist_stats == {"grow_policy": "leafwise", "hist_quant": "off",
                            "subtract": True, "efb_bundles": 0,
                            "efb_bundled_features": 0, "ooc": False,
                            "ooc_reason": "leafwise growth"}
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(r.booster, name),
                                      getattr(plain.booster, name))


def test_leafwise_multiclass_is_jax_bitwise_on_exact_sums():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1500, 5))
    y = np.argmax(x[:, :3] + 0.3 * rng.normal(size=(1500, 3)), axis=1) \
        .astype(np.float64)
    m = BinMapper.fit(x, max_bin=32)
    pr, jr = _fit_both(m.transform(x), y, m.bin_upper_values(32),
                       fobj=dyadic_objective, objective="multiclass",
                       num_class=3, num_iterations=4)
    _assert_boosters_equal(pr.booster, jr.booster)
    assert pr.booster.num_trees == 12 and pr.booster.num_class == 3
    # the metric's softmax takes torch's exp (an ulp from XLA's, C10)
    _assert_evals_match(pr.evals, jr.evals, rtol=1e-5)


def test_leafwise_goss_given_the_references_draws(monkeypatch):
    """GOSS keeps the port's counter hash (ROADMAP C13): given
    ``jax.random``'s draws, the reference's fit bit for bit."""
    monkeypatch.setattr(sampling, "draw", jax_draw)
    binned, y, bin_upper = _fit_case(n=3000)
    pr, jr = _fit_both(binned, y, bin_upper, fobj=dyadic_objective,
                       boosting_type="goss", top_rate=0.3, other_rate=0.2)
    _assert_boosters_equal(pr.booster, jr.booster)


def test_leafwise_early_stopping_is_the_references():
    binned, y, bin_upper = _fit_case(n=4000)
    cut = 3000
    pr, jr = _fit_both(binned[:cut], y[:cut], bin_upper,
                       fobj=dyadic_objective,
                       valid=(binned[cut:], y[cut:], None),
                       objective="regression", num_iterations=40,
                       learning_rate=1.0, num_leaves=31,
                       early_stopping_round=2)
    assert len(jr.evals) < 40
    assert pr.best_iteration == jr.best_iteration
    _assert_evals_match(pr.evals, jr.evals)
    _assert_boosters_equal(pr.booster, jr.booster)


def test_leafwise_uint16_bins():
    """``max_bin`` above 256: uint16 ids through the width-1 histograms."""
    binned, y, bin_upper = _fit_case(n=3000, max_bin=300)
    assert binned.max() > 255
    pr, jr = _fit_both(binned, y, bin_upper, fobj=dyadic_objective,
                       max_bin=300, num_iterations=4)
    _assert_boosters_equal(pr.booster, jr.booster)
    assert trainer._binned_to_device(binned, 300, torch.device("cpu")) \
        .dtype == torch.uint16


def test_resumed_bagged_segments_are_the_references():
    """The host loop re-seeds its numpy streams per segment with the
    offset, as the reference's does: a resumed bagged leaf-wise fit is
    the reference's resumed fit, not the uninterrupted one."""
    binned, y, bin_upper = _fit_case(n=3000)
    kw = _cfg(bagging_fraction=0.6, bagging_freq=1, num_iterations=3)

    def segments(mod):
        first = mod.train(binned.astype(np.int32) if mod is jax_trainer
                          else binned, y, mod.TrainConfig(**kw),
                          bin_upper=bin_upper,
                          custom_objective=dyadic_objective, **(
                              {} if mod is jax_trainer else {"device": "cpu"}))
        raw = np.asarray(first.booster.predict_binned(
            binned.astype(np.uint8), device="cpu").numpy()
            if mod is trainer else
            first.booster.predict_binned_jit()(binned.astype(np.uint8)))
        second = mod.train(binned.astype(np.int32) if mod is jax_trainer
                           else binned, y, mod.TrainConfig(**kw),
                           bin_upper=bin_upper, init_model=first.booster,
                           init_raw=raw, iteration_offset=3,
                           custom_objective=dyadic_objective, **(
                               {} if mod is jax_trainer else
                               {"device": "cpu"}))
        return second.booster

    got, want = segments(trainer), segments(jax_trainer)
    _assert_boosters_equal(got, want)
    whole = trainer.train(binned, y, trainer.TrainConfig(
        **dict(kw, num_iterations=6)), bin_upper=bin_upper,
        custom_objective=dyadic_objective, device="cpu").booster
    assert not np.array_equal(got.split_feature[3:], whole.split_feature[3:])


def _reference_best_split(f, b, cfg):
    """The reference builder's ``best_split`` closure."""
    build = jax_leafwise.make_build_tree_leafwise(f, b, cfg)
    cells = dict(zip(build.__code__.co_freevars,
                     (c.cell_contents for c in build.__closure__)))
    return cells["best_split"]


@pytest.mark.parametrize("case", ["random", "ties", "last_bin", "masked",
                                  "none"])
def test_best_split_is_the_references(case):
    f, b = 4, 9
    cfg_kw = dict(objective="regression", min_data_in_leaf=3,
                  min_sum_hessian_in_leaf=1.0, lambda_l2=1.0)
    rng = np.random.default_rng(11)
    hist = np.zeros((f, b, 3))
    hist[..., 2] = rng.integers(0, 20, size=(f, b))
    hist[..., 1] = hist[..., 2] * 0.25
    hist[..., 0] = rng.normal(size=(f, b)) * hist[..., 2]
    fmask = np.ones(f, np.float32)
    if case == "ties":
        hist[2] = hist[1]                    # features 1 and 2 tie
        hist[:, 4:] = hist[:, 3:4]           # bins tie within a feature
    elif case == "last_bin":
        hist[..., :-1, :] = 0.0              # only a cut before the last bin
        hist[:, -2] = (5.0, 1.25, 5.0)
        hist[:, -1] = (-5.0, 1.25, 5.0)
    elif case == "masked":
        fmask[[0, 3]] = 0.0
    elif case == "none":
        hist[..., 2] = np.minimum(hist[..., 2], 1.0)
    want = _reference_best_split(
        f, b, jax_trainer.TrainConfig(**cfg_kw))(hist, fmask)
    got = leafwise.make_build_tree_leafwise(
        f, b, trainer.TrainConfig(**cfg_kw)).best_split(hist, fmask)
    if want is None:
        assert got is None and case == "none"
        return
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    if case == "ties":
        assert got[1] != 2                   # the first of tied features
    if case == "last_bin":
        assert got[2] == b - 2               # never the last bin itself


def test_exact_sum_is_order_free_and_exact():
    rng = np.random.default_rng(0)
    x = (rng.normal(size=100_000) * 10.0 ** rng.integers(-6, 3, 100_000)) \
        .astype(np.float32)
    x[::7] *= -1
    want = float(np.sum(x.astype(np.float64)))
    from fractions import Fraction
    exact = float(sum(Fraction(float(v)) for v in x))
    got = leafwise.exact_sum(torch.from_numpy(x))
    assert got == leafwise.exact_sum(torch.from_numpy(x[::-1].copy()))
    assert abs(got - exact) <= 2 * np.spacing(abs(exact))
    assert abs(want - exact) <= 1e-9 * np.abs(x).sum()
    assert leafwise.exact_sum(torch.zeros(5)) == 0.0
    assert leafwise.exact_sum(torch.tensor([2.5, -0.125])) == 2.375


def test_builder_routes_on_the_device_and_keeps_the_layout():
    """The 6-tuple of the full heap layout: leaves at uneven depths, each
    split's left bins its threshold's prefix, and the rows' leaves
    (``_predict_tree`` on the layout) hold the leaf counts."""
    binned, y, _ = _fit_case(n=2000)
    cfg = trainer.TrainConfig(**_cfg(num_leaves=12, max_depth=-1))
    build = leafwise.make_build_tree_leafwise(binned.shape[1], 64, cfg)
    g = torch.from_numpy((0.5 - y).astype(np.float32))
    h = torch.full_like(g, 0.25)
    b = torch.from_numpy(binned.astype(np.uint8))
    sf, tb, nv, cnt, dt, bgl = build(b, g, h, None, None, 12)
    assert len(sf) == 2 ** (cfg.effective_depth + 1) - 1
    split = sf >= 0
    assert split.sum() == 11
    leaves = np.nonzero(~split & (cnt > 0))[0]
    depths = np.floor(np.log2(leaves + 1))
    assert len(leaves) == 12 and depths.min() < depths.max()
    np.testing.assert_array_equal(dt, np.where(split, 10, 0))
    np.testing.assert_array_equal(bgl[split], np.arange(64)[None, :]
                                  <= tb[split][:, None])
    node = trainer._predict_tree(torch.from_numpy(sf), torch.from_numpy(tb),
                                 torch.arange(len(sf), dtype=torch.float32),
                                 b, cfg.effective_depth).long().numpy()
    np.testing.assert_array_equal(np.bincount(node, minlength=len(sf))[
        leaves], cnt[leaves])


def test_leafwise_estimator_matches_the_reference_estimator(monkeypatch):
    """``LightGBMRegressor`` with the grow policy set on both sides:
    splits and counts exact, node values within ``rtol=1e-5`` (float
    labels: float32 bin sums in other orders), predictions within
    ``atol=1e-5``."""
    from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
    from mmlspark_tpu.models.gbdt import estimators as jax_est

    from mmlspark_tpu_torch import DataFrame
    from mmlspark_tpu_torch.models.gbdt import estimators

    rng = np.random.default_rng(6)
    x = rng.normal(size=(2000, 6))
    y = x[:, 0] * x[:, 1] + np.where(x[:, 2] > 0, x[:, 3], 0.0) \
        + 0.1 * rng.normal(size=2000)
    params = dict(numIterations=5, numLeaves=12, maxBin=32, learningRate=0.3)
    cols = {"features": x, "label": y}
    port = estimators.LightGBMRegressor(**params).set_device("cpu").fit(
        DataFrame(cols))
    ref = jax_est.LightGBMRegressor(**params).fit(JaxFrame(cols))
    pb, jb = port.booster, ref.booster
    for name in ("split_feature", "threshold_bin", "count", "tree_weights"):
        np.testing.assert_array_equal(getattr(pb, name), getattr(jb, name))
    np.testing.assert_allclose(pb.node_value, jb.node_value, rtol=1e-5,
                               atol=1e-7)
    assert ((pb.split_feature >= 0).sum(axis=1) == 11).all()
    np.testing.assert_allclose(
        port.transform(DataFrame({"features": x}))["prediction"],
        ref.transform(JaxFrame({"features": x}))["prediction"], atol=1e-5)
