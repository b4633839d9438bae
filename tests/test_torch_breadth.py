"""The port's in-step GBDT breadth against the JAX package, on the CPU:
uint16 bin ids (``max_bin`` above 256), exclusive feature bundling
(``ops/efb.py``), monotone constraints, ``extra_trees`` and
``feature_fraction_by_node``.

The JAX side pins its histogram formulation to ``per_feature`` (ROADMAP
C1) and out-of-core training off; EFB is off on both sides unless a
test turns it on. Tolerances, by case:

  - the plain level histograms on uint16 ids at B = 1,023: the JAX
    ``_level_histogram`` / ``_level_histogram_quant`` bit for bit on
    integer-valued stats (every sum exact in float32, C4);
  - EFB: plans, bundled matrices, cache keys and the knob bit for bit;
    the unbundled histogram equal to the reference's ``_unbundle_hist``
    lines on exact sums; an EFB fit the JAX EFB fit bit for bit on q8;
  - fits at ``max_bin=1023`` and with monotone constraints: the JAX
    package's bit for bit on q8 (every array of the booster); with
    ``extra_trees`` / ``feature_fraction_by_node`` bit for bit given the
    reference's draws (``sampling.draw`` replaced, as
    ``tests/test_torch_step.py`` does); binary fits take XLA's sigmoid
    (ROADMAP C10); the training metric within ``rtol=1e-6``;
  - with the port's own draws: monotone fits exactly monotone along the
    constrained features (every bin swept), the reference's fixtures of
    ``tests/gbdt/test_monotone.py`` and ``test_extended_params.py`` at
    their own bounds (C13), draws that are pure functions of their keys;
  - estimators at ``maxBin=1023`` and with ``monotoneConstraints``: the
    JAX estimator's booster bit for bit (q8), and transforms bitwise
    through ``model_from_jax`` and model strings both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu.models.gbdt.booster import BoosterArrays as JaxBooster
from mmlspark_tpu.ops import efb as jax_efb
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.models.gbdt import (
    estimators,
    hist_cuda,
    sampling,
    step,
    trainer,
)
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
from mmlspark_tpu_torch.models.gbdt.convert import model_from_jax
from mmlspark_tpu_torch.ops import efb
from mmlspark_tpu_torch.ops.binning import BinMapper
from mmlspark_tpu_torch.ops.ingest import binned_ingest_dtype
from tests.test_torch_sampling import jax_draw, jax_key

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

ARRAYS = ("split_feature", "threshold_bin", "threshold_value", "node_value",
          "count", "tree_weights")
WIDE = 1023                      # max_bin of the uint16 cases


@pytest.fixture(autouse=True)
def _pin(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv(efb.EFB, "off")
    for name in ("MMLSPARK_TPU_PALLAS_HIST", "MMLSPARK_TPU_HIST_QUANT",
                 "MMLSPARK_TPU_HIST_SUB", "MMLSPARK_TPU_GROW_POLICY",
                 trainer.HIST_QUANT_ENV, trainer.HIST_SUB_ENV):
        monkeypatch.delenv(name, raising=False)


def _knobs(monkeypatch, quant="q8", sub="0", bundling=None):
    """The same histogram plane, subtraction and EFB policy on both
    sides. q8: these data keep every quantization exponent where XLA's
    ``exp2`` is a power of two and q8 bin sums exact in float32 (ROADMAP
    C, closed list)."""
    for jax_name, port_name, v in (
            ("MMLSPARK_TPU_HIST_QUANT", trainer.HIST_QUANT_ENV, quant),
            ("MMLSPARK_TPU_HIST_SUB", trainer.HIST_SUB_ENV, sub),
            ("MMLSPARK_TPU_EFB", efb.EFB, bundling or "off")):
        monkeypatch.setenv(jax_name, v)
        monkeypatch.setenv(port_name, v)


def _xla_sigmoid(t):
    return torch.from_numpy(np.array(jax.nn.sigmoid(t.numpy())))


def _assert_boosters_equal(got, want):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert got.init_score == want.init_score


def _assert_boosters_within_c19(got, want):
    """Monotone fits with path smoothing (ROADMAP C19): splits, counts
    and weights exact, node values within two float32 ulps
    (``rtol=4e-7``: one rounding of the fused op, then the shrinkage's)."""
    for name in ("split_feature", "threshold_bin", "threshold_value",
                 "count", "tree_weights"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    np.testing.assert_allclose(got.node_value, want.node_value, rtol=4e-7,
                               atol=0)
    assert got.init_score == want.init_score


def _assert_evals_match(got, want):
    assert [list(e) for e in got] == [list(e) for e in want]
    for pe, je in zip(got, want):
        for k in je:
            np.testing.assert_allclose(pe[k], je[k], rtol=1e-6)


def _data(n=1200, f=6, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f))
    y = (1.5 * x[:, 0] - x[:, 1] + 0.5 * np.sin(3 * x[:, 2])
         + rng.normal(size=n) * 0.6)
    return x, y, (y > 0).astype(np.float64)


def _binned(x, max_bin):
    """Bin ids at the narrowest dtype (uint8, or uint16 past 256 bins),
    and the bins' upper values."""
    m = BinMapper.fit(x, max_bin=max_bin)
    return (m.transform(x, binned_ingest_dtype(max_bin)),
            m.bin_upper_values(max_bin))


def _fit_both(binned, y, bin_upper, **cfg):
    jr = jax_trainer.train(binned.astype(np.int32), y,
                           jax_trainer.TrainConfig(**cfg),
                           bin_upper=bin_upper)
    pr = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                       bin_upper=bin_upper, device="cpu")
    return jr, pr


# --- the plain histograms on uint16 ids --------------------------------------

def _u16_case(n, f, b, width, seed):
    rng = np.random.default_rng(seed)
    binned = rng.integers(0, b, size=(n, f)).astype(np.uint16)
    binned[:4] = b - 1                             # the top bin is used
    grad = rng.integers(-8, 9, size=n).astype(np.float32)
    hess = rng.integers(1, 9, size=n).astype(np.float32)
    live = (rng.random(n) < 0.9).astype(np.float32)
    local = rng.integers(0, width, size=n).astype(np.int32)
    return binned, grad, hess, live, local


@pytest.mark.parametrize("n,f,b,width", [(3000, 5, WIDE, 4), (999, 3, 4095, 2),
                                         (500, 27, WIDE, 1)])
def test_plain_histogram_on_uint16_ids_is_jax_bitwise(n, f, b, width):
    arrays = _u16_case(n, f, b, width, seed=n)
    got = hist_cuda.level_histogram(*(torch.from_numpy(a) for a in arrays),
                                    width, f, b)
    want = jax_trainer._level_histogram(*(jnp.asarray(a) for a in arrays),
                                        width, f, b)
    assert got.shape == (width, f, b, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the same ids as uint8 where they fit: the same sums
    small = tuple(np.minimum(a, 255).astype(np.uint8) if i == 0 else a
                  for i, a in enumerate(arrays))
    u16 = hist_cuda.level_histogram(
        torch.from_numpy(small[0].astype(np.uint16)),
        *(torch.from_numpy(a) for a in small[1:]), width, f, 256)
    u8 = hist_cuda.level_histogram(*(torch.from_numpy(a) for a in small),
                                   width, f, 256)
    np.testing.assert_array_equal(u16.numpy(), u8.numpy())


@pytest.mark.parametrize("quant", ["q16", "q8"])
def test_plain_quant_histogram_on_uint16_ids_is_jax_bitwise(quant):
    n, f, b, width = 2500, 7, WIDE, 8
    binned, grad, hess, live, local = _u16_case(n, f, b, width, seed=11)
    dtype = np.int16 if quant == "q16" else np.int8
    lim = np.iinfo(dtype)
    rng = np.random.default_rng(12)
    gq = rng.integers(lim.min, lim.max + 1, size=n).astype(dtype)
    hq = rng.integers(lim.min, lim.max + 1, size=n).astype(dtype)
    gsi, hsi = 2.0 ** -11, 2.0 ** -7
    arrays = (binned, gq, hq, live, local)
    got = hist_cuda.level_histogram_quant(
        *(torch.from_numpy(a) for a in arrays), width, f, b, gsi, hsi)
    want = jax_trainer._level_histogram_quant(
        *(jnp.asarray(a) for a in arrays), width, f, b, jnp.float32(gsi),
        jnp.float32(hsi), formulation="per_feature")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_bin_id_limits_by_dtype():
    """uint8 ids take at most 256 bins, uint16 at most 65,536 (int32 ids
    any count: ``tests/test_torch_int32.py``); other id types raise
    before anything runs."""
    binned, grad, hess, live, local = (torch.from_numpy(a) for a in
                                       _u16_case(64, 2, 300, 2, seed=1))
    hist_cuda.level_histogram(binned, grad, hess, live, local, 2, 2, 65_536)
    for bad, b in ((binned, 65_537), (binned.view(torch.int16), 300),
                   (binned.to(torch.int64), 300),
                   (torch.zeros((64, 2), dtype=torch.uint8), 257)):
        with pytest.raises(ValueError):
            hist_cuda.level_histogram(bad, grad, hess, live, local, 2, 2, b)


# --- EFB ---------------------------------------------------------------------

def _one_hot_data(n=1500, dense=4, fields=(4, 6, 9), seed=5):
    """Dense normal columns and one-hot fields (one 1.0 per row per
    field), as OneHotEncoder -> VectorAssembler gives them; an
    integer-valued L2 label from both, so q8 sums stay exact."""
    rng = np.random.default_rng(seed)
    x = [rng.normal(size=(n, dense))]
    signal = 1.2 * x[0][:, 0]
    for k in fields:
        cat = rng.integers(0, k, size=n)
        block = np.zeros((n, k))
        block[np.arange(n), cat] = 1.0
        x.append(block)
        signal = signal + (cat % 3 == 0)
    y = np.round(signal + rng.normal(size=n) * 0.5)
    return np.hstack(x), y


def _plan_tuple(plan):
    return (plan.n_features, plan.n_bins, plan.passthrough,
            [[(m.feature, m.default_bin, m.offset, m.vals) for m in bd]
             for bd in plan.bundles])


def _ids(binned, max_bin):
    """The binned matrix as the fit holds it: a uint8 / uint16 tensor."""
    return trainer._binned_to_device(binned, max_bin, "cpu")


def _u16_numpy(t):
    return (t.view(torch.int16).numpy().view(np.uint16)
            if t.dtype == torch.uint16 else t.numpy())


@pytest.mark.parametrize("mode", ["auto", "on"])
@pytest.mark.parametrize("max_bin", [31, WIDE])
def test_plan_and_bundled_matrix_are_the_reference(mode, max_bin):
    """The plan worked out with torch ops (the pairwise conflict matrix)
    is the reference's, and so is the bundled matrix."""
    x, _ = _one_hot_data()
    binned, _ = _binned(x, max_bin)
    got = efb.plan_bundles(_ids(binned, max_bin), max_bin, mode=mode)
    want = jax_efb.plan_bundles(binned, max_bin, mode=mode)
    assert got is not None and want is not None
    assert _plan_tuple(got) == _plan_tuple(want)
    assert got.cache_key == want.cache_key
    assert got.n_cols == want.n_cols < x.shape[1]
    for name in ("scatter_arrays", "member_default_arrays",
                 "passthrough_arrays"):
        for a, b in zip(getattr(got, name)(), getattr(want, name)()):
            np.testing.assert_array_equal(a, b)
    bundled = efb.apply_plan(_ids(binned, max_bin), got)
    assert bundled.dtype == (torch.uint16 if max_bin > 256 else torch.uint8)
    np.testing.assert_array_equal(_u16_numpy(bundled),
                                  jax_efb.apply_plan(binned, want))


@pytest.mark.parametrize("mode", ["auto", "on"])
def test_plan_in_blocks_of_rows_is_the_reference(mode):
    """The conflict matrix and the bin counts summed over blocks of rows
    (here 1000 ids a block, a few rows each) give the reference's plan."""
    x, _ = _one_hot_data()
    binned, _ = _binned(x, 31)
    got = efb.plan_bundles(_ids(binned, 31), 31, mode=mode, block=1000)
    assert _plan_tuple(got) == _plan_tuple(
        jax_efb.plan_bundles(binned, 31, mode=mode))


def test_plan_samples_the_reference_rows():
    """Past ``sample_rows`` the defaults and the sparsity gate come from
    the reference's seeded row sample: the same plan."""
    x, _ = _one_hot_data(n=3000)
    binned, _ = _binned(x, 31)
    got = efb.plan_bundles(_ids(binned, 31), 31, sample_rows=257, seed=4)
    want = jax_efb.plan_bundles(binned, 31, sample_rows=257, seed=4)
    assert _plan_tuple(got) == _plan_tuple(want)


def test_plan_refuses_ids_past_n_bins():
    binned = torch.zeros((50, 3), dtype=torch.uint8)
    binned[7, 2] = 40
    with pytest.raises(ValueError, match="n_bins"):
        efb.plan_bundles(binned, 31)


def test_dense_data_and_off_plan_nothing():
    x, _, _ = _data(n=3000)
    binned, _ = _binned(x, 63)
    assert efb.plan_bundles(_ids(binned, 63), 63) is None
    assert jax_efb.plan_bundles(binned, 63) is None
    xo, _ = _one_hot_data()
    assert efb.plan_bundles(_ids(_binned(xo, 63)[0], 63), 63,
                            mode="off") is None


@pytest.mark.parametrize("value,want", [("", "auto"), ("off", "off"),
                                        ("ON", "on"), (" auto ", "auto")])
def test_resolve_efb(monkeypatch, value, want):
    monkeypatch.setenv(efb.EFB, value)
    monkeypatch.setenv("MMLSPARK_TPU_EFB", value)
    assert efb.resolve_efb() == want == jax_efb.resolve_efb(warn=False)


def test_bad_efb_value_warns_once_and_runs_auto(monkeypatch):
    from mmlspark_tpu_torch.core import env
    env.reset_warnings()
    monkeypatch.setenv(efb.EFB, "sometimes")
    with pytest.warns(UserWarning, match=efb.EFB):
        assert efb.resolve_efb() == "auto"


def _ref_unbundle(plan, hb, f, b):
    """The reference's ``_unbundle_hist`` (``make_build_tree``,
    ``mmlspark_tpu/models/gbdt/trainer.py:1437-1456``), line for line."""
    ub_sc_col, ub_sc_bin, ub_sc_feat, ub_sc_obin = plan.scatter_arrays()
    ub_md_feat, ub_md_bin = plan.member_default_arrays()
    ub_pt_col, ub_pt_feat = plan.passthrough_arrays()
    width = hb.shape[0]
    hist = jnp.zeros((width, f, b, 3), hb.dtype)
    if len(ub_pt_col):
        hist = hist.at[:, ub_pt_feat].set(hb[:, ub_pt_col])
    if len(ub_sc_col):
        hist = hist.at[:, ub_sc_feat, ub_sc_obin].set(
            hb[:, ub_sc_col, ub_sc_bin])
    if len(ub_md_feat):
        total = hb[:, 0].sum(axis=1)
        present = hist[:, ub_md_feat].sum(axis=2)
        hist = hist.at[:, ub_md_feat, ub_md_bin].set(
            total[:, None, :] - present)
    return hist


@pytest.mark.parametrize("mode", ["auto", "on"])
@pytest.mark.parametrize("max_bin", [31, WIDE])
def test_unbundled_histogram_is_the_reference_and_the_direct_one(max_bin,
                                                                 mode):
    """On integer stats (exact sums): the unbundled histogram equals the
    reference's unbundling of the same bundled histogram, and the
    histogram of the original matrix, bit for bit; under ``on`` a
    constant column joins a bundle with no slot of its own."""
    x, _ = _one_hot_data(n=2000)
    x = np.hstack([x, np.full((len(x), 1), 2.5)])
    binned, _ = _binned(x, max_bin)
    plan = efb.plan_bundles(_ids(binned, max_bin), max_bin, mode=mode)
    if mode == "on":
        assert any(not m.vals for bd in plan.bundles for m in bd)
    bundled = efb.apply_plan(_ids(binned, max_bin), plan)
    n, f = binned.shape
    rng = np.random.default_rng(9)
    grad = rng.integers(-8, 9, size=n).astype(np.float32)
    hess = rng.integers(1, 9, size=n).astype(np.float32)
    live = (rng.random(n) < 0.8).astype(np.float32)
    local = rng.integers(0, 4, size=n).astype(np.int32)
    stats = [torch.from_numpy(a) for a in (grad, hess, live, local)]
    hb = hist_cuda.level_histogram(bundled, *stats, 4, plan.n_cols, max_bin)
    got = trainer._unbundle_hist(hb, efb.device_maps(plan, "cpu"), f,
                                 max_bin)
    want = _ref_unbundle(plan, jnp.asarray(hb.numpy()), f, max_bin)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    direct = hist_cuda.level_histogram(torch.from_numpy(binned), *stats, 4,
                                       f, max_bin)
    np.testing.assert_array_equal(got.numpy(), direct.numpy())


@pytest.mark.parametrize("max_bin", [31, WIDE])
def test_unbundled_default_bins_on_float_stats(max_bin):
    """On float32 stats the default bins are where the port departs from
    the reference (ROADMAP C20): it takes the node total and the present
    bins in float64 and rounds once, the reference sums and subtracts in
    float32. Counts and every cell but the members' default bins stay
    bit for bit the reference's; a default bin lies within 4·u·Σ|x| of
    the direct histogram's (u = 2^-24, Σ|x| the node's absolute sum: one
    rounding of the direct cell, of each bundled cell summed and of the
    difference), and within (B + 4)·u·Σ|x| of the reference's (its
    float32 sums over B bins, the recursive-summation bound)."""
    x, _ = _one_hot_data(n=2000)
    binned, _ = _binned(x, max_bin)
    ids = _ids(binned, max_bin)
    plan = efb.plan_bundles(ids, max_bin)
    n, f = binned.shape
    rng = np.random.default_rng(11)
    grad = rng.normal(size=n).astype(np.float32)
    hess = (rng.random(n) + 0.05).astype(np.float32)
    live = (rng.random(n) < 0.8).astype(np.float32)
    local = rng.integers(0, 4, size=n).astype(np.int32)
    stats = [torch.from_numpy(a) for a in (grad, hess, live, local)]
    hb = hist_cuda.level_histogram(efb.apply_plan(ids, plan), *stats, 4,
                                   plan.n_cols, max_bin)
    got = trainer._unbundle_hist(hb, efb.device_maps(plan, "cpu"), f,
                                 max_bin).numpy()
    want = np.asarray(_ref_unbundle(plan, jnp.asarray(hb.numpy()), f,
                                    max_bin))
    direct = hist_cuda.level_histogram(ids, *stats, 4, f, max_bin).numpy()
    md = np.zeros((f, max_bin), bool)
    md[tuple(plan.member_default_arrays())] = True
    np.testing.assert_array_equal(got[..., 2], want[..., 2])
    np.testing.assert_array_equal(got[:, ~md], want[:, ~md])
    absum = np.stack([np.bincount(local, np.abs(grad) * live, 4),
                      np.bincount(local, hess * live, 4)], -1)
    u = 2.0 ** -24
    for ref, k in ((direct, 4), (want, max_bin + 4)):
        err = np.abs(got[..., :2] - ref[..., :2])[:, md]      # (4, M, 2)
        assert (err <= k * u * absum[:, None, :]).all()


@pytest.mark.parametrize("sub", ["0", "1"])
@pytest.mark.parametrize("max_bin", [63, WIDE])
def test_efb_fit_is_the_jax_efb_fit(monkeypatch, sub, max_bin):
    _knobs(monkeypatch, "q8", sub, bundling="auto")
    x, y = _one_hot_data()
    binned, upper = _binned(x, max_bin)
    cfg = dict(objective="regression", num_iterations=4, num_leaves=12,
               max_depth=4, max_bin=max_bin, min_data_in_leaf=10)
    jr, pr = _fit_both(binned, y, upper, **cfg)
    assert jr.hist_stats["efb_bundles"] == pr.hist_stats["efb_bundles"] == 3
    assert (jr.hist_stats["efb_bundled_features"]
            == pr.hist_stats["efb_bundled_features"] == 19)
    _assert_boosters_equal(pr.booster, jr.booster)
    _assert_evals_match(pr.evals, jr.evals)
    # the trees name original features, and split on bundled ones
    assert (pr.booster.split_feature >= 4).any()
    # bundling off: the same trees on these exact sums
    monkeypatch.setenv(efb.EFB, "off")
    off = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                        bin_upper=upper, device="cpu")
    assert off.hist_stats["efb_bundles"] == 0
    _assert_boosters_equal(off.booster, pr.booster)


def test_efb_fit_on_the_float32_plane_is_the_jax_efb_fit(monkeypatch):
    """Binary, float32 histograms, real gradients: the bundled members'
    default bins differ from the reference's by float32 rounding (ROADMAP
    C20), as every bin sum does on this plane (C4). Held as the float32
    fits of ``tests/test_torch_gbdt_train.py`` are: split features, bins
    and counts exact, node values within ``rtol=1e-5``."""
    _knobs(monkeypatch, "off", bundling="auto")
    x, y = _one_hot_data()
    y_bin = (y > np.median(y)).astype(np.float64)
    binned, upper = _binned(x, 63)
    jr, pr = _fit_both(binned, y_bin, upper, objective="binary",
                       num_iterations=5, num_leaves=12, max_depth=4,
                       max_bin=63, min_data_in_leaf=10)
    assert jr.hist_stats["efb_bundles"] == pr.hist_stats["efb_bundles"] == 3
    for name in ("split_feature", "threshold_bin", "count"):
        np.testing.assert_array_equal(getattr(pr.booster, name),
                                      getattr(jr.booster, name))
    np.testing.assert_allclose(pr.booster.node_value, jr.booster.node_value,
                               rtol=1e-5, atol=1e-7)


def test_efb_plans_where_the_reference_plans(monkeypatch):
    """Bundles are planned for fits without categorical features only,
    as the reference's ``train`` plans them (``trainer.py:2621-2630``)."""
    monkeypatch.setenv(efb.EFB, "auto")
    x, y = _one_hot_data(n=600)
    binned, upper = _binned(x, 31)
    base = dict(objective="regression", num_iterations=1, num_leaves=4,
                max_depth=2, max_bin=31)
    plain = trainer.train(binned, y, trainer.TrainConfig(**base),
                          bin_upper=upper, device="cpu")
    assert plain.hist_stats["efb_bundles"] == 3
    cat = trainer.train(binned, y, trainer.TrainConfig(
        **base, categorical_features=(5,)), bin_upper=upper, device="cpu")
    assert cat.hist_stats["efb_bundles"] == 0


def test_step_cache_key_separates_what_the_graph_bakes_in():
    """Fits that differ in their EFB plan, monotone vector, extra_trees,
    feature_fraction_by_node or bin-id dtype never share a capture."""
    b8 = torch.zeros((10, 3), dtype=torch.uint8)
    b16 = torch.zeros((10, 3), dtype=torch.uint16)
    base = trainer.TrainConfig(max_bin=200)
    keys = [step._cache_key(base, b8, None, [], "off", False)]
    keys.append(step._cache_key(base, b8, None, [], "off", False,
                                efb_key="abc"))
    keys.append(step._cache_key(base, b16, None, [], "off", False))
    for kw in (dict(monotone_constraints=(1, 0, 0)), dict(extra_trees=True),
               dict(feature_fraction_by_node=0.5)):
        keys.append(step._cache_key(trainer.TrainConfig(max_bin=200, **kw),
                                    b8, None, [], "off", False))
    assert len(set(keys)) == len(keys)


# --- max_bin above 256 -------------------------------------------------------

@pytest.mark.parametrize("objective", ["regression", "binary"])
@pytest.mark.parametrize("sub", ["0", "1"])
def test_wide_bin_fit_is_jax_bitwise(monkeypatch, objective, sub):
    _knobs(monkeypatch, "q8", sub)
    monkeypatch.setattr(torch, "sigmoid", _xla_sigmoid)
    x, y, y_bin = _data(n=1500)
    binned, upper = _binned(x, WIDE)
    assert binned.dtype == np.uint16 and binned.max() > 255
    jr, pr = _fit_both(binned, y_bin if objective == "binary" else y,
                       upper, objective=objective, num_iterations=4,
                       num_leaves=12, max_depth=4, max_bin=WIDE,
                       min_data_in_leaf=10)
    _assert_boosters_equal(pr.booster, jr.booster)
    _assert_evals_match(pr.evals, jr.evals)
    assert (pr.booster.threshold_bin > 255).any()
    # the uint16 rows score as the reference scores them
    want = np.asarray(jr.booster.predict_binned_jit()(binned))
    got = pr.booster.predict_binned(binned, device="cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_wide_bin_fit_on_float_stats_matches(monkeypatch):
    """The float32 plane at max_bin=1023: split features and bins
    exact, node values within ``rtol=1e-5`` (sums in another order), as
    the narrow fits are held."""
    x, y, _ = _data(n=1500)
    binned, upper = _binned(x, WIDE)
    jr, pr = _fit_both(binned, y, upper, objective="regression",
                       num_iterations=3, num_leaves=8, max_depth=3,
                       max_bin=WIDE)
    for name in ("split_feature", "threshold_bin", "count"):
        np.testing.assert_array_equal(getattr(pr.booster, name),
                                      getattr(jr.booster, name))
    np.testing.assert_allclose(pr.booster.node_value, jr.booster.node_value,
                               rtol=1e-5, atol=1e-7)


def test_bin_ids_past_uint16_raise(monkeypatch):
    """``max_bin`` past 65,536, which raised before int32 bin ids were
    ported, trains on int32 ids: the JAX package's fit bit for bit on q8
    (tests/test_torch_int32.py holds the int32 path at more sizes)."""
    x, y, _ = _data(n=200)
    binned, _ = _binned(x, 63)
    _knobs(monkeypatch, "q8")
    got = trainer.train(binned, y, trainer.TrainConfig(max_bin=65_537,
                                                       num_iterations=1),
                        device="cpu")
    want = jax_trainer.train(binned.astype(np.int32), y,
                             jax_trainer.TrainConfig(max_bin=65_537,
                                                     num_iterations=1))
    _assert_boosters_equal(got.booster, want.booster)
    # 65,536 bins is the most uint16 ids hold: it trains
    res = trainer.train(binned, y, trainer.TrainConfig(
        max_bin=65_536, num_iterations=1, max_depth=2, num_leaves=4),
        device="cpu")
    assert res.booster.num_trees == 1


# --- monotone constraints, extra_trees, feature_fraction_by_node -------------

def jax_tree_draw(b):
    """``sampling.draw`` with the reference's draws, the tree streams
    included: ``uniform`` for ``feature_fraction_by_node``'s (seed, 4 + c,
    extra_seed, it, 101, d) and, for ``extra_trees``' (seed, 4 + c,
    extra_seed, it, d), the midpoints ``(randint + 0.5) / (b - 1)`` that
    ``extra_bins`` floors back to ``randint(0, b - 1)``."""
    def draw(keys, n, device):
        if int(keys[1]) < sampling.TREE:
            return jax_draw(keys, n, device)
        key = jax_key(keys)
        if len(keys) == 6:
            out = np.array(jax.random.uniform(key, (n,)))
        else:
            ints = np.asarray(jax.random.randint(key, (n,), 0, b - 1))
            out = ((ints + 0.5) / (b - 1)).astype(np.float32)
        return torch.from_numpy(out).to(device)
    return draw


BREADTH = {
    "monotone": dict(monotone_constraints=(1, -1, 0, 0, 0, 0)),
    "monotone_short": dict(monotone_constraints=(0, -1), lambda_l2=1.0,
                           path_smooth=2.0, max_delta_step=0.8),
    "extra_trees": dict(extra_trees=True, extra_seed=11),
    "by_node": dict(feature_fraction_by_node=0.6),
    "by_node_under_feature_fraction": dict(feature_fraction_by_node=0.5,
                                           feature_fraction=0.7),
    "all_three": dict(monotone_constraints=(1, -1), extra_trees=True,
                      feature_fraction_by_node=0.7),
    "all_three_bagged_wide": dict(monotone_constraints=(1, 0, -1),
                                  extra_trees=True,
                                  feature_fraction_by_node=0.7,
                                  bagging_fraction=0.7, bagging_freq=1,
                                  max_bin=WIDE),
    "binary_extra_trees": dict(objective="binary", extra_trees=True),
    "goss_monotone": dict(boosting_type="goss", monotone_constraints=(1,)),
}


@pytest.mark.parametrize("sub", ["0", "1"])
@pytest.mark.parametrize("case", sorted(BREADTH))
def test_breadth_fit_is_jax_bitwise_given_its_draws(monkeypatch, case, sub):
    _knobs(monkeypatch, "q8", sub)
    kw = {**dict(objective="regression", num_iterations=5, num_leaves=12,
                 max_depth=4, max_bin=63, min_data_in_leaf=10),
          **BREADTH[case]}
    monkeypatch.setattr(sampling, "draw", jax_tree_draw(kw["max_bin"]))
    monkeypatch.setattr(torch, "sigmoid", _xla_sigmoid)
    x, y, y_bin = _data()
    binned, upper = _binned(x, kw["max_bin"])
    jr, pr = _fit_both(binned, y_bin if kw["objective"] == "binary" else y,
                       upper, **kw)
    if "monotone_constraints" in kw and kw.get("path_smooth"):
        _assert_boosters_within_c19(pr.booster, jr.booster)
    else:
        _assert_boosters_equal(pr.booster, jr.booster)
    _assert_evals_match(pr.evals, jr.evals)
    # the settings took effect: the trees differ from the plain fit's
    plain = {k: v for k, v in kw.items() if k not in (
        "monotone_constraints", "extra_trees", "feature_fraction_by_node")}
    free = trainer.train(binned, y_bin if kw["objective"] == "binary" else y,
                         trainer.TrainConfig(**plain), bin_upper=upper,
                         device="cpu")
    assert not all(np.array_equal(getattr(free.booster, a),
                                  getattr(pr.booster, a))
                   for a in ("split_feature", "threshold_bin", "node_value"))


def test_multiclass_extra_trees_draw_per_class(monkeypatch):
    """K trees per iteration, each from its own stream (4 + class): bit
    for bit the reference's given its draws and XLA's ``exp``."""
    _knobs(monkeypatch, "q8")
    monkeypatch.setattr(sampling, "draw", jax_tree_draw(31))
    monkeypatch.setattr(torch, "exp", lambda t: torch.from_numpy(
        np.array(jnp.exp(t.numpy()))))
    x, y, _ = _data(n=900)
    y3 = np.digitize(y, [-1.0, 1.0]).astype(np.float64)
    binned, upper = _binned(x, 31)
    jr, pr = _fit_both(binned, y3, upper, objective="multiclass",
                       num_class=3, num_iterations=3, num_leaves=8,
                       max_depth=3, max_bin=31, extra_trees=True,
                       feature_fraction_by_node=0.7)
    _assert_boosters_equal(pr.booster, jr.booster)


def test_monotone_constraints_validate_as_the_reference():
    assert trainer.TrainConfig(monotone_constraints=[1, 0, -1]) \
        .monotone_constraints == (1, 0, -1)
    assert trainer.TrainConfig(monotone_constraints=1) \
        .monotone_constraints == (1,)
    assert not trainer.TrainConfig(monotone_constraints=(0, 0)).has_monotone
    x, y, _ = _data(n=300, f=3)
    binned, _ = _binned(x, 15)
    with pytest.raises(ValueError, match="only 3 features"):
        trainer.train(binned, y, trainer.TrainConfig(
            max_bin=15, num_iterations=1, monotone_constraints=(1, 0, 0, 1)),
            device="cpu")


def _sweep_violations(booster, binned, feature, direction, rows):
    """The largest step against ``direction`` of the raw score when one
    feature's bin sweeps every bin (0 .. max) with the other bins of each
    sampled row fixed."""
    top = int(binned[:, feature].max())
    worst = 0.0
    for r in rows:
        probe = np.repeat(binned[r:r + 1], top + 1, axis=0)
        probe[:, feature] = np.arange(top + 1)
        raw = booster.predict_binned(probe, device="cpu").numpy()
        worst = max(worst, float(np.max(-direction * np.diff(raw))))
    return worst


@pytest.mark.parametrize("extra", [{}, {"extra_trees": True},
                                   {"feature_fraction_by_node": 0.7,
                                    "max_bin": WIDE}])
def test_monotone_fit_is_exactly_monotone_with_the_ports_draws(extra):
    x, y, _ = _data(n=2000)
    cfg = {**dict(objective="regression", num_iterations=15, num_leaves=15,
                  max_depth=4, max_bin=63, monotone_constraints=(1, -1)),
           **extra}
    binned, upper = _binned(x, cfg["max_bin"])
    res = trainer.train(binned, y, trainer.TrainConfig(**cfg),
                        bin_upper=upper, device="cpu")
    rows = np.random.default_rng(0).choice(len(y), 64, replace=False)
    for feature, direction in ((0, 1), (1, -1)):
        assert _sweep_violations(res.booster, binned, feature, direction,
                                 rows) == 0.0
    # unconstrained, the same data break monotonicity along feature 1
    free = trainer.train(binned, y, trainer.TrainConfig(**{
        **cfg, "monotone_constraints": (), "num_iterations": 15}),
        bin_upper=upper, device="cpu")
    assert (_sweep_violations(free.booster, binned, 1, -1, rows) > 0
            or _sweep_violations(free.booster, binned, 0, 1, rows) > 0)


def test_extra_bins_and_node_masks_follow_their_contracts():
    """``extra_bins`` lies in [0, b - 1); ``node_feature_mask`` keeps
    ``max(1, round(avail * fraction))`` of the tree's features per node,
    only those; the draws are pure functions of their keys, an iteration
    given as an int or a device scalar alike."""
    cfg = trainer.TrainConfig(extra_seed=4, seed=2)
    for b in (2, 63, WIDE, 65_536):
        u = sampling.draw(sampling.tree_keys(cfg, 0, 3) + (1,), 5000, "cpu")
        bins = sampling.extra_bins(u, b)
        assert int(bins.min()) >= 0 and int(bins.max()) < max(b - 1, 1)
    edge = sampling.extra_bins(torch.tensor([1 - 2.0 ** -24]), 65_536)
    assert int(edge) == 65_534
    fm = torch.tensor([1, 0, 1, 1, 0, 1, 1, 0], dtype=torch.float32)
    for frac in (0.01, 0.3, 0.5, 0.9):
        d = sampling.draw(sampling.tree_keys(cfg, 1, torch.tensor(7))
                          + (sampling.NODE_FEATURES, 2), 4 * 8, "cpu")
        mask = sampling.node_feature_mask(d.reshape(4, 8), fm, frac)
        keep = max(1, int(np.round(np.float32(5) * np.float32(frac))))
        assert mask.sum(dim=1).tolist() == [keep] * 4
        assert not (mask & (fm == 0)).any()
        again = sampling.draw(sampling.tree_keys(cfg, 1, 7)
                              + (sampling.NODE_FEATURES, 2), 32, "cpu")
        assert torch.equal(d, again)
    every = sampling.node_feature_mask(torch.rand(3, 5), None, 0.4)
    assert every.sum(dim=1).tolist() == [2, 2, 2]


# --- the reference's fixtures, with the port's own draws (C13) ---------------

def _noisy_frame():
    """``tests/gbdt/test_monotone.py``'s ``noisy_df``."""
    rng = np.random.default_rng(0)
    n = 3000
    x = rng.normal(size=(n, 3))
    y = 1.5 * x[:, 0] + np.sin(x[:, 1] * 3) + rng.normal(size=n) * 0.8
    return DataFrame({"features": x, "label": y}), x


def _violations(model, x, feature, grid=None):
    grid = grid if grid is not None else np.linspace(-3, 3, 41)
    worst = 0.0
    for row in x[:20]:
        probe = np.tile(row, (len(grid), 1))
        probe[:, feature] = grid
        pred = model.booster.predict(probe, device="cpu").numpy()
        worst = max(worst, float(np.max(np.diff(pred) * -1)))
    return worst


def test_reference_monotone_fixtures_hold():
    """``test_constrained_fit_is_monotone``, ``test_decreasing_constraint``
    and ``test_unconstrained_config_unchanged`` on the port."""
    df, x = _noisy_frame()
    kw = dict(numIterations=40, numLeaves=15, maxDepth=4, maxBin=64)
    free = estimators.LightGBMRegressor(**kw).set_device("cpu").fit(df)
    mono = estimators.LightGBMRegressor(
        monotoneConstraints=[1, 0, 0], **kw).set_device("cpu").fit(df)
    v_free, v_mono = _violations(free, x, 0), _violations(mono, x, 0)
    assert v_mono <= 1e-5 and v_free > v_mono
    y = np.asarray(df.col("label"))
    for m in (free, mono):
        assert float(np.corrcoef(m.transform(df)["prediction"], y)[0, 1]) \
            > 0.8
    dec = estimators.LightGBMRegressor(
        monotoneConstraints=[-1, 0, 0], numIterations=20, numLeaves=15,
        maxDepth=4, maxBin=64).set_device("cpu").fit(df)
    grid = np.linspace(-3, 3, 41)
    for row in x[:10]:
        probe = np.tile(row, (len(grid), 1))
        probe[:, 0] = grid
        pred = dec.booster.predict(probe, device="cpu").numpy()
        assert float(np.max(np.diff(pred))) <= 1e-5
    kw = dict(numIterations=5, numLeaves=8, maxBin=32)
    a = estimators.LightGBMRegressor(**kw).set_device("cpu").fit(df)
    b = estimators.LightGBMRegressor(monotoneConstraints=[0, 0, 0],
                                     **kw).set_device("cpu").fit(df)
    np.testing.assert_array_equal(a.booster.node_value, b.booster.node_value)


def _reg_frame():
    """``tests/gbdt/test_extended_params.py``'s ``reg_df`` (``rng`` is
    ``default_rng(42)``)."""
    rng = np.random.default_rng(42)
    x = rng.normal(size=(1200, 4))
    y = 2.0 * x[:, 0] - x[:, 1] + rng.normal(size=1200) * 0.3
    return DataFrame({"features": x, "label": y}), x, y


def test_reference_extra_trees_and_by_node_fixtures_hold():
    """``test_extra_trees_randomizes_thresholds`` and
    ``test_feature_fraction_by_node`` on the port."""
    df, x, y = _reg_frame()
    kw = dict(numIterations=10, numLeaves=8, maxBin=64)
    et = estimators.LightGBMRegressor(extraTrees=True, **kw) \
        .set_device("cpu").fit(df)
    full = estimators.LightGBMRegressor(**kw).set_device("cpu").fit(df)
    assert not np.array_equal(et.booster.threshold_bin,
                              full.booster.threshold_bin)
    pe = np.asarray(et.transform(df)["prediction"])
    assert np.corrcoef(pe, y)[0, 1] > 0.85
    et2 = estimators.LightGBMRegressor(extraTrees=True, **kw) \
        .set_device("cpu").fit(df)
    np.testing.assert_array_equal(et.booster.threshold_bin,
                                  et2.booster.threshold_bin)
    kw = dict(numIterations=6, numLeaves=8, maxBin=32)
    m = estimators.LightGBMRegressor(featureFractionByNode=0.5, **kw) \
        .set_device("cpu").fit(df)
    pred = np.asarray(m.transform(df)["prediction"])
    assert np.corrcoef(pred, y)[0, 1] > 0.8
    distinct = {int(f) for t in range(m.booster.num_trees)
                for f in m.booster.split_feature[t] if f >= 0}
    assert len(distinct) > 2


# --- estimators --------------------------------------------------------------

@pytest.mark.parametrize("params", [
    {"maxBin": WIDE},
    {"monotoneConstraints": [1, -1, 0, 0, 0, 0]},
    {"maxBin": WIDE, "monotoneConstraints": [0, 1], "pathSmooth": 1.0},
])
def test_estimator_fit_is_jax_bitwise(monkeypatch, params):
    """Bit for bit on q8, boosters and transforms; with monotone
    constraints and path smoothing together within C19's two ulps per
    node value, so each prediction (four trees of values below 1) within
    ``atol=1e-6``."""
    _knobs(monkeypatch, "q8")
    x, y, _ = _data(n=1500)
    cols = {"features": x, "label": y}
    kw = dict(numIterations=4, numLeaves=12, maxDepth=4, **params)
    port = estimators.LightGBMRegressor(**kw).set_device("cpu").fit(
        DataFrame(cols))
    ref = jax_est.LightGBMRegressor(**kw).fit(JaxFrame(cols))
    c19 = "pathSmooth" in params
    (_assert_boosters_within_c19 if c19 else _assert_boosters_equal)(
        port.booster, ref.booster)
    for binned in (False, True):
        port.set("binnedScoring", binned)
        ref.set("binnedScoring", binned)
        np.testing.assert_allclose(
            port.transform(DataFrame({"features": x}))["prediction"],
            ref.transform(JaxFrame({"features": x}))["prediction"],
            rtol=0, atol=1e-6 if c19 else 0)


@pytest.mark.parametrize("params", [
    {"maxBin": WIDE}, {"monotoneConstraints": [1, 0, -1]},
    {"maxBin": WIDE, "monotoneConstraints": [0, -1], "extraTrees": True}])
def test_models_cross_both_ways(params):
    """A JAX model at ``maxBin=1023`` or with monotone constraints
    carries over through ``model_from_jax`` (transforms bitwise, raw and
    binned), and the port's model string loads in the JAX package and
    scores the same bits."""
    x, _, y_bin = _data(n=1200)
    cols = {"features": x, "label": y_bin}
    ref = jax_est.LightGBMClassifier(numIterations=5, numLeaves=15,
                                     **params).fit(JaxFrame(cols))
    state = {k: (np.asarray(v) if hasattr(v, "shape") else v)
             for k, v in ref._get_state().items()}
    port = model_from_jax("LightGBMClassificationModel", state,
                          ref.simple_param_values()).set_device("cpu")
    for binned in (False, True):
        port.set("binnedScoring", binned)
        ref.set("binnedScoring", binned)
        got = port.transform(DataFrame({"features": x}))
        want = ref.transform(JaxFrame({"features": x}))
        for col in want.columns:
            np.testing.assert_array_equal(got[col], want[col])
    if "maxBin" in params:
        assert binned_ingest_dtype(port.bin_mapper.max_num_bins) == np.uint16
    # port -> JAX: the port's fit, as a model string
    mine = estimators.LightGBMClassifier(
        numIterations=5, numLeaves=15, **params).set_device("cpu").fit(
            DataFrame(cols))
    text = mine.get_model_string()
    back = JaxBooster.load_model_string(text)
    np.testing.assert_array_equal(
        np.asarray(back.predict_jit()(x)),
        mine.booster.predict(x, device="cpu").numpy())
    assert BoosterArrays.load_model_string(text).save_model_string() == text


@pytest.mark.parametrize("extra", [
    dict(monotone_constraints=(0, -1), path_smooth=2.0),
    dict(monotone_constraints=(1, 1), path_smooth=1.0, lambda_l2=1.0,
         max_delta_step=0.8),
    dict(categorical_features=(5,), path_smooth=3.0),
    dict(extra_trees=True, path_smooth=1.5, max_depth=5, num_leaves=20),
    dict(feature_fraction_by_node=0.7, path_smooth=1.5),
    dict(monotone_constraints=(1, 1), path_smooth=1.5, max_depth=5,
         num_leaves=20),
])
def test_path_smoothing_on_the_general_branch_matches_jax(monkeypatch,
                                                          extra):
    """Path smoothing on the general branch rounds as the numeric path's,
    ``fma(parent, 1 - w, value * w)`` (``trainer._smooth``): bit for bit
    on q8 without monotone constraints. Where monotone bounds follow it
    XLA's CPU backend contracts the other product at some nodes (ROADMAP
    C19), so monotone fits hold the trees' splits and counts exactly and
    node values within ``rtol=4e-7`` (one rounding of the fused op, then
    the shrinkage's: two float32 ulps)."""
    _knobs(monkeypatch, "q8")
    kw = {**dict(objective="regression", num_iterations=4, num_leaves=12,
                 max_depth=4, max_bin=63, min_data_in_leaf=10), **extra}
    monkeypatch.setattr(sampling, "draw", jax_tree_draw(kw["max_bin"]))
    x, y, _ = _data()
    if kw.get("categorical_features"):
        x[:, 5] = np.random.default_rng(1).integers(0, 7, size=len(y))
        y = y + (x[:, 5] % 2)
    binned, upper = _binned(x, kw["max_bin"])
    jr, pr = _fit_both(binned, y, upper, **kw)
    if "monotone_constraints" in kw:
        _assert_boosters_within_c19(pr.booster, jr.booster)
    else:
        _assert_boosters_equal(pr.booster, jr.booster)


def test_checkpoint_fingerprints_cover_the_settings(tmp_path):
    """A checkpointed fit's fingerprint is the JAX estimator's with
    ``maxBin=1023``, monotone constraints, ``extraTrees`` and
    ``featureFractionByNode`` set (a directory crosses the packages), and
    differs from the plain fit's (a resume never mixes them)."""
    import json

    x, y, _ = _data(n=600)
    cols = {"features": x, "label": y}
    kw = dict(numIterations=2, numLeaves=4, maxDepth=2, checkpointInterval=1)
    breadth = dict(maxBin=WIDE, monotoneConstraints=[1, 0, -1],
                   extraTrees=True, featureFractionByNode=0.7)
    metas = []
    for name, est, params in (("port", estimators, breadth),
                              ("jax", jax_est, breadth),
                              ("plain", estimators, {})):
        model = est.LightGBMRegressor(checkpointDir=str(tmp_path / name),
                                      **kw, **params)
        if est is estimators:
            model.set_device("cpu")
        model.fit((DataFrame if est is estimators else JaxFrame)(cols))
        with open(tmp_path / name / "checkpoint_meta.json") as fh:
            metas.append(json.load(fh)["fingerprint"])
    assert metas[0] == metas[1] != metas[2]
