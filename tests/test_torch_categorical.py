"""Categorical features and missing values in the port, held against the
JAX package on the same seeded numpy inputs, on the CPU.

  - routing by decision bits (``score_cuda.decision_left``, the plain
    version of ``csrc/tree_score.cu``'s decision route) against the JAX
    package's ``_go_left_fn`` and ``predict_jit``, over every
    decision-bit combination and the category edge cases (NaN, 0.0,
    -0.0, negative, fractional, unseen and out-of-range values): bit for
    bit;
  - the LightGBM golden fixture (a categorical tree): ``predict`` and
    ``leaf_index`` bit for bit against ``predict_jit`` and
    ``leaf_index_fn``;
  - the decision tables: pushed-down leaves behind nodes every value
    passes, the leaf-slot map, and a scalar replay of the kernel's rule;
  - categorical ``BinMapper`` fit, transform and round trip: bit for bit;
  - categorical and zero-as-missing fits against the JAX trainer on the
    q8 plane (both sides; the JAX side pins its ``per_feature``
    formulation, ROADMAP C1): every booster array, the decision bits, the
    bitsets and the model string bit for bit, L2 labels (torch's sigmoid
    is not XLA's, C10);
  - estimator fits and transforms with both reply columns, through
    ``model_from_jax`` and fitted in the port; model strings both ways;
  - the serving plane: a categorical model is refused by the binned plane
    with the JAX reasons and served through ``transform``; a
    zero-as-missing model is served binned through the zero premap; both
    reply as ``transform`` does, bit for bit.
"""

import itertools
import json
import os
import urllib.request

import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu.models.gbdt.booster import BoosterArrays as JaxBooster
from mmlspark_tpu.ops.binning import BinMapper as JaxBinMapper
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.io.serving import ServingServer
from mmlspark_tpu_torch.models.gbdt import estimators, sampling, \
    score_cuda, step, trainer
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
from mmlspark_tpu_torch.models.gbdt.convert import model_from_jax
from mmlspark_tpu_torch.ops.binning import BinMapper
from tests.test_torch_sampling import jax_draw

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "gbdt", "fixtures",
                      "lightgbm_golden_model.txt")
NF, DEPTH = 4, 3
# every numeric decision byte LightGBM writes (bit 1 default-left, bits
# 2-3 missing type, 3 out of spec) and categorical ones (bit 0)
NUMERIC_BITS = [0, 2, 4, 6, 8, 10, 12, 14]
CATEGORICAL_BITS = [1, 3, 9, 11]
# values against thresholds on a grid through 0.0 and categories 0..70
EDGE_VALUES = np.array([np.nan, 0.0, -0.0, -0.7, -1.0, 0.25, 0.5, 1.5, 3.0,
                        3.7, 5.0, 31.0, 32.0, 33.9, 63.0, 64.0, 70.0, -5.5,
                        np.inf, -np.inf, 1e9])


@pytest.fixture(autouse=True)
def _pin_reference(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")
    for name in ("MMLSPARK_TPU_PALLAS_HIST", "MMLSPARK_TPU_HIST_QUANT",
                 "MMLSPARK_TPU_HIST_SUB", "MMLSPARK_TPU_GROW_POLICY",
                 trainer.HIST_QUANT_ENV, trainer.HIST_SUB_ENV):
        monkeypatch.delenv(name, raising=False)


def _q8(monkeypatch, subtract=False):
    """The q8 plane on both sides (bin sums exact in float32, exponents
    where XLA's ``exp2`` is a power of two), subtraction as asked."""
    monkeypatch.setenv("MMLSPARK_TPU_HIST_QUANT", "q8")
    monkeypatch.setenv(trainer.HIST_QUANT_ENV, "q8")
    flag = "1" if subtract else "0"
    monkeypatch.setenv("MMLSPARK_TPU_HIST_SUB", flag)
    monkeypatch.setenv(trainer.HIST_SUB_ENV, flag)


def _decision_arrays(bits, seed=0, words=3, trees=6):
    """A full ensemble of depth 3 over 4 features whose internal nodes
    carry the decision bytes ``bits`` (cycled), thresholds on a grid
    through 0.0 (NaN at categorical nodes, as loaded strings carry) and
    random bitsets of ``words`` words; some nodes are leaves early."""
    rng = np.random.default_rng(seed)
    m = 2 ** (DEPTH + 1) - 1
    internal = np.zeros((trees, m), bool)
    internal[:, :2 ** DEPTH - 1] = True
    internal[:, 2] &= rng.random(trees) < 0.5        # an early leaf
    internal[:, 5:7] &= internal[:, 2:3]
    sf = np.where(internal, rng.integers(0, NF, (trees, m)), -1)
    grid = np.array([-1.0, -0.5, 0.0, 0.25, 1.5, np.nan])
    codes = np.resize(np.asarray(bits), trees * m).reshape(trees, m)
    dt = np.where(internal, codes, 0).astype(np.int8)
    tv = np.where(internal, grid[rng.integers(0, len(grid), (trees, m))],
                  np.inf)
    tv = np.where((dt & 1) == 1, np.nan, tv)
    return dict(
        split_feature=sf.astype(np.int32),
        threshold_bin=np.where(internal, 1, 0).astype(np.int32),
        threshold_value=tv,
        node_value=rng.normal(size=(trees, m)).astype(np.float32),
        count=rng.integers(1, 50, (trees, m)).astype(np.float32),
        tree_weights=rng.uniform(0.3, 1.7, trees).astype(np.float32),
        max_depth=DEPTH, num_features=NF, init_score=0.25,
        decision_type=dt,
        cat_bitset=rng.integers(0, 2 ** 32, (trees, m, words),
                                dtype=np.uint64).astype(np.uint32))


def _edge_rows(n=160, seed=1):
    rng = np.random.default_rng(seed)
    return rng.choice(EDGE_VALUES, size=(n, NF))


BIT_CASES = {f"num_{b}": [b] for b in NUMERIC_BITS}
BIT_CASES.update({f"cat_{b}": [b, 10] for b in CATEGORICAL_BITS})
BIT_CASES["all"] = NUMERIC_BITS + CATEGORICAL_BITS


@pytest.mark.parametrize("case", list(BIT_CASES))
def test_go_left_is_the_jax_routing_bit_for_bit(case):
    """``decision_left`` at every node of every tree against the JAX
    package's ``_go_left_fn`` on the same values."""
    arrays = _decision_arrays(BIT_CASES[case])
    jb, pb = JaxBooster(**arrays), BoosterArrays(**arrays)
    x = _edge_rows()
    route = jb._go_left_fn()
    mine = pb._router("cpu")
    nodes = np.arange(pb.num_nodes, dtype=np.int32)
    xt = torch.as_tensor(x, dtype=torch.float32)
    for t in range(pb.num_trees):
        fx = x[:, np.maximum(pb.split_feature[t], 0)].astype(np.float32)
        want = np.asarray(route(t, nodes, fx))
        got = mine(t, torch.as_tensor(nodes, dtype=torch.int64),
                   xt[:, torch.as_tensor(np.maximum(pb.split_feature[t],
                                                    0))])
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("case", list(BIT_CASES))
def test_predict_and_leaf_index_are_jax_bit_for_bit(case):
    """The decision route's plain version (``tree_score_reference``) on
    the packed tables: scores bitwise ``predict_jit``, leaf slots
    bitwise ``leaf_index_fn``, from one walk."""
    arrays = _decision_arrays(BIT_CASES[case], seed=2)
    jb, pb = JaxBooster(**arrays), BoosterArrays(**arrays)
    x = _edge_rows(seed=3)
    np.testing.assert_array_equal(pb.predict(x, device="cpu").numpy(),
                                  np.asarray(jb.predict_jit()(x)))
    np.testing.assert_array_equal(pb.leaf_index(x, device="cpu").numpy(),
                                  np.asarray(jb.leaf_index_jit()(x)))
    scorer = pb._scorer(True, "off", "cpu", decision=True)
    assert scorer.tables.decision and scorer.tables.route == "decision"


def test_boosters_without_bits_give_jax_leaf_indices():
    """A booster without decision bits keeps the raw route for scores;
    its leaf slots come from the decision route at bits 10, which is how
    it routes: bitwise ``leaf_index_fn`` on rows with NaN."""
    arrays = _decision_arrays([10], seed=4)
    del arrays["decision_type"], arrays["cat_bitset"]
    jb, pb = JaxBooster(**arrays), BoosterArrays(**arrays)
    x = _edge_rows(seed=5)
    np.testing.assert_array_equal(pb.leaf_index(x, device="cpu").numpy(),
                                  np.asarray(jb.leaf_index_jit()(x)))
    np.testing.assert_array_equal(pb.predict(x, device="cpu").numpy(),
                                  np.asarray(jb.predict_jit()(x)))
    assert not pb._scorer(True, "off", "cpu").tables.decision


@pytest.fixture(scope="module")
def golden():
    with open(GOLDEN) as fh:
        text = fh.read()
    return text, JaxBooster.load_model_string(text), \
        BoosterArrays.load_model_string(text)


def _golden_rows(n=64, seed=6):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 5))
    x[:, 4] = rng.choice([0, 1, 2, 3, 4, 5, 6, 7, 9, 40, -1, 2.5, np.nan],
                         size=n)
    x[rng.random((n, 5)) < 0.1] = np.nan
    return x


def test_golden_fixture_predicts_and_indexes_leaves_as_jax(golden):
    _, jb, pb = golden
    assert pb.has_categorical and pb.cat_bitset.shape == jb.cat_bitset.shape
    np.testing.assert_array_equal(pb.decision_type, jb.decision_type)
    np.testing.assert_array_equal(pb.cat_bitset, jb.cat_bitset)
    x = _golden_rows()
    np.testing.assert_array_equal(pb.predict(x, device="cpu").numpy(),
                                  np.asarray(jb.predict_jit()(x)))
    np.testing.assert_array_equal(pb.leaf_index(x, device="cpu").numpy(),
                                  np.asarray(jb.leaf_index_fn()(x)))


def test_golden_fixture_crosses_both_ways(golden):
    """The port writes the JAX package's text for the golden booster, and
    each package loads the other's string to the same arrays."""
    _, jb, pb = golden
    text = pb.save_model_string()
    assert text == jb.save_model_string()
    back = JaxBooster.load_model_string(text)
    for name in ("split_feature", "threshold_value", "node_value", "count",
                 "decision_type", "cat_bitset"):
        np.testing.assert_array_equal(getattr(back, name), getattr(pb, name))
    again = BoosterArrays.load_model_string(jb.save_model_string())
    np.testing.assert_array_equal(again.cat_bitset, pb.cat_bitset)


def test_binned_scoring_refuses_categorical_boosters_as_jax(golden):
    _, jb, pb = golden
    with pytest.raises(NotImplementedError, match="categorical splits route"):
        jb.predict_binned_fn()
    for fn in (lambda: pb.predict_binned(np.zeros((2, 5), np.uint8),
                                         device="cpu"),
               lambda: pb.predict_binned_scorer("off", "cpu"),
               pb.derive_binning):
        with pytest.raises(NotImplementedError,
                           match="categorical splits route by raw-value"):
            fn()


def test_numeric_decision_bits_score_binned_as_jax():
    """A numeric booster with bits scores binned by ``threshold_bin``
    alone, as ``predict_binned_fn`` does."""
    arrays = _decision_arrays([6, 10, 8], seed=7)
    arrays["threshold_bin"] = np.where(arrays["split_feature"] >= 0,
                                       np.random.default_rng(8).integers(
                                           0, 30, arrays["split_feature"]
                                           .shape), 0).astype(np.int32)
    jb, pb = JaxBooster(**arrays), BoosterArrays(**arrays)
    bins = np.random.default_rng(9).integers(0, 31, (50, NF)).astype(np.uint8)
    np.testing.assert_array_equal(
        pb.predict_binned(bins, device="cpu").numpy(),
        np.asarray(jb.predict_binned_jit()(bins)))


# --- the decision tables -----------------------------------------------------

def test_decision_tables_push_leaves_down_behind_nodes_every_value_passes():
    arrays = _decision_arrays(NUMERIC_BITS + CATEGORICAL_BITS, seed=10)
    pb = BoosterArrays(**arrays)
    tables = pb._scorer(True, "off", "cpu", decision=True).tables
    feat, dt, thr, word = score_cuda.unpack_nodes(tables)
    m = tables.num_nodes
    sf = arrays["split_feature"]
    for t in range(pb.num_trees):
        for slot in range(2 ** DEPTH - 1):
            i = t * m + slot
            if sf[t, slot] < 0:   # pushed down: byte 0, threshold +inf
                assert int(feat[i]) == 0 and int(dt[i]) == 0
                assert float(thr[i]) == np.inf
                left = score_cuda.decision_left(
                    torch.tensor([np.nan, 0.0, -0.0, -np.inf, np.inf, 7.5],
                                 dtype=torch.float32),
                    dt[i].expand(6), thr[i].expand(6))
                assert bool(left.all())
            else:
                assert int(feat[i]) == sf[t, slot]
                assert int(dt[i]) == int(arrays["decision_type"][t, slot]) \
                    & 0xFF
    # the leaf slot of every last-level slot a walk can end on: the
    # first leaf of the path to it, where the reference's scan stops
    slots = tables.leaf_slot.numpy().reshape(pb.num_trees, m)
    for t in range(pb.num_trees):
        for last in range(2 ** DEPTH - 1, m):
            path = [last]
            while path[-1] > 0:
                path.append((path[-1] - 1) // 2)
            path.reverse()
            first = next(i for i, node in enumerate(path) if sf[t, node] < 0)
            if all(path[j] == 2 * path[j - 1] + 1
                   for j in range(first + 1, len(path))):
                assert slots[t, last] == path[first]


def test_decision_bitsets_hold_only_the_categorical_nodes():
    arrays = _decision_arrays([10, 1, 6], seed=11, words=2)
    sf, dt = arrays["split_feature"], arrays["decision_type"]
    nodes, _, bits, words, _ = score_cuda.pack_decision_nodes(
        sf, arrays["threshold_value"], arrays["node_value"], DEPTH, dt,
        arrays["cat_bitset"])
    cat = (sf >= 0) & ((dt & 1) == 1)
    assert words == 2 and bits.size == 2 * int(cat.sum())
    offsets = nodes[:, 1].reshape(sf.shape)[cat]
    np.testing.assert_array_equal(offsets, 2 * np.arange(int(cat.sum())))
    np.testing.assert_array_equal(
        bits.view(np.uint32).reshape(-1, 2), arrays["cat_bitset"][cat])
    # no categorical node: one zero word, bit 0 cleared at numeric nodes
    nodes, _, bits, words, _ = score_cuda.pack_decision_nodes(
        sf, arrays["threshold_value"], arrays["node_value"], DEPTH,
        np.where(sf >= 0, 10, 0), None)
    assert words == 1 and bits.tolist() == [0]
    with pytest.raises(ValueError, match="65535"):
        score_cuda.pack_decision_nodes(
            np.array([[70_000, -1, -1]]), np.zeros((1, 3)),
            np.zeros((1, 3), np.float32), 1, np.array([[10, 0, 0]]), None)


def _kernel_rule(v, word0, word1, bits, bit_words):
    """``Node<DFloat>::left`` of ``csrc/tree_score.cu`` in scalar numpy
    float32, on the packed words."""
    v = np.float32(v)
    d = (int(word0) & 0xFFFFFFFF) >> 16
    if d & 1:
        t = np.trunc(v)
        if not (t >= 0 and t < np.float32(bit_words * 32)):
            return False
        c = int(t)
        return bool((int(bits[int(word1) + (c >> 5)]) >> (c & 31)) & 1)
    nan = np.isnan(v)
    x = np.float32(0.0) if nan else v
    mt = (d >> 2) & 3
    missing = nan if mt == 2 else (mt == 1 and x == 0.0)
    thr = np.array([word1], np.int32).view(np.float32)[0]
    return bool(d & 2) if missing else bool(x <= thr)


def test_the_kernels_decision_rule_gives_the_plain_bits():
    """A scalar replay of the kernel's per-node rule on the packed words
    walks every row to the plain version's leaf slots."""
    arrays = _decision_arrays(NUMERIC_BITS + CATEGORICAL_BITS, seed=12)
    pb = BoosterArrays(**arrays)
    tables = pb._scorer(True, "off", "cpu", decision=True).tables
    x = _edge_rows(n=40, seed=13).astype(np.float32)
    nodes = tables.nodes.numpy()
    bits = tables.bits.numpy().view(np.uint32)
    slots = tables.leaf_slot.numpy()
    m = tables.num_nodes
    _, want = score_cuda.tree_score_reference(torch.as_tensor(x), tables,
                                              leaves=True)
    for r in range(len(x)):
        for t in range(tables.num_trees):
            node = 0
            for _ in range(DEPTH):
                w0, w1 = nodes[t * m + node]
                f = (int(w0) & 0xFFFF)
                left = _kernel_rule(x[r, f], w0, w1, bits, tables.bit_words)
                node = 2 * node + (1 if left else 2)
            assert slots[t * m + node] == int(want[r, t])


# --- categorical binning -----------------------------------------------------

def _cat_sample(n=3000, seed=0):
    rng = np.random.default_rng(seed)
    x = np.column_stack([
        rng.integers(0, 4, n), rng.zipf(1.3, n) % 400, rng.normal(size=n),
        rng.integers(0, 30, n).astype(np.float64)])
    x[rng.random(x.shape) < 0.05] = np.nan
    return x


@pytest.mark.parametrize("case", ["cap", "max_bin_by_feature", "small"])
def test_categorical_binning_is_jax_bit_for_bit(case):
    x = _cat_sample(seed=1)
    kw = dict(max_bin=63, categorical_features=[0, 1, 3])
    if case == "max_bin_by_feature":
        kw["max_bin_by_feature"] = [0, 16, 0, 8]
    if case == "small":
        x, kw["max_bin"] = x[:40], 255
    mine, ref = BinMapper.fit(x, **kw), JaxBinMapper.fit(x, **kw)
    np.testing.assert_array_equal(mine.is_categorical, ref.is_categorical)
    for a, b in zip(mine.categories, ref.categories):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert [mine.num_bins(f) for f in range(4)] \
        == [ref.num_bins(f) for f in range(4)]
    # unseen, rare, fractional and NaN categories land in bin 0
    rows = np.vstack([_cat_sample(n=500, seed=2),
                      [[7.0, 399.5, 0.1, -1.0], [3.0, 1e6, np.nan, 29.0]]])
    want = ref.transform(rows)
    np.testing.assert_array_equal(mine.transform(rows), want)
    np.testing.assert_array_equal(mine._transform_python(rows), want)
    np.testing.assert_array_equal(mine.transform(rows, np.uint8), want)
    np.testing.assert_array_equal(mine.bin_upper_values(63),
                                  ref.bin_upper_values(63))
    # the mapper's dict crosses both ways
    d = mine.to_dict()
    assert json.loads(json.dumps(d)) == json.loads(json.dumps(ref.to_dict()))
    np.testing.assert_array_equal(
        JaxBinMapper.from_dict(d).transform(rows), want)
    np.testing.assert_array_equal(
        BinMapper.from_dict(ref.to_dict()).transform(rows), want)


# --- fits against the JAX trainer --------------------------------------------

def _fit_data(n=1200, seed=0, zeros=0.0):
    rng = np.random.default_rng(seed)
    c_small = rng.integers(0, 3, n)
    c_wide = rng.integers(0, 25, n)
    x = np.column_stack([c_small, c_wide, rng.normal(size=n),
                         rng.normal(size=n)]).astype(np.float64)
    effect = np.array([0.0, 2.0, -1.0])[c_small] \
        + np.where(np.isin(c_wide, [1, 4, 7, 11, 19]), 1.5, -0.5)
    y = np.round(2 * (effect + x[:, 2] + 0.3 * rng.normal(size=n))) / 2
    x[rng.random(n) < 0.05, 2] = np.nan
    if zeros:
        x[rng.random((n, 4)) < zeros] = 0.0
        x[:, :2] = np.abs(x[:, :2])
    return x, y


FIT_CASES = {
    # name: (cfg, subtraction, zeros)
    "categorical": (dict(categorical_features=(0, 1)), False, 0.0),
    "categorical_subtract": (dict(categorical_features=(0, 1)), True, 0.0),
    "categorical_onehot_only": (dict(categorical_features=(0,),
                                     max_cat_to_onehot=4), False, 0.0),
    "categorical_sorted_caps": (dict(categorical_features=(0, 1),
                                     max_cat_to_onehot=1,
                                     max_cat_threshold=3, cat_l2=1.0,
                                     cat_smooth=2.0, min_data_per_group=30),
                                False, 0.0),
    "categorical_bagged": (dict(categorical_features=(1,),
                                bagging_fraction=0.7, bagging_freq=1),
                           False, 0.0),
    "categorical_zero_as_missing": (dict(categorical_features=(0, 1),
                                         zero_as_missing=True), False, 0.3),
    "zero_as_missing": (dict(zero_as_missing=True), False, 0.3),
}


@pytest.mark.parametrize("case", list(FIT_CASES))
def test_fits_are_the_jax_trainers_bit_for_bit(monkeypatch, case):
    extra, subtract, zeros = FIT_CASES[case]
    _q8(monkeypatch, subtract)
    x, y = _fit_data(seed=3, zeros=zeros)
    if extra.get("zero_as_missing"):
        x = np.where(x == 0.0, np.nan, x)
    cat = list(extra.get("categorical_features", ()))
    mapper = JaxBinMapper.fit(x, max_bin=63, categorical_features=cat)
    binned = mapper.transform(x)
    bin_upper = mapper.bin_upper_values(63)
    cfg_kw = {**dict(objective="regression", num_iterations=6,
                     num_leaves=12, max_depth=4, max_bin=63,
                     min_data_in_leaf=10, min_data_per_group=10), **extra}
    if "bagging_fraction" in extra:
        # the reference's draws (the port's own are not jax.random's
        # bits, ROADMAP C13)
        monkeypatch.setattr(sampling, "draw", jax_draw)
    want = jax_trainer.train(binned, y, jax_trainer.TrainConfig(**cfg_kw),
                             bin_upper=bin_upper).booster
    got = trainer.train(binned, y, trainer.TrainConfig(**cfg_kw),
                        bin_upper=bin_upper, device="cpu").booster
    for name in ("split_feature", "threshold_bin", "threshold_value",
                 "node_value", "count", "tree_weights", "decision_type",
                 "cat_bitset"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=name)
    if cat:
        assert got.has_categorical       # a real categorical split
    assert got.save_model_string() == want.save_model_string()
    np.testing.assert_array_equal(got.predict(x, device="cpu").numpy(),
                                  np.asarray(want.predict_jit()(x)))


def test_categorical_tree_routes_rows_by_its_masks():
    """``build_tree``'s masks: each split's left bins route the training
    rows, and ``_predict_tree`` on them gives each row its leaf."""
    x, y = _fit_data(n=600, seed=4)
    mapper = BinMapper.fit(x, max_bin=31, categorical_features=[0, 1])
    b = torch.as_tensor(mapper.transform(x, np.uint8))
    cfg = trainer.TrainConfig(objective="regression", num_leaves=8,
                              max_depth=3, max_bin=31, min_data_in_leaf=5,
                              categorical_features=[0, 1],
                              min_data_per_group=5)
    g = torch.as_tensor(-y, dtype=torch.float32)
    h = torch.ones_like(g)
    sf, tb, nv, cnt, dt, bgl = trainer.build_tree(b, g, h, 8, cfg, 31)
    assert set(dt[sf >= 0].tolist()) <= {1, 10} and 1 in dt.tolist()
    assert not bgl[sf < 0].any() and not bgl[:, 0][dt == 1].any()
    numeric = (sf >= 0) & (dt == 10)
    for slot in torch.nonzero(numeric)[:, 0].tolist():
        np.testing.assert_array_equal(
            bgl[slot].numpy(), np.arange(31) <= int(tb[slot]))
    leaf = trainer._predict_tree(sf, tb, nv, b, 3, bgl)
    # the leaves' counts are the rows that reach them
    vals, counts = np.unique(leaf.numpy(), return_counts=True)
    leaves = (sf < 0) & (cnt > 0)
    assert sorted(counts.tolist()) == sorted(
        cnt[leaves].numpy().astype(int).tolist())


def test_packed_rows_carry_the_masks_of_categorical_fits():
    cfg = trainer.TrainConfig(max_bin=15, categorical_features=(1,))
    slots, bins = step.num_slots(cfg), step.mask_bins(cfg)
    assert bins == 15 and step.mask_bins(trainer.TrainConfig()) == 0
    rng = np.random.default_rng(14)
    dt = rng.choice([0, 1, 10], slots).astype(np.float32)
    bgl = rng.random((slots, bins)) < 0.5
    sf = np.arange(slots, dtype=np.int32)
    row = np.concatenate([sf.view(np.float32), sf.view(np.float32),
                          np.ones(2 * slots, np.float32), dt,
                          bgl.reshape(-1).astype(np.float32),
                          np.array([3.0, 4.0], np.float32)])[None]
    assert step.tree_cols(slots, bins) == row.shape[1] - 2
    *_, met = step.unpack(row, slots, bins)
    assert met.tolist() == [[3.0, 4.0]]
    got_dt, got_bgl = step.unpack_masks(row, slots, bins)
    np.testing.assert_array_equal(got_dt[0], dt.astype(np.int8))
    np.testing.assert_array_equal(got_bgl[0], bgl)


def test_assembly_refuses_category_values_a_bitset_cannot_hold():
    x, y = _fit_data(n=400, seed=5)
    for bad, match in ((-3.0, "non-negative"), (2.5, "integers"),
                       (float(1 << 21), "too large")):
        mapper = BinMapper.fit(x, max_bin=31, categorical_features=[0])
        mapper.categories[0] = mapper.categories[0].astype(np.float64)
        upper = mapper.bin_upper_values(31)
        upper[0, 1:4] = bad
        with pytest.raises(ValueError, match=match):
            trainer.train(mapper.transform(x, np.uint8), y,
                          trainer.TrainConfig(
                              objective="regression", num_iterations=2,
                              num_leaves=8, max_depth=3, max_bin=31,
                              min_data_in_leaf=5, min_data_per_group=5,
                              categorical_features=(0,), max_cat_to_onehot=1,
                              cat_smooth=0.0),
                          bin_upper=upper, device="cpu")


def test_voting_and_feature_learners_still_refuse():
    """Without a mesh the voting learner trains serially, categorical
    features and all, as the JAX package's; under a mesh the voting and
    feature learners refuse categorical features with the reference's
    message (``parallel_modes.check_supported``)."""
    import torch

    from mmlspark_tpu_torch.models.gbdt import parallel_modes
    from mmlspark_tpu_torch.parallel.mesh import Mesh

    cfg = trainer.TrainConfig(categorical_features=(0,), tree_learner="voting")
    trainer.check_supported(cfg)
    assert trainer.resolve_mode(cfg, None) == "serial"
    mesh = Mesh(1, 1, {}, 0, "gloo", torch.device("cpu"))
    for mode in ("voting", "feature"):
        with pytest.raises(NotImplementedError,
                           match="categorical splits are implemented"):
            parallel_modes.check_supported(cfg, mode, 4, mesh)


def test_train_config_takes_a_list_of_categorical_slots():
    cfg = trainer.TrainConfig(categorical_features=[2, 0])
    assert cfg.categorical_features == (2, 0) and cfg.has_categorical
    assert hash(cfg) == hash(trainer.TrainConfig(categorical_features=(2, 0)))
    assert not trainer.TrainConfig().has_categorical


# --- estimators --------------------------------------------------------------

EST = dict(numIterations=6, numLeaves=12, maxDepth=4, maxBin=63,
           minDataInLeaf=10, minDataPerGroup=10)


def _to_port(ref):
    state = {k: (np.asarray(v) if hasattr(v, "shape") else v)
             for k, v in ref._get_state().items()}
    return model_from_jax(type(ref).__name__, state,
                          ref.simple_param_values()).set_device("cpu")


@pytest.mark.parametrize("case", ["categorical", "zero_as_missing"])
def test_estimator_fits_are_jax_bit_for_bit(monkeypatch, case):
    _q8(monkeypatch)
    zeros = 0.3 if case == "zero_as_missing" else 0.0
    x, y = _fit_data(seed=6, zeros=zeros)
    params = dict(EST, **({"categoricalSlotIndexes": [0, 1]}
                          if case == "categorical" else
                          {"zeroAsMissing": True}))
    ref = jax_est.LightGBMRegressor(**params).fit(
        JaxFrame({"features": x, "label": y}))
    mine = estimators.LightGBMRegressor(**params).set_device("cpu").fit(
        DataFrame({"features": x, "label": y}))
    assert mine.get_model_string() == ref.get_model_string()
    assert mine.bin_mapper.to_dict() == ref.bin_mapper.to_dict()
    got = mine.transform(DataFrame({"features": x}))["prediction"]
    want = ref.transform(JaxFrame({"features": x}))["prediction"]
    np.testing.assert_array_equal(got, want)
    if case == "zero_as_missing":
        assert mine.booster.zero_premap_mode == "all_left"
        binned = mine.copy(binnedScoring=True)
        binned.booster, binned.bin_mapper = mine.booster, mine.bin_mapper
        np.testing.assert_array_equal(
            binned.transform(DataFrame({"features": x}))["prediction"], want)


@pytest.fixture(scope="module")
def jax_categorical_model():
    x, y = _fit_data(seed=7)
    yb = (y > np.median(y)).astype(np.float64)
    model = jax_est.LightGBMClassifier(
        categoricalSlotIndexes=[0, 1], **EST).fit(
        JaxFrame({"features": x, "label": yb}))
    return x, model


def test_transform_reply_columns_through_model_from_jax(
        jax_categorical_model):
    """Leaf slots bit for bit and TreeSHAP within rtol 1e-5 / atol 1e-6
    (float32 sums in another order), as float64 columns, beside the
    predictions bit for bit."""
    x, ref = jax_categorical_model
    cols = dict(leafPredictionCol="leaves", featuresShapCol="shap")
    want = ref.copy(**cols).transform(JaxFrame({"features": x}))
    port = _to_port(ref)
    assert port.booster.has_categorical
    assert port.bin_mapper.is_categorical[:2].all()
    got = port.copy(**cols).set_device("cpu").transform(
        DataFrame({"features": x}))
    for name in ("rawPrediction", "probability", "prediction", "leaves"):
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert got["leaves"].dtype == got["shap"].dtype == np.float64
    np.testing.assert_allclose(got["shap"], want["shap"], rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(got["shap"].sum(axis=1),
                               got["rawPrediction"][:, 1], atol=1e-3)


def test_port_models_load_in_the_jax_package(jax_categorical_model):
    """The port's categorical model string scores the same in the JAX
    package, and a port fit's saved stage loads there."""
    x, ref = jax_categorical_model
    port = _to_port(ref)
    back = JaxBooster.load_model_string(port.get_model_string())
    np.testing.assert_array_equal(
        np.asarray(back.predict_jit()(x)),
        port.booster.predict(x, device="cpu").numpy())


def test_categorical_slot_names_and_metadata_resolve():
    x, y = _fit_data(n=500, seed=8)
    frame = DataFrame({"features": x, "label": y}).with_metadata(
        "features", {"slots": ["a", "b", "c", "d"], "categorical_slots": [0]})
    model = estimators.LightGBMRegressor(
        categoricalSlotNames=["b"], **EST).set_device("cpu").fit(frame)
    assert model.bin_mapper.is_categorical.tolist() == [True, True, False,
                                                        False]


# --- serving -----------------------------------------------------------------

def _post(url, payload):
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("case", ["categorical", "zero_as_missing"])
def test_served_replies_are_transforms(case):
    zeros = 0.3 if case == "zero_as_missing" else 0.0
    x, y = _fit_data(n=800, seed=9, zeros=zeros)
    params = dict(EST, **({"categoricalSlotIndexes": [0, 1]}
                          if case == "categorical" else
                          {"zeroAsMissing": True}))
    model = estimators.LightGBMRegressor(**params).set_device("cpu").fit(
        DataFrame({"features": x, "label": y}))
    if case == "categorical":
        with pytest.raises(estimators.BinnedServingUnsupported,
                           match="categorical splits"):
            model.serving_binned_plan()
    else:
        assert model.serving_binned_plan() is not None
    want = model.transform(DataFrame({"features": x[:24]}))["prediction"]
    with ServingServer(model, max_batch_size=8,
                       max_latency_ms=2.0) as server:
        got = [_post(server.url, {"features": row.tolist()})["prediction"]
               for row in x[:24]]
        binned = server._health()["binned"]
    assert binned["active"] == (case == "zero_as_missing")
    np.testing.assert_array_equal(np.asarray(got), want)


def test_every_decision_bit_pair_on_one_path_is_jax():
    """Two nodes on one path with every pair of decision bytes (a
    numeric or categorical parent over a child of any byte)."""
    pairs = list(itertools.product(NUMERIC_BITS + [1], repeat=2))
    trees = len(pairs)
    arrays = _decision_arrays([10], seed=15, trees=trees)
    dt = arrays["decision_type"]
    for t, (a, b) in enumerate(pairs):
        dt[t, 0], dt[t, 1], dt[t, 2] = a, b, b
    tv = arrays["threshold_value"]
    arrays["threshold_value"] = np.where((dt & 1) == 1, np.nan,
                                         np.where(np.isnan(tv), 0.0, tv))
    jb, pb = JaxBooster(**arrays), BoosterArrays(**arrays)
    x = _edge_rows(n=120, seed=16)
    np.testing.assert_array_equal(pb.predict(x, device="cpu").numpy(),
                                  np.asarray(jb.predict_jit()(x)))
    np.testing.assert_array_equal(pb.leaf_index(x, device="cpu").numpy(),
                                  np.asarray(jb.leaf_index_jit()(x)))
