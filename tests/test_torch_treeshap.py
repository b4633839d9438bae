"""Contributions in the port (``BoosterArrays.contrib``, exact
path-dependent TreeSHAP, and ``contrib_saabas``) against the JAX
package's ``contrib_fn`` / ``contrib_saabas_fn`` on the same seeded numpy
boosters and rows, on the CPU.

Both are plain torch ops in the port, as they are XLA (not Pallas) in the
reference, and follow its float32 polynomial in its order; the one place
the two can round apart is where XLA fuses a multiply-add or sums in
another order, so they are held to rtol 1e-5 / atol 1e-6, and each row
sums to the raw score within 1e-3 (the reference's own tolerance,
``tests/gbdt/test_treeshap.py``). The boosters: numeric without decision
bits, zero-as-missing (bits 6) on rows with exact zeros, a categorical
fit, the LightGBM golden fixture (a categorical tree), trees splitting
one feature twice on a path, and an imported three-class string (per-
class blocks). The port is also held to the reference test's brute-force
Shapley oracle.
"""

import os

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu.models.gbdt.booster import BoosterArrays as JaxBooster
from mmlspark_tpu.ops.binning import BinMapper as JaxBinMapper
from mmlspark_tpu_torch.models.gbdt import booster as booster_mod
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
from tests.gbdt.test_treeshap import _brute_shap

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

GOLDEN = os.path.join(os.path.dirname(__file__), "gbdt", "fixtures",
                      "lightgbm_golden_model.txt")
RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _pin_reference(monkeypatch):
    monkeypatch.setenv("MMLSPARK_TPU_HIST_FORMULATION", "per_feature")
    monkeypatch.setenv("MMLSPARK_TPU_EFB", "off")
    monkeypatch.setenv("MMLSPARK_TPU_OOC", "off")
    for name in ("MMLSPARK_TPU_PALLAS_HIST", "MMLSPARK_TPU_HIST_QUANT",
                 "MMLSPARK_TPU_HIST_SUB", "MMLSPARK_TPU_GROW_POLICY"):
        monkeypatch.delenv(name, raising=False)


def _jax_fit(x, y, cat=(), **kw):
    mapper = JaxBinMapper.fit(x, max_bin=32, categorical_features=list(cat))
    cfg = jax_trainer.TrainConfig(**{
        "objective": "regression", "num_leaves": 8, "max_depth": 3,
        "min_data_in_leaf": 5, "max_bin": 32, "num_iterations": 6,
        "categorical_features": tuple(cat), "min_data_per_group": 5, **kw})
    return jax_trainer.train(mapper.transform(x), y, cfg,
                             bin_upper=mapper.bin_upper_values(32)).booster


def _numeric(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(400, 5))
    y = x[:, 0] - 2 * x[:, 1] * (x[:, 2] > 0) + 0.1 * rng.normal(size=400)
    x[rng.random(x.shape) < 0.05] = np.nan
    return x, _jax_fit(x, y)


def _zero_as_missing(seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(400, 4))
    x[rng.random(x.shape) < 0.3] = 0.0
    y = x[:, 0] + (x[:, 1] == 0) + 0.1 * rng.normal(size=400)
    b = _jax_fit(np.where(x == 0.0, np.nan, x), y, zero_as_missing=True)
    assert b.zero_premap_mode == "all_left"
    return x, b


def _categorical(seed=2):
    rng = np.random.default_rng(seed)
    x = np.column_stack([rng.integers(0, 3, 500), rng.integers(0, 20, 500),
                         rng.normal(size=500)]).astype(np.float64)
    y = np.array([1.0, -1.0, 0.5])[x[:, 0].astype(int)] \
        + np.where(x[:, 1] % 3 == 0, 1.0, 0.0) + x[:, 2]
    b = _jax_fit(x, y, cat=(0, 1))
    assert b.has_categorical
    x = np.vstack([x, [[7.0, 2.5, np.nan], [-1.0, 40.0, 0.0]]])
    return x, b


def _golden(seed=3):
    with open(GOLDEN) as fh:
        b = JaxBooster.load_model_string(fh.read())
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(64, b.num_features))
    x[:, 4] = rng.choice([0, 1, 2, 3, 5, 7, 9, np.nan, -2, 3.5], size=64)
    return x, b


def _repeated_feature(seed=4):
    """Deep trees on two features, so a path splits one feature again
    (the duplicate-feature merge)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(500, 2))
    y = np.sin(3 * x[:, 0]) + 0.3 * x[:, 1]
    b = _jax_fit(x, y, num_leaves=16, max_depth=4)
    dup = False
    for t in range(b.num_trees):
        for slot in range(b.num_nodes):
            f, node = b.split_feature[t, slot], slot
            while f >= 0 and node > 0:
                node = (node - 1) // 2
                dup |= bool(b.split_feature[t, node] == f)
    assert dup
    return x, b


def _multiclass(seed=5):
    """A JAX three-class fit carried as a model string."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(600, 4))
    y = np.argmax(np.stack([x[:, 0], x[:, 1], x[:, 2]]), axis=0) \
        .astype(np.float64)
    b = _jax_fit(x, y, objective="multiclass", num_class=3, num_iterations=4)
    text = b.save_model_string()
    assert "num_class=3" in text
    return x, JaxBooster.load_model_string(text)


BOOSTERS = {"numeric": _numeric, "zero_as_missing": _zero_as_missing,
            "categorical": _categorical, "golden": _golden,
            "repeated_feature": _repeated_feature, "multiclass": _multiclass}


@pytest.fixture(scope="module", params=list(BOOSTERS))
def case(request):
    x, jb = BOOSTERS[request.param]()
    pb = BoosterArrays.load_model_string(jb.save_model_string()) \
        if request.param in ("golden", "multiclass") else \
        BoosterArrays(**{k: getattr(jb, k) for k in (
            "split_feature", "threshold_bin", "threshold_value", "node_value",
            "count", "tree_weights", "max_depth", "num_features",
            "num_class", "objective", "init_score", "decision_type",
            "cat_bitset")})
    return request.param, x, jb, pb


@pytest.mark.parametrize("fn", ["contrib", "contrib_saabas"])
def test_contributions_match_jax(case, fn):
    _, x, jb, pb = case
    want = np.asarray(getattr(jb, f"{fn}_jit")()(x))
    got = getattr(pb, fn)(x, device="cpu").numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("fn", ["contrib", "contrib_saabas"])
def test_contributions_sum_to_the_raw_score(case, fn):
    name, x, _, pb = case
    raw = pb.predict(x, device="cpu").numpy()
    got = getattr(pb, fn)(x, device="cpu").numpy()
    k = max(pb.num_class, 1)
    blocks = got.reshape(len(x), k, pb.num_features + 1).sum(axis=2)
    np.testing.assert_allclose(blocks[:, 0] if k == 1 else blocks, raw,
                               atol=1e-3)
    if name == "multiclass":
        assert got.shape == (len(x), 3 * (pb.num_features + 1))


def test_treeshap_is_the_brute_force_shapley_value():
    """The reference test's oracle: Shapley values over the path-
    dependent conditional expectation, enumerated subset by subset."""
    x, jb = _numeric(seed=6)
    x = np.nan_to_num(x[:12])
    pb = BoosterArrays(**{k: getattr(jb, k) for k in (
        "split_feature", "threshold_bin", "threshold_value", "node_value",
        "count", "tree_weights", "max_depth", "num_features", "init_score")})
    got = pb.contrib(x, device="cpu").numpy()
    for r in range(len(x)):
        # the reference test's tolerance against its oracle
        np.testing.assert_allclose(got[r], _brute_shap(pb, x[r]), rtol=2e-3,
                                   atol=2e-4)


def test_row_blocks_change_no_bit(monkeypatch):
    x, jb = _categorical(seed=7)
    pb = BoosterArrays.load_model_string(jb.save_model_string())
    whole = pb.contrib(x, device="cpu")
    monkeypatch.setattr(booster_mod, "CONTRIB_CELLS", 7 * pb.num_nodes)
    np.testing.assert_array_equal(pb.contrib(x, device="cpu").numpy(),
                                  whole.numpy())


def test_no_rows_and_no_trees():
    _, jb = _numeric(seed=8)
    pb = BoosterArrays.load_model_string(jb.save_model_string())
    assert tuple(pb.contrib(np.zeros((0, 5)), device="cpu").shape) == (0, 6)
    empty = BoosterArrays(**{k: getattr(pb, k)[:0] for k in (
        "split_feature", "threshold_bin", "threshold_value", "node_value",
        "count", "tree_weights")}, max_depth=pb.max_depth,
        num_features=pb.num_features, init_score=pb.init_score)
    got = empty.contrib(np.ones((3, 5)), device="cpu").numpy()
    np.testing.assert_array_equal(got[:, -1], np.float32(pb.init_score))
    assert not got[:, :-1].any()
