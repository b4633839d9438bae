"""The port's tree scorer (``score_cuda.tree_score``: the kernel
``csrc/tree_score.cu`` on the card, its plain version on the CPU) against
the JAX package's jitted scorers, on the same seeded numpy boosters and
rows, on the CPU.

Held bit for bit: ``predict_binned_scorer`` (autocast off and bf16),
``predict_binned`` and ``predict`` against ``predict_binned_jit`` /
``predict_jit`` at every serving rung, with uint8, uint16 and int32 bin
ids, tree weights other than 1 (each per-tree add rounded as XLA's fused
multiply-add, ROADMAP C9) and a three-class booster built from random
arrays. The wrapper refuses what the kernel does not take before any
launch. The kernel itself runs on the card only: ``chip_smoke.py``'s
phase ``kernel_score`` holds it to the plain version there.
"""

import re

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt.booster import BoosterArrays as JaxBooster
from mmlspark_tpu_torch.models.gbdt import score_cuda
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
from mmlspark_tpu_torch.native import bindings
from mmlspark_tpu_torch.parallel.inference import bucket_ladder

F = 28
RUNGS = bucket_ladder(64)
BIN_DTYPES = {np.uint8: 255, np.uint16: 1000, np.int32: 70_000}


def _arrays(seed, trees, depth, k, max_bin):
    """A random full-layout ensemble: the root splits, every node below
    an internal node with probability 0.8 (else it is a leaf); random
    features, bin thresholds in [0, max_bin), raw thresholds from a
    normal, leaf values and tree weights (0.3..1.7) in float32."""
    rng = np.random.default_rng(seed)
    m = 2 ** (depth + 1) - 1
    sf = np.full((trees, m), -1, np.int32)
    tb = np.zeros((trees, m), np.int32)
    tv = np.full((trees, m), np.inf)
    for t in range(trees):
        for node in range(2 ** depth - 1):
            if node == 0 or (sf[t, (node - 1) // 2] >= 0
                             and rng.random() < 0.8):
                sf[t, node] = rng.integers(F)
                tb[t, node] = rng.integers(max_bin)
                tv[t, node] = np.round(rng.normal(), 2)
    return dict(
        split_feature=sf, threshold_bin=tb, threshold_value=tv,
        node_value=rng.normal(size=(trees, m)).astype(np.float32),
        count=np.zeros((trees, m), np.float32),
        tree_weights=rng.uniform(0.3, 1.7, trees).astype(np.float32),
        max_depth=depth, num_features=F, num_class=k,
        init_score=0.123456789)


def _boosters(seed=0, trees=30, depth=6, k=1, max_bin=255):
    arrays = _arrays(seed, trees, depth, k, max_bin)
    return JaxBooster(**arrays), BoosterArrays(**arrays)


def _bins(rng, n, dtype, max_bin):
    return rng.integers(0, max_bin + 1, size=(n, F)).astype(dtype)


def _raw_rows(rng, n, booster):
    """Raw rows holding NaN and values exactly at (the float32 rounding
    of) the trees' thresholds."""
    x = np.round(rng.normal(size=(n, F)), 2)
    x[rng.random(x.shape) < 0.05] = np.nan
    thr = booster.threshold_value[booster.split_feature >= 0]
    at = rng.random(x.shape) < 0.1
    x[at] = rng.choice(thr, size=int(at.sum())).astype(np.float32)
    return x


@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", list(BIN_DTYPES), ids=lambda d: d.__name__)
@pytest.mark.parametrize("autocast", ["off", "bf16"])
def test_binned_scorer_is_jax_at_every_rung(autocast, dtype, k):
    max_bin = BIN_DTYPES[dtype]
    jb, pb = _boosters(seed=k, k=k, max_bin=max_bin)
    rng = np.random.default_rng(10 + k)
    scorer = pb.predict_binned_scorer(autocast, "cpu")
    want_fn = jb.predict_binned_jit(autocast)
    for n in RUNGS:
        bins = _bins(rng, n, dtype, max_bin)
        got = scorer(bins).numpy()
        want = np.asarray(want_fn(bins))
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        if autocast == "off":
            np.testing.assert_array_equal(
                pb.predict_binned(bins, device="cpu").numpy(), want)


@pytest.mark.parametrize("k", [1, 3])
def test_predict_is_jax_on_rows_with_nan(k):
    jb, pb = _boosters(seed=20 + k, k=k)
    rng = np.random.default_rng(30 + k)
    for n in RUNGS + [1000]:
        x = _raw_rows(rng, n, pb)
        got = pb.predict(x, device="cpu").numpy()
        np.testing.assert_array_equal(got, np.asarray(jb.predict_jit()(x)))
        # a float32 tensor scores as the float64 rows do
        np.testing.assert_array_equal(
            pb.predict(torch.as_tensor(x.astype(np.float32)),
                       device="cpu").numpy(), got)


def test_trees_stop_at_their_first_leaf():
    """Shallow trees in a deeper layout (leaves above the last level,
    garbage below them) and a single-leaf tree: the walk stops where
    the scan's node stays."""
    arrays = _arrays(5, trees=12, depth=5, k=1, max_bin=255)
    sf = arrays["split_feature"]
    sf[3, 1:] = np.where(np.arange(1, sf.shape[1]) > 2, 7, -1)
    sf[4, :] = -1
    sf[4, 5:] = 3
    jb, pb = JaxBooster(**arrays), BoosterArrays(**arrays)
    bins = _bins(np.random.default_rng(6), 64, np.uint8, 255)
    np.testing.assert_array_equal(
        pb.predict_binned(bins, device="cpu").numpy(),
        np.asarray(jb.predict_binned_jit()(bins)))


def test_plain_version_blocks_change_no_bit(monkeypatch):
    _, pb = _boosters(seed=7, k=3)
    bins = _bins(np.random.default_rng(8), 300, np.uint8, 255)
    whole = pb.predict_binned(bins, device="cpu").numpy()
    monkeypatch.setattr(score_cuda, "PLAIN_ROWS", 7)
    pb.clear_jit_cache()
    np.testing.assert_array_equal(
        pb.predict_binned(bins, device="cpu").numpy(), whole)


def test_no_trees_scores_init_score():
    arrays = _arrays(9, trees=1, depth=2, k=1, max_bin=255)
    arrays = {k: (v[:0] if isinstance(v, np.ndarray) else v)
              for k, v in arrays.items()}
    pb = BoosterArrays(**arrays)
    got = pb.predict_binned(np.zeros((5, F), np.uint8), device="cpu")
    np.testing.assert_array_equal(got.numpy(),
                                  np.full(5, np.float32(0.123456789)))


def test_scorers_are_cached_per_kind_and_cleared():
    _, pb = _boosters(seed=11)
    bins = _bins(np.random.default_rng(12), 8, np.uint8, 255)
    pb.predict_binned(bins, device="cpu")
    pb.predict(bins.astype(np.float64), device="cpu")
    binned = pb.predict_binned_scorer("off", "cpu")
    assert len(pb.__dict__["_scorers"]) == 2
    assert binned.tables.threshold.dtype == torch.int32
    assert binned.tables.split_feature.dtype == torch.int32
    raw = pb._scorer(True, "off", "cpu")
    assert raw.tables.threshold.dtype == torch.float32
    assert pb.predict_binned_scorer("bf16", "cpu").tables.leaf.dtype \
        == torch.bfloat16
    pb.clear_jit_cache()
    assert pb.predict_binned_scorer("off", "cpu") is not binned


def test_split_feature_past_num_features_is_refused():
    arrays = _arrays(13, trees=3, depth=3, k=1, max_bin=255)
    arrays["split_feature"][1, 0] = 5
    arrays["num_features"] = 5
    with pytest.raises(ValueError, match="num_features"):
        BoosterArrays(**arrays).predict_binned(
            np.zeros((2, 5), np.uint8), device="cpu")


# --- what the kernel refuses -------------------------------------------------

@pytest.fixture
def no_launch(monkeypatch):
    """Fail if either version of the scorer is reached."""
    def reached(*args):
        raise AssertionError("the scorer ran")
    monkeypatch.setattr(score_cuda, "_launch", reached)
    monkeypatch.setattr(score_cuda, "tree_score_reference", reached)


def _tables(raw=False):
    _, pb = _boosters(seed=14, trees=5, depth=3)
    return pb._scorer(raw, "off", "cpu").tables


@pytest.mark.parametrize("case", [
    "float_bins", "int64_bins", "int16_bins", "bins_for_raw_tables",
    "float64_raw", "fewer_features", "non_contiguous", "one_dimensional"])
def test_wrapper_refuses_before_any_launch(case, no_launch):
    raw = case in ("bins_for_raw_tables", "float64_raw")
    tables = _tables(raw)
    x = torch.zeros((6, F), dtype=torch.uint8)
    x = {"float_bins": x.float(), "int64_bins": x.long(),
         "int16_bins": x.short(), "bins_for_raw_tables": x,
         "float64_raw": x.double(), "fewer_features": x[:, :F - 1],
         "non_contiguous": x.t().contiguous().t(),
         "one_dimensional": x[0]}[case]
    with pytest.raises(ValueError):
        score_cuda.tree_score(x, tables)


def test_tables_the_kernel_does_not_take_are_refused(no_launch):
    import dataclasses
    tables = _tables()
    x = torch.zeros((2, F), dtype=torch.uint8)
    for bad in (dict(split_feature=tables.split_feature.long()),
                dict(leaf=tables.leaf.double()),
                dict(tree_weight=tables.tree_weight[:-1]),
                dict(threshold=tables.threshold.long()),
                dict(num_nodes=tables.num_nodes - 1,
                     split_feature=tables.split_feature[:-5],
                     threshold=tables.threshold[:-5],
                     leaf=tables.leaf[:-5])):
        with pytest.raises(ValueError):
            score_cuda.tree_score(x, dataclasses.replace(tables, **bad))


def test_a_cpu_tensor_runs_the_plain_version():
    before = score_cuda.tree_score_launches
    tables = _tables()
    x = torch.zeros((4, F), dtype=torch.uint8)
    want = score_cuda.tree_score_reference(x, tables)
    assert torch.equal(score_cuda.tree_score(x, tables), want)
    assert score_cuda.tree_score_launches == before


@pytest.mark.parametrize("fn,count", [("mmls_tree_score", 17),
                                      ("mmls_tree_score_staged", 20)])
def test_the_c_signature_matches_the_declared_argtypes(fn, count):
    src = (bindings.CSRC / "tree_score.cu").read_text()
    params = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    argtypes, _ = bindings.SIGNATURES["tree_score"][fn]
    assert len(params.split(",")) == len(argtypes) == count
    assert "tree_score" in bindings.HOLD_GIL
    assert bindings.sources("tree_score") == [bindings.CSRC / "tree_score.cu"]
    assert bindings.library_path("tree_score").name.startswith(
        "libtree_score-")


# --- the staged serving batch ------------------------------------------------

@pytest.mark.parametrize("k", [1, 3])
@pytest.mark.parametrize("dtype", list(BIN_DTYPES), ids=lambda d: d.__name__)
def test_staged_batch_scores_as_tree_score(dtype, k):
    _, pb = _boosters(seed=15 + k, k=k, max_bin=BIN_DTYPES[dtype])
    scorer = pb.predict_binned_scorer("off", "cpu")
    batch = scorer.staged_batch(64, F, dtype)
    assert batch.x.dtype == dtype and batch.out.shape == (64, k)
    rng = np.random.default_rng(16)
    before = score_cuda.tree_score_launches
    for _ in range(2):      # the buffers are reused
        bins = _bins(rng, 64, dtype, BIN_DTYPES[dtype])
        batch.x[:] = bins
        scorer.score_staged(batch)
        np.testing.assert_array_equal(
            batch.out, scorer(bins).numpy().reshape(64, k))
    assert score_cuda.tree_score_launches == before


def test_staged_batch_refuses_what_the_kernel_does_not_take():
    _, pb = _boosters(seed=17)
    with pytest.raises(ValueError, match="bin ids"):
        pb._scorer(True, "off", "cpu").staged_batch(8, F, np.uint8)
    scorer = pb.predict_binned_scorer("off", "cpu")
    with pytest.raises(ValueError, match="features"):
        scorer.staged_batch(8, F - 1, np.uint8)
    with pytest.raises(ValueError, match="bin ids"):
        scorer.staged_batch(8, F, np.int64)


def test_binned_plane_keeps_one_staged_batch_per_rung():
    from mmlspark_tpu_torch.io.serving import _BinnedPlane
    from mmlspark_tpu_torch.models.gbdt.estimators import ServingBinnedPlan

    _, pb = _boosters(seed=18)
    scorer = pb.predict_binned_scorer("off", "cpu")
    plan = ServingBinnedPlan(
        bin_rows=lambda x: x, score=scorer, finish=lambda raw: {"raw": raw},
        ingest_dtype=np.uint8, num_features=F, features_col="features")
    plane = _BinnedPlane(plan, RUNGS)
    plane.warmup()
    assert plane.shapes_seen == len(RUNGS)
    batches = dict(plane._batches)
    rng = np.random.default_rng(19)
    for n in (3, 64, 3, 1):
        rows = list(_bins(rng, n, np.uint8, 255))
        got = plane.score_rows(rows)["raw"]
        np.testing.assert_array_equal(got, scorer(np.stack(rows)).numpy())
    assert plane._batches == batches and plane.shapes_seen == len(RUNGS)
