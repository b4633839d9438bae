"""The port's tree scorer (``score_cuda.tree_score``: the kernel
``csrc/tree_score.cu`` on the card, its plain version on the CPU) against
the JAX package's jitted scorers, on the same seeded numpy boosters and
rows, on the CPU.

Held bit for bit: ``predict_binned_scorer`` (autocast off and bf16),
``predict_binned`` and ``predict`` against ``predict_binned_jit`` /
``predict_jit`` at every serving rung, with uint8, uint16 and int32 bin
ids, tree weights other than 1 (each per-tree add rounded as XLA's fused
multiply-add, ROADMAP C9) and a three-class booster built from random
arrays, all through the packed node tables the kernel reads. What a
32-bit node cannot hold packs into wide nodes, and the wrapper refuses
what the kernel does not take before any launch. ``score_plan``'s launch
plans are checked for their invariants, and a replay of the kernel's
loops under each plan (the trees of a chunk or a cluster rank, the class
passes, the fold order) gives the plain version's bits. The kernel
itself runs on the card only: ``chip_smoke.py``'s phase ``kernel_score``
holds it to the plain version there.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt.booster import BoosterArrays as JaxBooster
from mmlspark_tpu_torch.models.gbdt import score_cuda
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
from mmlspark_tpu_torch.native import bindings
from mmlspark_tpu_torch.parallel.inference import bucket_ladder

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

F = 28
RUNGS = bucket_ladder(64)
BIN_DTYPES = {np.uint8: 255, np.uint16: 1000, np.int32: 70_000}


def _arrays(seed, trees, depth, k, max_bin):
    """A random full-layout ensemble: the root splits, every node below
    an internal node with probability 0.8 (else it is a leaf); random
    features, bin thresholds in [0, max_bin) (at most 65534, the largest
    a packed node holds), raw thresholds from a normal, leaf values and
    tree weights (0.3..1.7) in float32."""
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
                tb[t, node] = rng.integers(
                    min(max_bin, score_cuda.MAX_BIN_THRESHOLD + 1))
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


def test_predict_sends_only_nan_left_of_a_nan_threshold():
    """A trained booster can split at a NaN raw threshold (only NaN goes
    left there); some of the random trees' thresholds are NaN, and a few
    rows hold -inf, +inf and -0.0 beside NaN."""
    jb, pb = _boosters(seed=44, k=2)
    internal = pb.split_feature >= 0
    rng = np.random.default_rng(45)
    pb.threshold_value[internal & (rng.random(internal.shape) < 0.2)] = np.nan
    jb = JaxBooster(**{k: getattr(pb, k) for k in (
        "split_feature", "threshold_bin", "threshold_value", "node_value",
        "count", "tree_weights", "max_depth", "num_features", "num_class",
        "init_score")})
    x = _raw_rows(rng, 500, pb)
    x[rng.random(x.shape) < 0.02] = -np.inf
    x[rng.random(x.shape) < 0.02] = np.inf
    x[rng.random(x.shape) < 0.02] = -0.0
    np.testing.assert_array_equal(pb.predict(x, device="cpu").numpy(),
                                  np.asarray(jb.predict_jit()(x)))


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
    m = pb.split_feature.shape[1]
    assert binned.tables.nodes.dtype == torch.int32
    assert tuple(binned.tables.nodes.shape) == (30 * m,)
    assert not binned.tables.raw
    raw = pb._scorer(True, "off", "cpu")
    assert raw.tables.raw and tuple(raw.tables.nodes.shape) == (30 * m, 2)
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
    for bad in (dict(nodes=tables.nodes.long()),
                dict(leaf=tables.leaf.double()),
                dict(tree_weight=tables.tree_weight[:-1]),
                dict(nodes=tables.nodes[:-5]),
                dict(nodes=tables.nodes.view(-1, 1).expand(-1, 2)),
                dict(products=tables.products.float()),
                dict(num_nodes=tables.num_nodes - 1,
                     nodes=tables.nodes[:-5], leaf=tables.leaf[:-5],
                     products=tables.products[:-5])):
        with pytest.raises(ValueError):
            score_cuda.tree_score(x, dataclasses.replace(tables, **bad))


def test_a_cpu_tensor_runs_the_plain_version():
    before = score_cuda.tree_score_launches
    tables = _tables()
    x = torch.zeros((4, F), dtype=torch.uint8)
    want = score_cuda.tree_score_reference(x, tables)
    assert torch.equal(score_cuda.tree_score(x, tables), want)
    assert score_cuda.tree_score_launches == before


@pytest.mark.parametrize("fn,count", [("mmls_tree_score", 21),
                                      ("mmls_tree_score_decision", 24),
                                      ("mmls_tree_score_staged", 24)])
def test_the_c_signature_matches_the_declared_argtypes(fn, count):
    src = (bindings.CSRC / "tree_score.cu").read_text()
    params = re.search(rf"int {fn}\(([^)]*)\)", src).group(1)
    argtypes, _ = bindings.SIGNATURES["tree_score"][fn]
    assert len(params.split(",")) == len(argtypes) == count
    c_types = {"void*": ctypes.c_void_p, "int": ctypes.c_int,
               "long long": ctypes.c_longlong, "float": ctypes.c_float}
    for param, argtype in zip(params.split(","), argtypes):
        ctype = re.sub(r"\s*\*\s*", "* ", re.sub(r"^\s*const\s+", "",
                                                 param)).rsplit(" ", 1)[0]
        assert c_types[ctype.strip()] is argtype, param
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


# --- the packed node tables --------------------------------------------------

def test_packed_nodes_push_every_leaf_to_the_last_level():
    """Internal nodes keep their feature and threshold (features 0 and
    32767, thresholds 0 and 65534); a leaf above the last level becomes
    an always-left node (feature 0, threshold 65535) whose left spine
    carries its value to the last level; a last-level leaf stays."""
    sf = np.full((1, 15), -1, np.int32)          # depth 3
    sf[0, [0, 1, 2, 4]] = [32767, 0, 5, 9]       # leaves 3, 5, 6, 9, 10
    tb = np.zeros((1, 15), np.int32)
    tb[0, [0, 1, 2, 4]] = [65534, 0, 7, 255]
    nv = np.arange(15, dtype=np.float32)[None] * 0.5
    nodes, leaf, wide = score_cuda.pack_nodes(sf, tb, nv, 3, raw=False)
    assert nodes.dtype == np.int32 and nodes.shape == (15,) and not wide
    tables = score_cuda.make_tables(
        torch.as_tensor(nodes), torch.as_tensor(leaf), torch.ones(1), 15, 3,
        1, 32768, 0.0)
    feat, thr = (v.numpy() for v in score_cuda.unpack_nodes(tables))
    for node in (0, 1, 2, 4):
        assert (feat[node], thr[node]) == (sf[0, node], tb[0, node])
    for node in (3, 5, 6):                       # leaves on level 2
        assert (feat[node], thr[node]) == (0, 65535)
        assert feat[2 * node + 1] == -1 and leaf[2 * node + 1] == nv[0, node]
    assert feat[9] == feat[10] == -1 and (leaf[[9, 10]] == nv[0, [9, 10]]).all()
    np.testing.assert_array_equal(tables.products.numpy(), leaf)


def test_packed_raw_nodes_keep_the_float32_threshold():
    _, pb = _boosters(seed=40, trees=4, depth=3)
    tables = pb._scorer(True, "off", "cpu").tables
    feat, thr = (v.numpy() for v in score_cuda.unpack_nodes(tables))
    internal = (pb.split_feature >= 0).reshape(-1)
    np.testing.assert_array_equal(feat[internal],
                                  pb.split_feature.reshape(-1)[internal])
    np.testing.assert_array_equal(
        thr[internal],
        pb.threshold_value.astype(np.float32).reshape(-1)[internal])
    pushed = ~internal & (feat >= 0)
    assert pushed.any() and (feat[pushed] == 0).all() \
        and np.isposinf(thr[pushed]).all()


@pytest.mark.parametrize("case", ["feature_32768", "threshold_65535",
                                  "threshold_65536"])
def test_packing_refuses_what_a_word_cannot_hold(case):
    """A split feature above 32767 or a threshold above 65534 does not
    fit a 32-bit bin node: the booster packs wide nodes (int32 feature,
    int32 threshold) instead and scores bit for bit as the JAX package's
    binned scorer, ids past 65535 unclamped; a negative threshold, which
    no bin node holds, is still refused."""
    arrays = _arrays(41, trees=3, depth=3, k=1, max_bin=255)
    if case == "feature_32768":
        arrays["split_feature"][1, 0] = 32768
        arrays["num_features"] = 32769
    else:
        arrays["threshold_bin"][2, 0] = int(case.split("_")[1])
    pb = BoosterArrays(**arrays)
    tables = pb.predict_binned_scorer("off", "cpu").tables
    assert tables.wide and tables.route == "wide"
    assert tuple(tables.nodes.shape) == (3 * 15, 2)
    x = np.random.default_rng(44).integers(
        0, 70_000, size=(40, arrays["num_features"])).astype(np.int32)
    np.testing.assert_array_equal(
        pb.predict_binned(x, device="cpu").numpy(),
        np.asarray(JaxBooster(**arrays).predict_binned_jit()(x)))
    with pytest.raises(ValueError, match="packed bin node"):
        score_cuda.pack_nodes(np.array([[0]]), np.array([[-1]]),
                              np.zeros((1, 1), np.float32), 0, raw=False)


def test_raw_nodes_take_a_feature_past_what_a_bin_node_holds():
    """Raw nodes hold an int32 feature, so a split on feature 40,000
    scores as in the JAX package."""
    arrays = _arrays(42, trees=6, depth=3, k=1, max_bin=255)
    arrays["split_feature"][0, 0] = 40_000
    arrays["num_features"] = 40_001
    rng = np.random.default_rng(43)
    x = np.round(rng.normal(size=(9, 40_001)), 2)
    np.testing.assert_array_equal(
        BoosterArrays(**arrays).predict(x, device="cpu").numpy(),
        np.asarray(JaxBooster(**arrays).predict_jit()(x)))


# --- the launch plans --------------------------------------------------------

PLAN_CASES = {
    # n, trees, nodes, classes, input dtype, features
    "served": (64, 100, 127, 1, torch.uint8, 28),
    "served_raw": (64, 100, 127, 1, torch.float32, 28),
    "main": (2_000_000, 20, 127, 1, torch.uint8, 28),
    "main_raw": (2_000_000, 20, 127, 1, torch.float32, 28),
    "ragged": (2_000_007, 20, 127, 1, torch.uint8, 28),
    "one_row": (1, 20, 127, 1, torch.uint8, 28),
    "one_row_served": (1, 100, 127, 1, torch.uint8, 28),
    "crossover_cluster": (4200, 100, 127, 1, torch.uint8, 28),
    "crossover_rows": (4201, 100, 127, 1, torch.uint8, 28),
    "forty_trees": (64, 40, 127, 1, torch.uint8, 28),
    "no_trees": (1000, 0, 127, 1, torch.uint8, 28),
    "no_trees_large": (100_000, 0, 127, 1, torch.float32, 28),
    "deep": (100_003, 6, 2 ** 17 - 1, 1, torch.uint8, 28),
    "deep_small": (64, 6, 2 ** 17 - 1, 1, torch.uint8, 28),
    "thousand_trees": (100_003, 1000, 127, 1, torch.uint8, 28),
    "thousand_trees_served": (64, 1000, 127, 1, torch.float32, 28),
    "ten_classes": (100_003, 100, 127, 10, torch.uint16, 28),
    "three_classes_served": (64, 100, 127, 3, torch.int32, 28),
    "wide_rows": (100_000, 20, 127, 1, torch.float32, 20_000),
    "wide_bins": (100_000, 20, 127, 1, torch.uint8, 100),
    "too_wide_bins": (100_000, 20, 127, 1, torch.int32, 30_000),
}


def _chunks(plan, trees):
    """The trees each pass of a rows plan walks."""
    step = max(plan.chunk if plan.tables == "shared" else trees, 1)
    return [(lo, min(trees, lo + step))
            for lo in range(0, max(trees, 1), step)]


def _slices(plan, trees):
    """The trees each rank of a cluster walks."""
    c = plan.cluster
    return [(r * trees // c, (r + 1) * trees // c) for r in range(c)]


@pytest.mark.parametrize("case", list(PLAN_CASES))
def test_score_plan_invariants(case):
    n, trees, m, k, dtype, f = PLAN_CASES[case]
    plan = score_cuda.score_plan(n, trees, m, k, dtype, f)
    in_bytes = torch.empty((), dtype=dtype).element_size()
    words = score_cuda._row_words(f, in_bytes)
    assert words * 4 >= f * in_bytes > words * 4 - 4
    assert 1 <= plan.cluster <= score_cuda.CLUSTER_MAX
    assert plan.ctas % plan.cluster == 0
    assert 0 <= plan.smem <= score_cuda.SMEM_BLOCK
    assert plan.rows % 32 == 0 and plan.rows <= score_cuda.SM_THREADS
    if plan.regime == "rows":
        assert plan.cluster == 1
        tiles = -(-n // plan.rows)
        # every CTA has a tile; the tiles end in the last row's tile
        assert 1 <= plan.ctas <= tiles and (tiles - 1) * plan.rows < n
        covered = [t for lo, hi in _chunks(plan, trees)
                   for t in range(lo, hi)]
        assert covered == list(range(trees))
        if plan.tables == "shared":
            assert plan.smem == score_cuda._smem_bytes(
                plan.chunk, m, dtype == torch.float32, f, words, False,
                plan.rows)
            per_sm = -(-plan.ctas // score_cuda.SMS)
            assert per_sm * plan.rows <= score_cuda.SM_THREADS
            if plan.ctas < tiles:
                assert int(per_sm) * (plan.smem + score_cuda.SMEM_RESERVED) \
                    <= score_cuda.SMEM_SM
        else:
            assert plan.smem == 0
    else:
        assert n <= score_cuda.cluster_rows(trees) \
            and trees > score_cuda.CLUSTER_TREES
        blocks = plan.ctas // plan.cluster
        assert (blocks - 1) * plan.rows < n <= blocks * plan.rows
        slices = _slices(plan, trees)
        assert [t for lo, hi in slices for t in range(lo, hi)] \
            == list(range(trees))
        assert all(1 <= hi - lo <= plan.chunk for lo, hi in slices)
        assert plan.smem == score_cuda._smem_bytes(
            plan.chunk, m, dtype == torch.float32, f, words, True)
    want = {"served": ("cluster", "shared"), "main": ("rows", "shared"),
            "main_raw": ("rows", "shared"), "deep": ("rows", "global"),
            "deep_small": ("rows", "global"),
            "wide_rows": ("rows", "global"),
            "too_wide_bins": ("rows", "global"),
            "no_trees": ("rows", "shared"),
            "three_classes_served": ("cluster", "shared"),
            "one_row": ("rows", "shared"),
            "one_row_served": ("cluster", "shared"),
            "crossover_cluster": ("cluster", "shared"),
            "crossover_rows": ("rows", "shared"),
            "forty_trees": ("rows", "shared")}.get(case)
    if want:
        assert (plan.regime, plan.tables) == want
    if case in ("main", "main_raw"):     # at least 512 rows of each SM
        assert plan.chunk == 20 \
            and plan.ctas * plan.rows >= 512 * score_cuda.SMS
    if case == "main":                   # a CTA of 1,024 rows per SM
        assert (plan.rows, plan.ctas) == (1024, score_cuda.SMS)
    if case == "thousand_trees":
        assert len(_chunks(plan, trees)) > 1
    if case == "wide_bins":     # 100 features still stage
        assert (plan.regime, plan.tables) == ("rows", "shared")


def _first_tree(t, k, c0, gs):
    q, c = divmod(t, k)
    if c < c0:
        return q * k + c0, c0
    if c < c0 + gs:
        return t, c
    return (q + 1) * k + c0, c0


def _next_tree(k, c0, gs, tree, cls):
    return (tree + 1, cls + 1) if cls + 1 < c0 + gs \
        else (tree + k - gs + 1, c0)


def _rotate(acc, gs):
    return acc[1:gs] + acc[:1] + acc[gs:]


def _replay(x, tables, plan):
    """The kernel's loops under ``plan`` in scalar Python: which trees a pass
    or a rank walks (``max_depth`` steps each, bin ids clamped to 65535 against
    32-bit nodes, unclamped against wide ones), the order the products are
    folded in (the rows plan's accumulators rotated as the classes come round),
    and which rows each CTA writes (once per pass and class; none past N).
    Decision tables route by the kernel's decision rule, and every walk writes
    its leaf slot: each (row, tree) once. Returns the scores, and for decision
    tables the leaf slots."""
    unpacked = [v.numpy() for v in score_cuda.unpack_nodes(tables)]
    feat, thr = unpacked[0], unpacked[-2 if tables.decision else 1]
    prod = tables.products.numpy()
    xs = x.numpy()
    n, trees, m, k = x.shape[0], tables.num_trees, tables.num_nodes, \
        tables.num_class
    depth = tables.max_depth if x.shape[1] else 0
    init = np.float32(tables.init_score)
    out = np.zeros((n, k), np.float32)
    writes = np.zeros((n, k), np.int64)
    slots = np.zeros((n, trees), np.int64)
    leaf_writes = np.zeros((n, trees), np.int64)
    if tables.decision:
        words = tables.nodes.numpy()
        bits = tables.bits.numpy().view(np.uint32)

    def product(t, row, r):
        node = 0
        for _ in range(depth):
            f, th = feat[t * m + node], thr[t * m + node]
            v = row[f]
            if tables.decision:
                left = _decision_rule(v, *words[t * m + node], bits,
                                      tables.bit_words)
            else:
                left = (np.isnan(v) or v <= th) if tables.raw \
                    else int(v) <= th if tables.wide \
                    else min(int(v), 65535) <= th
            node = 2 * node + (1 if left else 2)
        if tables.decision:
            slots[r, t] = tables.leaf_slot[t * m + node]
            leaf_writes[r, t] += 1
        return prod[t * m + node]

    def fold(acc, p):
        return np.float32(np.float64(acc) + p)

    if plan.regime == "rows":
        tiles = -(-n // plan.rows)
        for lo, hi in _chunks(plan, trees):
            for cta in range(plan.ctas):
                for tile in range(cta, tiles, plan.ctas):
                    for r in range(tile * plan.rows, (tile + 1) * plan.rows):
                        if r >= n:
                            continue
                        for c0 in range(0, k, 4):
                            gs = min(4, k - c0)
                            tree, cls = _first_tree(lo, k, c0, gs)
                            phase = cls - c0
                            acc = [init if lo == 0 or j >= gs
                                   else out[r, c0 + (phase + j) % gs]
                                   for j in range(4)]
                            folded = 0
                            while tree < hi:
                                group = []
                                for _ in range(4):    # walks in flight
                                    if tree < hi:
                                        group.append(tree)
                                        tree, cls = (tree + 1, cls) \
                                            if gs == k else \
                                            _next_tree(k, c0, gs, tree, cls)
                                for t in group:
                                    assert t % k == c0 + (phase + folded) % gs
                                    acc[0] = fold(acc[0],
                                                  product(t, xs[r], r))
                                    acc = _rotate(acc, gs)
                                    folded += 1
                            nxt = (phase + folded) % gs
                            for j in range(gs):
                                out[r, c0 + (nxt + j) % gs] = acc[j]
                                writes[r, c0 + (nxt + j) % gs] += 1
        assert (writes == len(_chunks(plan, trees))).all()
    else:
        for block in range(plan.ctas // plan.cluster):
            row0 = block * plan.rows
            nb = min(plan.rows, n - row0)
            ranks = []
            for lo, hi in _slices(plan, trees):
                prods = np.empty((hi - lo) * nb)
                for w in range(nb * (hi - lo)):
                    tl, rl = divmod(w, nb)
                    prods[w] = product(lo + tl, xs[row0 + rl], row0 + rl)
                ranks.append((lo, hi, prods))
            for p in range(nb * k):     # rank 0: a thread per (row, class)
                c, r = divmod(p, nb)
                acc = init
                for lo, hi, prods in ranks:
                    t = lo + ((c - lo % k) % k + k) % k
                    while t < hi:
                        acc = fold(acc, prods[(t - lo) * nb + r])
                        t += k
                out[row0 + r, c] = acc
                writes[row0 + r, c] += 1
        assert (writes == 1).all()
    scores = out[:, 0] if k == 1 else out
    if not tables.decision:
        return scores
    assert (leaf_writes == 1).all()
    return scores, slots


def _decision_rule(v, word0, word1, bits, bit_words):
    """``Node<DFloat>::left`` of ``csrc/tree_score.cu`` in scalar numpy
    float32, on a packed decision node's two words."""
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


REPLAYS = {
    # trees, depth, classes, raw, rows, plan
    "cluster_k1": (100, 6, 1, False, 37, "score"),
    "cluster_k3_ragged": (100, 6, 3, False, 70, "score"),
    "cluster_raw": (41, 4, 1, True, 64, "score"),
    "rows_raw_nan_thresholds": (12, 5, 1, True, 50, "rows"),
    "rows_tiles_of_1024_on_one_sm": (20, 5, 2, False, 1100, "rows_one_sm"),
    "cluster_one_row": (45, 5, 2, False, 1, "score"),
    "cluster_few_trees": (5, 4, 3, False, 40, "cluster"),
    "rows_chunks": (300, 6, 1, False, 40, "rows"),
    "rows_chunks_k3_raw": (300, 6, 3, True, 23, "rows"),
    "rows_ten_classes": (47, 5, 10, False, 19, "rows"),
    "rows_no_trees": (0, 3, 2, False, 300, "score"),
    "rows_global_deep": (3, 14, 1, False, 21, "rows"),
    "rows_int32_ids_past_65535": (30, 6, 2, False, 33, "rows"),
    "cluster_int32_ids_past_65535": (30, 6, 1, False, 33, "cluster"),
    "cluster_decision": (60, 5, 1, "decision", 45, "score"),
    "cluster_decision_k3": (50, 4, 3, "decision", 64, "cluster"),
    "rows_decision_chunks": (300, 6, 1, "decision", 37, "rows"),
    "rows_decision_k2_tiles_of_1024": (20, 5, 2, "decision", 1100,
                                       "rows_one_sm"),
    "rows_decision_global_deep": (3, 14, 1, "decision", 9, "rows"),
}


@pytest.mark.parametrize("case", list(REPLAYS))
def test_the_kernels_loops_under_each_plan_give_the_plain_bits(case):
    trees, depth, k, raw, n, which = REPLAYS[case]
    arrays = _arrays(50 + len(case), max(trees, 1), depth, k, 255)
    if not trees:
        arrays = {key: (v[:0] if isinstance(v, np.ndarray) else v)
                  for key, v in arrays.items()}
    if "nan" in case:
        tv = arrays["threshold_value"]
        tv[np.random.default_rng(61).random(tv.shape) < 0.3] = np.nan
    decision = raw == "decision"
    if decision:
        # every decision byte, categorical nodes over 40 categories
        rng = np.random.default_rng(62)
        internal = arrays["split_feature"] >= 0
        arrays["decision_type"] = np.where(internal, rng.choice(
            [0, 1, 2, 4, 6, 8, 10, 12, 14, 1, 3], internal.shape),
            0).astype(np.int8)
        arrays["cat_bitset"] = rng.integers(
            0, 2 ** 32, internal.shape + (2,), dtype=np.uint64).astype(
                np.uint32)
    pb = BoosterArrays(**arrays)
    tables = pb._scorer(bool(raw), "off", "cpu", decision=decision).tables
    rng = np.random.default_rng(60)
    x = torch.as_tensor(_raw_rows(rng, n, pb).astype(np.float32)) if raw \
        else torch.as_tensor(_bins(rng, n, np.int32, 70_000)
                             if "int32" in case else _bins(rng, n, np.uint8,
                                                           255))
    shape = (n, tables.num_trees, tables.num_nodes, k, x.dtype, F)
    plan = {"score": score_cuda.score_plan, "rows": score_cuda.rows_plan,
            "rows_one_sm": lambda *a: score_cuda.rows_plan(*a, sms=1),
            "cluster": score_cuda.cluster_plan}[which](*shape)
    if which == "rows_one_sm":
        assert (plan.rows, plan.ctas) == (1024, 1)
    if case.startswith("cluster"):
        assert plan.regime == "cluster"
    if case == "rows_chunks" or case == "rows_chunks_k3_raw":
        assert len(_chunks(plan, trees)) > 1
    if case == "rows_global_deep":
        assert plan.tables == "global"
    if decision:
        # categories, negative and fractional values and zeros too
        x[:, ::3] = torch.as_tensor(rng.choice(
            [0.0, -0.0, 3.0, 17.5, 39.0, 64.0, -2.0, np.nan],
            size=x[:, ::3].shape).astype(np.float32))
        want, want_slots = score_cuda.tree_score_reference(x, tables,
                                                           leaves=True)
        got, got_slots = _replay(x, tables, plan)
        np.testing.assert_array_equal(got, want.numpy())
        np.testing.assert_array_equal(got_slots, want_slots.numpy())
        return
    want = score_cuda.tree_score_reference(x, tables).numpy()
    np.testing.assert_array_equal(_replay(x, tables, plan), want)
