"""Learning to rank in the port (lambdarank over query groups, the
``ndcg`` metric, ``LightGBMRanker``) against the JAX package on the same
seeded numpy inputs, on the CPU.

The JAX side pins its histogram formulation to ``per_feature`` (ROADMAP
C1), EFB and out-of-core training off. Tolerances, by case:

  - the group layout (``make_group_layout``), ``group_ranks``,
    ``_ranks_within`` and ``dense_group_index``: bit for bit, with tied
    scores;
  - lambdarank grad / hess, bucketed and (N, N), with and without
    ``label_gain`` and weights: within ``rtol=1e-6`` of the row's terms
    (the sum over its pairs of |lambda|, resp. |hessian term|, times the
    row weight) plus ``atol=1e-7``: torch's ``sigmoid`` and ``log2`` and
    XLA's differ by an ulp (ROADMAP C10) and the pair sums reduce in
    another order;
  - ``ndcg_at``: within ``rtol=1e-6`` (float32 sums in another order),
    zero-weight groups included;
  - fits given the JAX package's grads (as a custom objective, q8 on both
    sides): every booster array bit for bit, evals within ``rtol=1e-6``;
    with the port's own grads, NDCG within ``1e-4`` of the JAX fit's;
  - estimators: a JAX-fitted ranker carried across (``model_from_jax``)
    transforms bit for bit as in JAX.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.core.dataframe import DataFrame as JaxFrame
from mmlspark_tpu.models.gbdt import estimators as jax_est
from mmlspark_tpu.models.gbdt import metrics as jax_metrics
from mmlspark_tpu.models.gbdt import objectives as jax_objectives
from mmlspark_tpu.models.gbdt import trainer as jax_trainer
from mmlspark_tpu_torch import DataFrame
from mmlspark_tpu_torch.models.gbdt import (estimators, metrics, objectives,
                                            step, trainer)
from mmlspark_tpu_torch.models.gbdt.convert import model_from_jax
from mmlspark_tpu_torch.ops.binning import BinMapper

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

ARRAYS = ("split_feature", "threshold_bin", "threshold_value", "node_value",
          "count", "tree_weights")
MAX_BIN = 32
GAINS = (0.0, 1.0, 4.0, 9.0, 20.0)


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
    """q8 on both sides: these data keep every quantization exponent
    where XLA's ``exp2`` is a power of two and q8 bin sums exact in
    float32 (ROADMAP C3, C4), so fits compare bit for bit."""
    monkeypatch.setenv("MMLSPARK_TPU_HIST_QUANT", "q8")
    monkeypatch.setenv(trainer.HIST_QUANT_ENV, "q8")


def _groups(profile, seed=0):
    """Shuffled query ids of a size profile: ``uniform`` (8-40 rows),
    ``skewed`` (log-uniform 1-300, as ``tools/bench_ranker.py --skewed``
    at a small scale), ``singletons`` (many one-row groups), ``sparse``
    (large, non-contiguous ids)."""
    rng = np.random.default_rng(seed)
    if profile == "uniform":
        sizes = rng.integers(8, 41, size=25)
    elif profile == "skewed":
        sizes = np.exp(rng.uniform(0, np.log(300), size=20)).astype(int) + 1
    elif profile == "singletons":
        sizes = np.concatenate([np.ones(30, int), rng.integers(2, 6, 10)])
    else:
        sizes = rng.integers(1, 30, size=15)
    ids = rng.permutation(10_000)[:len(sizes)] * (7 if profile == "sparse"
                                                  else 1)
    return rng.permutation(np.repeat(ids, sizes))


def _rank_data(profile="uniform", seed=0, f=5):
    """Features, graded labels 0-4 from the features' signal, and query
    ids: the MSLR shape at a small scale."""
    gid = _groups(profile, seed)
    rng = np.random.default_rng(seed + 100)
    n = len(gid)
    x = rng.normal(size=(n, f))
    rel = x[:, 0] + 0.5 * x[:, 1] - 0.3 * x[:, 2] + 0.5 * rng.normal(size=n)
    y = np.clip(np.round(rel + 1.5), 0, 4)
    return x, y, gid


def _binned(x):
    m = BinMapper.fit(x, max_bin=MAX_BIN)
    return m.transform(x), m.bin_upper_values(MAX_BIN)


def _jax_layout(gid):
    return tuple((jnp.asarray(r), jnp.asarray(m))
                 for r, m in jax_objectives.make_group_layout(gid))


# --- layout and ranks ------------------------------------------------------------

@pytest.mark.parametrize("profile", ["uniform", "skewed", "singletons",
                                     "sparse"])
def test_make_group_layout_is_jax_bitwise(profile):
    gid = _groups(profile)
    want = jax_objectives.make_group_layout(gid)
    got = objectives.make_group_layout(gid)
    assert len(got) == len(want) >= 1
    for (gr, gm), (wr, wm) in zip(got, want):
        assert gr.dtype == np.int32 and gm.dtype == np.float32
        np.testing.assert_array_equal(gr, np.asarray(wr))
        np.testing.assert_array_equal(gm, np.asarray(wm))
    # every row in exactly one real slot; pads point at the sentinel N
    rows = np.concatenate([r[m > 0] for r, m in got])
    assert sorted(rows.tolist()) == list(range(len(gid)))
    assert all((r[m == 0] == len(gid)).all() for r, m in got)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_group_ranks_and_dense_index_are_jax_bitwise(seed):
    gid = _groups("skewed", seed)
    rng = np.random.default_rng(seed)
    # few distinct scores: many ties, broken in row order
    scores = rng.integers(-3, 4, size=len(gid)).astype(np.float32)
    for s in (scores, np.zeros_like(scores)):
        want = np.asarray(jax_objectives.group_ranks(jnp.asarray(s),
                                                     jnp.asarray(gid)))
        got = objectives.group_ranks(torch.from_numpy(s),
                                     torch.from_numpy(gid))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        objectives.dense_group_index(torch.from_numpy(gid)).numpy(),
        np.asarray(jax_objectives.dense_group_index(jnp.asarray(gid))))


@pytest.mark.parametrize("seed", [0, 1])
def test_ranks_within_is_jax_bitwise(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, size=(12, 9)).astype(np.float32)
    mask = (rng.random((12, 9)) < 0.7).astype(np.float32)
    want = np.asarray(jax_objectives._ranks_within(jnp.asarray(x),
                                                   jnp.asarray(mask)))
    got = objectives._ranks_within(torch.from_numpy(x),
                                   torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)


# --- lambdarank grads --------------------------------------------------------------

def _terms(scores, labels, gid, gain_table, sigmoid=1.0, trunc=30):
    """Per row, the sums over its pairs of |lambda| and of the hessian
    terms, in float64 (the magnitudes the grads add up)."""
    s = scores.astype(np.float64)
    y = labels.astype(np.float64)
    gain = (2.0 ** y - 1.0 if gain_table is None
            else np.asarray(gain_table)[np.clip(y.astype(int), 0,
                                                len(gain_table) - 1)])
    pr = objectives.group_ranks(torch.from_numpy(scores),
                                torch.from_numpy(gid)).numpy()
    ir = objectives.group_ranks(torch.from_numpy(labels),
                                torch.from_numpy(gid)).numpy()
    same = gid[:, None] == gid[None, :]
    idcg = np.maximum(same @ (gain / np.log2(2.0 + ir)), 1e-12)
    disc = 1.0 / np.log2(2.0 + pr)
    valid = same & (y[:, None] > y[None, :]) \
        & ((pr < trunc)[:, None] | (pr < trunc)[None, :])
    rho = 1.0 / (1.0 + np.exp(sigmoid * (s[:, None] - s[None, :])))
    delta = np.abs((gain[:, None] - gain[None, :])
                   * (disc[:, None] - disc[None, :])) / idcg[:, None]
    lam = np.where(valid, sigmoid * rho * delta, 0.0)
    h = np.where(valid, sigmoid * sigmoid * rho * (1 - rho) * delta, 0.0)
    return lam.sum(1) + lam.sum(0), h.sum(1) + h.sum(0)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("gain", [None, GAINS])
@pytest.mark.parametrize("route", ["bucketed", "pairs"])
def test_lambdarank_grads_match_jax(route, gain, weighted):
    _, labels, gid = _rank_data("skewed", seed=3)
    n = len(gid)
    rng = np.random.default_rng(9)
    scores = np.round(rng.normal(size=n), 1).astype(np.float32)   # ties
    labels = labels.astype(np.float32)
    w = rng.uniform(0.5, 2.0, size=n).astype(np.float32) if weighted \
        else None
    kw = dict(sigmoid=1.5, truncation_level=12, label_gain=gain)
    if route == "bucketed":
        jkw = dict(kw, group_layout=_jax_layout(gid))
        pkw = dict(kw, group_layout=objectives.layout_to(
            objectives.make_group_layout(gid), "cpu"))
    else:
        jkw = dict(kw, group_ids=jnp.asarray(gid))
        pkw = dict(kw, group_ids=torch.from_numpy(gid))
    jg, jh = jax_objectives.lambdarank(
        jnp.asarray(scores), jnp.asarray(labels),
        None if w is None else jnp.asarray(w), **jkw)
    pg, ph = objectives.lambdarank(
        torch.from_numpy(scores), torch.from_numpy(labels),
        None if w is None else torch.from_numpy(w), **pkw)
    assert pg.dtype == ph.dtype == torch.float32
    tg, th = _terms(scores, labels, gid, gain, sigmoid=1.5, trunc=12)
    scale = 1.0 if w is None else w.astype(np.float64)
    assert np.abs(np.asarray(jg)).max() > 0.1          # real lambdas
    assert np.all(np.abs(pg.numpy() - np.asarray(jg))
                  <= 1e-6 * tg * scale + 1e-7)
    assert np.all(np.abs(ph.numpy() - np.asarray(jh))
                  <= 1e-6 * th * scale + 1e-7)


def test_lambdarank_chunks_give_the_same_bits(monkeypatch):
    """A bucket taken a group at a time gives the bits of the bucket at
    once: each row lies in one bucket, added into zeros."""
    _, labels, gid = _rank_data("skewed", seed=5)
    scores = torch.from_numpy(np.random.default_rng(1).normal(
        size=len(gid)).astype(np.float32))
    lay = objectives.layout_to(objectives.make_group_layout(gid), "cpu")
    y = torch.from_numpy(labels.astype(np.float32))
    whole = objectives.lambdarank(scores, y, group_layout=lay)
    monkeypatch.setattr(objectives, "LAMBDARANK_CHUNK_BYTES", 1)
    assert len(objectives._chunks(*lay[-1][0].shape)) == lay[-1][0].shape[0]
    chunked = objectives.lambdarank(scores, y, group_layout=lay)
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="requires group_ids"):
        objectives.lambdarank(scores, y)


# --- ndcg ----------------------------------------------------------------------------

@pytest.mark.parametrize("weights", ["none", "rows", "zero_groups"])
@pytest.mark.parametrize("gain", [None, GAINS])
@pytest.mark.parametrize("k", [1, 5, 10])
def test_ndcg_matches_jax(k, gain, weights):
    _, labels, gid = _rank_data("skewed", seed=k)
    n = len(gid)
    rng = np.random.default_rng(k)
    raw = np.round(rng.normal(size=n), 1).astype(np.float32)
    labels = labels.astype(np.float32)
    w = None
    if weights == "rows":
        w = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    elif weights == "zero_groups":
        # every row of three groups weighs 0: those groups are left out
        w = np.ones(n, np.float32)
        w[np.isin(gid, np.unique(gid)[:3])] = 0.0
    want = float(jax_metrics.ndcg_at(k, gain)(
        jnp.asarray(raw), jnp.asarray(labels),
        None if w is None else jnp.asarray(w), group_ids=jnp.asarray(gid)))
    fn = metrics.ndcg_at(k, gain)
    got = fn(torch.from_numpy(raw), torch.from_numpy(labels),
             None if w is None else torch.from_numpy(w),
             group_ids=torch.from_numpy(gid))
    assert got.shape == () and got.dtype == torch.float32
    assert fn.__name__ == f"ndcg@{k}"
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    # the layout the trainer passes gives the same bits
    lay = objectives.layout_to(objectives.make_group_layout(gid), "cpu")
    by_layout = fn(torch.from_numpy(raw), torch.from_numpy(labels),
                   None if w is None else torch.from_numpy(w),
                   group_layout=lay)
    assert torch.equal(by_layout, got)


def test_ndcg_table_entry_and_group_ids_required():
    fn, higher = metrics.METRICS["ndcg"]
    jfn, jhigher = jax_metrics.METRICS["ndcg"]
    assert higher is jhigher is True and fn.__name__ == jfn.__name__
    with pytest.raises(ValueError, match="ndcg requires group_ids"):
        fn(torch.zeros(4), torch.zeros(4))
    cfg = trainer.TrainConfig(objective="lambdarank", eval_at=[3, 7],
                              label_gain=[0, 1, 3])
    name, fns, hb, kw = trainer._resolve_metrics(cfg)
    jname, jfns, jhb, jkw = jax_trainer._resolve_metrics(
        jax_trainer.TrainConfig(objective="lambdarank", eval_at=[3, 7],
                                label_gain=[0, 1, 3]))
    assert (name, [lbl for lbl, _ in fns], hb, kw) == \
        (jname, [lbl for lbl, _ in jfns], jhb, jkw) == \
        ("ndcg", ["ndcg@3", "ndcg@7"], True, {})


# --- fits ------------------------------------------------------------------------------

def _jax_grads(gid, **kw):
    """Custom objectives giving the JAX package's lambdarank grads: one
    for each package's trainer (the port's passes torch tensors)."""
    lay = _jax_layout(gid)

    def jax_side(preds, labels, weights):
        g, h = jax_objectives.lambdarank(
            jnp.asarray(np.asarray(preds)), jnp.asarray(np.asarray(labels)),
            None if weights is None else jnp.asarray(np.asarray(weights)),
            group_layout=lay, **kw)
        return np.asarray(g), np.asarray(h)

    def port_side(preds, labels, weights):
        return jax_side(preds.numpy(), labels.numpy(),
                        None if weights is None else weights.numpy())
    return jax_side, port_side


def _assert_same_fit(got, want):
    for name in ARRAYS:
        np.testing.assert_array_equal(getattr(got.booster, name),
                                      getattr(want.booster, name),
                                      err_msg=name)
    assert got.booster.init_score == want.booster.init_score == 0.0
    assert [sorted(e) for e in got.evals] == [sorted(e) for e in want.evals]
    for ge, we in zip(got.evals, want.evals):
        for k in we:
            np.testing.assert_allclose(ge[k], we[k], rtol=1e-6)


BASE = dict(objective="lambdarank", num_iterations=5, num_leaves=8,
            max_depth=3, max_bin=MAX_BIN, min_data_in_leaf=10)


@pytest.mark.parametrize("case", ["plain", "gains_weights_valid"])
def test_lambdarank_fit_is_jax_bitwise_given_its_grads(case, monkeypatch):
    _q8(monkeypatch)
    x, y, gid = _rank_data("uniform", seed=2)
    binned, bin_upper = _binned(x)
    kw = dict(BASE, eval_at=(3, 5))
    fit_kw = {}
    okw = {}
    if case != "plain":
        kw.update(label_gain=GAINS, lambdarank_truncation_level=10)
        okw = dict(label_gain=GAINS, truncation_level=10)
        w = np.random.default_rng(3).uniform(0.5, 2.0, size=len(y))
        vx, vy, vgid = _rank_data("skewed", seed=4)
        vb = BinMapper.fit(x, max_bin=MAX_BIN).transform(vx)
        fit_kw = dict(weights=w, valid_sets=[(vb, vy, None, vgid)])
    jfobj, pfobj = _jax_grads(gid, **okw)
    jax_fit = dict(fit_kw)
    if "valid_sets" in fit_kw:
        jax_fit["valid_sets"] = [(vb.astype(np.int32), vy, None, vgid)]
    want = jax_trainer.train(binned.astype(np.int32), y,
                             jax_trainer.TrainConfig(**kw),
                             bin_upper=bin_upper, group_ids=gid,
                             custom_objective=jfobj, **jax_fit)
    got = trainer.train(binned, y, trainer.TrainConfig(**kw),
                        bin_upper=bin_upper, group_ids=gid,
                        custom_objective=pfobj, device="cpu", **fit_kw)
    assert got.booster.num_trees == 5 and got.booster.num_class == 1
    _assert_same_fit(got, want)
    if case != "plain":
        assert "valid0_ndcg@5" in got.evals[-1]


def test_lambdarank_fit_with_its_own_grads_tracks_jax():
    x, y, gid = _rank_data("skewed", seed=6)
    binned, bin_upper = _binned(x)
    kw = dict(BASE, num_iterations=8, eval_at=(5,))
    want = jax_trainer.train(binned.astype(np.int32), y,
                             jax_trainer.TrainConfig(**kw),
                             bin_upper=bin_upper, group_ids=gid)
    got = trainer.train(binned, y, trainer.TrainConfig(**kw),
                        bin_upper=bin_upper, group_ids=gid, device="cpu")
    # the first tree's root: both fits start from all-equal scores
    assert got.booster.split_feature[0, 0] == want.booster.split_feature[0, 0]
    g, w = got.evals[-1]["train_ndcg@5"], want.evals[-1]["train_ndcg@5"]
    assert abs(g - w) <= 1e-4, (g, w)
    assert g > got.evals[0]["train_ndcg@5"]


def test_early_stopping_on_ndcg_cuts_like_jax(monkeypatch):
    _q8(monkeypatch)
    x, y, gid = _rank_data("uniform", seed=7)
    n = len(y)
    val = np.isin(gid, np.unique(gid)[::3])      # a third of the queries
    binned, bin_upper = _binned(x)
    kw = dict(BASE, num_iterations=40, learning_rate=0.5,
              early_stopping_round=3, eval_at=(2, 5))
    tr, va = ~val, val
    jfobj, pfobj = _jax_grads(gid[tr])
    args = dict(bin_upper=bin_upper, group_ids=gid[tr])
    want = jax_trainer.train(
        binned[tr].astype(np.int32), y[tr], jax_trainer.TrainConfig(**kw),
        valid_sets=[(binned[va].astype(np.int32), y[va], None, gid[va])],
        custom_objective=jfobj, **args)
    got = trainer.train(
        binned[tr], y[tr], trainer.TrainConfig(**kw),
        valid_sets=[(binned[va], y[va], None, gid[va])],
        custom_objective=pfobj, device="cpu", **args)
    assert 0 <= got.best_iteration == want.best_iteration < 39
    assert got.booster.num_trees == want.booster.num_trees == \
        got.best_iteration + 1
    _assert_same_fit(got, want)
    assert n > 0
    # the stop keys on the first metric: ndcg@2
    vals = [e["valid0_ndcg@2"] for e in got.evals]
    assert trainer.stop_iteration(vals, 3, 0.0, True)[0] == got.best_iteration


def test_lambdarank_and_ndcg_need_group_ids():
    x, y, gid = _rank_data("uniform")
    binned, _ = _binned(x)
    cfg = trainer.TrainConfig(**BASE)
    with pytest.raises(ValueError, match="lambdarank requires group_ids"):
        trainer.train(binned, y, cfg, device="cpu")
    with pytest.raises(ValueError, match="valid set 0: ndcg eval requires"):
        trainer.train(binned, y, cfg, group_ids=gid, device="cpu",
                      valid_sets=[(binned, y, None)])
    with pytest.raises(ValueError, match="ndcg requires group_ids"):
        trainer.train(binned, y, dataclasses.replace(
            cfg, objective="regression", metric="ndcg"), device="cpu")


def test_step_cache_key_holds_the_group_layouts():
    x, y, gid = _rank_data("uniform")
    b = torch.from_numpy(_binned(x)[0].astype(np.uint8))
    cfg = trainer.TrainConfig(**BASE)
    lay = objectives.layout_to(objectives.make_group_layout(gid), "cpu")
    other = objectives.layout_to(objectives.make_group_layout(
        _groups("skewed")[:len(gid)]), "cpu")
    key = step._cache_key(cfg, b, None, [], "off", False, lay)
    assert key == step._cache_key(cfg, b, None, [], "off", False, lay)
    assert key != step._cache_key(cfg, b, None, [], "off", False, other)
    # a cached step's buffers take another fit's layout of the same shape
    own = step.Step.owning(cfg, b, torch.zeros(len(gid)), None,
                           torch.zeros(len(gid)), [], lay, "off", False)
    own.load(b, torch.zeros(len(gid)), None, torch.zeros(len(gid)), [], lay)
    for (r, m), (r2, m2) in zip(own.layout, lay):
        assert torch.equal(r, r2) and torch.equal(m, m2)


# --- estimators ------------------------------------------------------------------------

def _frame(x, y, gid, cls=DataFrame, **extra):
    return cls({"features": x, "label": y, "query": gid, **extra})


RANKER = dict(numIterations=6, numLeaves=8, maxDepth=3, maxBin=MAX_BIN,
              minDataInLeaf=10, groupCol="query", evalAt=[3, 5])


def test_ranker_transform_through_model_from_jax():
    x, y, gid = _rank_data("skewed", seed=8)
    ref = jax_est.LightGBMRanker(**RANKER).fit(_frame(x, y, gid, JaxFrame))
    state = {k: (np.asarray(v) if hasattr(v, "shape") else v)
             for k, v in ref._get_state().items()}
    port = model_from_jax("LightGBMRankerModel", state,
                          ref.simple_param_values())
    assert type(port).__name__ == "LightGBMRankerModel"
    got = port.set_device("cpu").transform(DataFrame({"features": x}))
    want = ref.transform(JaxFrame({"features": x}))
    assert got.columns == want.columns
    for col in got.columns:
        np.testing.assert_array_equal(got[col], want[col])


def test_ranker_fits_validates_and_serves(monkeypatch):
    """``LightGBMRanker`` on the CPU: group ids encoded per set after the
    validation split, NDCG at each ``evalAt`` on both sets, early
    stopping on the first, the model string round trip, and the binned
    serving plan's replies bitwise ``transform``'s."""
    _q8(monkeypatch)
    x, y, gid = _rank_data("uniform", seed=9)
    val = np.isin(gid, np.unique(gid)[::4])
    params = dict(RANKER, numIterations=30, learningRate=0.5,
                  earlyStoppingRound=3, validationIndicatorCol="val",
                  labelGain=list(GAINS), maxPosition=10)
    est = estimators.LightGBMRanker(**params).set_device("cpu")
    model = est.fit(_frame(x, y, gid, val=val))
    ref = jax_est.LightGBMRanker(**params).fit(
        _frame(x, y, gid, JaxFrame, val=val))
    assert set(model.evals_result[0]) == set(ref.evals_result[0]) == {
        "iteration", "train_ndcg@3", "train_ndcg@5", "valid0_ndcg@3",
        "valid0_ndcg@5"}
    assert model.best_iteration == ref.best_iteration >= 0
    assert model.booster.num_trees == model.best_iteration + 1
    for a, b in zip(model.evals_result, ref.evals_result):
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4, atol=1e-4)
    out = model.transform(DataFrame({"features": x}))
    raw = model.booster.predict(x, device="cpu").numpy()
    np.testing.assert_array_equal(out["prediction"], raw.astype(np.float64))
    again = estimators.LightGBMRankerModel.load_native_model_from_string(
        model.get_model_string()).set_device("cpu")
    np.testing.assert_array_equal(
        again.transform(DataFrame({"features": x}))["prediction"],
        out["prediction"])
    plan = model.serving_binned_plan()
    scores = plan.score(plan.bin_rows(x)).numpy()
    replies = plan.finish(scores)
    binned_out = model.copy(binnedScoring=True).set_device("cpu").transform(
        DataFrame({"features": x}))
    np.testing.assert_array_equal(replies["prediction"],
                                  binned_out["prediction"])


def test_ranker_checkpoint_resumes_bitwise_and_keys_on_groups(tmp_path,
                                                              monkeypatch):
    _q8(monkeypatch)
    x, y, gid = _rank_data("uniform", seed=10)
    params = dict(RANKER, numIterations=6, checkpointInterval=2,
                  checkpointDir=str(tmp_path / "ck"))
    full = estimators.LightGBMRanker(**params).set_device("cpu").fit(
        _frame(x, y, gid))
    plain = estimators.LightGBMRanker(**dict(RANKER, numIterations=6)) \
        .set_device("cpu").fit(_frame(x, y, gid))
    assert full.booster.num_trees == plain.booster.num_trees == 6
    # the directory now holds checkpoint 6: a re-run resumes there
    again = estimators.LightGBMRanker(**params).set_device("cpu").fit(
        _frame(x, y, gid))
    assert again.get_model_string() == full.get_model_string()
    # other query ids over the same rows: another fingerprint
    regrouped = np.roll(gid, 1)
    with pytest.raises(ValueError, match="different config or dataset"):
        estimators.LightGBMRanker(**params).set_device("cpu").fit(
            _frame(x, y, regrouped))
