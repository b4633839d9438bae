"""The port's sampling draws and masks (``models/gbdt/sampling.py``)
against the JAX package's fused step (``trainer._make_step_fn``, the
bagging, feature-fraction and GOSS lines), on the CPU.

Tolerances, by case:

  - fed ``jax.random``'s draws for the reference's keys, ``bag_mask``,
    ``feature_mask`` and ``goss_mult`` are the reference's masks and
    multipliers bit for bit (the same float32 compares and products);
  - ``nanquantile`` is ``jnp.nanquantile`` bit for bit, ties and NaNs
    included (XLA rounds the linear blend as one fused multiply-add);
  - the port's own draws: the kept-row share of a bag lies within 6
    binomial standard deviations of the fraction (a false alarm about
    once in 10^9 runs), exactly ``keep`` features are kept, GOSS keeps
    at least ``top_rate`` of the rows, and a draw is a pure function of
    its key (the same bits on two calls, and for an iteration given as an
    int or as a device scalar, so a resumed segment draws what the
    uninterrupted fit drew).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu_torch.models.gbdt import sampling
from mmlspark_tpu_torch.models.gbdt.trainer import TrainConfig

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)


def jax_key(keys):
    """The reference's key for a chain ``(seed, stream, ...)``:
    ``fold_in`` of each entry after the seed, in order."""
    seed, *rest = (int(k) for k in keys)
    key = jax.random.key(seed)
    for v in rest:
        key = jax.random.fold_in(key, v)
    return key


def jax_draw(keys, n, device):
    """``sampling.draw`` with the reference's draws: uniforms for the
    bagging and GOSS streams; for the feature stream, each feature's
    place in ``jax.random.permutation`` (so sorting the draws gives the
    reference's permutation)."""
    key = jax_key(keys)
    if int(keys[1]) == sampling.FEATURES:
        perm = np.asarray(jax.random.permutation(key, n))
        out = np.empty(n, np.float32)
        out[perm] = np.arange(n, dtype=np.float32)
    else:
        out = np.array(jax.random.uniform(key, (n,)))
    return torch.from_numpy(out).to(device)


def _cfg(**kw):
    return TrainConfig(objective="binary", **kw)


# --- the reference's lines, as _make_step_fn writes them ---------------------

def ref_bag_mask(cfg, labels, rv, it):
    frac, freq = cfg.bagging_fraction, cfg.bagging_freq
    pos_neg = (cfg.pos_bagging_fraction < 1.0
               or cfg.neg_bagging_fraction < 1.0)
    is_rf = cfg.boosting_type == "rf"
    ref_it = it - (it % freq) if freq > 0 else 0
    kbag = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.key(cfg.seed), 1), cfg.bagging_seed), ref_it)
    draw = jax.random.uniform(kbag, (labels.shape[0],))
    if pos_neg and not is_rf:
        thr_vec = jnp.where(labels > 0, cfg.pos_bagging_fraction,
                            cfg.neg_bagging_fraction)
        return (draw < thr_vec).astype(jnp.float32) * rv
    use_frac = (frac if frac < 1.0 else 0.632) if is_rf else frac
    return (draw < use_frac).astype(jnp.float32) * rv


def ref_feature_mask(cfg, num_f, it):
    keep = max(1, int(round(num_f * cfg.feature_fraction)))
    kf = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.key(cfg.seed), 2), cfg.feature_fraction_seed), it)
    perm = jax.random.permutation(kf, num_f)
    return jnp.zeros(num_f, jnp.float32).at[perm[:keep]].set(1.0)


@jax.jit
def _ref_quantile(a, q):
    return jnp.nanquantile(a, q)


def ref_goss_mult(cfg, g, rv, it):
    absg = jnp.abs(g)
    thr = jnp.nanquantile(jnp.where(rv > 0, absg, jnp.nan),
                          1.0 - cfg.top_rate)
    big = absg >= thr
    kg = jax.random.fold_in(jax.random.fold_in(jax.random.key(cfg.seed), 3),
                            it)
    small_keep = jax.random.uniform(kg, absg.shape) < (
        cfg.other_rate / max(1.0 - cfg.top_rate, 1e-12))
    amplify = (1.0 - cfg.top_rate) / max(cfg.other_rate, 1e-12)
    return jnp.where(big, 1.0, jnp.where(small_keep, amplify, 0.0))


# --- masks against the reference, given its draws ----------------------------

@pytest.mark.parametrize("kw", [
    dict(bagging_fraction=0.5, bagging_freq=1),
    dict(bagging_fraction=0.8, bagging_freq=3, bagging_seed=11, seed=5),
    dict(pos_bagging_fraction=0.7, neg_bagging_fraction=0.2,
         bagging_freq=2),
    dict(boosting_type="rf"),
    dict(boosting_type="rf", bagging_fraction=0.4, bagging_freq=1,
         pos_bagging_fraction=0.5),
])
@pytest.mark.parametrize("it", [0, 1, 7])
def test_bag_mask_is_the_reference_given_its_draws(kw, it):
    cfg = _cfg(**kw)
    n = 5000
    rng = np.random.default_rng(it)
    labels = (rng.random(n) < 0.4).astype(np.float32)
    rv = (rng.random(n) < 0.9).astype(np.float32)
    draw = jax_draw(sampling.bag_keys(cfg, torch.tensor(it)), n, "cpu")
    got = sampling.bag_mask(draw, torch.from_numpy(labels), cfg,
                            torch.from_numpy(rv))
    want = np.asarray(ref_bag_mask(cfg, jnp.asarray(labels),
                                   jnp.asarray(rv), it))
    np.testing.assert_array_equal(got.numpy(), want)
    assert sampling.bag_active(cfg)


@pytest.mark.parametrize("num_f,ff", [(28, 0.5), (7, 0.3), (5, 0.01),
                                      (64, 0.9)])
@pytest.mark.parametrize("it", [0, 3])
def test_feature_mask_is_the_reference_given_its_draws(num_f, ff, it):
    cfg = _cfg(feature_fraction=ff, feature_fraction_seed=4, seed=9)
    keep = sampling.feature_keep(num_f, ff)
    draw = jax_draw(sampling.feature_keys(cfg, it), num_f, "cpu")
    got = sampling.feature_mask(draw, num_f, keep)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_feature_mask(cfg, num_f, it)))
    assert int(got.sum()) == keep


def _grads(kind, n, rng):
    if kind == "normal":
        return rng.normal(size=n).astype(np.float32)
    if kind == "ties":       # L2 on integer labels: a few |g| values
        return (rng.integers(-3, 4, size=n) * 0.3).astype(np.float32)
    return (rng.random(n) ** 4 - 0.2).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "ties", "skewed"])
@pytest.mark.parametrize("rates", [(0.2, 0.1), (0.3, 0.25), (0.05, 0.5)])
@pytest.mark.parametrize("with_rv", [False, True])
def test_goss_mult_is_the_reference_given_its_draws(kind, rates, with_rv):
    cfg = _cfg(boosting_type="goss", top_rate=rates[0], other_rate=rates[1],
               seed=3)
    n, it = 4001, 5
    rng = np.random.default_rng(len(kind))
    g = _grads(kind, n, rng)
    rv = ((rng.random(n) < 0.8) if with_rv else np.ones(n)).astype(
        np.float32)
    draw = jax_draw(sampling.goss_keys(cfg, it), n, "cpu")
    got = sampling.goss_mult(torch.from_numpy(g), draw,
                             torch.from_numpy(rv) if with_rv else None, cfg)
    want = np.asarray(ref_goss_mult(cfg, jnp.asarray(g), jnp.asarray(rv), it))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed", range(6))
def test_nanquantile_is_jnp_nanquantile(seed):
    rng = np.random.default_rng(seed)
    for q in (0.8, 0.7, 0.95, 0.5, 0.0, 1.0, 1 - 0.33):
        n = int(rng.integers(1, 3000))
        a = np.abs(_grads(("normal", "ties", "skewed")[seed % 3], n, rng))
        if seed % 2:
            a[rng.random(n) < 0.2] = np.nan
        got = sampling.nanquantile(torch.from_numpy(a), q)
        want = np.asarray(_ref_quantile(a, q))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"q={q}")


# --- the port's own draws ----------------------------------------------------

def test_mul32_and_mix32_are_exact_on_ints_and_tensors():
    rng = np.random.default_rng(0)
    xs = [0, 1, 2 ** 32 - 1, 2 ** 31, *map(int, rng.integers(0, 2 ** 32,
                                                             size=200))]
    t = torch.tensor(xs, dtype=torch.int64)
    for c in (0x85EBCA6B, 0xC2B2AE35, 0x9E3779B9, 1, 0xFFFFFFFF):
        want = [(x * c) % 2 ** 32 for x in xs]
        assert [sampling._mul32(x, c) for x in xs] == want
        assert sampling._mul32(t, c).tolist() == want
    assert sampling.mix32(t).tolist() == [sampling.mix32(x) for x in xs]
    assert len(set(sampling.mix32(t).tolist())) == len(set(xs))  # bijective


def test_draw_is_a_pure_function_of_its_key():
    keys = (0, sampling.BAG, 3, 4)
    a = sampling.counter_uniform(keys, 10_000, "cpu")
    b = sampling.counter_uniform(keys, 10_000, "cpu")
    c = sampling.counter_uniform((0, 1, 3, torch.tensor(4)), 10_000, "cpu")
    assert torch.equal(a, b) and torch.equal(a, c)
    assert a.dtype == torch.float32 and bool((a >= 0).all() & (a < 1).all())
    # another iteration, stream or seed draws other numbers
    for other in ((0, 1, 3, 5), (0, 2, 3, 4), (1, 1, 3, 4), (0, 1, 4, 4)):
        assert not torch.equal(a, sampling.counter_uniform(other, 10_000,
                                                           "cpu"))
    # a prefix of a longer draw is the shorter draw (row r depends on r only)
    assert torch.equal(sampling.counter_uniform(keys, 777, "cpu"), a[:777])


def test_bag_keys_follow_the_reference_schedule():
    cfg = _cfg(bagging_fraction=0.5, bagging_freq=3, seed=2, bagging_seed=8)
    assert [sampling.bag_keys(cfg, it)[3] for it in range(7)] == \
        [0, 0, 0, 3, 3, 3, 6]
    assert sampling.bag_keys(cfg, 5)[:3] == (2, sampling.BAG, 8)
    rf = _cfg(boosting_type="rf")
    assert sampling.bag_keys(rf, 9)[3] == 0        # one fixed bag
    assert sampling.bag_active(rf)
    assert not sampling.bag_active(_cfg(bagging_fraction=0.5))  # no freq
    assert not sampling.bag_active(_cfg(bagging_freq=1))        # fraction 1
    assert sampling.goss_keys(cfg, 4) == (2, sampling.GOSS, 4)
    assert sampling.feature_keys(_cfg(feature_fraction_seed=6, seed=1), 4) \
        == (1, sampling.FEATURES, 6, 4)


@pytest.mark.parametrize("frac", [0.1, 0.5, 0.632, 0.9])
def test_kept_share_lies_within_binomial_bounds(frac):
    n = 200_000
    cfg = _cfg(bagging_fraction=frac, bagging_freq=1)
    labels = torch.zeros(n)
    for it in range(3):
        mask = sampling.bag_mask(sampling.draw(sampling.bag_keys(cfg, it), n,
                                               "cpu"), labels, cfg)
        sd = (n * frac * (1 - frac)) ** 0.5
        assert abs(float(mask.sum()) - n * frac) < 6 * sd, (it, frac)


def test_pos_neg_rates_apply_per_class():
    n = 200_000
    cfg = _cfg(pos_bagging_fraction=0.7, neg_bagging_fraction=0.2,
               bagging_freq=1)
    labels = (torch.arange(n) % 3 == 0).float()
    mask = sampling.bag_mask(sampling.draw(sampling.bag_keys(cfg, 0), n,
                                           "cpu"), labels, cfg)
    for cls, rate in ((1.0, 0.7), (0.0, 0.2)):
        sel = labels == cls
        k = int(sel.sum())
        sd = (k * rate * (1 - rate)) ** 0.5
        assert abs(float(mask[sel].sum()) - k * rate) < 6 * sd


@pytest.mark.parametrize("num_f,ff", [(28, 0.5), (10, 0.25), (3, 0.1)])
def test_exactly_keep_features_are_used(num_f, ff):
    cfg = _cfg(feature_fraction=ff)
    keep = sampling.feature_keep(num_f, ff)
    seen = set()
    for it in range(20):
        m = sampling.feature_mask(sampling.draw(
            sampling.feature_keys(cfg, it), num_f, "cpu"), num_f, keep)
        assert int(m.sum()) == keep and set(m.unique().tolist()) <= {0.0, 1.0}
        seen.add(tuple(m.tolist()))
    assert len(seen) > 1              # the subset changes with the tree


@pytest.mark.parametrize("top,other", [(0.2, 0.1), (0.5, 0.3), (0.1, 0.0)])
def test_goss_keeps_at_least_top_rate(top, other):
    n = 50_000
    cfg = _cfg(boosting_type="goss", top_rate=top, other_rate=other)
    g = torch.from_numpy(np.random.default_rng(1).normal(size=n)
                         .astype(np.float32))
    mult = sampling.goss_mult(g, sampling.draw(sampling.goss_keys(cfg, 2), n,
                                               "cpu"), None, cfg)
    big = mult == 1.0
    assert int(big.sum()) >= top * n
    # every kept large-gradient row has |g| at least every dropped row's
    assert float(g.abs()[big].min()) >= float(g.abs()[~big].max())
    small = mult > 1.0
    rate = other / (1 - top)
    k = n - int(big.sum())
    sd = (k * rate * (1 - rate)) ** 0.5 + 1e-9
    assert abs(int(small.sum()) - k * rate) < 6 * sd
    if other:
        assert torch.all(mult[small] == np.float32((1 - top) / other))


def test_draws_are_alike_at_any_iteration_offset():
    """The draw of global iteration ``it`` depends on ``it`` alone: a
    fit resumed at offset k draws for iterations k, k+1, ... what an
    uninterrupted fit drew there."""
    cfg = dataclasses.replace(_cfg(bagging_fraction=0.5, bagging_freq=2),
                              feature_fraction=0.5)
    full = [sampling.draw(sampling.bag_keys(cfg, it), 500, "cpu")
            for it in range(8)]
    offset = 5
    it_buf = torch.zeros((), dtype=torch.int64)
    for local in range(3):
        it_buf.fill_(offset + local)
        got = sampling.draw(sampling.bag_keys(cfg, it_buf), 500, "cpu")
        assert torch.equal(got, full[offset + local])
