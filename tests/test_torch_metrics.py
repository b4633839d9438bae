"""The port's evaluation metrics (``models/gbdt/metrics.py``) against the
JAX package's on the same seeded numpy inputs.

Tolerances: every metric within ``rtol=1e-6`` of JAX's, with and
without row weights (float32 sums in another order). AUC with tied
scores is exact: on small integer-valued inputs every midrank and sum
is an exact float32 value, so the port, JAX and a pairwise count in
float64 agree bit for bit.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlspark_tpu.models.gbdt import metrics as jax_metrics
from mmlspark_tpu_torch.models.gbdt import metrics, trainer

# one intra-op thread per process: pytest-xdist runs several test
# files at once on shared cores, and the port's plain CPU path is
# many small ops that an oversubscribed thread pool slows down
torch.set_num_threads(1)

# the metrics of ungrouped rows (ndcg: tests/test_torch_ranking.py)
NAMES = sorted(set(metrics.METRICS) - {"ndcg"})


def _inputs(name, n=600, seed=0):
    rng = np.random.default_rng(seed)
    if name.startswith("multi_"):
        raw = rng.normal(size=(n, 4)).astype(np.float32) * 2
        labels = rng.integers(0, 4, size=n).astype(np.float32)
    else:
        raw = rng.normal(size=n).astype(np.float32) * 2
        if name in ("binary_logloss", "binary_error", "auc"):
            labels = (rng.random(n) < 0.4).astype(np.float32)
        elif name == "poisson":
            labels = rng.poisson(2.0, size=n).astype(np.float32)
        else:
            labels = (rng.normal(size=n) * 3).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    return raw, labels, weights


def test_the_port_has_every_metric_but_ndcg():
    """Every metric of the JAX table, ndcg too since lambdarank came
    over (its parity: tests/test_torch_ranking.py)."""
    assert set(metrics.METRICS) == set(jax_metrics.METRICS)
    assert metrics.METRICS["ndcg"][1] is True


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_metric_matches_jax(name, weighted):
    raw, labels, weights = _inputs(name)
    w = weights if weighted else None
    jfn, jhb = jax_metrics.METRICS[name]
    pfn, phb = metrics.METRICS[name]
    want = float(jfn(jnp.asarray(raw), jnp.asarray(labels),
                     None if w is None else jnp.asarray(w)))
    got = pfn(torch.from_numpy(raw), torch.from_numpy(labels),
              None if w is None else torch.from_numpy(w))
    assert got.shape == () and got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    assert phb == jhb


@pytest.mark.parametrize("alpha", [0.1, 0.5, 0.9])
def test_quantile_alpha_matches_jax(alpha):
    raw, labels, weights = _inputs("quantile", seed=3)
    want = float(jax_metrics.quantile_loss(
        jnp.asarray(raw), jnp.asarray(labels), jnp.asarray(weights),
        alpha=alpha))
    got = float(metrics.quantile_loss(
        torch.from_numpy(raw), torch.from_numpy(labels),
        torch.from_numpy(weights), alpha=alpha))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _pairwise_auc(scores, labels, weights):
    """Weighted AUC by counting pairs in float64: a tie counts half."""
    num = den = 0.0
    for i, j in itertools.product(range(len(scores)), repeat=2):
        if labels[i] == 1 and labels[j] == 0:
            ww = weights[i] * weights[j]
            den += ww
            num += ww * (1.0 if scores[i] > scores[j]
                         else 0.5 if scores[i] == scores[j] else 0.0)
    return num / den


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("weighted", [False, True])
def test_auc_with_ties_is_exact(seed, weighted):
    rng = np.random.default_rng(seed)
    n = 64
    raw = rng.integers(-3, 4, size=n).astype(np.float32)      # many ties
    labels = (rng.random(n) < 0.5).astype(np.float32)
    weights = (rng.integers(1, 4, size=n) if weighted
               else np.ones(n)).astype(np.float32)
    w = weights if weighted else None
    got = float(metrics.auc(torch.from_numpy(raw), torch.from_numpy(labels),
                            None if w is None else torch.from_numpy(w)))
    want = float(jax_metrics.auc(jnp.asarray(raw), jnp.asarray(labels),
                                 None if w is None else jnp.asarray(w)))
    assert got == want
    assert got == np.float32(_pairwise_auc(raw, labels, weights))


def test_auc_of_constant_scores_and_one_class():
    labels = torch.tensor([0.0, 1.0, 1.0, 0.0, 1.0])
    assert float(metrics.auc(torch.zeros(5), labels)) == 0.5
    assert float(metrics.auc(torch.arange(5.0), torch.ones(5))) == 0.5


@pytest.mark.parametrize("objective", [
    "binary", "regression", "regression_l1", "l1", "mae", "quantile",
    "poisson", "mape", "huber", "multiclass", "softmax", "lambdarank"])
def test_default_metric_matches_jax(objective):
    assert metrics.default_metric(objective) == \
        jax_metrics.default_metric(objective)


@pytest.mark.parametrize("name,item", [
    # no ROADMAP item adds a metric the reference does not have either
    # (its KeyError); the case keeps its id
    pytest.param("map", "not a metric of the port or of the reference",
                 id="map-A7")])
def test_metrics_outside_the_slice_raise(name, item):
    cfg = trainer.TrainConfig(objective="binary", metric=name)
    with pytest.raises(NotImplementedError, match=item):
        trainer.check_supported(cfg)


def test_quantile_metric_takes_the_training_alpha():
    cfg = trainer.TrainConfig(objective="regression", metric="quantile",
                              alpha=0.3)
    name, fns, higher, kw = trainer._resolve_metrics(cfg)
    assert (name, [n for n, _ in fns], higher, kw) == \
        ("quantile", ["quantile"], False, {"alpha": 0.3})
