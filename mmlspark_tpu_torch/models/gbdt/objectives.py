"""GBDT objectives: per-sample gradient/hessian of the loss wrt raw score.

Port of the JAX package's ``objectives.py``: binary, multiclass
(softmax; ``multiclassova`` is the same softmax there too), the
regression family L2 / L1 / huber / fair / poisson / quantile / mape /
gamma / tweedie, and lambdarank. Each is a plain function on tensors:
(preds, labels, weights, **cfg) -> (grad, hess), ``preds`` being raw
(pre-link) scores, (N, K) for multiclass. A custom objective is any
callable with the same signature (``get_objective`` returns it
unchanged).

Lambdarank's pairs are taken within query groups: the trainer builds
the groups' padded layout once per fit on the host
(:func:`make_group_layout`: groups bucketed by the next power of two of
their size) and each bucket's (G, S, S) pair tensors are computed in
chunks of groups under ``LAMBDARANK_CHUNK_BYTES``; the shapes are static
per dataset, so the lambdas run inside the captured boosting step.
Under a mesh every rank takes the lambdas over every row's gathered
scores and the layout of every group (``step.Step.scores``): the
objective never sees the row-sharded learners' pad rows, so nothing
mirrors the reference's group of their own for them
(``mmlspark_tpu/models/gbdt/trainer.py:2518-2525``). Every rank builds
every group's pair tensors (ROADMAP A8b's scaling limit).

The arithmetic is the reference's, op for op, so grad and hess are the
JAX package's bits wherever ``exp`` is; torch's ``exp``, ``sigmoid``
and ``log2`` and XLA's can differ by an ulp (poisson, gamma, tweedie,
multiclass, lambdarank: ROADMAP C10).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

ObjectiveFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]

# bytes of one float32 (G, S, S) pair tensor of a lambdarank chunk: a
# bucket's groups are taken this many bytes' worth at a time
LAMBDARANK_CHUNK_BYTES = 1 << 28


def _weighted(grad, hess, w):
    if w is None:
        return grad, hess
    if grad.ndim == 2 and w.ndim == 1:
        w = w[:, None]
    return grad * w, hess * w


# -- binary -----------------------------------------------------------------

def binary(preds, labels, weights=None, sigmoid: float = 1.0):
    p = torch.sigmoid(sigmoid * preds)
    grad = sigmoid * (p - labels)
    hess = sigmoid * sigmoid * p * (1.0 - p)
    return _weighted(grad, hess, weights)


# -- multiclass softmax ------------------------------------------------------

def multiclass(preds, labels, weights=None, num_class: int = 2):
    # jax.nn.softmax's ops: exp(x - max) / sum(exp(x - max))
    e = torch.exp(preds - torch.amax(preds, dim=-1, keepdim=True))
    p = e / torch.sum(e, dim=-1, keepdim=True)
    # jax.nn.one_hot: a label outside [0, K) is a row of zeros
    y = (labels.to(torch.int32)[:, None] == torch.arange(
        num_class, dtype=torch.int32, device=preds.device)).to(preds.dtype)
    grad = p - y
    # LightGBM's diagonal hessian approximation: factor 2 for stability
    hess = 2.0 * p * (1.0 - p)
    return _weighted(grad, hess, weights)


# -- regression family -------------------------------------------------------

def l2(preds, labels, weights=None):
    return _weighted(preds - labels, torch.ones_like(preds), weights)


def l1(preds, labels, weights=None):
    return _weighted(torch.sign(preds - labels), torch.ones_like(preds),
                     weights)


def huber(preds, labels, weights=None, alpha: float = 0.9):
    d = preds - labels
    grad = torch.where(torch.abs(d) <= alpha, d, alpha * torch.sign(d))
    return _weighted(grad, torch.ones_like(preds), weights)


def fair(preds, labels, weights=None, fair_c: float = 1.0):
    d = preds - labels
    grad = fair_c * d / (torch.abs(d) + fair_c)
    # a true division: torch's scalar / tensor multiplies by the
    # reciprocal, which rounds twice
    hess = torch.full_like(d, fair_c * fair_c) / (torch.abs(d) + fair_c) ** 2
    return _weighted(grad, hess, weights)


def poisson(preds, labels, weights=None, max_delta_step: float = 0.7):
    # score is log(mean); grad = exp(s) - y, hess = exp(s + max_delta_step)
    ex = torch.exp(preds)
    return _weighted(ex - labels, torch.exp(preds + max_delta_step), weights)


def quantile(preds, labels, weights=None, alpha: float = 0.5):
    d = preds - labels
    grad = torch.where(d >= 0, 1.0 - alpha, -alpha).to(preds.dtype)
    return _weighted(grad, torch.ones_like(preds), weights)


def mape(preds, labels, weights=None):
    safe = torch.clamp_min(torch.abs(labels), 1.0)
    grad = torch.sign(preds - labels) / safe
    return _weighted(grad, torch.ones_like(preds) / safe, weights)


def gamma(preds, labels, weights=None):
    # log-link gamma deviance: grad = 1 - y*exp(-s)
    ey = labels * torch.exp(-preds)
    return _weighted(1.0 - ey, ey, weights)


def tweedie(preds, labels, weights=None,
            tweedie_variance_power: float = 1.5):
    rho = tweedie_variance_power
    a = labels * torch.exp((1.0 - rho) * preds)
    b = torch.exp((2.0 - rho) * preds)
    grad = -a + b
    hess = -a * (1.0 - rho) + b * (2.0 - rho)
    return _weighted(grad, hess, weights)


# -- lambdarank --------------------------------------------------------------

def label_gains(labels, label_gain):
    """Each row's NDCG gain: ``label_gain[clip(int(label))]``, or
    ``2^label - 1`` without a table. ``label_gain`` is a sequence, or a
    float32 tensor on ``labels``' device: a copy from the host cannot
    run inside a captured step, so the step passes the tensor it made
    (``step.Step``)."""
    if label_gain is None:
        return 2.0 ** labels - 1.0
    lg = torch.as_tensor(label_gain, dtype=torch.float32,
                         device=labels.device).to(labels.dtype)
    idx = torch.clamp(labels.to(torch.int32), 0, lg.shape[0] - 1)
    return lg[idx.long()]


def group_ranks(scores, group_ids):
    """0-based descending-score rank within each group, ties broken by
    row order (tied scores still get distinct ranks, as the cold start
    needs: all raw scores are equal there)."""
    n = scores.shape[0]
    order1 = torch.argsort(-scores, stable=True)
    order2 = torch.argsort(group_ids[order1], stable=True)
    perm = order1[order2]                    # lexicographic (group, -score)
    pos = torch.arange(n, dtype=torch.int64, device=scores.device)
    pg = group_ids[perm]
    is_start = torch.cat([torch.ones(1, dtype=torch.bool,
                                     device=scores.device),
                          pg[1:] != pg[:-1]])
    start_pos = torch.cummax(torch.where(is_start, pos, -1), dim=0).values
    return torch.zeros(n, dtype=torch.int32, device=scores.device).scatter_(
        0, perm, (pos - start_pos).to(torch.int32))


def dense_group_index(group_ids):
    """Group ids -> dense indices in [0, G), numbered in sorted-group-id
    order (not first-occurrence order)."""
    n = group_ids.shape[0]
    order = torch.argsort(group_ids, stable=True)
    sg = group_ids[order]
    is_start = torch.cat([torch.ones(1, dtype=torch.int64,
                                     device=group_ids.device),
                          (sg[1:] != sg[:-1]).to(torch.int64)])
    dense_sorted = torch.cumsum(is_start, 0) - 1
    return torch.zeros(n, dtype=torch.int32, device=group_ids.device) \
        .scatter_(0, order, dense_sorted.to(torch.int32))


def make_group_layout(group_ids) -> tuple:
    """Host-side (numpy) padded group layouts for the bucketed
    lambdarank, as the JAX package builds them: a tuple of ``(rows,
    mask)`` buckets, each ``rows`` (G_b, S_b) int32 indices into the row
    arrays (pad slots point at index N: callers append one sentinel
    row) and ``mask`` (G_b, S_b) float32, 1.0 on real slots. Groups are
    bucketed by the next power of two of their size, so a skewed dataset
    never pays the largest group's pairwise work for its small groups;
    within a group, slots keep the rows' order."""
    gid = np.asarray(group_ids)
    n = gid.shape[0]
    inv = np.unique(gid, return_inverse=True)[1].reshape(-1)
    order = np.argsort(inv, kind="stable")
    counts = np.bincount(inv)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos_within = np.arange(n) - starts[inv[order]]
    # group -> size bucket (next power of two); dense index per bucket
    bucket_of = np.maximum(
        np.ceil(np.log2(np.maximum(counts, 1))), 0).astype(np.int64)
    buckets = []
    for b in np.unique(bucket_of):
        gsel = np.nonzero(bucket_of == b)[0]       # group ids in bucket
        s_b = int(counts[gsel].max())
        g_b = len(gsel)
        local_of = np.full(len(counts), -1, np.int64)
        local_of[gsel] = np.arange(g_b)
        rows = np.full((g_b, s_b), n, dtype=np.int32)
        mask = np.zeros((g_b, s_b), dtype=np.float32)
        in_b = bucket_of[inv[order]] == b
        rr = local_of[inv[order][in_b]]
        pp = pos_within[in_b]
        rows[rr, pp] = order[in_b].astype(np.int32)
        mask[rr, pp] = 1.0
        buckets.append((rows, mask))
    return tuple(buckets)


def layout_to(layout, device) -> tuple:
    """A host layout's buckets as (int64 rows, float32 mask) tensors on
    ``device``."""
    return tuple((torch.as_tensor(np.asarray(r), device=device).long(),
                  torch.as_tensor(np.asarray(m), device=device))
                 for r, m in layout)


def _ranks_within(x, mask):
    """(G, S) scores -> 0-based descending rank within each group row;
    masked slots sort last; ties break by slot (= row) order."""
    neg = torch.where(mask > 0, -x, torch.inf)
    order = torch.argsort(neg, dim=1, stable=True)
    # the inverse permutation (jnp.argsort of a permutation)
    return torch.empty_like(order).scatter_(
        1, order, torch.arange(x.shape[1], device=x.device)
        .expand_as(order).contiguous()).to(torch.int32)


def _chunks(g_b: int, s_b: int):
    """Slices of a bucket's groups whose (G, S, S) float32 tensors fit
    ``LAMBDARANK_CHUNK_BYTES`` (one group at least)."""
    step = max(1, LAMBDARANK_CHUNK_BYTES // max(s_b * s_b * 4, 1))
    return [slice(a, min(a + step, g_b)) for a in range(0, g_b, step)]


def _lambdarank_bucketed(preds, labels, group_layout, sigmoid_p,
                         truncation_level, label_gain):
    """Within-group pairwise lambdas over the size-bucketed layout: work
    and memory scale with sum_b G_b * S_b^2, never with N^2. Each row
    lies in exactly one bucket, so adding a chunk's lambdas into zeros
    is exact whatever the chunking."""
    n = preds.shape[0]
    grad = torch.zeros(n + 1, dtype=preds.dtype, device=preds.device)
    hess = torch.zeros(n + 1, dtype=preds.dtype, device=preds.device)
    zero = torch.zeros(1, dtype=preds.dtype, device=preds.device)
    preds_pad = torch.cat([preds, zero])
    labels_pad = torch.cat([labels, zero.to(labels.dtype)])
    for rows, mask in group_layout:
        rows = rows.long()
        for sl in _chunks(*rows.shape):
            r, m = rows[sl], mask[sl]
            g_b, h_b = _lambdarank_one_bucket(
                preds_pad[r], labels_pad[r], m, sigmoid_p,
                truncation_level, label_gain)
            flat = r.reshape(-1)
            grad.index_add_(0, flat, g_b.reshape(-1))
            hess.index_add_(0, flat, h_b.reshape(-1))
    return grad[:n], torch.clamp_min(hess[:n], 1e-9)


def _pair_lambdas(s_diff, valid, gain, disc_pred, idcg, sigmoid_p):
    """The pairs' (lambda, hessian) terms from the score differences, the
    valid-pair mask and each side's gain and discount (broadcast against
    ``s_diff``; ``idcg`` broadcast the same way)."""
    rho = torch.sigmoid(-sigmoid_p * s_diff)
    delta_ndcg = torch.abs(
        (gain[..., :, None] - gain[..., None, :])
        * (disc_pred[..., :, None] - disc_pred[..., None, :])) / idcg
    lam = torch.where(valid, -sigmoid_p * rho * delta_ndcg, 0.0)
    h = torch.where(valid,
                    sigmoid_p * sigmoid_p * rho * (1 - rho) * delta_ndcg, 0.0)
    return lam, h


def _lambdarank_one_bucket(pp, ll, mask, sigmoid_p, truncation_level,
                           label_gain):
    gain = label_gains(ll, label_gain) * mask
    pred_rank = _ranks_within(pp, mask)
    ideal_rank = _ranks_within(ll, mask)
    disc_pred = 1.0 / torch.log2(2.0 + pred_rank)
    disc_ideal = 1.0 / torch.log2(2.0 + ideal_rank)
    idcg = torch.clamp_min(torch.sum(gain * disc_ideal * mask, dim=1), 1e-12)

    s_diff = pp[:, :, None] - pp[:, None, :]
    label_diff = ll[:, :, None] - ll[:, None, :]
    valid = ((mask[:, :, None] * mask[:, None, :]) > 0) & (label_diff > 0)
    topk = pred_rank < truncation_level
    valid = valid & (topk[:, :, None] | topk[:, None, :])
    lam, h = _pair_lambdas(s_diff, valid, gain, disc_pred,
                           idcg[:, None, None], sigmoid_p)
    grad_gs = (torch.sum(lam, dim=2) - torch.sum(lam, dim=1)) * mask
    hess_gs = (torch.sum(h, dim=2) + torch.sum(h, dim=1)) * mask
    return grad_gs, hess_gs


def lambdarank(preds, labels, weights=None, group_ids=None,
               max_label: int = 31, sigmoid: float = 1.0,
               truncation_level: int = 30, label_gain=None,
               group_layout=None):
    """LambdaMART gradients with NDCG delta weighting, LightGBM's
    ``lambdarank``. With ``group_layout`` (the trainer always passes one:
    :func:`make_group_layout`'s buckets as tensors, :func:`layout_to`)
    the pairs are taken per group in the padded (G, S, S) layout;
    without one (direct callers) over the whole (N, N) batch, for small
    N only. ``label_gain``: a sequence (or a float32 tensor) of gains by
    integer label, else ``2^label - 1``. Only pairs touching the top
    ``truncation_level`` predicted positions carry gradient; the hessian
    is floored at 1e-9."""
    if group_ids is None and group_layout is None:
        raise ValueError("lambdarank requires group_ids")
    if label_gain is not None and len(label_gain) == 0:
        label_gain = None
    if group_layout is not None:
        grad, hess = _lambdarank_bucketed(
            preds, labels, group_layout, sigmoid, truncation_level,
            label_gain)
        return _weighted(grad, hess, weights)
    gain = label_gains(labels, label_gain)
    pred_rank = group_ranks(preds, group_ids)
    label_rank = group_ranks(labels, group_ids)
    disc_pred = 1.0 / torch.log2(2.0 + pred_rank)
    disc_ideal = 1.0 / torch.log2(2.0 + label_rank)
    idcg_terms = gain * disc_ideal
    # per-row ideal DCG of the row's group, through the pair mask
    same = group_ids[:, None] == group_ids[None, :]
    idcg_per_row = torch.clamp_min(same.to(preds.dtype) @ idcg_terms, 1e-12)

    s_diff = preds[:, None] - preds[None, :]
    label_diff = labels[:, None] - labels[None, :]
    valid = same & (label_diff > 0)
    topk = pred_rank < truncation_level
    valid = valid & (topk[:, None] | topk[None, :])
    lam, h = _pair_lambdas(s_diff, valid, gain, disc_pred,
                           idcg_per_row[:, None], sigmoid)
    grad = torch.sum(lam, dim=1) - torch.sum(lam, dim=0)
    hess = torch.clamp_min(torch.sum(h, dim=1) + torch.sum(h, dim=0), 1e-9)
    return _weighted(grad, hess, weights)


_L2_NAMES = ("regression", "regression_l2", "l2", "mean_squared_error", "mse")
_L1_NAMES = ("regression_l1", "l1", "mae")

MULTICLASS_NAMES = ("multiclass", "softmax", "multiclassova")
# the objectives that boost from the label median (``init_score``)
MEDIAN_NAMES = _L1_NAMES + ("quantile",)

OBJECTIVES: Dict[str, ObjectiveFn] = {
    "binary": binary,
    # multiclassova is the same softmax, as in the JAX package
    **{name: multiclass for name in MULTICLASS_NAMES},
    **{name: l2 for name in _L2_NAMES},
    **{name: l1 for name in _L1_NAMES},
    "huber": huber,
    "fair": fair,
    "poisson": poisson,
    "quantile": quantile,
    "mape": mape,
    "gamma": gamma,
    "tweedie": tweedie,
    "lambdarank": lambdarank,
}


def get_objective(name_or_fn) -> ObjectiveFn:
    """The objective named ``name_or_fn``, or the callable itself (a
    custom objective)."""
    if callable(name_or_fn):
        return name_or_fn
    try:
        return OBJECTIVES[name_or_fn]
    except KeyError:
        raise ValueError(f"unknown objective {name_or_fn!r}; "
                         f"have {sorted(OBJECTIVES)}") from None


def init_score(objective: str, labels, weights=None) -> float:
    """Constant initial raw score (LightGBM boost_from_average semantics),
    computed on the host in float64 as the JAX package does: the log of
    the weighted mean for the log-link objectives, the unweighted median
    for l1 / quantile, the weighted mean for the rest of the regression
    family, 0 otherwise (multiclass, lambdarank; the trainer never boosts
    lambdarank from the average)."""
    labels = np.asarray(labels, dtype=np.float64)
    w = np.ones_like(labels) if weights is None else np.asarray(weights)
    mean = float(np.sum(labels * w) / np.sum(w))
    if objective == "binary":
        mean = min(max(mean, 1e-12), 1 - 1e-12)
        return float(np.log(mean / (1 - mean)))
    if objective in ("poisson", "gamma", "tweedie"):
        return float(np.log(max(mean, 1e-12)))
    if objective in _L2_NAMES + ("huber", "fair", "mape"):
        return mean
    if objective in MEDIAN_NAMES:
        return float(np.median(labels))
    return 0.0
