"""Evaluation metrics for training-time eval and early stopping — the
port of the JAX package's ``models/gbdt/metrics.py``.

Each metric maps raw scores (and labels, optional row weights) to a 0-d
tensor on the scores' device; ``higher_better`` drives the early-stop
direction, as LightGBM's per-metric flag does. ``ndcg_at(k)`` takes
query groups: the trainer passes each set's padded group layout
(``objectives.make_group_layout``, built once per fit), so the metric
runs in the captured step without a host sync.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from mmlspark_tpu_torch.models.gbdt import objectives as obj_mod


def _w(weights, like):
    return torch.ones_like(like) if weights is None else weights


def binary_logloss(raw, labels, weights=None):
    p = torch.sigmoid(raw)
    p = torch.clamp(p, 1e-15, 1 - 1e-15)
    w = _w(weights, raw)
    ll = -(labels * torch.log(p) + (1 - labels) * torch.log1p(-p))
    return torch.sum(ll * w) / torch.sum(w)


def binary_error(raw, labels, weights=None):
    pred = (raw > 0).to(raw.dtype)
    w = _w(weights, raw)
    return torch.sum((pred != labels) * w) / torch.sum(w)


def auc(raw, labels, weights=None):
    """Weighted ROC-AUC via the rank statistic with true midranks for
    tied scores (ties share the average of their rank range, so the
    value is permutation-invariant; constant scores give exactly 0.5)."""
    w = _w(weights, raw)
    order = torch.argsort(raw, stable=True)
    s, sw, sy = raw[order], w[order], labels[order]
    cum = torch.cumsum(sw, 0)
    left = torch.searchsorted(s, s, side="left")
    right = torch.searchsorted(s, s, side="right")
    below = torch.where(left > 0, cum[torch.clamp_min(left - 1, 0)], 0.0)
    upto = cum[right - 1]
    midrank = (below + upto) / 2.0
    pos = torch.sum(sw * sy)
    neg = torch.sum(sw) - pos
    pos_rank = torch.sum(midrank * sw * sy)
    u = pos_rank - pos * pos / 2.0
    return torch.where((pos > 0) & (neg > 0), u / (pos * neg),
                       torch.full_like(u, 0.5))


def multi_logloss(raw, labels, weights=None):
    logp = torch.log_softmax(raw, dim=-1)
    ll = -torch.gather(logp, 1, labels.long()[:, None])[:, 0]
    w = _w(weights, ll)
    return torch.sum(ll * w) / torch.sum(w)


def multi_error(raw, labels, weights=None):
    pred = torch.argmax(raw, dim=-1)
    w = _w(weights, pred.to(raw.dtype))
    return torch.sum((pred != labels.to(pred.dtype)) * w) / torch.sum(w)


def l2(raw, labels, weights=None):
    w = _w(weights, raw)
    return torch.sum((raw - labels) ** 2 * w) / torch.sum(w)


def rmse(raw, labels, weights=None):
    return torch.sqrt(l2(raw, labels, weights))


def l1(raw, labels, weights=None):
    w = _w(weights, raw)
    return torch.sum(torch.abs(raw - labels) * w) / torch.sum(w)


def mape_metric(raw, labels, weights=None):
    w = _w(weights, raw)
    e = torch.abs(raw - labels) / torch.clamp_min(torch.abs(labels), 1.0)
    return torch.sum(e * w) / torch.sum(w)


def poisson_deviance(raw, labels, weights=None):
    # raw is log(mean)
    w = _w(weights, raw)
    d = torch.exp(raw) - labels * raw
    return torch.sum(d * w) / torch.sum(w)


def quantile_loss(raw, labels, weights=None, alpha: float = 0.5):
    w = _w(weights, raw)
    d = labels - raw
    loss = torch.maximum(alpha * d, (alpha - 1) * d)
    return torch.sum(loss * w) / torch.sum(w)


def ndcg_at(k: int, label_gain=None):
    """NDCG@k averaged over query groups (the JAX package's ``ndcg_at``):
    each group counted once, groups whose rows all have zero weight left
    out, ties ranked in row order; ``label_gain`` as in
    ``objectives.label_gains``. ``ndcg(raw, labels, weights=None,
    group_ids=None, group_layout=None)``: the groups as ``group_layout``
    (``objectives.layout_to`` of ``make_group_layout``'s buckets), or as
    ``group_ids``, whose layout is then built on the host. A group's
    sums are reductions over its row of the padded layout (the
    reference's segment sums over dense group ids), so the value is the
    same bits on every run."""
    def ndcg(raw, labels, weights=None, group_ids=None, group_layout=None):
        if group_layout is None:
            if group_ids is None:
                raise ValueError("ndcg requires group_ids")
            ids = (group_ids.cpu().numpy() if isinstance(group_ids,
                                                         torch.Tensor)
                   else group_ids)
            group_layout = obj_mod.layout_to(
                obj_mod.make_group_layout(ids), raw.device)
        zero = torch.zeros(1, dtype=raw.dtype, device=raw.device)
        raw_p = torch.cat([raw, zero])
        lab_p = torch.cat([labels, zero.to(labels.dtype)])
        w_p = torch.cat([_w(weights, raw), zero])
        total = torch.zeros((), dtype=raw.dtype, device=raw.device)
        count = torch.zeros((), dtype=raw.dtype, device=raw.device)
        for rows, mask in group_layout:
            rows = rows.long()
            ll = lab_p[rows]
            real = mask > 0
            gain = obj_mod.label_gains(ll, label_gain)

            def dcg(rank):
                return torch.sum(torch.where(
                    real & (rank < k), gain / torch.log2(2.0 + rank), 0.0),
                    dim=1)

            ndcg_g = dcg(obj_mod._ranks_within(raw_p[rows], mask)) \
                / torch.clamp_min(dcg(obj_mod._ranks_within(ll, mask)),
                                  1e-12)
            valid = torch.any(real & (w_p[rows] > 0), dim=1)
            total = total + torch.sum(torch.where(valid, ndcg_g, 0.0))
            count = count + torch.sum(valid.to(raw.dtype))
        return total / torch.clamp_min(count, 1e-12)

    ndcg.__name__ = f"ndcg@{k}"
    return ndcg


# name -> (fn, higher_better)
METRICS: Dict[str, Tuple[Callable, bool]] = {
    "binary_logloss": (binary_logloss, False),
    "binary_error": (binary_error, False),
    "auc": (auc, True),
    "multi_logloss": (multi_logloss, False),
    "multi_error": (multi_error, False),
    "l2": (l2, False),
    "mse": (l2, False),
    "rmse": (rmse, False),
    "l1": (l1, False),
    "mae": (l1, False),
    "mape": (mape_metric, False),
    "poisson": (poisson_deviance, False),
    "quantile": (quantile_loss, False),
    "ndcg": (ndcg_at(5), True),
}


def default_metric(objective: str) -> str:
    if objective == "binary":
        return "binary_logloss"
    if objective in ("multiclass", "softmax", "multiclassova"):
        return "multi_logloss"
    if objective == "lambdarank":
        return "ndcg"
    if objective in ("regression_l1", "l1", "mae"):
        return "l1"
    if objective == "quantile":
        return "quantile"
    if objective == "poisson":
        return "poisson"
    if objective == "mape":
        return "mape"
    return "l2"
