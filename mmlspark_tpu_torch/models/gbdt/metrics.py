"""Training-time evaluation metrics (raw scores -> scalar tensor).

Port of the metrics this slice's objectives default to; the rest of the
JAX package's ``metrics.py`` (auc, multiclass, ndcg, ...) comes with the
estimator slice (ROADMAP A6).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch


def _w(weights, like):
    return torch.ones_like(like) if weights is None else weights


def binary_logloss(raw, labels, weights=None):
    p = torch.sigmoid(raw)
    p = torch.clamp(p, 1e-15, 1 - 1e-15)
    w = _w(weights, raw)
    ll = -(labels * torch.log(p) + (1 - labels) * torch.log1p(-p))
    return torch.sum(ll * w) / torch.sum(w)


def l2(raw, labels, weights=None):
    w = _w(weights, raw)
    return torch.sum((raw - labels) ** 2 * w) / torch.sum(w)


# name -> (fn, higher_better)
METRICS: Dict[str, Tuple[Callable, bool]] = {
    "binary_logloss": (binary_logloss, False),
    "l2": (l2, False),
    "mse": (l2, False),
}


def default_metric(objective: str) -> str:
    if objective == "binary":
        return "binary_logloss"
    return "l2"
