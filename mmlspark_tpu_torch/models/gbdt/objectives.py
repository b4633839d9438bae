"""GBDT objectives: per-sample gradient/hessian of the loss wrt raw score.

Port of the JAX package's ``objectives.py`` for the objectives this
slice trains (binary and L2). Each is a plain function on tensors:
(preds, labels, weights, **cfg) -> (grad, hess), ``preds`` being raw
(pre-link) scores. The other objectives are later work (ROADMAP A3).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

ObjectiveFn = Callable[..., Tuple[torch.Tensor, torch.Tensor]]


def _weighted(grad, hess, w):
    if w is None:
        return grad, hess
    if grad.ndim == 2 and w.ndim == 1:
        w = w[:, None]
    return grad * w, hess * w


def binary(preds, labels, weights=None, sigmoid: float = 1.0):
    p = torch.sigmoid(sigmoid * preds)
    grad = sigmoid * (p - labels)
    hess = sigmoid * sigmoid * p * (1.0 - p)
    return _weighted(grad, hess, weights)


def l2(preds, labels, weights=None):
    return _weighted(preds - labels, torch.ones_like(preds), weights)


_L2_NAMES = ("regression", "regression_l2", "l2", "mean_squared_error", "mse")

OBJECTIVES: Dict[str, ObjectiveFn] = {
    "binary": binary,
    **{name: l2 for name in _L2_NAMES},
}


# objectives of GBDT breadth (ROADMAP A7); the rest are A3's
_BREADTH = ("multiclass", "softmax", "multiclassova", "lambdarank")


def get_objective(name: str) -> ObjectiveFn:
    if name in _BREADTH:
        raise NotImplementedError(
            f"objective {name!r} is not in the port yet (ROADMAP A7, GBDT "
            "breadth: multiclass and lambdarank)")
    try:
        return OBJECTIVES[name]
    except KeyError:
        raise NotImplementedError(
            f"objective {name!r} is not in the port yet (ROADMAP A3, the "
            f"other objectives); have {sorted(OBJECTIVES)}") from None


def init_score(objective: str, labels, weights=None) -> float:
    """Constant initial raw score (LightGBM boost_from_average semantics),
    computed on the host in float64 as the JAX package does."""
    labels = np.asarray(labels, dtype=np.float64)
    w = np.ones_like(labels) if weights is None else np.asarray(weights)
    mean = float(np.sum(labels * w) / np.sum(w))
    if objective == "binary":
        mean = min(max(mean, 1e-12), 1 - 1e-12)
        return float(np.log(mean / (1 - mean)))
    if objective in _L2_NAMES:
        return mean
    raise NotImplementedError(
        f"init_score for objective {objective!r} is not in the port yet "
        "(ROADMAP A3, the other objectives)")
