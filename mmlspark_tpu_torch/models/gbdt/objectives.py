"""GBDT objectives: per-sample gradient/hessian of the loss wrt raw score.

Port of the JAX package's ``objectives.py``: binary, and the regression
family L2 / L1 / huber / fair / poisson / quantile / mape / gamma /
tweedie. Each is a plain function on tensors: (preds, labels, weights,
**cfg) -> (grad, hess), ``preds`` being raw (pre-link) scores. A custom
objective is any callable with the same signature (``get_objective``
returns it unchanged). Multiclass and lambdarank are later work
(ROADMAP A7).

The arithmetic is the reference's, op for op, so grad and hess are the
JAX package's bits wherever ``exp`` is; torch's ``exp`` and XLA's can
differ by an ulp (poisson, gamma, tweedie: ROADMAP C10).
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


# -- binary -----------------------------------------------------------------

def binary(preds, labels, weights=None, sigmoid: float = 1.0):
    p = torch.sigmoid(sigmoid * preds)
    grad = sigmoid * (p - labels)
    hess = sigmoid * sigmoid * p * (1.0 - p)
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


_L2_NAMES = ("regression", "regression_l2", "l2", "mean_squared_error", "mse")
_L1_NAMES = ("regression_l1", "l1", "mae")

OBJECTIVES: Dict[str, ObjectiveFn] = {
    "binary": binary,
    **{name: l2 for name in _L2_NAMES},
    **{name: l1 for name in _L1_NAMES},
    "huber": huber,
    "fair": fair,
    "poisson": poisson,
    "quantile": quantile,
    "mape": mape,
    "gamma": gamma,
    "tweedie": tweedie,
}

# objectives of GBDT breadth (ROADMAP A7)
_BREADTH = ("multiclass", "softmax", "multiclassova", "lambdarank")


def get_objective(name_or_fn) -> ObjectiveFn:
    """The objective named ``name_or_fn``, or the callable itself (a
    custom objective)."""
    if callable(name_or_fn):
        return name_or_fn
    if name_or_fn in _BREADTH:
        raise NotImplementedError(
            f"objective {name_or_fn!r} is not in the port yet (ROADMAP A7, "
            "GBDT breadth: multiclass and lambdarank)")
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
    family, 0 otherwise."""
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
    if objective in _L1_NAMES + ("quantile",):
        return float(np.median(labels))
    return 0.0
