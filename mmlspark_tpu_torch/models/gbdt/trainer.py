"""Histogram-GBDT training on PyTorch — the port of the JAX trainer's
numeric fast path.

What this slice runs (and the JAX trainer it mirrors, file
``mmlspark_tpu/models/gbdt/trainer.py``):

  - ``TrainConfig`` with ``effective_depth``;
  - per level, the histogram (``hist_cuda.level_histogram``: the CUDA
    kernel on the card, its plain version on the CPU), numeric split
    finding (``_find_numeric_splits``) and row routing — the
    ``simple_numeric`` branch of ``make_build_tree``;
  - the gbdt boosting step: objective grad/hess, one tree, shrinkage,
    raw-score update through ``_predict_tree``, the training metric;
  - ``train``: serial, in-core, no validation sets, and
    ``_assemble_booster``.

Trees grow level-wise over ``effective_depth`` levels in the full-tree
layout (node i's children are 2i+1 / 2i+2), with the ``num_leaves``
budget applied by within-level gain rank, as in the JAX package. No
histogram subtraction: every level histograms all rows, as the JAX
trainer does on the TPU.

The boosting loop never reads a device value on the host: trees and
metrics stay on the device and come back in one transfer at the end.
Every ``TrainConfig`` setting outside this slice raises
``NotImplementedError`` naming the ROADMAP item that will add it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, fields
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.models.gbdt import metrics as metrics_mod
from mmlspark_tpu_torch.models.gbdt import objectives as obj_mod
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
from mmlspark_tpu_torch.models.gbdt.hist_cuda import level_histogram
from mmlspark_tpu_torch.ops.ingest import binned_ingest_dtype


@dataclass(frozen=True)
class TrainConfig:
    """Static training configuration. Field names and defaults are the
    JAX package's, so one config describes the same fit in both."""

    objective: str = "regression"
    num_iterations: int = 100
    learning_rate: float = 0.1
    num_leaves: int = 31
    max_depth: int = 5            # full-tree layout depth (2^d leaves max)
    max_bin: int = 255
    lambda_l1: float = 0.0
    lambda_l2: float = 0.0
    min_data_in_leaf: int = 20
    min_sum_hessian_in_leaf: float = 1e-3
    min_gain_to_split: float = 0.0
    feature_fraction: float = 1.0
    bagging_fraction: float = 1.0
    bagging_freq: int = 0
    boosting_type: str = "gbdt"   # gbdt | rf | dart | goss
    top_rate: float = 0.2         # goss
    other_rate: float = 0.1       # goss
    drop_rate: float = 0.1        # dart
    skip_drop: float = 0.5        # dart
    num_class: int = 1
    sigmoid: float = 1.0
    alpha: float = 0.9            # huber / quantile
    tweedie_variance_power: float = 1.5
    poisson_max_delta_step: float = 0.7
    fair_c: float = 1.0
    early_stopping_round: int = 0
    metric: Optional[str] = None
    eval_at: Any = 5
    tree_learner: str = "serial"
    top_k: int = 20
    seed: int = 0
    deterministic: bool = True
    boost_from_average: bool = True
    categorical_features: Any = ()
    cat_smooth: float = 10.0
    cat_l2: float = 10.0
    max_cat_threshold: int = 32
    max_cat_to_onehot: int = 4
    monotone_constraints: Any = ()
    path_smooth: float = 0.0
    max_delta_step: float = 0.0
    pos_bagging_fraction: float = 1.0
    neg_bagging_fraction: float = 1.0
    extra_trees: bool = False
    max_drop: int = 50
    uniform_drop: bool = False
    drop_seed: Optional[int] = None
    bagging_seed: int = 3
    feature_fraction_seed: int = 2
    extra_seed: int = 6
    lambdarank_truncation_level: int = 30
    label_gain: Any = ()
    zero_as_missing: bool = False
    feature_fraction_by_node: float = 1.0
    improvement_tolerance: float = 0.0
    min_data_per_group: int = 100
    min_data_in_bin: int = 3

    @property
    def effective_depth(self) -> int:
        # enough depth for num_leaves leaves, capped by max_depth if set
        need = max(1, math.ceil(math.log2(max(self.num_leaves, 2))))
        if self.max_depth and self.max_depth > 0:
            return min(need, self.max_depth) if self.num_leaves > 0 else self.max_depth
        return need


# Settings this slice does not implement: field -> the ROADMAP item that
# adds it. A non-default value raises instead of being ignored.
_LATER = {
    "boosting_type": "A7 (GBDT breadth: dart, goss, rf)",
    "feature_fraction": "A7 (GBDT breadth: feature sampling)",
    "feature_fraction_by_node": "A7 (GBDT breadth: feature sampling)",
    "bagging_fraction": "A7 (GBDT breadth: bagging)",
    "bagging_freq": "A7 (GBDT breadth: bagging)",
    "pos_bagging_fraction": "A7 (GBDT breadth: bagging)",
    "neg_bagging_fraction": "A7 (GBDT breadth: bagging)",
    "num_class": "A7 (GBDT breadth: multiclass)",
    "categorical_features": "A7 (GBDT breadth: categorical splits)",
    "monotone_constraints": "A7 (GBDT breadth: monotone constraints)",
    "extra_trees": "A7 (GBDT breadth: extra_trees)",
    "zero_as_missing": "A7 (GBDT breadth: zero_as_missing)",
    "tree_learner": "A8 (multi-device GBDT)",
    "early_stopping_round": "A6 (estimators: validation sets, early stopping)",
}
_DEFAULTS = {fl.name: fl.default for fl in fields(TrainConfig)}


def check_supported(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for any setting outside this slice."""
    for name, later in _LATER.items():
        value = getattr(cfg, name)
        default = _DEFAULTS[name]
        if name == "monotone_constraints":
            off = not any(value or ())
        elif name == "categorical_features":
            off = not tuple(value or ())
        else:
            off = value == default
        if not off:
            raise NotImplementedError(
                f"TrainConfig.{name}={value!r} is not in the port yet "
                f"(ROADMAP {later})")
    obj_mod.get_objective(cfg.objective)  # raises for other objectives
    if cfg.metric is not None and cfg.metric not in metrics_mod.METRICS:
        raise NotImplementedError(
            f"metric {cfg.metric!r} is not in the port yet (ROADMAP A6); "
            f"have {sorted(metrics_mod.METRICS)}")


@dataclass
class TrainResult:
    booster: BoosterArrays
    evals: List[Dict[str, float]] = field(default_factory=list)
    best_iteration: int = -1


# ---------------------------------------------------------------------------
# Tree building (device side)
# ---------------------------------------------------------------------------

def _leaf_objective_impl(g, h, lam1, lam2):
    """L1-regularized leaf value and its score contribution."""
    g_adj = torch.sign(g) * torch.clamp_min(torch.abs(g) - lam1, 0.0)
    denom = h + lam2 + 1e-30
    value = -g_adj / denom
    score = g_adj * g_adj / denom
    return value, score


def _find_numeric_splits(hist, remaining, parent_value, *, b, lam1, lam2,
                         min_child, min_hess, min_gain, path_smooth,
                         max_delta_step):
    """Numeric split finding for one level from the (width, F, B, 3)
    histogram: ordered cumulative scan, first-max best split per node,
    leaf-budget ranking and child values.

    Returns (do_split, best_feat, best_bin, lval, rval, left_stats,
    right_stats, remaining)."""
    width = hist.shape[0]
    dev = hist.device
    cum = torch.cumsum(hist, dim=2)              # left stats per bin
    tot = cum[:, :, -1:, :]
    gl, hl, cl = cum[..., 0], cum[..., 1], cum[..., 2]
    gt, ht, ct = tot[..., 0], tot[..., 1], tot[..., 2]
    gr, hr, cr = gt - gl, ht - hl, ct - cl
    _, score_l = _leaf_objective_impl(gl, hl, lam1, lam2)
    _, score_r = _leaf_objective_impl(gr, hr, lam1, lam2)
    _, score_p = _leaf_objective_impl(gt, ht, lam1, lam2)
    gain = 0.5 * (score_l + score_r - score_p)
    ok = ((cl >= min_child) & (cr >= min_child)
          & (hl >= min_hess) & (hr >= min_hess)
          & (gain > min_gain))
    # last bin can't split (right side empty by construction)
    ok &= torch.arange(b, device=dev)[None, None, :] < b - 1
    gain = torch.where(ok, gain, -torch.inf)

    flat_gain = gain.reshape(width, -1)
    # torch.argmax returns the first maximum (all -inf rows give 0)
    best_fb = torch.argmax(flat_gain, dim=1)
    best_gain = torch.gather(flat_gain, 1, best_fb[:, None])[:, 0]
    best_feat = best_fb // b
    best_bin = best_fb % b

    # leaf budget: within-level gain ranking (stable, as jnp.argsort)
    can_split = torch.isfinite(best_gain)
    order = torch.argsort(-torch.where(can_split, best_gain, -torch.inf),
                          stable=True)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(width, device=dev))
    do_split = can_split & (rank < remaining)
    remaining = remaining - do_split.sum()

    left_mask = torch.arange(b, device=dev)[None, :] <= best_bin[:, None]
    hist_best = hist[torch.arange(width, device=dev), best_feat]  # (width, B, 3)
    left_stats = torch.sum(hist_best * left_mask[..., None], dim=1)
    tot_best = torch.sum(hist_best, dim=1)
    right_stats = tot_best - left_stats
    lval, _ = _leaf_objective_impl(left_stats[:, 0], left_stats[:, 1],
                                   lam1, lam2)
    rval, _ = _leaf_objective_impl(right_stats[:, 0], right_stats[:, 1],
                                   lam1, lam2)
    if path_smooth > 0:
        # shrink child outputs toward the parent's by n/(n+ps)
        wl = left_stats[:, 2] / (left_stats[:, 2] + path_smooth)
        wr = right_stats[:, 2] / (right_stats[:, 2] + path_smooth)
        lval = lval * wl + parent_value * (1.0 - wl)
        rval = rval * wr + parent_value * (1.0 - wr)
    if max_delta_step > 0:
        lval = torch.clamp(lval, -max_delta_step, max_delta_step)
        rval = torch.clamp(rval, -max_delta_step, max_delta_step)
    return (do_split, best_feat, best_bin, lval, rval, left_stats,
            right_stats, remaining)


def build_tree(binned, grad, hess, num_leaves: int, cfg: TrainConfig,
               total_bins: int):
    """One depthwise tree over the (N, F) uint8 ``binned`` matrix with
    (N,) float32 ``grad`` / ``hess``. Returns the full-layout
    (split_feature int32, threshold_bin int32, node_value float32,
    node_count float32) device tensors, each (2^(D+1)-1,)."""
    dev = binned.device
    n, f = binned.shape
    b = total_bins
    depth = cfg.effective_depth
    num_slots = 2 ** (depth + 1) - 1
    lam1, lam2 = cfg.lambda_l1, cfg.lambda_l2
    split_kw = dict(b=b, lam1=lam1, lam2=lam2,
                    min_child=float(cfg.min_data_in_leaf),
                    min_hess=cfg.min_sum_hessian_in_leaf,
                    min_gain=cfg.min_gain_to_split,
                    path_smooth=cfg.path_smooth,
                    max_delta_step=cfg.max_delta_step)

    node = torch.zeros(n, dtype=torch.int64, device=dev)   # full-layout slot
    done = torch.zeros(n, dtype=torch.bool, device=dev)    # settled in a leaf
    split_feature = torch.full((num_slots,), -1, dtype=torch.int32, device=dev)
    threshold_bin = torch.zeros(num_slots, dtype=torch.int32, device=dev)
    node_value = torch.zeros(num_slots, dtype=torch.float32, device=dev)
    node_count = torch.zeros(num_slots, dtype=torch.float32, device=dev)

    valid = torch.ones(n, dtype=torch.float32, device=dev)
    rv, _ = _leaf_objective_impl(torch.sum(grad), torch.sum(hess), lam1, lam2)
    if cfg.max_delta_step > 0:
        rv = torch.clamp(rv, -cfg.max_delta_step, cfg.max_delta_step)
    node_value[0] = rv
    node_count[0] = torch.sum(valid)
    # filled on the device: a host->device copy would sync every tree
    remaining = torch.full((), num_leaves - 1, dtype=torch.int64, device=dev)

    for d in range(depth):
        level_start = 2 ** d - 1
        width = 2 ** d
        kids = 2 * level_start + 1      # first slot of the next level
        local = torch.clamp(node - level_start, 0, width - 1)
        live = (~done).to(torch.float32)
        hist = level_histogram(binned, grad, hess, live, local, width, f, b)
        (do_split, best_feat, best_bin, lval, rval, left_stats, right_stats,
         remaining) = _find_numeric_splits(
            hist, remaining, node_value[level_start:kids], **split_kw)
        split_feature[level_start:kids] = torch.where(
            do_split, best_feat, -1).to(torch.int32)
        threshold_bin[level_start:kids] = torch.where(
            do_split, best_bin, 0).to(torch.int32)
        # children of slot s are 2s+1 / 2s+2: interleaved left/right
        node_value[kids:kids + 2 * width] = torch.where(
            do_split[:, None], torch.stack([lval, rval], dim=1),
            0.0).reshape(-1)
        node_count[kids:kids + 2 * width] = torch.where(
            do_split[:, None],
            torch.stack([left_stats[:, 2], right_stats[:, 2]], dim=1),
            0.0).reshape(-1)
        # --- route rows; rows already done stay where they are ---------
        nfeat = best_feat[local]
        nbin = torch.gather(binned, 1, nfeat[:, None])[:, 0]
        nsplit = do_split[local]
        go_left = nbin.to(torch.int64) <= best_bin[local]
        child = torch.where(go_left, 2 * node + 1, 2 * node + 2)
        newly_done = ~nsplit & ~done
        node = torch.where(done | ~nsplit, node, child)
        done = done | newly_done
    return split_feature, threshold_bin, node_value, node_count


def _predict_tree(sf, tb, nv, binned, depth: int):
    """(N,) leaf values of one full-layout tree on the (N, F) binned
    matrix: ``depth`` gather steps, bins <= threshold go left."""
    n = binned.shape[0]
    sf, tb = sf.long(), tb.long()
    nodev = torch.zeros(n, dtype=torch.int64, device=binned.device)
    for _ in range(depth):
        feat = sf[nodev]
        is_leaf = feat < 0
        fb = torch.gather(binned, 1, torch.clamp_min(feat, 0)[:, None])[:, 0]
        child = torch.where(fb.long() <= tb[nodev], 2 * nodev + 1,
                            2 * nodev + 2)
        nodev = torch.where(is_leaf, nodev, child)
    return nv[nodev]


# ---------------------------------------------------------------------------
# Boosting loop
# ---------------------------------------------------------------------------

def train(binned: np.ndarray, labels: np.ndarray, cfg: TrainConfig,
          weights: Optional[np.ndarray] = None,
          bin_upper: Optional[np.ndarray] = None,
          device: DeviceLike = None) -> TrainResult:
    """Boosting loop. ``binned``: (N, F) bin ids (``BinMapper.transform``
    output, or a uint8 tensor already on the device); ``weights``:
    optional (N,) row weights; ``bin_upper``: (F, B) raw-value bin upper
    edges (``BinMapper.bin_upper_values``), which become the booster's
    raw-value thresholds.

    ``device=None`` runs on the CUDA card (and raises without one);
    ``device="cpu"`` runs the plain PyTorch path."""
    dev = resolve_device(device)
    check_supported(cfg)
    total_bins = cfg.max_bin
    depth = cfg.effective_depth
    num_slots = 2 ** (depth + 1) - 1
    if binned_ingest_dtype(total_bins) != np.uint8:
        raise NotImplementedError(
            f"max_bin={total_bins} needs wider bin ids than uint8; the "
            "level-histogram kernel takes <= 256 bins (ROADMAP A7)")
    n, num_f = binned.shape
    if n and (int(binned.min()) < 0 or int(binned.max()) >= total_bins):
        raise ValueError(f"bin ids must lie in [0, max_bin={total_bins})")

    base_score = (obj_mod.init_score(cfg.objective, labels, weights)
                  if cfg.boost_from_average else 0.0)
    # the binned matrix goes to the device once, at the narrowest dtype
    if isinstance(binned, np.ndarray):
        binned = binned.astype(np.uint8, copy=False)
    binned_d = torch.as_tensor(binned, device=dev).to(torch.uint8).contiguous()
    labels_d = torch.as_tensor(np.asarray(labels, dtype=np.float32),
                               device=dev)
    weights_d = None if weights is None else torch.as_tensor(
        np.asarray(weights, dtype=np.float32), device=dev)

    objective_fn = obj_mod.get_objective(cfg.objective)
    obj_kwargs = {"sigmoid": cfg.sigmoid} if cfg.objective == "binary" else {}
    metric_name = cfg.metric or metrics_mod.default_metric(cfg.objective)
    metric_fn, _ = metrics_mod.METRICS[metric_name]
    nl = cfg.num_leaves if cfg.num_leaves > 0 else 2 ** depth
    lr = torch.tensor(cfg.learning_rate, dtype=torch.float32, device=dev)

    raw = torch.full((n,), base_score, dtype=torch.float32, device=dev)
    trees, metric_vals = [], []
    for _ in range(cfg.num_iterations):
        g, h = objective_fn(raw, labels_d, weights_d, **obj_kwargs)
        sf, tb, nv, cnt = build_tree(binned_d, g, h, nl, cfg, total_bins)
        nv = nv * lr
        raw = raw + _predict_tree(sf, tb, nv, binned_d, depth)
        trees.append((sf, tb, nv, cnt))
        metric_vals.append(metric_fn(raw, labels_d, weights_d))

    # one transfer of every tree and metric, after the last step
    if trees:
        sf_h, tb_h, nv_h, cnt_h = (torch.stack(list(a)).cpu().numpy()
                                   for a in zip(*trees))
        met_h = torch.stack(metric_vals).cpu().numpy()
    else:
        sf_h = np.full((0, num_slots), -1, np.int32)
        tb_h = np.zeros((0, num_slots), np.int32)
        nv_h = np.zeros((0, num_slots), np.float32)
        cnt_h = np.zeros((0, num_slots), np.float32)
        met_h = np.zeros(0, np.float32)
    evals = [{"iteration": j, f"train_{metric_name}": float(met_h[j])}
             for j in range(len(met_h))]
    booster = _assemble_booster(sf_h, tb_h, nv_h, cnt_h, cfg, num_f,
                                total_bins, depth, bin_upper, base_score)
    return TrainResult(booster=booster, evals=evals, best_iteration=-1)


def _assemble_booster(sf_all, tb_all, nv_all, cnt_all, cfg, num_f,
                      total_bins, depth, bin_upper, base_score):
    """Pack the (T, M) host arrays into a numeric ``BoosterArrays`` with
    raw-value thresholds from ``bin_upper``."""
    if bin_upper is None:
        bin_upper = np.full((num_f, total_bins), np.inf)
    thr_val = np.where(sf_all >= 0,
                       bin_upper[np.maximum(sf_all, 0), tb_all], np.inf)
    return BoosterArrays(
        split_feature=sf_all,
        threshold_bin=tb_all,
        threshold_value=thr_val,
        node_value=nv_all,
        count=cnt_all,
        tree_weights=np.ones(sf_all.shape[0], dtype=np.float32),
        max_depth=depth,
        num_features=num_f,
        num_class=1,
        objective=cfg.objective,
        init_score=base_score,
    )
