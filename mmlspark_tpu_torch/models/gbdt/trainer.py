"""Histogram-GBDT training on PyTorch — the port of the JAX trainer's
numeric fast path.

What this slice runs (and the JAX trainer it mirrors, file
``mmlspark_tpu/models/gbdt/trainer.py``):

  - ``TrainConfig`` with ``effective_depth``;
  - per level, the histogram (``hist_cuda.level_histogram``, or
    ``level_histogram_quant`` on the quantized plane: the CUDA kernels
    on the card, their plain versions on the CPU), numeric split
    finding (``_find_numeric_splits``) and row routing — the
    ``simple_numeric`` branch of ``make_build_tree``;
  - the quantized-gradient plane (``MMLSPARK_TORCH_HIST_QUANT=q16|q8``,
    ``resolve_hist_quant``): per-round power-of-two scales, int16/int8
    grad/hess, integer histograms, and root stats from the level-0
    histogram totals. Integer sums make the fit reproducible run to run
    on the card, as the float32 plane's fixed-point sums do;
  - histogram subtraction (``MMLSPARK_TORCH_HIST_SUB=1``,
    ``resolve_subtract``): below the root only each split's smaller
    child is histogrammed, by masking its sibling's rows out of
    ``live`` (the kernels skip masked rows), and the sibling is
    ``parent - smaller`` (``_derive_sibling_hist``);
  - the gbdt boosting step: objective grad/hess, one tree, shrinkage,
    raw-score update through ``_predict_tree``, the training metric;
  - ``train``: serial, in-core, no validation sets, and
    ``_assemble_booster``.

Trees grow level-wise over ``effective_depth`` levels in the full-tree
layout (node i's children are 2i+1 / 2i+2), with the ``num_leaves``
budget applied by within-level gain rank, as in the JAX package.

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

from mmlspark_tpu_torch.core import env
from mmlspark_tpu_torch.core.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.models.gbdt import metrics as metrics_mod
from mmlspark_tpu_torch.models.gbdt import objectives as obj_mod
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
from mmlspark_tpu_torch.models.gbdt.hist_cuda import (
    level_histogram,
    level_histogram_quant,
)
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
    # what ran: {"hist_quant": "off"|"q16"|"q8", "subtract": bool}
    hist_stats: Dict[str, object] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Histogram policies (port knobs, read once per fit)
# ---------------------------------------------------------------------------

HIST_QUANT_ENV = "MMLSPARK_TORCH_HIST_QUANT"
HIST_SUB_ENV = "MMLSPARK_TORCH_HIST_SUB"
_VALID_QUANT = ("off", "q16", "q8")


def resolve_hist_quant() -> str:
    """Gradient/hessian quantization policy (``MMLSPARK_TORCH_HIST_QUANT``,
    default off): per-round grad/hess rounded to int16 (q16) or int8
    (q8) under a shared power-of-two scale, summed exactly in integers
    and dequantized once. A mistyped value warns once and runs
    unquantized, as the JAX package's ``resolve_hist_quant`` does."""
    raw = (env.env_str(HIST_QUANT_ENV, "") or "").strip().lower()
    if not raw:
        return "off"
    if raw not in _VALID_QUANT:
        env.warn_once(HIST_QUANT_ENV, f"{HIST_QUANT_ENV}={raw!r} is not one "
                                      "of off|q16|q8; histograms run "
                                      "unquantized")
        return "off"
    return raw


def resolve_subtract() -> bool:
    """Histogram subtraction (``MMLSPARK_TORCH_HIST_SUB=1``/``0``, default
    off, as the JAX package's default is off on its TPU path). A
    malformed value warns once and leaves it off."""
    return env.env_flag(HIST_SUB_ENV, False)


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


_INV_LN2 = float(np.float32(1.0) / np.float32(math.log(2.0)))


def _pow2_scale(amax, qmax: float):
    """Power-of-two quantization scale pair (scale, scale_inv), 0-d
    float32 tensors, mapping |x| <= amax into [-qmax, qmax]. The
    exponent is the JAX package's (``trainer._pow2_scale``):
    ``floor(log(qmax/amax) * (1/ln 2))`` in float32, clipped to
    [-126, 126] — the product form is how XLA evaluates ``jnp.log2``.
    The scales are built from their exponent bits, so they are exact
    powers of two on every device and ``int * scale_inv`` is exact."""
    amax = torch.clamp_min(amax.float(), 1e-30)
    ratio = torch.full_like(amax, qmax) / amax
    e = torch.clamp(torch.floor(torch.log(ratio) * _INV_LN2), -126.0, 126.0)
    e = e.to(torch.int32)
    return (((e + 127) << 23).view(torch.float32),
            ((127 - e) << 23).view(torch.float32))


def _derive_sibling_hist(hist_small, prev_hist, prev_split, prev_ss):
    """Histogram-subtraction sibling derivation for one level
    (``trainer._derive_sibling_hist``). ``hist_small`` (width, F, B, 3)
    holds real histograms only on each split's smaller child; the larger
    sibling is parent - smaller, and slots under non-split parents are
    zeroed. Float cancellation can leave tiny negative counts or
    hessians on the derived side: both are clamped at 0."""
    width = hist_small.shape[0]
    kids = torch.arange(width, device=hist_small.device)
    par_idx = kids // 2
    is_small = (kids % 2) == prev_ss[par_idx]
    sib = hist_small[kids ^ 1]
    parent_h = prev_hist[par_idx]
    hist = torch.where(
        is_small[:, None, None, None], hist_small,
        torch.where(prev_split[par_idx][:, None, None, None],
                    parent_h - sib, 0.0))
    hist[..., 1:].clamp_(min=0.0)
    return hist


def _smooth(value, w, parent):
    """Path smoothing, ``value * w + parent * (1 - w)``, rounded as the
    fused multiply-add ``fma(parent, 1 - w, value * w)`` that XLA makes
    of the JAX package's expression. The float64 product is exact and
    the float64 sum rounds far below a float32 ulp, so the one float32
    rounding is the fused op's (barring a sum exactly on a midpoint)."""
    return (parent.double() * (1.0 - w).double()
            + (value * w).double()).float()


def _find_numeric_splits(hist, remaining, parent_value, *, b, lam1, lam2,
                         min_child, min_hess, min_gain, path_smooth,
                         max_delta_step):
    """Numeric split finding for one level from the (width, F, B, 3)
    histogram: ordered cumulative scan, first-max best split per node,
    leaf-budget ranking and child values.

    Returns (do_split, best_feat, best_bin, lval, rval, left_stats,
    right_stats, remaining, smaller_side); ``smaller_side`` is 0 where
    the left child holds no more rows than the right, else 1."""
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
        lval = _smooth(lval, wl, parent_value)
        rval = _smooth(rval, wr, parent_value)
    if max_delta_step > 0:
        lval = torch.clamp(lval, -max_delta_step, max_delta_step)
        rval = torch.clamp(rval, -max_delta_step, max_delta_step)
    smaller_side = torch.where(left_stats[:, 2] <= right_stats[:, 2], 0, 1)
    return (do_split, best_feat, best_bin, lval, rval, left_stats,
            right_stats, remaining, smaller_side)


def build_tree(binned, grad, hess, num_leaves: int, cfg: TrainConfig,
               total_bins: int, hist_quant: str = "off",
               subtract: bool = False):
    """One depthwise tree over the (N, F) uint8 ``binned`` matrix with
    (N,) float32 ``grad`` / ``hess``. ``hist_quant`` (off|q16|q8) picks
    the histogram plane and ``subtract`` the sibling trick (see the
    module note). Returns the full-layout (split_feature int32,
    threshold_bin int32, node_value float32, node_count float32) device
    tensors, each (2^(D+1)-1,)."""
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
    if hist_quant != "off":
        # per-round shared pow2 scales; rows outside `valid` quantize to 0
        qdt = torch.int8 if hist_quant == "q8" else torch.int16
        qmax = 120.0 if hist_quant == "q8" else 32000.0
        gscale, gscale_inv = _pow2_scale(torch.max(torch.abs(grad) * valid),
                                         qmax)
        hscale, hscale_inv = _pow2_scale(torch.max(torch.abs(hess) * valid),
                                         qmax)
        # torch.round rounds half to even, as jnp.rint
        grad_q = torch.round(grad * valid * gscale).to(qdt)
        hess_q = torch.round(hess * valid * hscale).to(qdt)
    else:
        rv, _ = _leaf_objective_impl(torch.sum(grad), torch.sum(hess), lam1,
                                     lam2)
        if cfg.max_delta_step > 0:
            rv = torch.clamp(rv, -cfg.max_delta_step, cfg.max_delta_step)
        node_value[0] = rv
        node_count[0] = torch.sum(valid)
    # filled on the device: a host->device copy would sync every tree
    remaining = torch.full((), num_leaves - 1, dtype=torch.int64, device=dev)
    prev_hist = prev_split = prev_ss = None

    def hist_of(live, local, width):
        if hist_quant != "off":
            return level_histogram_quant(binned, grad_q, hess_q, live, local,
                                         width, f, b, gscale_inv, hscale_inv)
        return level_histogram(binned, grad, hess, live, local, width, f, b)

    for d in range(depth):
        level_start = 2 ** d - 1
        width = 2 ** d
        kids = 2 * level_start + 1      # first slot of the next level
        local = torch.clamp(node - level_start, 0, width - 1)
        live = (~done).to(torch.float32)
        if subtract and d > 0:
            # the smaller child of each split only, by masking its
            # sibling's rows out of live: masked rows fall in no tile of
            # the kernels. live stays binary, so the cover stat that
            # picked the smaller side counts its rows.
            sel = (live > 0) & ((local % 2) == prev_ss[local // 2])
            hist = _derive_sibling_hist(
                hist_of(live * sel.to(live.dtype), local, width), prev_hist,
                prev_split, prev_ss)
        else:
            hist = hist_of(live, local, width)
        if hist_quant != "off" and d == 0:
            # quantized-plane root stats from the level-0 histogram (any
            # one feature's bins partition the live rows), recorded before
            # split finding so path smoothing sees the root value
            tot0 = torch.sum(hist[0, 0], dim=0)
            rv0, _ = _leaf_objective_impl(tot0[0], tot0[1], lam1, lam2)
            if cfg.max_delta_step > 0:
                rv0 = torch.clamp(rv0, -cfg.max_delta_step,
                                  cfg.max_delta_step)
            node_value[0] = rv0
            node_count[0] = tot0[2]
        (do_split, best_feat, best_bin, lval, rval, left_stats, right_stats,
         remaining, small_side) = _find_numeric_splits(
            hist, remaining, node_value[level_start:kids], **split_kw)
        if subtract:
            prev_hist, prev_split, prev_ss = hist, do_split, small_side
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
    ``device="cpu"`` runs the plain PyTorch path. The histogram plane
    and subtraction follow ``MMLSPARK_TORCH_HIST_QUANT`` /
    ``MMLSPARK_TORCH_HIST_SUB``, read once here; ``hist_stats`` records
    what ran."""
    dev = resolve_device(device)
    check_supported(cfg)
    hist_quant = resolve_hist_quant()
    subtract = resolve_subtract()
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
        sf, tb, nv, cnt = build_tree(binned_d, g, h, nl, cfg, total_bins,
                                     hist_quant, subtract)
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
    return TrainResult(booster=booster, evals=evals, best_iteration=-1,
                       hist_stats={"hist_quant": hist_quant,
                                   "subtract": subtract})


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
