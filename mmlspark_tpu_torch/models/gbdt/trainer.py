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
  - bin ids: uint8 up to 256 bins, uint16 up to 65,536, int32 past
    that (``max_bin``; ``binned_ingest_dtype``), each through its own
    instance of both histogram kernels, the routing and the trees'
    scoring;
  - exclusive feature bundling (``ops/efb.py``, ``MMLSPARK_TORCH_EFB``):
    planned where the reference plans it (no categorical features), the
    bundled matrix beside the original; histograms read the bundled one
    and are unbundled (``_unbundle_hist``) before split finding, so the
    trees name original features;
  - the general branch of ``make_build_tree`` (``_find_general_splits``)
    for categorical features, monotone constraints (the "basic" method:
    splits whose child values go against a constrained feature's
    direction are refused, child values are clamped into their parent's
    bounds and a constrained split's children meet at the midpoint),
    ``extra_trees`` (one random candidate bin per node and feature) and
    ``feature_fraction_by_node`` (a feature subset per node, drawn from
    the tree's);
  - categorical features (``categorical_features``): the categorical
    branch of ``make_build_tree`` (``_find_general_splits``: the
    bins sorted by grad / (hess + cat_smooth), a prefix scan under
    ``lambda_l2 + cat_l2`` and ``max_cat_threshold``, one-vs-rest where a
    node uses at most ``max_cat_to_onehot`` categories), each split's
    left bins as a (slots, B) mask that routes the rows, and the
    decision bits (1 categorical, 10 numeric, 6 under
    ``zero_as_missing``); ``_assemble_booster`` turns the masks into
    bitsets over the raw category values. ``zero_as_missing`` itself is
    the estimator's premap (0.0 -> NaN before binning) and the stamp 6
    on every split;
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
  - the boosting step of gbdt, goss and rf (``step.py``): the sampling
    masks (``sampling.py``: bagging, pos/neg bagging,
    ``feature_fraction``, GOSS, rf's bag), objective grad/hess, one tree
    per class under the masks (K = ``num_class`` for the multiclass
    objectives, else 1), shrinkage, raw-score updates through
    ``_predict_tree`` (training rows and each validation set), the
    metrics (``_resolve_metrics``, one ``ndcg@p`` per ``eval_at``
    position); on the card one captured CUDA graph replayed per
    iteration;
  - lambdarank over query groups (``group_ids``): the groups' padded
    layout built once per fit on the host
    (``objectives.make_group_layout``), for the lambdas and for each
    set's ``ndcg``;
  - out-of-core training (``MMLSPARK_TORCH_OOC``, ``resolve_ooc`` /
    ``_ooc_supported``; ``ooc.py``): a supported fit whose in-core fit
    would not fit in the card's free memory streams from a spill
    directory in row chunks, its trees bitwise the in-core quantized
    fit's;
  - ``train``: serial, with validation sets, early stopping
    (``_train_scan``'s stop rule, metrics synced in blocks), warm starts
    (``init_model`` / ``init_raw``, ``warm_start_scores``), custom
    objectives (``custom_objective``), resumed segments
    (``iteration_offset``), the ``gbdt.train_step`` fault point once per
    iteration, and ``_assemble_booster`` (rf's and DART's tree weights,
    the trees cut after the best iteration, the warm-start ``concat``);
  - DART (``boosting_type="dart"``) and leaf-wise growth
    (``MMLSPARK_TORCH_GROW_POLICY=leafwise``, ``resolve_grow_policy``;
    ``leafwise.py``) through the eager host loop (``host_loop.py``);
  - multi-device fits over ``torch.distributed`` (``train(...,
    mesh=...)``; ``resolve_mode``, ``parallel_modes.py``): the data,
    data_sharded (``MMLSPARK_TORCH_HIST_SHARD``), voting and feature
    learners, each the serial fit bit for bit; without a mesh voting and
    feature train serially, as in the reference.

The reference has two loops: ``_train_scan`` (one fused step per
iteration) and the eager ``_train_loop`` that custom objectives, DART
and leaf-wise fits take. The port's ``train`` runs DART and leaf-wise
fits through its host loop, the counterpart of ``_train_loop``, and
every other fit through one step: a named objective's step is captured
on the card, a custom objective's runs uncaptured (its ``fobj`` may sync
with the host) with the same masks.

Trees grow level-wise over ``effective_depth`` levels in the full-tree
layout (node i's children are 2i+1 / 2i+2), with the ``num_leaves``
budget applied by within-level gain rank, as in the JAX package.

The boosting loop reads no device value on the host, except where early
stopping needs the metrics: then it syncs them in blocks of
``max(early_stopping_round, 8)`` iterations, as the JAX package does.
Trees and metrics stay on the device and come back in one transfer at
the end.
Every ``TrainConfig`` setting outside this slice raises
``NotImplementedError`` naming the ROADMAP item that will add it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from mmlspark_tpu_torch.core import env, sanitizer
from mmlspark_tpu_torch.core.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.core.faults import fault_point
from mmlspark_tpu_torch.core.logging_utils import warn_once
from mmlspark_tpu_torch.core.timer import InstrumentationMeasures
from mmlspark_tpu_torch.models.gbdt import metrics as metrics_mod
from mmlspark_tpu_torch.models.gbdt import objectives as obj_mod
from mmlspark_tpu_torch.models.gbdt import sampling
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays
from mmlspark_tpu_torch.models.gbdt.hist_cuda import (
    bin_ids,
    level_histogram,
    level_histogram_quant,
)
from mmlspark_tpu_torch.ops import efb as efb_mod
from mmlspark_tpu_torch.ops.ingest import binned_ingest_dtype
from mmlspark_tpu_torch.parallel import resilience


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

    def __post_init__(self):
        # the config keys the captured-step cache: every field hashable
        cat = self.categorical_features
        if isinstance(cat, (int, np.integer)):
            cat = (cat,)
        if cat is not None and not isinstance(cat, tuple):
            object.__setattr__(self, "categorical_features",
                               tuple(int(i) for i in cat))
        elif isinstance(cat, tuple):
            object.__setattr__(self, "categorical_features", cat)
        mono = self.monotone_constraints
        if isinstance(mono, (int, np.integer)):
            object.__setattr__(self, "monotone_constraints", (int(mono),))
        elif isinstance(mono, (list, np.ndarray)):
            object.__setattr__(self, "monotone_constraints",
                               tuple(int(i) for i in mono))
        # as the JAX package's: eval_at stays scalar-or-tuple, label_gain
        # becomes a tuple of floats
        if isinstance(self.eval_at, list):
            object.__setattr__(self, "eval_at", tuple(self.eval_at))
        if isinstance(self.label_gain, (int, float)):
            object.__setattr__(self, "label_gain",
                               (float(self.label_gain),))
        elif isinstance(self.label_gain, (list, np.ndarray)):
            object.__setattr__(self, "label_gain",
                               tuple(float(g) for g in self.label_gain))

    @property
    def num_trees_per_iteration(self) -> int:
        """K: ``num_class`` for the multiclass objectives, else 1."""
        return (self.num_class if self.objective in obj_mod.MULTICLASS_NAMES
                else 1)

    @property
    def has_categorical(self) -> bool:
        return bool(self.categorical_features)

    @property
    def has_monotone(self) -> bool:
        return bool(np.any(self.monotone_constraints))

    @property
    def draws_per_node(self) -> bool:
        """Whether trees draw per level: ``extra_trees``' candidate bins
        or ``feature_fraction_by_node``'s node features."""
        return self.extra_trees or self.feature_fraction_by_node < 1.0

    @property
    def general_split(self) -> bool:
        """Whether split finding takes the reference's general branch
        (``make_build_tree``'s ``simple_numeric`` is its negation)."""
        return (self.has_categorical or self.has_monotone
                or self.draws_per_node)

    @property
    def effective_depth(self) -> int:
        # enough depth for num_leaves leaves, capped by max_depth if set
        need = max(1, math.ceil(math.log2(max(self.num_leaves, 2))))
        if self.max_depth and self.max_depth > 0:
            return min(need, self.max_depth) if self.num_leaves > 0 else self.max_depth
        return need


BOOSTING_TYPES = ("gbdt", "rf", "dart", "goss")


def check_supported(cfg: TrainConfig) -> None:
    """Raise ``NotImplementedError`` for any setting outside this slice,
    ``ValueError`` for a boosting type LightGBM does not have."""
    if cfg.boosting_type not in BOOSTING_TYPES:
        raise ValueError(f"boosting_type={cfg.boosting_type!r} is not one "
                         f"of {BOOSTING_TYPES}")
    if (cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0) \
            and cfg.objective != "binary":
        raise ValueError(
            "pos/neg_bagging_fraction applies to the binary objective "
            "only (LightGBM semantics); got objective="
            f"{cfg.objective!r}")
    obj_mod.get_objective(cfg.objective)  # raises for other objectives
    _resolve_metrics(cfg)                 # raises for other metrics


def _resolve_metrics(cfg: TrainConfig, label_gain=None):
    """(metric_name, [(label, fn)], higher_better, metric_kwargs), as the
    JAX package's ``_resolve_metrics``: ``ndcg`` is one ``ndcg@p`` per
    ``eval_at`` position under ``label_gain`` (the step's device tensor
    of the gains), else ``cfg.label_gain``; an unknown name raises
    ``NotImplementedError`` (where the reference raises ``KeyError``: the
    port has every name the reference has)."""
    metric_name = cfg.metric or metrics_mod.default_metric(cfg.objective)
    if metric_name == "ndcg":
        positions = (cfg.eval_at if isinstance(cfg.eval_at, (list, tuple))
                     else [cfg.eval_at])
        lg = (label_gain if label_gain is not None
              else tuple(cfg.label_gain or ()) or None)
        return metric_name, [(f"ndcg@{p}", metrics_mod.ndcg_at(
            int(p), label_gain=lg)) for p in positions], True, {}
    if metric_name not in metrics_mod.METRICS:
        raise NotImplementedError(
            f"metric {metric_name!r} is not a metric of the port or of the "
            f"reference; have {sorted(metrics_mod.METRICS)}")
    metric_fn, higher_better = metrics_mod.METRICS[metric_name]
    # quantile's pinball alpha is the training alpha
    metric_kwargs = {"alpha": cfg.alpha} if metric_name == "quantile" else {}
    return metric_name, [(metric_name, metric_fn)], higher_better, \
        metric_kwargs


def _objective_kwargs(cfg: TrainConfig) -> Dict[str, Any]:
    """The named objective's settings from the config (the JAX
    package's ``_objective_kwargs``, for the objectives the port has)."""
    name = cfg.objective
    if name == "binary":
        return {"sigmoid": cfg.sigmoid}
    if name in obj_mod.MULTICLASS_NAMES:
        return {"num_class": cfg.num_class}
    if name == "lambdarank":
        kw: Dict[str, Any] = {
            "sigmoid": cfg.sigmoid,
            "truncation_level": cfg.lambdarank_truncation_level}
        if cfg.label_gain:
            kw["label_gain"] = tuple(cfg.label_gain)
        return kw
    if name in ("huber", "quantile"):
        return {"alpha": cfg.alpha}
    if name == "fair":
        return {"fair_c": cfg.fair_c}
    if name == "tweedie":
        return {"tweedie_variance_power": cfg.tweedie_variance_power}
    if name == "poisson":
        return {"max_delta_step": cfg.poisson_max_delta_step}
    return {}


def _custom_grad_hess(fn, raw, labels, weights):
    """Call a custom objective with the fit's device tensors (float32
    ``raw`` and ``labels``, ``weights`` or None) and bring its (grad,
    hess) back to that device as float32 tensors of ``raw``'s shape,
    (N,) or (N, K) for a multiclass fit, as the reference's
    ``_train_loop`` passes them; tensors and array-likes are both taken,
    other shapes raise."""
    out = fn(raw, labels, weights)
    if not isinstance(out, (tuple, list)) or len(out) != 2:
        raise ValueError("a custom objective must return (grad, hess); "
                         f"got {type(out).__name__}")
    res = []
    for what, v in zip(("grad", "hess"), out):
        v = (v.to(device=raw.device, dtype=torch.float32)
             if isinstance(v, torch.Tensor) else
             torch.as_tensor(np.asarray(v, dtype=np.float32),
                             device=raw.device))
        if tuple(v.shape) != tuple(raw.shape):
            raise ValueError(f"custom objective {what} has shape "
                             f"{tuple(v.shape)}; expected "
                             f"{tuple(raw.shape)}")
        res.append(v)
    return res[0], res[1]


@dataclass
class TrainResult:
    booster: BoosterArrays
    evals: List[Dict[str, float]] = field(default_factory=list)
    best_iteration: int = -1
    # what ran: {"ooc": bool (streamed out of core), "ooc_reason": why an
    # in-core fit did not stream (None where it streamed), "grow_policy":
    # "depthwise"|"leafwise", "hist_quant": "off"|"q16"|"q8", "subtract":
    # bool, "efb_bundles": bundles of the EFB plan (0: none),
    # "efb_bundled_features": the features in them}; a streamed fit's
    # keys are ``ooc.train_ooc``'s
    hist_stats: Dict[str, object] = field(default_factory=dict)
    # the step: {"captured": bool (replayed as a CUDA graph), "capture_s":
    # the seconds this fit spent capturing, None where it made none; for
    # a host-loop fit "host_loop": ``host_loop.HostLoop.stats``}
    step_stats: Dict[str, object] = field(default_factory=dict)


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


_VALID_SHARD = ("auto", "off", "on")


def resolve_hist_shard() -> str:
    """Raw ``MMLSPARK_TORCH_HIST_SHARD`` value (auto|off|on, default auto;
    the JAX package's ``resolve_hist_shard``): ``auto`` reduce-scatters a
    data-parallel fit's histogram sums exactly where the fit runs over
    dp > 1 and :func:`_hist_shard_supported` allows the config; ``on``
    forces it, with one warning where the config cannot honor it;
    ``off`` all-reduces them whole. A bad value warns once and runs
    auto."""
    raw = (env.env_str(env.HIST_SHARD, "") or "").strip().lower()
    if not raw:
        return "auto"
    if raw not in _VALID_SHARD:
        env.warn_once(env.HIST_SHARD, f"{env.HIST_SHARD}={raw!r} is not one "
                                      "of auto|off|on; using auto")
        return "auto"
    return raw


def _hist_shard_supported(cfg: TrainConfig, mesh) -> Optional[str]:
    """None where the reduce-scatter learner (``data_sharded``) can honor
    this config bit for bit as the full all-reduce does, else the reason
    the fit stays on the full all-reduce (the reference's words)."""
    if mesh is None:
        return "no device mesh is attached"
    if cfg.tree_learner in ("voting", "feature"):
        return f"tree_learner={cfg.tree_learner!r}"
    from mmlspark_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
    if axis_size(mesh, DATA_AXIS) < 2:
        return "dp axis size is 1"
    if cfg.categorical_features:
        return "categorical_features"
    if any(cfg.monotone_constraints or ()):
        return "monotone_constraints"
    if cfg.extra_trees:
        return "extra_trees"
    if cfg.feature_fraction_by_node < 1.0:
        return "feature_fraction_by_node"
    return None


def resolve_hist_shard_mode(cfg: TrainConfig, mesh,
                            warn: bool = True) -> Tuple[str, Optional[str]]:
    """(mode, reason): ``("on", None)`` runs the reduce-scatter learner,
    ``("off", reason or None)`` the full all-reduce. A forced ``on`` that
    the config cannot honor warns once; ``auto`` resolves to off for
    such fits silently."""
    raw = resolve_hist_shard()
    if raw == "off":
        return "off", None
    reason = _hist_shard_supported(cfg, mesh)
    if reason is None:
        return "on", None
    if raw == "on" and warn:
        env.warn_once(
            f"{env.HIST_SHARD}:downgrade",
            f"{env.HIST_SHARD}=on cannot shard the histogram reduction for "
            f"this fit ({reason}); running the full all-reduce — label A/B "
            "measurements accordingly")
    return "off", reason


def resolve_mode(cfg: TrainConfig, mesh) -> str:
    """The fit's tree learner (the reference's ``_resolve_mode``):
    ``serial`` without a mesh (voting and feature included, as there);
    under one ``voting`` / ``feature`` as ``tree_learner`` asks, else
    ``data_sharded`` where :func:`resolve_hist_shard_mode` turns it on,
    else ``data`` (``parallel_modes.py``)."""
    if mesh is None:
        return "serial"
    if cfg.tree_learner in ("voting", "feature"):
        return cfg.tree_learner
    if resolve_hist_shard_mode(cfg, mesh, warn=False)[0] == "on":
        return "data_sharded"
    return "data"


GROW_POLICY_ENV = "MMLSPARK_TORCH_GROW_POLICY"
_VALID_GROW = ("depthwise", "leafwise")


def resolve_grow_policy() -> str:
    """Tree growth policy (``MMLSPARK_TORCH_GROW_POLICY``, default
    depthwise): ``leafwise`` grows each tree by a max-gain priority queue
    capped by ``num_leaves`` (LightGBM's native policy, ``leafwise.py``)
    over width-1 calls of the level-histogram kernel with sibling
    subtraction; ``depthwise`` is the level-wise builder with the
    within-level leaf budget. A bad value warns once and grows depthwise,
    as the JAX package's ``resolve_grow_policy``."""
    raw = (env.env_str(GROW_POLICY_ENV, "") or "").strip().lower()
    if not raw:
        return "depthwise"
    if raw not in _VALID_GROW:
        env.warn_once(GROW_POLICY_ENV, f"{GROW_POLICY_ENV}={raw!r} is not "
                                       "one of depthwise|leafwise; growing "
                                       "depthwise")
        return "depthwise"
    return raw


def _leafwise_supported(cfg: TrainConfig, mesh=None) -> Optional[str]:
    """None when leaf-wise growth can honor this config, else the reason
    for the depthwise fallback (the JAX package's
    ``_leafwise_supported``)."""
    if mesh is not None:
        return "a device mesh is attached (leafwise is single-program)"
    if cfg.tree_learner in ("voting", "feature"):
        return f"tree_learner={cfg.tree_learner!r}"
    if cfg.categorical_features:
        return "categorical_features"
    if any(cfg.monotone_constraints or ()):
        return "monotone_constraints"
    if cfg.extra_trees:
        return "extra_trees"
    if cfg.feature_fraction_by_node < 1.0:
        return "feature_fraction_by_node"
    return None


def grow_policy_of(cfg: TrainConfig, mesh=None) -> str:
    """The fit's growth policy: ``resolve_grow_policy``, downgraded to
    depthwise where leaf-wise cannot honor the config (or under a mesh),
    with one warning per process in the reference's words."""
    policy = resolve_grow_policy()
    if policy == "leafwise":
        reason = _leafwise_supported(cfg, mesh)
        if reason is not None:
            env.warn_once(
                f"{GROW_POLICY_ENV}:downgrade",
                f"{GROW_POLICY_ENV}=leafwise does not support {reason}; "
                "growing depthwise — label A/B measurements accordingly")
            policy = "depthwise"
    return policy


_VALID_OOC = ("auto", "off", "on")


def resolve_ooc() -> str:
    """Out-of-core training policy (``MMLSPARK_TORCH_OOC``, default auto;
    the JAX package's ``resolve_ooc``): ``auto`` streams a supported fit
    through the spill plane (``ooc.train_from_binned``) when its in-core
    fit would not fit in the card's free memory (``fits_in_core``);
    ``on`` streams every supported fit (an unsupported one warns once
    and stays in-core); ``off`` never streams. A bad value warns once
    and runs auto."""
    raw = (env.env_str(env.OOC, "") or "").strip().lower()
    if not raw:
        return "auto"
    if raw not in _VALID_OOC:
        env.warn_once(env.OOC, f"{env.OOC}={raw!r} is not one of "
                               "auto|off|on; using auto")
        return "auto"
    return raw


# rows per spill chunk of a streamed ``train`` fit (the reference's
# default; the tests lower it)
OOC_CHUNK_ROWS = 262_144
# device bytes an in-core fit holds per row beside its two copies of the
# bin ids (the upload and the step's own buffer): labels, raw scores,
# grad/hess and their quanta, node ids, the histogram kernels' row
# stats and partition order, the step's temporaries. chip_smoke.py's
# ooc_path holds it above the measured peak of the 4M x 28 in-core fits
IN_CORE_ROW_BYTES = 160
# device bytes an in-core fit holds per (node, feature, bin) cell of its
# widest level beside the rows: the float32 histogram (12) and the
# kernel's int64 sums (24), the parent's histogram kept for subtraction,
# the split scan's float32 temporaries over (width, F, B). Negligible at
# 255 bins, gigabytes past 65,536; chip_smoke.py's int32_path holds it
# above the measured peak of the 2M x 28 fits at B = 131,072 (about 62
# bytes a cell on the H100)
HIST_CELL_BYTES = 80


def in_core_bytes(n: int, f: int, total_bins: int, width: int = 1) -> int:
    """The device bytes an in-core fit of ``n`` rows of ``f`` features
    holds at its peak, its widest level ``width`` nodes wide (an
    estimate: ``IN_CORE_ROW_BYTES`` per row, ``HIST_CELL_BYTES`` per
    histogram cell)."""
    itemsize = np.dtype(binned_ingest_dtype(total_bins)).itemsize
    return (n * (2 * f * itemsize + IN_CORE_ROW_BYTES)
            + width * f * total_bins * HIST_CELL_BYTES)


def device_free_bytes(dev: torch.device) -> Optional[int]:
    """The bytes a fit could still allocate on ``dev``: the card's free
    memory and the segments PyTorch's caching allocator holds wholly
    unused in its default pool (it hands those back to the driver before
    it fails an allocation; a captured graph's private pool serves no
    other allocation). None on the CPU, where the caller's matrix is
    already in host memory."""
    if dev.type != "cuda":
        return None
    free, _ = torch.cuda.mem_get_info(dev)
    index = dev.index if dev.index is not None else \
        torch.cuda.current_device()
    segments = torch.cuda.memory_snapshot()
    return free + sum(s["total_size"] for s in segments
                      if s["device"] == index and s["allocated_size"] == 0
                      and tuple(s["segment_pool_id"]) == (0, 0))


def fits_in_core(n: int, f: int, total_bins: int, dev: torch.device,
                 width: int = 1) -> bool:
    """Whether ``auto`` keeps a fit in-core: its estimated peak
    (``in_core_bytes``) fits in ``device_free_bytes``. The reference
    streams from a row count instead (``MMLSPARK_TPU_OOC_ROWS``, 4M),
    its TPU's memory in rows (ROADMAP C25)."""
    free = device_free_bytes(dev)
    return free is None or in_core_bytes(n, f, total_bins, width) <= free


def _ooc_supported(cfg: TrainConfig, k: int = 1, has_valid: bool = False,
                   has_custom: bool = False,
                   has_groups: bool = False, mesh=None) -> Optional[str]:
    """None where the chunked loop (``ooc.py``) reproduces this fit
    exactly, else the reason it stays in-core, in the JAX package's words
    (``_ooc_supported``): the serial depthwise numeric plane, whose
    integer histograms merge exactly across row chunks. Anything that
    samples rows or features per iteration, needs full-N state
    (validation scoring, lambdarank groups) or runs another builder stays
    in-core. The reference's clause that the native histogram
    formulation be available has no counterpart: the port's quantized
    kernel always sums integers exactly (ROADMAP C24)."""
    if mesh is not None:
        return "a device mesh is attached (out-of-core is single-program)"
    if grow_policy_of(cfg) == "leafwise":
        return "leafwise growth"
    if cfg.tree_learner in ("voting", "feature"):
        return f"tree_learner={cfg.tree_learner!r}"
    if cfg.boosting_type != "gbdt":
        return f"boosting_type={cfg.boosting_type!r}"
    if has_custom:
        return "a custom objective"
    if k > 1:
        return "multiclass objectives"
    if cfg.objective == "lambdarank" or has_groups:
        return "lambdarank / grouped fits"
    if has_valid or cfg.early_stopping_round > 0:
        return "validation sets / early stopping"
    if cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0:
        return "bagging"
    if cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0:
        return "pos/neg bagging"
    if cfg.feature_fraction < 1.0 or cfg.feature_fraction_by_node < 1.0:
        return "feature sampling"
    if cfg.extra_trees:
        return "extra_trees"
    if cfg.categorical_features:
        return "categorical_features"
    if any(cfg.monotone_constraints or ()):
        return "monotone_constraints"
    return None


# ---------------------------------------------------------------------------
# Tree building (device side)
# ---------------------------------------------------------------------------

def _leaf_objective_impl(g, h, lam1, lam2, extra_l2=None):
    """L1-regularized leaf value and its score contribution;
    ``extra_l2`` (categorical splits' ``cat_l2``) adds to ``lam2`` in
    the reference's order, ``h + lam2 + extra_l2 + 1e-30``."""
    g_adj = torch.sign(g) * torch.clamp_min(torch.abs(g) - lam1, 0.0)
    denom = h + lam2
    if extra_l2 is not None:
        denom = denom + extra_l2
    denom = denom + 1e-30
    value = -g_adj / denom
    score = g_adj * g_adj / denom
    return value, score


# XLA's exponent decision in the JAX package's ``_pow2_scale``: t_k, the
# smallest float32 r at which its float32 ``floor(log2(r))`` reaches k,
# for k = -126 .. 126, as the int32 bits of 2^k plus these ulp offsets.
# Derived from JAX by ``tools/pow2_thresholds.py`` (which also checks
# that the decision is monotone in r); a test derives them again.
_POW2_THRESHOLD_ULPS = (
    0, -11, -35, -59, -83, -107, -3, -27, -51, -75, -99, -123, -19, -43,
    -67, -91, -115, -11, -35, -59, -83, -107, -3, -27, -51, -75, -99,
    -123, -19, -43, -67, -91, -115, -10, -66, -26, -50, -74, -34, -58,
    -82, -42, -66, -26, -50, -74, -34, -58, -82, -42, -66, -26, -50,
    -74, -34, -58, -82, -42, -66, -26, -50, -74, -34, -58, -17, -41, -1,
    -25, -49, -9, -33, -57, -17, -41, -1, -25, -49, -9, -33, -57, -33,
    -25, -17, -41, -33, -25, -17, -41, -33, -25, -17, -41, -33, -25,
    -17, -8, 0, -24, -16, -8, 0, -24, -16, -16, -8, -16, -8, -16, -8,
    -16, -8, 0, -8, 0, -8, -4, -4, -4, -4, -4, -4, -2, -2, -2, -1, 0, 0,
    0, 0, -1, -1, -1, -3, -3, -3, -3, -3, -3, -7, 1, -7, 1, -7, -15, -7,
    -15, -7, -15, -7, -15, -15, -7, 1, 5, -15, -7, 1, 5, -14, -6, -30,
    -22, -14, -6, -30, -22, -14, -6, -30, -22, -14, -6, -30, -6, -30, 5,
    -14, -38, 1, -22, 9, -6, -30, 5, -14, -38, 1, -22, 9, -5, -29, -53,
    -13, -37, -61, -21, -45, -5, -29, -53, -13, -37, -61, -21, -45, -5,
    -29, -53, -13, -37, -61, -21, -45, -5, -29, -53, -13, -37, -61, 6,
    -13, -36, -60, -84, 10, -4, -28, -52, -76, 14, 2, -20, -44, -68, 18,
    6, -12, -36, -60, -84, 10, -4, -28, -52, -76, 14, 2, -20, -44, -68,
    18, 6, -11)
POW2_THRESHOLD_BITS = tuple(((k + 127) << 23) + ulps for k, ulps in zip(
    range(-126, 127), _POW2_THRESHOLD_ULPS))
_POW2_TABLES: Dict[torch.device, torch.Tensor] = {}


def _pow2_thresholds(device: torch.device) -> torch.Tensor:
    """The threshold bits as an int32 tensor on ``device``, copied there
    once per process (later fits make no host-to-device copy)."""
    table = _POW2_TABLES.get(device)
    if table is None:
        table = torch.tensor(POW2_THRESHOLD_BITS, dtype=torch.int32,
                             device=device)
        _POW2_TABLES[device] = table
    return table


def _pow2_scale(amax, qmax: float):
    """Power-of-two quantization scale pair (scale, scale_inv), float32
    tensors of ``amax``'s shape, mapping |x| <= amax into [-qmax, qmax].
    The exponent is the JAX package's (``trainer._pow2_scale``): XLA's
    float32 ``floor(log2(qmax / amax))``, clipped to [-126, 126]. No
    logarithm is taken here: ``r = qmax / amax`` is one IEEE division,
    and the exponent counts the thresholds ``t_k <= r`` by integer
    compares of bit patterns (positive floats order as their bits), so
    the decision is the same bits in every process and on every device.
    The scales are built from their exponent bits, so they are exact
    powers of two and ``int * scale_inv`` is exact."""
    amax = torch.clamp_min(amax.float(), 1e-30)
    ratio = torch.full_like(amax, qmax) / amax
    table = _pow2_thresholds(ratio.device)
    reached = ratio.view(torch.int32).unsqueeze(-1) >= table
    e = torch.clamp(reached.sum(-1, dtype=torch.int32) - 127, -126, 126)
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
    fused multiply-add XLA's CPU backend makes of the JAX package's
    expression, ``fma(parent, 1 - w, value * w)``. The float64 product is
    exact and the float64 sum rounds far below a float32 ulp, so the one
    float32 rounding is the fused op's (barring a sum exactly on a
    midpoint). Where monotone bounds follow it, XLA fuses the other
    product at some nodes (ROADMAP C19): those values lie within two
    float32 ulps of the reference's."""
    return (parent.double() * (1.0 - w).double()
            + (value * w).double()).float()


def _find_numeric_splits(hist, fmask, remaining, parent_value, *, b,
                         lam1, lam2, min_child, min_hess, min_gain,
                         path_smooth, max_delta_step):
    """Numeric split finding for one level from the (width, F, B, 3)
    histogram: ordered cumulative scan, first-max best split per node
    over the features ``fmask`` allows (a (1, F) bool, all where None;
    the others get gain -inf, as the reference's ``node_fmask``),
    leaf-budget ranking and child values.

    Returns (do_split, best_feat, best_bin, lval, rval, left_stats,
    right_stats, remaining, smaller_side); ``smaller_side`` is 0 where
    the left child holds no more rows than the right, else 1."""
    gain, _ = _numeric_gains(hist, fmask, b=b, lam1=lam1, lam2=lam2,
                             min_child=min_child, min_hess=min_hess,
                             min_gain=min_gain)
    do_split, best_feat, best_bin, remaining = _best_splits(gain, remaining,
                                                           b)
    left_mask = torch.arange(b, device=hist.device)[None, :] \
        <= best_bin[:, None]
    lval, rval, left_stats, right_stats, smaller_side = _children(
        hist, best_feat, left_mask, parent_value, lam1=lam1, lam2=lam2,
        path_smooth=path_smooth, max_delta_step=max_delta_step)
    return (do_split, best_feat, best_bin, lval, rval, left_stats,
            right_stats, remaining, smaller_side)


def _numeric_gains(hist, fmask, *, b, lam1, lam2, min_child, min_hess,
                   min_gain, mono=None, rand_bin=None):
    """(width, F, B) gain of every ordered split ``bin <= t``, and the
    (width, F, 1, 3) totals. The gain is -inf where a guard fails, where
    ``fmask`` ((1 or width, F) bool, or None) keeps the node off the
    feature, where t is the last bin, where the children's values go
    against the feature's direction in ``mono`` ((F,) float32 of -1, 0,
    +1: the monotone rejection, ``mono * (val_r - val_l) >= 0``), and
    where t is not the node's candidate bin ``rand_bin`` ((width, F),
    ``extra_trees``)."""
    dev = hist.device
    cum = torch.cumsum(hist, dim=2)              # left stats per bin
    tot = cum[:, :, -1:, :]
    gl, hl, cl = cum[..., 0], cum[..., 1], cum[..., 2]
    gt, ht, ct = tot[..., 0], tot[..., 1], tot[..., 2]
    gr, hr, cr = gt - gl, ht - hl, ct - cl
    val_l, score_l = _leaf_objective_impl(gl, hl, lam1, lam2)
    val_r, score_r = _leaf_objective_impl(gr, hr, lam1, lam2)
    _, score_p = _leaf_objective_impl(gt, ht, lam1, lam2)
    gain = 0.5 * (score_l + score_r - score_p)
    ok = ((cl >= min_child) & (cr >= min_child)
          & (hl >= min_hess) & (hr >= min_hess)
          & (gain > min_gain))
    if fmask is not None:
        ok &= fmask[:, :, None]
    # last bin can't split (right side empty by construction)
    bins = torch.arange(b, device=dev)[None, None, :]
    ok &= bins < b - 1
    if mono is not None:
        ok &= mono[None, :, None] * (val_r - val_l) >= 0
    if rand_bin is not None:
        ok &= bins == rand_bin[..., None]
    return torch.where(ok, gain, -torch.inf), tot


def _best_splits(gain, remaining, b: int):
    """The first-max split per node of the (width, F, B) gains and the
    leaf budget (within-level gain ranking): (do_split, best_feat,
    best_bin, remaining)."""
    width = gain.shape[0]
    flat_gain = gain.reshape(width, -1)
    # torch.argmax returns the first maximum (all -inf rows give 0)
    best_fb = torch.argmax(flat_gain, dim=1)
    best_gain = torch.gather(flat_gain, 1, best_fb[:, None])[:, 0]
    best_feat = best_fb // b
    best_bin = best_fb % b
    do_split, remaining = _leaf_budget(best_gain, remaining)
    return do_split, best_feat, best_bin, remaining


def _leaf_budget(best_gain, remaining):
    """The leaf budget over the nodes' best gains (within-level gain
    ranking, stable, as jnp.argsort): (do_split, remaining)."""
    width = best_gain.shape[0]
    can_split = torch.isfinite(best_gain)
    order = torch.argsort(-torch.where(can_split, best_gain, -torch.inf),
                          stable=True)
    rank = torch.empty_like(order).scatter_(
        0, order, torch.arange(width, device=best_gain.device))
    do_split = can_split & (rank < remaining)
    return do_split, remaining - do_split.sum()


def _children(hist, best_feat, left_mask, parent_value, *, lam1, lam2,
              path_smooth, max_delta_step, extra_l2=None):
    """Child values and stats of each node's chosen split, whose left
    bins are ``left_mask`` (width, B): (lval, rval, left_stats,
    right_stats, smaller_side)."""
    width = hist.shape[0]
    hist_best = hist[torch.arange(width, device=hist.device), best_feat]
    left_stats = torch.sum(hist_best * left_mask[..., None], dim=1)
    tot_best = torch.sum(hist_best, dim=1)
    right_stats = tot_best - left_stats
    lval, rval, smaller_side = _child_values(
        left_stats, right_stats, parent_value, lam1=lam1, lam2=lam2,
        path_smooth=path_smooth, max_delta_step=max_delta_step,
        extra_l2=extra_l2)
    return lval, rval, left_stats, right_stats, smaller_side


def _child_values(left_stats, right_stats, parent_value, *, lam1, lam2,
                  path_smooth, max_delta_step, extra_l2=None):
    """(lval, rval, smaller_side) of the chosen splits from their (width,
    3) child stats."""
    lval, _ = _leaf_objective_impl(left_stats[:, 0], left_stats[:, 1],
                                   lam1, lam2, extra_l2)
    rval, _ = _leaf_objective_impl(right_stats[:, 0], right_stats[:, 1],
                                   lam1, lam2, extra_l2)
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
    return lval, rval, smaller_side


def _find_general_splits(hist, fmask, remaining, parent_value, is_cat,
                         cfg, *, b, lam1, lam2, min_child, min_hess,
                         min_gain, path_smooth, max_delta_step, mono=None,
                         rand_bin=None):
    """Split finding for one level on the general branch of the
    reference's ``make_build_tree``: fits with categorical features
    (``is_cat``, (F,) bool, or None), monotone constraints (``mono``),
    ``extra_trees`` (``rand_bin``) or a feature subset per node
    (``fmask``, (1 or width, F) bool). Numeric features gain as in
    ``_numeric_gains``. A categorical feature's used bins (rows
    present, never the missing bin 0) are sorted by grad / (hess +
    cat_smooth) (stable: ties and the unused bins, at +inf, keep bin
    order), those of at least ``min_data_per_group`` rows scanned as
    prefixes under ``lambda_l2 + cat_l2`` with at most
    ``max_cat_threshold`` categories on the smaller side; a node using at
    most ``max_cat_to_onehot`` categories takes one-vs-rest splits.

    Returns (do_split, best_feat, best_bin, left_mask, chosen_cat, lval,
    rval, left_stats, right_stats, remaining, smaller_side):
    ``left_mask`` (width, B) the bins each chosen split sends left,
    ``best_bin`` a categorical split's prefix length - 1 (sorted scan) or
    its category's bin (one-vs-rest). The children's values are before
    the monotone clamp (``build_tree`` applies it)."""
    dev = hist.device
    gain, tot = _numeric_gains(hist, fmask, b=b, lam1=lam1, lam2=lam2,
                               min_child=min_child, min_hess=min_hess,
                               min_gain=min_gain, mono=mono,
                               rand_bin=rand_bin)
    bins = torch.arange(b, device=dev)
    if is_cat is None:
        do_split, best_feat, best_bin, remaining = _best_splits(
            gain, remaining, b)
        chosen_cat = torch.zeros_like(do_split)
        left_mask = bins[None, :] <= best_bin[:, None]
        lval, rval, left_stats, right_stats, smaller_side = _children(
            hist, best_feat, left_mask, parent_value, lam1=lam1, lam2=lam2,
            path_smooth=path_smooth, max_delta_step=max_delta_step)
        return (do_split, best_feat, best_bin, left_mask, chosen_cat, lval,
                rval, left_stats, right_stats, remaining, smaller_side)
    gt, ht, ct = tot[..., 0], tot[..., 1], tot[..., 2]
    fmask = (torch.ones_like(is_cat)[None, :] if fmask is None
             else fmask)[:, :, None]
    g_b, h_b, c_b = hist[..., 0], hist[..., 1], hist[..., 2]
    used = (c_b > 0) & (bins > 0)[None, None, :]
    used_sorted = used & (c_b >= float(max(cfg.min_data_per_group, 1)))
    ratio = torch.where(used_sorted, g_b / (h_b + cfg.cat_smooth), torch.inf)
    # jnp.argsort is stable
    sort_idx = torch.argsort(ratio, dim=2, stable=True)
    scum = torch.cumsum(torch.gather(
        hist, 2, sort_idx[..., None].expand(-1, -1, -1, 3)), dim=2)
    num_used = used.sum(dim=2)
    num_sorted = used_sorted.sum(dim=2)
    gl_c, hl_c, cl_c = scum[..., 0], scum[..., 1], scum[..., 2]
    gr_c, hr_c, cr_c = gt - gl_c, ht - hl_c, ct - cl_c
    _, cscore_l = _leaf_objective_impl(gl_c, hl_c, lam1, lam2, cfg.cat_l2)
    _, cscore_r = _leaf_objective_impl(gr_c, hr_c, lam1, lam2, cfg.cat_l2)
    _, cscore_p = _leaf_objective_impl(gt, ht, lam1, lam2, cfg.cat_l2)
    cgain = 0.5 * (cscore_l + cscore_r - cscore_p)
    pos1 = (bins + 1)[None, None, :]               # the left set's size
    side = torch.minimum(pos1, num_sorted[..., None] - pos1)
    cok = ((pos1 < num_sorted[..., None])
           & (side <= cfg.max_cat_threshold)
           & (cl_c >= min_child) & (cr_c >= min_child)
           & (hl_c >= min_hess) & (hr_c >= min_hess)
           & (cgain > min_gain))
    cgain = torch.where(cok, cgain, -torch.inf)
    # one-vs-rest, indexed by the category's bin
    _, oscore_l = _leaf_objective_impl(g_b, h_b, lam1, lam2, cfg.cat_l2)
    _, oscore_r = _leaf_objective_impl(gt - g_b, ht - h_b, lam1, lam2,
                                       cfg.cat_l2)
    ogain = 0.5 * (oscore_l + oscore_r - cscore_p)
    ook = (used & (c_b >= min_child) & (ct - c_b >= min_child)
           & (h_b >= min_hess) & (ht - h_b >= min_hess)
           & (ogain > min_gain) & (num_used[..., None] > 1))
    ogain = torch.where(ook, ogain, -torch.inf)
    onehot = num_used <= cfg.max_cat_to_onehot
    cat_gain = torch.where(fmask, torch.where(onehot[..., None], ogain,
                                              cgain), -torch.inf)
    gain = torch.where(is_cat[None, :, None], cat_gain, gain)
    do_split, best_feat, best_bin, remaining = _best_splits(gain, remaining,
                                                           b)

    sel = torch.arange(gain.shape[0], device=dev)
    mask_num = bins[None, :] <= best_bin[:, None]
    chosen_cat = is_cat[best_feat] & do_split
    # each bin's place in its node's sorted order (a permutation's
    # inverse, so stability does not matter)
    bin_rank = torch.argsort(sort_idx[sel, best_feat], dim=1, stable=True)
    mask_prefix = (bin_rank <= best_bin[:, None]) & used_sorted[sel, best_feat]
    mask_cat = torch.where(
        (num_used[sel, best_feat] <= cfg.max_cat_to_onehot)[:, None],
        bins[None, :] == best_bin[:, None], mask_prefix)
    left_mask = torch.where(chosen_cat[:, None], mask_cat, mask_num)
    lx2 = torch.where(chosen_cat, cfg.cat_l2, 0.0).to(torch.float32)
    lval, rval, left_stats, right_stats, smaller_side = _children(
        hist, best_feat, left_mask, parent_value, lam1=lam1, lam2=lam2,
        path_smooth=path_smooth, max_delta_step=max_delta_step,
        extra_l2=lx2)
    return (do_split, best_feat, best_bin, left_mask, chosen_cat, lval, rval,
            left_stats, right_stats, remaining, smaller_side)


def _unbundle_hist(hb, maps, f: int, b: int):
    """The (width, F, B, 3) histogram of the original features from the
    (width, F_bundled, B, 3) histogram of an EFB-bundled matrix
    (``ops/efb.py``; the reference's ``_unbundle_hist``): pass-through
    columns copy over, bundled slots scatter to their (feature, bin), and
    each bundled member's default bin is the node total (from bundled
    column 0: every live row lies in one of its bins) minus the member's
    present bins (its scattered slots: a run of the scatter entries,
    summed as differences of one running sum). Both are taken in float64
    and the difference rounded once, so counts are exact and grad/hess
    lie within float32 rounding of the direct histogram's.
    ``maps``: ``efb.device_maps``."""
    width = hb.shape[0]
    hist = torch.zeros((width, f, b, 3), dtype=hb.dtype, device=hb.device)
    if maps["pt_col"].numel():
        hist[:, maps["pt_feat"]] = hb[:, maps["pt_col"]]
    slots = hb[:, maps["sc_col"], maps["sc_bin"]]            # (width, S, 3)
    if maps["sc_col"].numel():
        hist[:, maps["sc_feat"], maps["sc_obin"]] = slots
    if maps["md_feat"].numel():
        total = hb[:, 0].double().sum(dim=1)                 # (width, 3)
        run = torch.nn.functional.pad(slots.double().cumsum(dim=1),
                                      (0, 0, 1, 0))
        present = run[:, maps["md_end"]] - run[:, maps["md_start"]]
        hist[:, maps["md_feat"], maps["md_bin"]] = \
            (total[:, None, :] - present).float()
    return hist


def _bins_at(binned, feat):
    """(N,) bin ids of each row's feature ``feat`` (N,) int64: uint8 and
    int32 as gathered, uint16 as int64 through its int16 view (torch
    gathers no uint16)."""
    if binned.dtype == torch.uint16:
        return torch.gather(binned.view(torch.int16), 1,
                            feat[:, None])[:, 0].long() & 0xFFFF
    return torch.gather(binned, 1, feat[:, None])[:, 0]


def _root_stats(hist, cfg: TrainConfig):
    """The quantized plane's root (value, count) from the level-0
    histogram: any one feature's bins partition the live rows."""
    tot0 = torch.sum(hist[0, 0], dim=0)
    rv0, _ = _leaf_objective_impl(tot0[0], tot0[1], cfg.lambda_l1,
                                  cfg.lambda_l2)
    if cfg.max_delta_step > 0:
        rv0 = torch.clamp(rv0, -cfg.max_delta_step, cfg.max_delta_step)
    return rv0, tot0[2]


def _record_level(tree, d: int, do_split, best_feat, best_bin, lval, rval,
                  left_stats, right_stats) -> None:
    """Write level ``d``'s splits into the full-layout ``tree``
    (split_feature, threshold_bin, node_value, node_count): the level's
    slots, and its children's values and counts (the children of slot s
    are 2s+1 / 2s+2, interleaved left/right)."""
    split_feature, threshold_bin, node_value, node_count = tree
    level_start, width = 2 ** d - 1, 2 ** d
    kids = 2 * level_start + 1
    split_feature[level_start:kids] = torch.where(
        do_split, best_feat, -1).to(torch.int32)
    threshold_bin[level_start:kids] = torch.where(
        do_split, best_bin, 0).to(torch.int32)
    node_value[kids:kids + 2 * width] = torch.where(
        do_split[:, None], torch.stack([lval, rval], dim=1), 0.0).reshape(-1)
    node_count[kids:kids + 2 * width] = torch.where(
        do_split[:, None],
        torch.stack([left_stats[:, 2], right_stats[:, 2]], dim=1),
        0.0).reshape(-1)


def _level_rows(node, d: int):
    """(local slot ids, bool mask of the rows still at level ``d``) of the
    full-layout slots ``node``: a row that settled in a leaf above level
    ``d`` keeps a slot below 2^d - 1."""
    level_start, width = 2 ** d - 1, 2 ** d
    return (torch.clamp(node - level_start, 0, width - 1),
            node >= level_start)


def _smaller_child(local, prev_ss):
    """The rows whose slot is its split's smaller child (``prev_ss``, the
    previous level's side per split), the one histogrammed under
    subtraction; its sibling's histogram is derived."""
    return (local % 2) == prev_ss[local // 2]


def _route_rows(node, d: int, local, binned, best_feat, best_bin, do_split,
                left_mask=None):
    """Each row's slot after level ``d``'s splits: bins <= the threshold
    (or, with ``left_mask`` (width, B), the bins a split sends left) go
    to 2s+1, the others to 2s+2; rows settled above level ``d`` and rows
    of a slot that did not split stay where they are."""
    nbin = _bins_at(binned, best_feat[local])
    go_left = (left_mask[local, nbin.long()] if left_mask is not None
               else nbin.to(torch.int64) <= best_bin[local])
    child = torch.where(go_left, 2 * node + 1, 2 * node + 2)
    return torch.where((node >= 2 ** d - 1) & do_split[local], child, node)


def build_tree(binned, grad, hess, num_leaves: int, cfg: TrainConfig,
               total_bins: int, hist_quant: str = "off",
               subtract: bool = False, valid=None, feat_mask=None, key=None,
               efb=None, learner=None, root=None):
    """One depthwise tree over the (N, F) uint8, uint16 or int32 ``binned``
    matrix with (N,) float32 ``grad`` / ``hess``. ``hist_quant``
    (off|q16|q8) picks the histogram plane and ``subtract`` the sibling
    trick (see the module note). ``valid``: an (N,) float32 0/1 row mask
    (bagging and GOSS; every row where None), ``feat_mask``: an (F,)
    float32 0/1 mask of the features the tree may split on (all where
    None), as the reference builder's (``make_build_tree``). ``key``:
    the tree's stream keys (``sampling.tree_keys``), which
    ``extra_trees`` and ``feature_fraction_by_node`` draw from per level.
    ``efb``: an EFB plan's bundled matrix (``"binned"``, (N, F_bundled)
    of ``binned``'s dtype) and index maps (``efb.device_maps``): the
    histograms read the bundled matrix and are unbundled
    (``_unbundle_hist``), rows route on ``binned``. Returns the
    full-layout (split_feature int32, threshold_bin int32, node_value
    float32, node_count float32) device tensors, each (2^(D+1)-1,); for a
    fit with categorical features also (decision_type int8 (slots,),
    bin_go_left bool (slots, B): the bins each split sends left, by which
    its rows are routed; ``_find_general_splits``), as the reference's
    ``make_build_tree`` returns them.

    ``learner``: this rank's ``parallel_modes.Learner`` in a
    multi-device fit (float32 plane, no EFB plan): the ``data`` learner
    reduces each level's histogram, the others find the level's splits
    by their own protocol (``find_splits``), padding rows are kept out
    of every histogram (``live_rows``), and the feature learner routes
    the rows (``route``) and returns each row's final slot as a fifth
    tensor, as its columns alone cannot score them. ``root``: the root's
    (sum of grad, sum of hess, count), :func:`_root_sums` of every row
    where the rows are a rank's share (None: of these rows)."""
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
    if cfg.draws_per_node and key is None:
        raise ValueError("extra_trees / feature_fraction_by_node need the "
                         "tree's stream keys (key)")

    node = torch.zeros(n, dtype=torch.int64, device=dev)   # full-layout slot
    split_feature = torch.full((num_slots,), -1, dtype=torch.int32, device=dev)
    threshold_bin = torch.zeros(num_slots, dtype=torch.int32, device=dev)
    node_value = torch.zeros(num_slots, dtype=torch.float32, device=dev)
    node_count = torch.zeros(num_slots, dtype=torch.float32, device=dev)
    has_cat = cfg.has_categorical
    is_cat = None
    if has_cat:
        # filled slot by slot with a scalar fill: no host-to-device copy
        # inside a capture
        is_cat = torch.zeros(f, dtype=torch.bool, device=dev)
        for slot in cfg.categorical_features:
            is_cat[slot:slot + 1].fill_(True)
        decision_type = torch.zeros(num_slots, dtype=torch.int8, device=dev)
        bin_go_left = torch.zeros((num_slots, b), dtype=torch.bool,
                                  device=dev)
        num_bits = 6 if cfg.zero_as_missing else 10
    mono = None
    if cfg.has_monotone:
        if len(cfg.monotone_constraints) > f:
            raise ValueError(
                f"monotone_constraints has {len(cfg.monotone_constraints)} "
                f"entries but there are only {f} features")
        # the features' directions by scalar fills, as is_cat; each
        # slot's output bounds (the "basic" method: the children of a
        # constrained split may not cross its midpoint)
        mono = torch.zeros(f, dtype=torch.float32, device=dev)
        for slot, v in enumerate(cfg.monotone_constraints):
            if v:
                mono[slot:slot + 1].fill_(float(v))
        node_lower = torch.full((num_slots,), -torch.inf, device=dev)
        node_upper = torch.full((num_slots,), torch.inf, device=dev)
    fmask = None if feat_mask is None else (feat_mask > 0)[None, :]

    if hist_quant != "off":
        # every row valid: grad * 1 and hess * 1 are the same bits
        grad_v, hess_v = ((grad, hess) if valid is None else
                          (grad * valid, hess * valid))
        # per-round shared pow2 scales; rows outside `valid` quantize to 0
        qdt = torch.int8 if hist_quant == "q8" else torch.int16
        qmax = 120.0 if hist_quant == "q8" else 32000.0
        gscale, gscale_inv = _pow2_scale(torch.max(torch.abs(grad_v)), qmax)
        hscale, hscale_inv = _pow2_scale(torch.max(torch.abs(hess_v)), qmax)
        # torch.round rounds half to even, as jnp.rint
        grad_q = torch.round(grad_v * gscale).to(qdt)
        hess_q = torch.round(hess_v * hscale).to(qdt)
    else:
        if root is None:
            root = _root_sums(grad, hess, valid)
        rv, _ = _leaf_objective_impl(root[0], root[1], lam1, lam2)
        if cfg.max_delta_step > 0:
            rv = torch.clamp(rv, -cfg.max_delta_step, cfg.max_delta_step)
        node_value[0] = rv
        node_count[0] = root[2]
    # filled on the device: a host->device copy would sync every tree
    remaining = torch.full((), num_leaves - 1, dtype=torch.int64, device=dev)
    prev_hist = prev_split = prev_ss = None
    hist_mat = binned if efb is None else efb["binned"]
    f_hist = hist_mat.shape[1]

    def hist_of(live, local, width):
        if hist_quant != "off":
            hist = level_histogram_quant(hist_mat, grad_q, hess_q, live,
                                         local, width, f_hist, b, gscale_inv,
                                         hscale_inv)
        elif learner is not None:
            hist = learner.histogram(hist_mat, grad, hess, live, local,
                                     width, b)
        else:
            hist = level_histogram(hist_mat, grad, hess, live, local, width,
                                   f_hist, b)
        return hist if efb is None else _unbundle_hist(hist, efb, f, b)

    # the learners that find splits by their own protocol
    selects = learner is not None and learner.mode != "data"

    for d in range(depth):
        level_start = 2 ** d - 1
        width = 2 ** d
        kids = 2 * level_start + 1      # first slot of the next level
        local, at_level = _level_rows(node, d)
        live = at_level.to(torch.float32)
        if valid is not None:
            live = live * valid
        if learner is not None:
            live = learner.live_rows(live)
        if selects:
            (do_split, best_feat, best_bin, lval, rval, left_stats,
             right_stats, remaining, small_side) = learner.find_splits(
                hist_mat, grad, hess, live, local, width, fmask, remaining,
                node_value[level_start:kids], split_kw)
            _record_level((split_feature, threshold_bin, node_value,
                           node_count), d, do_split, best_feat, best_bin,
                          lval, rval, left_stats, right_stats)
            node = learner.route(node, d, local, binned, best_feat,
                                 best_bin, do_split) \
                if learner.mode == "feature" else _route_rows(
                    node, d, local, binned, best_feat, best_bin, do_split)
            continue
        if subtract and d > 0:
            # the smaller child of each split only, by masking its
            # sibling's rows out of live: masked rows fall in no tile of
            # the kernels. live stays binary, so the cover stat that
            # picked the smaller side counts its rows.
            sel = (live > 0) & _smaller_child(local, prev_ss)
            hist = _derive_sibling_hist(
                hist_of(live * sel.to(live.dtype), local, width), prev_hist,
                prev_split, prev_ss)
        else:
            hist = hist_of(live, local, width)
        if hist_quant != "off" and d == 0:
            # quantized-plane root stats, recorded before split finding so
            # path smoothing sees the root value
            node_value[0], node_count[0] = _root_stats(hist, cfg)
        parent_value = node_value[level_start:kids]
        if cfg.general_split:
            node_mask = fmask
            if cfg.feature_fraction_by_node < 1.0:
                node_mask = sampling.node_feature_mask(
                    sampling.draw(key + (sampling.NODE_FEATURES, d),
                                  width * f, dev).reshape(width, f),
                    feat_mask, cfg.feature_fraction_by_node)
            rand_bin = None
            if cfg.extra_trees:
                rand_bin = sampling.extra_bins(
                    sampling.draw(key + (d,), width * f, dev).reshape(
                        width, f), b)
            (do_split, best_feat, best_bin, left_mask, chosen_cat, lval, rval,
             left_stats, right_stats, remaining, small_side) = \
                _find_general_splits(
                    hist, node_mask, remaining, parent_value, is_cat, cfg,
                    mono=mono, rand_bin=rand_bin, **split_kw)
            if has_cat:
                decision_type[level_start:kids] = torch.where(
                    chosen_cat, 1, torch.where(do_split, num_bits, 0)).to(
                        torch.int8)
                bin_go_left[level_start:kids] = left_mask & do_split[:, None]
            else:
                left_mask = None         # numeric splits route by threshold
            if mono is not None:
                # child values into the parent's bounds; a constrained
                # split's children meet at the midpoint (numeric splits
                # only: a categorical one constrains nothing)
                p_lo = node_lower[level_start:kids]
                p_hi = node_upper[level_start:kids]
                lval = torch.minimum(torch.maximum(lval, p_lo), p_hi)
                rval = torch.minimum(torch.maximum(rval, p_lo), p_hi)
                c_mono = mono[best_feat] * (~chosen_cat)
                mid = (lval + rval) / 2.0
                up, down = c_mono > 0, c_mono < 0
                bounds = (
                    (node_lower, torch.where(down, torch.maximum(p_lo, mid),
                                             p_lo),
                     torch.where(up, torch.maximum(p_lo, mid), p_lo), p_lo),
                    (node_upper, torch.where(up, torch.minimum(p_hi, mid),
                                             p_hi),
                     torch.where(down, torch.minimum(p_hi, mid), p_hi),
                     p_hi))
                for slots, left, right, parent in bounds:
                    slots[kids:kids + 2 * width] = torch.stack(
                        [torch.where(do_split, left, parent),
                         torch.where(do_split, right, parent)],
                        dim=1).reshape(-1)
        else:
            (do_split, best_feat, best_bin, lval, rval, left_stats,
             right_stats, remaining, small_side) = _find_numeric_splits(
                hist, fmask, remaining, parent_value, **split_kw)
            left_mask = None
        if subtract:
            prev_hist, prev_split, prev_ss = hist, do_split, small_side
        _record_level((split_feature, threshold_bin, node_value,
                       node_count), d, do_split, best_feat, best_bin, lval,
                      rval, left_stats, right_stats)
        node = _route_rows(node, d, local, binned, best_feat, best_bin,
                           do_split, left_mask)
    if has_cat:
        return (split_feature, threshold_bin, node_value, node_count,
                decision_type, bin_go_left)
    if learner is not None and learner.mode == "feature":
        return split_feature, threshold_bin, node_value, node_count, node
    return split_feature, threshold_bin, node_value, node_count


def _root_sums(grad, hess, valid=None):
    """The float32 root's (sum of grad, sum of hess, count) over the rows
    ``valid`` (a 0/1 float32 mask, every row where None) keeps."""
    if valid is None:
        return (torch.sum(grad), torch.sum(hess), torch.sum(torch.ones(
            grad.shape[0], dtype=torch.float32, device=grad.device)))
    return (torch.sum(grad * valid), torch.sum(hess * valid),
            torch.sum(valid))


def _predict_tree(sf, tb, nv, binned, depth: int, bin_go_left=None):
    """(N,) leaf values of one full-layout tree on the (N, F) binned
    matrix: ``depth`` gather steps, bins <= threshold go left, or with
    ``bin_go_left`` (slots, B) the bins each split's mask sends left."""
    n = binned.shape[0]
    sf, tb = sf.long(), tb.long()
    nodev = torch.zeros(n, dtype=torch.int64, device=binned.device)
    for _ in range(depth):
        feat = sf[nodev]
        is_leaf = feat < 0
        fb = _bins_at(binned, torch.clamp_min(feat, 0))
        left = (bin_go_left[nodev, fb.long()] if bin_go_left is not None
                else fb.long() <= tb[nodev])
        child = torch.where(left, 2 * nodev + 1, 2 * nodev + 2)
        nodev = torch.where(is_leaf, nodev, child)
    return nv[nodev]


# ---------------------------------------------------------------------------
# Boosting loop
# ---------------------------------------------------------------------------

def warm_start_scores(init_model: Optional[BoosterArrays], x: np.ndarray,
                      offset: Optional[np.ndarray] = None,
                      device: DeviceLike = None) -> Optional[np.ndarray]:
    """Raw-space warm-start margins for continuing a fit on fresh data
    (the JAX package's ``warm_start_scores``): ``init_model.predict`` on
    the RAW features, scored on ``device``, so the warm start stays valid
    when the new rows are binned differently; plus the optional per-row
    ``offset``. ``None`` when both are None."""
    s = None if init_model is None else \
        init_model.predict(x, device=device).cpu().numpy()
    if offset is not None:
        s = offset if s is None else s + offset
    return s


def _check_bin_range(binned, total_bins: int):
    """Raise where an id of ``binned`` lies outside [0, max_bin); return
    the ids as compared (int64 for uint16 and float tensors)."""
    ids = (bin_ids(binned) if isinstance(binned, torch.Tensor)
           and (binned.dtype == torch.uint16 or binned.is_floating_point())
           else binned)
    if binned.shape[0] and (int(ids.min()) < 0
                            or int(ids.max()) >= total_bins):
        raise ValueError(f"bin ids must lie in [0, max_bin={total_bins})")
    return ids


def _binned_to_device(binned, total_bins: int, dev: torch.device):
    """(N, F) bin ids (numpy, or a tensor on any device) -> uint8 (at most
    256 bins), uint16 (at most 65,536) or int32 (past that) on ``dev``,
    one copy at the narrowest dtype (``binned_ingest_dtype``); ids
    outside [0, max_bin) raise. uint16 crosses as int16's bits: torch
    converts little to or from uint16."""
    want = binned_ingest_dtype(total_bins)
    tensor = isinstance(binned, torch.Tensor)
    # The range is checked on the ids as given, before any narrowing.
    ids = _check_bin_range(binned, total_bins)
    if want == np.int32:
        if not tensor:
            ids = torch.from_numpy(np.ascontiguousarray(
                binned.astype(np.int32, copy=False)))
        return ids.to(device=dev, dtype=torch.int32).contiguous()
    if tensor:
        if want == np.uint16:
            bits = (binned.view(torch.int16) if binned.dtype == torch.uint16
                    else ids.to(torch.int16))
            return bits.to(dev).contiguous().view(torch.uint16)
        return (binned if binned.dtype == torch.uint8
                else ids.to(torch.uint8)).to(dev).contiguous()
    if want == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(
            binned.astype(np.uint16, copy=False)).view(np.int16)).to(
                dev).view(torch.uint16)
    return torch.as_tensor(binned.astype(np.uint8, copy=False),
                           device=dev).contiguous()


def plan_efb(binned_d, cfg: TrainConfig):
    """The fit's EFB plan where the reference makes one (a serial
    depthwise fit without categorical features, ``trainer.py:2621-2630``;
    the port has no other learner), under ``MMLSPARK_TORCH_EFB``, planned
    and applied on the fit's device copy ``binned_d``: (plan or None,
    {"binned": the bundled matrix beside ``binned_d``, and the plan's
    index maps} or None)."""
    plan = (None if cfg.has_categorical else efb_mod.plan_bundles(
        binned_d, cfg.max_bin, mode=efb_mod.resolve_efb()))
    if plan is None:
        return None, None
    return plan, {"binned": efb_mod.apply_plan(binned_d, plan),
                  **efb_mod.device_maps(plan, binned_d.device)}


def _f32(a, dev, shape=None):
    a = np.asarray(a, dtype=np.float32)
    return torch.as_tensor(a if shape is None else a.reshape(shape),
                           device=dev)


def stop_iteration(values, esr: int, tol: float, higher_better: bool):
    """The early-stopping rule of the JAX package's ``_train_scan``
    (TrainUtils.scala:143-169) over one metric's per-iteration values:
    ``(best_iteration, stop_after)``, ``stop_after`` None while the rule
    has not fired. An improvement must clear ``tol`` (higher-better) or
    stay within it (lower-better)."""
    best_val = -np.inf if higher_better else np.inf
    best_iter, rounds_no_improve = -1, 0
    for j, cur in enumerate(values):
        improved = (cur - best_val > tol if higher_better
                    else cur - best_val < tol)
        if improved:
            best_val, best_iter, rounds_no_improve = cur, j, 0
        else:
            rounds_no_improve += 1
            if rounds_no_improve >= esr:
                return best_iter, j + 1
    return best_iter, None


def train(binned: np.ndarray, labels: np.ndarray, cfg: TrainConfig,
          weights: Optional[np.ndarray] = None,
          bin_upper: Optional[np.ndarray] = None,
          valid_sets: Optional[List[Tuple[Any, Any, Any]]] = None,
          init_model: Optional[BoosterArrays] = None,
          init_raw: Optional[np.ndarray] = None,
          valid_init_raws: Optional[List[np.ndarray]] = None,
          measures: Optional[InstrumentationMeasures] = None,
          device: DeviceLike = None,
          custom_objective: Optional[Callable] = None,
          iteration_offset: int = 0, capture: bool = True,
          group_ids: Optional[np.ndarray] = None,
          mesh=None) -> TrainResult:
    """Boosting loop. ``binned``: (N, F) bin ids (``BinMapper.transform``
    output, or a uint8 tensor already on the device); ``weights``:
    optional (N,) row weights; ``bin_upper``: (F, B) raw-value bin upper
    edges (``BinMapper.bin_upper_values``), which become the booster's
    raw-value thresholds; ``group_ids``: (N,) query ids of the rows, which
    lambdarank and the ``ndcg`` metric need (the groups' padded layout
    is built from them once, on the host).

    A multiclass objective grows K = ``num_class`` trees per iteration,
    one per class from that class's grad/hess column, all under the
    iteration's masks; the raw scores are (N, K) and the booster's trees
    are interleaved by class (tree i is class i % K).

    ``valid_sets``: (binned, labels, weights) per validation set, or
    (binned, labels, weights, group_ids) where the metric is ``ndcg``.
    Each set's raw scores update on the device every tree and its
    metrics are recorded as ``valid<i>_<label>``, after
    ``train_<label>``. With ``cfg.early_stopping_round > 0`` the first
    set's first metric drives ``stop_iteration``: the metrics are synced
    in blocks of ``max(early_stopping_round, 8)`` iterations, the loop
    stops at the first block where the rule fires, ``best_iteration`` is
    returned and the trees after it are cut (``(best + 1) * K`` kept).

    ``init_model`` + ``init_raw``: warm start — the new trees continue
    ``init_model`` (whose ``init_score`` is kept) from its raw scores on
    the training rows (``warm_start_scores``); ``init_raw`` alone is a
    per-row offset that the model does not keep. ``valid_init_raws``:
    the same per validation set; both reshape to (n, K) for a multiclass
    fit. ``measures``: an
    ``InstrumentationMeasures`` timing the phases dataPreparation,
    training (host dispatch) and validation (metric syncs and the final
    transfer, which waits for the device).

    ``custom_objective``: ``fn(preds, labels, weights) -> (grad, hess)``
    in place of the named objective, which still picks the metric and
    the base score. It is called once per iteration with the fit's
    device tensors: float32 ``preds`` (raw scores, (N, K) for a
    multiclass fit) and ``labels``, and the float32 ``weights`` or None;
    it gets none of the named objective's settings. It may return
    tensors or array-likes of ``preds``' shape, which go to the device
    as float32; other shapes raise ``ValueError``. A numpy objective converts its inputs with
    ``preds.cpu().numpy()`` (``np.asarray`` raises on a CUDA tensor),
    which syncs with the card every iteration.

    ``iteration_offset``: the number of iterations trained before this
    call, for a resumed segment: the sampling streams (``sampling``) are
    keyed by the global iteration, so a resumed bagged fit draws what
    the uninterrupted one drew.

    Each iteration is one call of the boosting step (``step.Step``):
    sampling masks, grad/hess, GOSS, the tree, shrinkage (none for rf),
    the raw-score updates and the metric row. ``boosting_type`` gbdt,
    goss and rf run; rf fits every tree on the base score and weighs
    each ``1 / num_trees``. DART fits, and fits that grow leaf-wise
    (``grow_policy_of``: ``MMLSPARK_TORCH_GROW_POLICY=leafwise``, where
    the config allows it), run the eager host loop instead
    (``host_loop.HostLoop``, the reference's ``_train_loop``): its
    sampling masks are the reference's numpy draws, DART's tree weights
    change every iteration, early stopping reads the metrics every
    iteration, and nothing is captured; ``step_stats["host_loop"]``
    records the leaf-wise builder's histogram calls, host reads and host
    seconds. Leaf-wise fits run the float32 histogram plane with
    sibling subtraction and no EFB plan (``hist_stats`` records
    ``"off"``, ``True`` and 0), as the reference's leaf-wise fits. On
    the card a named objective's step is one
    captured CUDA graph, replayed every iteration (cached across fits of
    the same shape and config; ``step.clear_step_cache`` frees them);
    ``capture=False`` runs the same step uncaptured, as the CPU and a
    custom objective always do. ``step_stats`` records ``captured`` and
    the capture's seconds (``capture_s``, None where this fit made
    none).

    ``fault_point("gbdt.train_step")`` and then
    ``fault_point("train.participant_loss")`` are hit once per
    iteration, before its work, as in the reference: arming one with
    ``nth=k`` stops the fit at its k-th iteration.
    ``parallel.resilience.step_start`` / ``step_end`` bracket each
    iteration and the final drain as in the reference (the refresh
    loop's refit throttle runs at ``step_start``), under
    ``resilience.fit_watchdog("gbdt.train")``: with
    ``MMLSPARK_TORCH_WATCHDOG_MULT`` > 0 a span past its budget aborts
    the fit with ``TrainStalled``. Each host read of the metrics and the
    drain is a ``collective`` boundary with the fault points
    ``allreduce`` and ``mesh.collective_hang`` (``_host_sync``).

    The sanitizer (``core/sanitizer.py``, ``MMLSPARK_TORCH_SAN``; each
    check a no-op while it is off) is reset at the fit's start, and
    guards the reference's boundaries: the inputs at
    ``gbdt.train_scan.entry`` (the step) or ``gbdt.train_loop.entry``
    (the host loop), every histogram at ``gbdt.level_hist``, the metric
    rows at ``gbdt.metrics_sync`` (then ``step_boundary``: on a mesh,
    every rank's collective sequence is held against the others'), and
    the raw scores at ``gbdt.train_scan.exit``. While it is on, the step
    runs uncaptured, with the captured step's trees.

    Out of core (``resolve_ooc``): with ``MMLSPARK_TORCH_OOC`` auto and
    too little free device memory for the in-core fit (``fits_in_core``),
    or ``on``, a fit that ``_ooc_supported`` accepts streams through
    ``ooc.train_from_binned``: the rows are spilled in
    ``OOC_CHUNK_ROWS`` chunks and
    boosted chunk by chunk, on the quantized plane (q16 where
    ``MMLSPARK_TORCH_HIST_QUANT`` is off, with one warning), the trees
    bitwise the in-core fit's on that plane. ``on`` with a fit that
    cannot stream warns once and trains in-core; a full spill disk
    (``DiskFull``) warns once and trains in-core. ``hist_stats`` records
    ``ooc`` and ``ooc_reason`` (why the fit stayed in-core, else None).

    ``device=None`` runs on the CUDA card (and raises without one);
    ``device="cpu"`` runs the plain PyTorch path. The histogram plane
    and subtraction follow ``MMLSPARK_TORCH_HIST_QUANT`` /
    ``MMLSPARK_TORCH_HIST_SUB``, and bundling ``MMLSPARK_TORCH_EFB``
    (``plan_efb``), read once here; ``hist_stats`` records what ran,
    and the growth policy (``"grow_policy"``).
    Bin ids go to the device as uint8 up to ``max_bin=256``, as uint16
    up to 65,536, else as int32.

    ``mesh`` (``parallel.mesh.create_mesh``): a multi-device fit. Every
    rank of the mesh calls ``train`` with the same arguments (the full
    arrays) and gets the same result; the tree learner is
    ``resolve_mode``'s (``parallel_modes.py``): ``data`` or
    ``data_sharded`` (rows sharded over ``dp``, padded to a multiple of
    it with rows that ``row_valid`` keeps out of the histograms, the bag
    and the metrics), ``voting`` (rows over ``dp``) or ``feature``
    (columns over ``fp``). Each rank holds its share on its device; the
    sampling draws are keyed by the global row index, the base score and
    the bin-range check are taken over every row, validation sets are
    scored whole on every rank, and the training metrics on the gathered
    scores, so the trees, scores and metrics are the serial fit's bit
    for bit (voting at ``top_k >= F``). As in the reference, the
    quantized plane falls back to float32 with one warning, leaf-wise
    growth to depthwise and out-of-core training to in-core, with the
    reference's reasons; EFB is not planned; only ``data`` subtracts.
    The step runs uncaptured. Every objective and boosting type runs
    as serially: GOSS draws over every row, lambdarank and ``ndcg`` take
    the layout of every query group (and each validation set's), DART's
    host loop keeps each tree's prediction on this rank's rows, and a
    custom objective is called on every rank with the serial call's
    arguments (every row's scores, the labels, the weights as passed),
    so a host-side objective must give every rank the same result.
    ``hist_stats`` adds ``hist_shard``, ``hist_shard_reason`` (where the
    reduce-scatter is off for a reason) and ``grad_shard``."""
    from mmlspark_tpu_torch.models.gbdt import host_loop
    from mmlspark_tpu_torch.models.gbdt import step as step_mod

    dev = resolve_device(device)
    check_supported(cfg)
    # a fresh collective, recompile and dtype-contract record per fit
    # (keeps the ranks' cumulative sequence hashes comparable)
    sanitizer.reset()
    measures = measures if measures is not None else InstrumentationMeasures()
    mode = resolve_mode(cfg, mesh)
    learner = None
    if mesh is not None:
        from mmlspark_tpu_torch.models.gbdt import parallel_modes
        parallel_modes.check_supported(cfg, mode, binned.shape[1], mesh)
        learner = parallel_modes.Learner(mode, mesh, cfg, binned.shape[0],
                                         binned.shape[1])
    grow_policy = grow_policy_of(cfg, mesh)
    leafwise = grow_policy == "leafwise"
    host = leafwise or cfg.boosting_type == "dart"
    # leaf-wise histograms run the float32 plane on the rows' own matrix
    # and always derive the larger child by subtraction
    hist_quant = "off" if leafwise else resolve_hist_quant()
    subtract = leafwise or resolve_subtract()
    if learner is not None:
        if hist_quant != "off":
            env.warn_once(
                f"{HIST_QUANT_ENV}:mesh",
                f"{HIST_QUANT_ENV} is single-program only; sharded "
                "(data/voting/feature-parallel) fits build f32 histograms "
                "— label A/B measurements accordingly")
            hist_quant = "off"
        # the other learners histogram each level whole
        subtract = subtract and mode == "data"
    total_bins = cfg.max_bin
    depth = cfg.effective_depth
    n, num_f = binned.shape
    k = cfg.num_trees_per_iteration
    if cfg.objective == "lambdarank" and group_ids is None:
        raise ValueError("lambdarank requires group_ids")
    metric_name, metric_list, higher_better, _ = _resolve_metrics(cfg)
    if metric_name == "ndcg":
        if group_ids is None:
            raise ValueError("ndcg requires group_ids")
        for vi, vset in enumerate(valid_sets or []):
            if len(vset) < 4 or vset[3] is None:
                raise ValueError(
                    f"valid set {vi}: ndcg eval requires its own group ids "
                    "(pass 4-tuples in valid_sets)")

    ooc_mode = resolve_ooc()
    if ooc_mode == "off":
        ooc_reason: Optional[str] = f"{env.OOC}=off"
    else:
        ooc_reason = _ooc_supported(
            cfg, k=k, has_valid=bool(valid_sets),
            has_custom=custom_objective is not None,
            has_groups=group_ids is not None, mesh=mesh)
        want_ooc = (ooc_mode == "on"
                    or not fits_in_core(n, num_f, total_bins, dev,
                                        2 ** max(cfg.effective_depth - 1,
                                                 0)))
        if want_ooc and ooc_reason is None:
            from mmlspark_tpu_torch.core.serialize import DiskFull
            from mmlspark_tpu_torch.models.gbdt import ooc as ooc_mod
            try:
                return ooc_mod.train_from_binned(
                    binned, labels, cfg, weights=weights,
                    bin_upper=bin_upper, init_model=init_model,
                    init_raw=init_raw, measures=measures,
                    iteration_offset=iteration_offset, device=dev)
            except DiskFull as e:
                # the caller handed over the whole binned matrix, so the
                # rows fit in memory: train in-core rather than fail
                warn_once(
                    "gbdt.ooc.disk_full",
                    "out-of-core spill hit a full disk (%s); the rows "
                    "already fit in memory, so this fit continues IN-CORE "
                    "— free spill space to restore chunked training", e)
                ooc_reason = "io.disk_full: spill write failed"
        elif want_ooc:
            env.warn_once(f"{env.OOC}:downgrade",
                          f"{env.OOC}=on cannot stream this fit "
                          f"({ooc_reason}); training in-core — label A/B "
                          "measurements accordingly")
        elif ooc_reason is None:
            ooc_reason = "auto: the in-core fit fits in device memory"

    def shape_of(rows):
        return (rows,) if k == 1 else (rows, k)

    def layout_of(ids):
        # the padded (rows, mask) buckets of the groups, built once on
        # the host; the lambdas and ndcg take them on the device
        return (None if ids is None or (cfg.objective != "lambdarank"
                                        and metric_name != "ndcg")
                else obj_mod.layout_to(obj_mod.make_group_layout(ids), dev))

    with measures.phase("dataPreparation"):
        # the binned matrix goes to the device once, at the narrowest
        # dtype; an EFB plan's bundled matrix beside it
        if learner is None:
            binned_d = _binned_to_device(binned, total_bins, dev)
        else:
            # the range over every row, then this rank's share
            _check_bin_range(binned, total_bins)
            binned_d = _binned_to_device(learner.columns(binned), total_bins,
                                         dev)
            learner.set_device(dev)
        efb_plan, efb_maps = ((None, None) if leafwise or learner is not None
                              else plan_efb(binned_d, cfg))
        if init_model is not None:
            # continued training: keep the old model's base score and fit
            # on top of its raw scores
            base_score = init_model.init_score
            if init_raw is None:
                raise ValueError("warm start needs init_raw (the init "
                                 "model's raw scores on the training rows)")
        elif init_raw is not None:
            # a per-row offset (LightGBM init_score), not kept in the model
            base_score = 0.0
        else:
            # lambdarank never boosts from the average (as the reference)
            base_score = (obj_mod.init_score(cfg.objective, labels, weights)
                          if cfg.boost_from_average
                          and cfg.objective != "lambdarank" else 0.0)
        # every row's labels and weights (a multi-device step evaluates the
        # objective and the metrics on every row); the raw scores of this
        # rank's rows
        labels_d = _f32(labels, dev)
        weights_d = None if weights is None else _f32(weights, dev)
        n_rows = n
        if learner is not None:
            n_rows = learner.n_local
            if init_raw is not None:
                init_raw = learner.rows(np.asarray(
                    init_raw, dtype=np.float32).reshape(shape_of(n)))
        raw = (_f32(init_raw, dev, shape_of(n_rows)) if init_raw is not None
               else torch.full(shape_of(n_rows), base_score,
                               dtype=torch.float32, device=dev))
        layout = layout_of(group_ids)
        valids = []
        for vi, vset in enumerate(valid_sets or []):
            vb, vy, vw = vset[:3]
            vn = vb.shape[0]
            valids.append({
                "binned": _binned_to_device(vb, total_bins, dev),
                "labels": _f32(vy, dev),
                "weights": None if vw is None else _f32(vw, dev),
                "raw": (_f32(valid_init_raws[vi], dev, shape_of(vn))
                        if valid_init_raws is not None else
                        torch.full(shape_of(vn), base_score,
                                   dtype=torch.float32, device=dev)),
                "layout": layout_of(vset[3] if len(vset) > 3 else None)})

    # the metric row's layout: train_<m>, valid0_<m>, ... per metric
    labels_order = []
    for m_label, _ in metric_list:
        labels_order.append(f"train_{m_label}")
        labels_order += [f"valid{vi}_{m_label}" for vi in range(len(valids))]

    esr = cfg.early_stopping_round
    has_es = esr > 0 and bool(valids)
    total = cfg.num_iterations
    # the host loop reads the metrics every iteration: DART's later
    # drops would rescale the kept trees' weights
    block = (1 if host else max(esr, 8)) if has_es else total
    slots = step_mod.num_slots(cfg)
    bins = step_mod.mask_bins(cfg)
    cols = k * step_mod.tree_cols(slots, bins)
    # the first metric's label, as the reference's _train_scan keys it
    vidx = (labels_order.index(f"valid0_{metric_list[0][0]}") if has_es
            else -1)
    rows, met_host = [], []
    best_iter, stop_after = -1, None

    def metrics_synced(met):
        """The metric rows' first host read: guarded, and the ranks'
        collective sequences cross-checked."""
        sanitizer.check_finite("gbdt.metrics_sync", met)
        sanitizer.step_boundary("gbdt.metrics_sync", mesh)

    def sync_metrics_through(upto):
        """Metric values [len(met_host), upto) to the host in one copy."""
        if upto > len(met_host):
            met = _host_sync(
                dev, lambda: f"gbdt metric sync through iter {upto}",
                lambda: torch.stack(rows[len(met_host):upto])
                [:, cols:].cpu().numpy())
            metrics_synced(met)
            met_host.extend(met)

    if not host:
        # the host loop guards its own entry (``HostLoop``)
        data = {"binned": binned_d, "labels": labels_d,
                "weights": weights_d, "base": np.float32(base_score),
                "lr": np.float32(cfg.learning_rate),
                "valids": tuple({key: vs[key] for key in
                                 ("binned", "labels", "weights")}
                                for vs in valids)}
        sanitizer.check_finite("gbdt.train_scan.entry", data)
        sanitizer.check_dtype_contract("gbdt.train_scan.entry", data)
    st = step_mod.open_step(
        cfg, binned_d, labels_d, weights_d, raw, valids, layout=layout,
        lr=cfg.learning_rate, base=base_score, hist_quant=hist_quant,
        subtract=subtract, custom_objective=custom_objective,
        capture=capture and not host and learner is None, efb=efb_maps,
        efb_key=None if efb_plan is None else efb_plan.cache_key,
        learner=learner)
    cached_graph = st.graph is not None
    runner = (host_loop.HostLoop(st, labels, leafwise=leafwise,
                                 iteration_offset=iteration_offset)
              if host else None)
    try:
        # the train-step watchdog (off unless MMLSPARK_TORCH_WATCHDOG_MULT
        # > 0) times each iteration's host span and the final drain
        with resilience.fit_watchdog("gbdt.train"):
            it = 0
            while it < total:
                # the step boundary (a refit's throttle yields here),
                # then once per iteration, before its work: an armed
                # raise is the deterministic stand-in for a fit killed
                # mid-training, or for a mesh participant lost
                resilience.step_start(it + iteration_offset)
                fault_point("gbdt.train_step")
                fault_point("train.participant_loss")
                with measures.phase("training"):
                    rows.append(runner.run(it) if runner is not None else
                                step_mod.run_step(st, it + iteration_offset))
                    it += 1
                if has_es and (it % block == 0 or it == total):
                    # trees do not depend on the metrics, so syncing a
                    # block and replaying the rule stops where a
                    # per-iteration check would
                    with measures.phase("validation"):
                        sync_metrics_through(it)
                    best_iter, stop_after = stop_iteration(
                        [float(r[vidx]) for r in met_host], esr,
                        cfg.improvement_tolerance, higher_better)
                    if stop_after is not None:
                        break
                resilience.step_end()
            kept = len(rows) if stop_after is None else stop_after

            # the queued steps' device work lands in this drain: the
            # watchdog times it as one span (MIN_S must cover it); not a
            # step, so a refit's throttle does not yield here
            resilience.span_start("drain")
            with measures.phase("validation"):
                # one transfer of every kept tree and metric
                packed = (_host_sync(
                    dev, f"gbdt final drain of {kept} iterations",
                    lambda: torch.stack(rows[:kept]).cpu().numpy())
                    if kept else
                    np.zeros((0, cols + len(labels_order)), np.float32))
            resilience.step_end()
            carry = (st.raw, tuple(vs["raw"] for vs in st.valids))
            sanitizer.check_finite("gbdt.train_scan.exit", carry)
            sanitizer.check_dtype_contract("gbdt.train_scan.exit", carry)
            metrics_synced(packed[:, cols:])
    finally:
        step_mod.close_step(st)
    sf_h, tb_h, nv_h, cnt_h, met = step_mod.unpack(packed, slots, bins, k)
    masks = step_mod.unpack_masks(packed, slots, bins, k) if bins else None
    evals = [{"iteration": j,
              **{name: float(met[j, mi])
                 for mi, name in enumerate(labels_order)}}
             for j in range(kept)]
    booster = _assemble_booster(
        sf_h, tb_h, nv_h, cnt_h, cfg, num_f, total_bins, depth, bin_upper,
        base_score, best_iter, init_model, masks, k,
        tree_weights=(None if runner is None
                      else runner.tree_weights[:kept * k]))
    hist_stats = {"ooc": False, "ooc_reason": ooc_reason,
                  "grow_policy": grow_policy,
                  "hist_quant": hist_quant, "subtract": subtract,
                  "efb_bundles": (0 if efb_plan is None
                                  else len(efb_plan.bundles)),
                  "efb_bundled_features": (
                      0 if efb_plan is None
                      else efb_plan.n_bundled_features)}
    if learner is not None:
        shard, reason = resolve_hist_shard_mode(cfg, mesh)
        hist_stats.update(hist_shard=shard,
                          grad_shard="off" if mode == "feature" else "dp")
        if reason is not None:
            hist_stats["hist_shard_reason"] = reason
    return TrainResult(booster=booster, evals=evals, best_iteration=best_iter,
                       hist_stats=hist_stats,
                       step_stats={"captured": st.graph is not None,
                                   "capture_s": None if cached_graph
                                   else st.capture_s,
                                   **({} if runner is None else
                                      {"host_loop": runner.stats()})})


def _host_sync(dev, detail, read):
    """``read()``, a host read of the fit's values on ``dev``: the host
    boundary of the reference's cross-replica metric sync, where its
    fault points ``allreduce`` and ``mesh.collective_hang`` sit and which
    its watchdog classifies as a ``collective`` stall. While a watchdog
    is armed the card's queued work is awaited by polling
    (``resilience.wait_for_device``), so the wait can be interrupted."""
    fault_point("allreduce")
    prev = resilience.mark_boundary("collective", detail)
    try:
        fault_point("mesh.collective_hang")
        resilience.wait_for_device(dev)
        return read()
    finally:
        resilience.restore_boundary(prev)


def _assemble_booster(sf_all, tb_all, nv_all, cnt_all, cfg, num_f,
                      total_bins, depth, bin_upper, base_score, best_iter=-1,
                      init_model=None, masks=None, k=1, tree_weights=None):
    """Pack the (T, M) host arrays, interleaved by class for K = ``k``
    trees per iteration (tree i is class i % K), into a
    ``BoosterArrays`` with raw-value thresholds from ``bin_upper``;
    ``tree_weights`` (the host loop's, DART's Python floats) as float32,
    else 1; rf's weights times ``K / T`` (each class's trees average);
    with early stopping, only the ``(best_iter + 1) * K`` trees through
    ``best_iter``; after a warm start, ``init_model``'s trees first
    (``BoosterArrays.concat``). ``masks``: a categorical
    fit's (decision_type, bin_go_left) per tree; each categorical
    split's left bins become a bitset over the raw category values
    (``bin_upper`` holds each categorical bin's category id), LightGBM's
    ``cat_threshold`` layout, as the reference's ``_assemble_booster``
    builds it, refusing negative, fractional or huge category values.
    A zero-as-missing fit without categorical features stamps 6
    (default-left, zero and NaN missing) on every split."""
    num_trees = sf_all.shape[0]
    weights = (np.ones(num_trees, dtype=np.float32) if tree_weights is None
               else np.asarray(tree_weights, dtype=np.float32))
    if cfg.boosting_type == "rf" and num_trees:
        weights = weights / (num_trees / max(k, 1))
    if (cfg.early_stopping_round > 0 and best_iter >= 0
            and best_iter + 1 < num_trees // max(k, 1)):
        keep = (best_iter + 1) * k
        sf_all, tb_all = sf_all[:keep], tb_all[:keep]
        nv_all, cnt_all = nv_all[:keep], cnt_all[:keep]
        weights = weights[:keep]
        if masks is not None:
            masks = (masks[0][:keep], masks[1][:keep])
    if bin_upper is None:
        bin_upper = np.full((num_f, total_bins), np.inf)
    thr_val = np.where(sf_all >= 0,
                       bin_upper[np.maximum(sf_all, 0), tb_all], np.inf)
    dt_all = cat_bitset = None
    if masks is not None and num_trees:
        dt_all, bgl_all = masks
        thr_val = np.where(dt_all == 1, np.nan, thr_val)
        node_vals = []   # (t, m, the left set's category values)
        for t, m in np.argwhere(dt_all == 1):
            vals = bin_upper[sf_all[t, m], 1:][bgl_all[t, m, 1:]]
            vals = vals[np.isfinite(vals)]
            if vals.size and ((vals < 0).any()
                              or (vals != np.floor(vals)).any()):
                raise ValueError(
                    "categorical feature values must be non-negative "
                    "integers (index them first, e.g. ValueIndexer)")
            node_vals.append((t, m, vals.astype(np.int64)))
        max_val = max((int(v.max()) for _, _, v in node_vals if v.size),
                      default=0)
        if max_val >= 1 << 20:
            raise ValueError(
                f"categorical value {max_val} too large for bitset "
                f"representation; re-index categories to a dense range")
        cat_bitset = np.zeros(sf_all.shape + (max_val // 32 + 1,),
                              np.uint32)
        for t, m, vals in node_vals:
            np.bitwise_or.at(cat_bitset[t, m], vals // 32,
                             np.uint32(1) << (vals % 32).astype(np.uint32))
    elif cfg.zero_as_missing:
        dt_all = np.where(sf_all >= 0, 6, 0).astype(np.int8)
    booster = BoosterArrays(
        split_feature=sf_all,
        threshold_bin=tb_all,
        threshold_value=thr_val,
        node_value=nv_all,
        count=cnt_all,
        tree_weights=weights,
        max_depth=depth,
        num_features=num_f,
        num_class=k,
        objective=cfg.objective,
        init_score=base_score,
        decision_type=dt_all,
        cat_bitset=cat_bitset,
    )
    if init_model is not None:
        booster = BoosterArrays.concat(init_model, booster)
    return booster
