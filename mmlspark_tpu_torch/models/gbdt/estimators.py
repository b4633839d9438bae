"""LightGBM-parity estimators on PyTorch — the port of the JAX package's
``models/gbdt/estimators.py``: binary and multiclass classification
(``LightGBMClassifier``: multiclass, K trees per iteration, whenever the
label has more than two values), the regression objectives (L2, L1,
huber, fair, poisson, quantile, mape, gamma, tweedie) and lambdarank
ranking (``LightGBMRanker``: query groups from ``groupCol``, NDCG at
``evalAt``, ``labelGain``, ``maxPosition``).

    LightGBMClassifier(numIterations=..., ...).fit(DataFrame(
        {"features": X, "label": y})).transform(frame)
    LightGBMRanker(groupCol="query").fit(DataFrame(
        {"features": X, "label": relevance, "query": qid}))

``fit`` bins on the host (``BinMapper`` on a row sample), moves the
binned rows to the card once and trains there (``trainer.train``: the
level-histogram kernels, validation sets, early stopping, warm starts);
``transform`` scores on the card (``BoosterArrays.predict``, or
``predict_binned`` under ``binnedScoring``) and derives the reply
columns with the JAX package's numpy tail, then, where asked, the leaf
slots (``leafPredictionCol``, ``BoosterArrays.leaf_index``) and the
TreeSHAP contributions (``featuresShapCol``, ``contrib``), both as
float64; ``serving_binned_plan`` gives the serving plane
(``io/serving.py``) the same replies from pre-binned rows, and refuses
those two columns and categorical boosters with the JAX package's
reasons (such a model is served through ``transform``).

Categorical slots (``categoricalSlotIndexes``, ``categoricalSlotNames``
or the features column's metadata) bin by category and split on
category sets (``catSmooth``, ``catL2``, ``maxCatThreshold``,
``maxCatToOnehot``, ``minDataPerGroup``); ``zeroAsMissing`` maps 0.0 to
NaN before binning, at fit and wherever ``transform`` bins, and the
trees route exact zeros by their decision bits.

Stages run on the card unless ``set_device("cpu")`` is called; a fitted
model inherits the setting, a loaded one takes the card. Without a card the default raises: nothing falls back to the CPU.

A custom objective (``fobj``) is called with the fit's device tensors
(see ``trainer.train``); a numpy one converts them with
``preds.cpu().numpy()``, a sync with the card every iteration.
``checkpointDir`` + ``checkpointInterval`` train in warm-started
segments and write ``checkpoint_<n>.txt`` (the model string) with a
``.crc32`` sidecar after each; a restarted fit resumes from the newest
checkpoint whose digest verifies, and refuses a directory written for
another config or dataset (``checkpoint_meta.json``'s fingerprint, the
JAX package's digest, so a directory crosses between the packages).

Row and feature sampling train as the reference's fused step draws
them (``baggingFraction`` / ``baggingFreq``, ``posBaggingFraction`` /
``negBaggingFraction``, ``featureFraction``, ``boostingType="goss"``
and ``"rf"``; ``trainer.train``), keyed by the global iteration, so a
checkpointed or incremental fit resumed at iteration k draws what the
uninterrupted one drew.

``maxBin`` above 256 bins into uint16 ids and above 65,536 into int32
ids (``binned_ingest_dtype``), which train, transform and serve on the
card (a model whose thresholds or split features pass what a 32-bit bin
node holds scores through the scorer's wide nodes, an imported model's
derived binning too); ``monotoneConstraints``,
``extraTrees`` and ``featureFractionByNode`` train as the reference's
general split branch does, and fits without categorical slots bundle
sparse columns (``MMLSPARK_TORCH_EFB``, ``ops/efb.py``).

The param surface is the JAX package's (the same names, defaults and
validation); ``boostingType="dart"`` fits through the trainer's host
loop (a checkpointed dart fit raises the reference's ``ValueError``), and
``MMLSPARK_TORCH_GROW_POLICY=leafwise`` grows every estimator's trees
leaf-wise. ``set_mesh(mesh)`` (``parallel.mesh.create_mesh``) fits
over ``torch.distributed``: every rank of the mesh makes the same
``fit`` call on the same frame, ``parallelism`` picks the learner
(``data_parallel`` / ``serial``: rows over ``dp``; ``voting_parallel``;
``feature_parallel``: columns over ``fp``; ``trainer.train``'s
``mesh``), and the fitted model scores through
``parallel.shard_rules.ShardedScorer`` (rows over ``dp``, every rank
gets every row's scores). Settings outside the port raise
``NotImplementedError`` naming the ROADMAP item that adds them: under a
mesh, ``checkpointInterval`` (A8b).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.core.logging_utils import warn_once
from mmlspark_tpu_torch.core.param import (
    HasFeaturesCol,
    HasLabelCol,
    HasPredictionCol,
    HasWeightCol,
    Param,
    ge,
    gt,
    in_range,
    one_of,
    to_bool,
    to_float,
    to_int,
    to_list,
    to_str,
)
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.core.timer import InstrumentationMeasures
from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays, TreeScorer
from mmlspark_tpu_torch.models.gbdt.trainer import (TrainConfig,
                                                    check_supported, train,
                                                    warm_start_scores)
from mmlspark_tpu_torch.ops.binning import BinMapper
from mmlspark_tpu_torch.ops.ingest import (binned_ingest_dtype,
                                           resolve_spill_verify)
from mmlspark_tpu_torch.parallel.shard_rules import resolve_infer_autocast

# the JAX estimator's tree_learner for each parallelism. The port's
# config keeps "serial" for data_parallel (the same learner: serial
# without a mesh, data-parallel under one, ``trainer.resolve_mode``),
# and the checkpoint fingerprint takes the JAX name so a checkpoint
# directory crosses between the packages
_JAX_TREE_LEARNER = {"data_parallel": "data", "serial": "serial",
                     "voting_parallel": "voting",
                     "feature_parallel": "feature"}
_TREE_LEARNER = {**_JAX_TREE_LEARNER, "data_parallel": "serial"}
# rows scored per call of the booster in transform (rows are
# independent); bounds the device copy of the features
_SCORE_BATCH_ROWS = 1 << 21


def _cust(stage) -> Optional[Any]:
    """The stage's custom objective callable, if set (fobj param)."""
    return stage.get("fobj") if stage.is_set("fobj") else None


def _apply_pass_through(cfg: TrainConfig, args: Optional[str]) -> TrainConfig:
    """Apply LightGBM-style ``key=value`` overrides onto the config
    (the reference's passThroughArgs escape hatch, LightGBMParams
    OtherParams group). Keys are TrainConfig field names, which match
    LightGBM's snake_case option names; unknown keys raise rather than
    silently vanish."""
    if not args:
        return cfg
    import dataclasses
    fields = {f.name: f for f in dataclasses.fields(TrainConfig)}
    updates: Dict[str, Any] = {}
    for tok in args.split():
        if "=" not in tok:
            raise ValueError(f"passThroughArgs entry {tok!r} is not "
                             "key=value")
        key, val = tok.split("=", 1)
        if key not in fields:
            raise ValueError(
                f"passThroughArgs: {key!r} is not a training option "
                "this engine knows (see PARAMS.md for the parity table)")
        updates[key] = _parse_arg_value(val)
    return replace(cfg, **updates)


def _parse_arg_value(val: str) -> Any:
    """LightGBM-style literal: bool / int / float / comma list / str.
    Value-driven (not keyed off the field's current value, which may be
    None or a differently-typed default)."""
    def scalar(v):
        low = v.strip().lower()
        if low in ("true", "+"):
            return True
        if low in ("false", "-"):
            return False
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
        return v
    if "," in val:
        return tuple(scalar(v) for v in val.split(",") if v != "")
    return scalar(val)


class _LightGBMParams(HasFeaturesCol, HasLabelCol, HasWeightCol, HasPredictionCol):
    """Shared param block (params/LightGBMParams.scala:1 surface)."""

    numIterations = Param("numIterations", "number of boosting iterations",
                          to_int, ge(1), default=100)
    learningRate = Param("learningRate", "shrinkage rate", to_float, gt(0),
                         default=0.1)
    numLeaves = Param("numLeaves", "max leaves per tree", to_int, ge(2),
                      default=31)
    maxDepth = Param("maxDepth", "max tree depth (<=0 means from numLeaves)",
                     to_int, default=-1)
    maxBin = Param("maxBin", "max feature bins", to_int, ge(4), default=255)
    lambdaL1 = Param("lambdaL1", "L1 regularization", to_float, ge(0), default=0.0)
    lambdaL2 = Param("lambdaL2", "L2 regularization", to_float, ge(0), default=0.0)
    minDataInLeaf = Param("minDataInLeaf", "min rows per leaf", to_int, ge(0),
                          default=20)
    minSumHessianInLeaf = Param("minSumHessianInLeaf", "min hessian per leaf",
                                to_float, ge(0), default=1e-3)
    minGainToSplit = Param("minGainToSplit", "min split gain", to_float, ge(0),
                           default=0.0)
    featureFraction = Param("featureFraction", "feature subsample per tree",
                            to_float, in_range(0, 1, lo_inclusive=False), default=1.0)
    baggingFraction = Param("baggingFraction", "row subsample", to_float,
                            in_range(0, 1, lo_inclusive=False), default=1.0)
    baggingFreq = Param("baggingFreq", "re-bag every k iterations", to_int,
                        ge(0), default=0)
    baggingSeed = Param("baggingSeed", "bagging seed", to_int, default=3)
    featureFractionSeed = Param("featureFractionSeed",
                                "feature-subsampling seed", to_int,
                                default=2)
    extraSeed = Param("extraSeed", "extra_trees threshold seed", to_int,
                      default=6)
    posBaggingFraction = Param("posBaggingFraction", "bagging rate for "
                               "positive binary rows", to_float,
                               in_range(0, 1, lo_inclusive=False), default=1.0)
    negBaggingFraction = Param("negBaggingFraction", "bagging rate for "
                               "negative binary rows", to_float,
                               in_range(0, 1, lo_inclusive=False), default=1.0)
    pathSmooth = Param("pathSmooth", "smooth child outputs toward the "
                       "parent by n/(n+pathSmooth)", to_float, ge(0),
                       default=0.0)
    maxDeltaStep = Param("maxDeltaStep", "clamp |leaf output| (0 = off)",
                         to_float, ge(0), default=0.0)
    extraTrees = Param("extraTrees", "evaluate one random threshold per "
                       "node/feature (extremely randomized trees)",
                       to_bool, default=False)
    boostingType = Param("boostingType", "gbdt | rf | dart | goss", to_str,
                         one_of("gbdt", "rf", "dart", "goss"), default="gbdt")
    topRate = Param("topRate", "GOSS large-gradient keep rate", to_float,
                    in_range(0, 1), default=0.2)
    otherRate = Param("otherRate", "GOSS small-gradient sample rate", to_float,
                      in_range(0, 1), default=0.1)
    dropRate = Param("dropRate", "DART tree drop rate", to_float, in_range(0, 1),
                     default=0.1)
    skipDrop = Param("skipDrop", "DART skip-drop prob", to_float, in_range(0, 1),
                     default=0.5)
    earlyStoppingRound = Param("earlyStoppingRound",
                               "stop after n rounds w/o improvement (0=off)",
                               to_int, ge(0), default=0)
    validationIndicatorCol = Param("validationIndicatorCol",
                                   "bool column marking validation rows", to_str)
    categoricalSlotIndexes = Param("categoricalSlotIndexes",
                                   "indices of categorical features",
                                   to_list(to_int))
    categoricalSlotNames = Param("categoricalSlotNames",
                                 "slot names of categorical features "
                                 "(resolved via the features column's "
                                 "slot metadata)", to_list(to_str))
    catSmooth = Param("catSmooth", "categorical smoothing added to the "
                      "per-bin hessian in the sort ratio", to_float, ge(0),
                      default=10.0)
    catL2 = Param("catL2", "extra L2 for categorical splits", to_float,
                  ge(0), default=10.0)
    maxCatThreshold = Param("maxCatThreshold", "max categories on the "
                            "scanned side of a categorical split", to_int,
                            gt(0), default=32)
    maxCatToOnehot = Param("maxCatToOnehot", "use one-vs-rest splits when "
                           "a node has at most this many used categories",
                           to_int, gt(0), default=4)
    monotoneConstraints = Param(
        "monotoneConstraints", "per-feature -1/0/+1 monotone direction "
        "(LightGBM monotone_constraints, basic method)", to_list(to_int))
    checkpointDir = Param(
        "checkpointDir", "directory for mid-training model-string "
        "checkpoints; a restarted fit resumes from the latest one "
        "(elastic restart, SURVEY.md §5 checkpoint/resume)", to_str)
    checkpointInterval = Param(
        "checkpointInterval", "save a checkpoint every n iterations "
        "(0 = off; requires checkpointDir)", to_int, ge(0), default=0)
    minDataInBin = Param("minDataInBin", "min sampled rows per feature bin",
                         to_int, gt(0), default=3)
    maxDrop = Param("maxDrop", "DART: max trees dropped per iteration "
                    "(<=0 = unlimited)", to_int, default=50)
    uniformDrop = Param("uniformDrop", "DART: drop trees uniformly instead "
                        "of weight-proportionally", to_bool, default=False)
    dropSeed = Param("dropSeed", "DART: seed of the drop-selection RNG "
                     "stream (default derived from seed)", to_int)
    featureFractionByNode = Param(
        "featureFractionByNode", "re-sample the feature subset at every "
        "tree node (LightGBM feature_fraction_bynode)", to_float,
        in_range(0, 1, lo_inclusive=False), default=1.0)
    improvementTolerance = Param(
        "improvementTolerance", "early stopping: margin an eval score "
        "must clear to count as improved (TrainUtils.scala:143-169)",
        to_float, default=0.0)
    minDataPerGroup = Param(
        "minDataPerGroup", "min rows per category for the sorted "
        "categorical scan (LightGBM min_data_per_group)", to_int, gt(0),
        default=100)
    initScoreCol = Param(
        "initScoreCol", "column of per-row initial scores to boost from "
        "(LightGBM init_score; scores are a training offset and are NOT "
        "added back at predict, matching LightGBM)", to_str)
    boostFromAverage = Param(
        "boostFromAverage", "start boosting from the objective's average "
        "score instead of 0", to_bool, default=True)
    deterministic = Param(
        "deterministic", "deterministic training (always true on this "
        "engine: the histograms sum in fixed point or integers)", to_bool,
        default=True)
    monotoneConstraintsMethod = Param(
        "monotoneConstraintsMethod", "constraint enforcement method; this "
        "engine implements LightGBM's 'basic'",
        to_str, one_of("basic"), default="basic")
    zeroAsMissing = Param(
        "zeroAsMissing", "treat 0.0 feature values as missing (LightGBM "
        "zero_as_missing; stamps zero-missing decision bits so scoring "
        "routes zeros like NaN)", to_bool, default=False)
    maxBinByFeature = Param(
        "maxBinByFeature", "per-feature max bin counts overriding maxBin",
        to_list(to_int))
    binSampleCount = Param(
        "binSampleCount", "rows sampled to compute bin boundaries",
        to_int, gt(0), default=200_000)
    fobj = Param(
        "fobj", "custom objective callable (preds, labels, weights) -> "
        "(grad, hess) (FObjTrait.scala:1 analog); called with the fit's "
        "device tensors (float32 preds and labels, weights or None), it "
        "may return tensors or array-likes; a numpy objective uses "
        "preds.cpu().numpy(), which syncs with the card every iteration",
        is_complex=True)
    isProvideTrainingMetric = Param(
        "isProvideTrainingMetric", "training metrics are always recorded "
        "here (train_<metric> series in evals_result); declared for "
        "parity", to_bool, default=False)
    passThroughArgs = Param(
        "passThroughArgs", "space-separated LightGBM-style key=value "
        "overrides applied onto the training config after the typed "
        "params (snake_case LightGBM names)", to_str)
    objective = Param("objective", "training objective", to_str)
    metric = Param("metric", "eval metric (default per objective)", to_str)
    modelString = Param("modelString", "warm-start model string", to_str)
    parallelism = Param("parallelism", "data_parallel | voting_parallel | "
                        "feature_parallel | serial", to_str,
                        one_of("data_parallel", "voting_parallel",
                               "feature_parallel", "serial"),
                        default="data_parallel")
    topK = Param("topK", "voting_parallel local vote size "
                 "(LightGBMConstants.scala:22-24)", to_int, gt(0),
                 default=20)
    useBarrierExecutionMode = Param("useBarrierExecutionMode",
                                    "gang scheduling (one device here; "
                                    "accepted for parity)",
                                    to_bool, default=False)
    numBatches = Param("numBatches", "split training into n sequential "
                       "batches, warm-starting each (LightGBMBase.scala:45-60)",
                       to_int, ge(0), default=0)
    seed = Param("seed", "random seed", to_int, default=0)
    verbosity = Param("verbosity", "verbosity", to_int, default=-1)
    leafPredictionCol = Param("leafPredictionCol",
                              "output col for per-tree leaf indices", to_str)
    featuresShapCol = Param("featuresShapCol",
                            "output col for per-feature contributions", to_str)
    predictDisableShapeCheck = Param("predictDisableShapeCheck",
                                     "skip feature-count check at predict",
                                     to_bool, default=False)

    def _train_config(self, objective: str,
                      categorical_features: List[int] = (),
                      **extra: Any) -> TrainConfig:
        """The JAX package's param -> ``TrainConfig`` mapping;
        ``parallelism`` picks the tree learner (without a mesh every one
        trains serially, as in the JAX package)."""
        return TrainConfig(
            objective=objective,
            num_iterations=self.get("numIterations"),
            learning_rate=self.get("learningRate"),
            num_leaves=self.get("numLeaves"),
            max_depth=(self.get("maxDepth") if self.get("maxDepth") > 0
                       else 16),
            max_bin=self.get("maxBin"),
            lambda_l1=self.get("lambdaL1"),
            lambda_l2=self.get("lambdaL2"),
            min_data_in_leaf=self.get("minDataInLeaf"),
            min_sum_hessian_in_leaf=self.get("minSumHessianInLeaf"),
            min_gain_to_split=self.get("minGainToSplit"),
            feature_fraction=self.get("featureFraction"),
            bagging_fraction=self.get("baggingFraction"),
            bagging_freq=self.get("baggingFreq"),
            boosting_type=self.get("boostingType"),
            top_rate=self.get("topRate"),
            other_rate=self.get("otherRate"),
            drop_rate=self.get("dropRate"),
            skip_drop=self.get("skipDrop"),
            early_stopping_round=self.get("earlyStoppingRound"),
            metric=self.get("metric"),
            categorical_features=tuple(categorical_features),
            cat_smooth=self.get("catSmooth"),
            cat_l2=self.get("catL2"),
            max_cat_threshold=self.get("maxCatThreshold"),
            max_cat_to_onehot=self.get("maxCatToOnehot"),
            monotone_constraints=tuple(self.get("monotoneConstraints")
                                       or ()),
            pos_bagging_fraction=self.get("posBaggingFraction"),
            neg_bagging_fraction=self.get("negBaggingFraction"),
            path_smooth=self.get("pathSmooth"),
            max_delta_step=self.get("maxDeltaStep"),
            extra_trees=self.get("extraTrees"),
            tree_learner=_TREE_LEARNER[self.get("parallelism")],
            top_k=self.get("topK"),
            seed=self.get("seed"),
            max_drop=self.get("maxDrop"),
            uniform_drop=self.get("uniformDrop"),
            drop_seed=(self.get("dropSeed")
                       if self.is_set("dropSeed") else None),
            feature_fraction_by_node=self.get("featureFractionByNode"),
            improvement_tolerance=self.get("improvementTolerance"),
            min_data_per_group=self.get("minDataPerGroup"),
            min_data_in_bin=self.get("minDataInBin"),
            bagging_seed=self.get("baggingSeed"),
            feature_fraction_seed=self.get("featureFractionSeed"),
            extra_seed=self.get("extraSeed"),
            boost_from_average=self.get("boostFromAverage"),
            deterministic=self.get("deterministic"),
            zero_as_missing=self.get("zeroAsMissing"),
            **extra,
        )

    # -- device -------------------------------------------------------------
    _device: DeviceLike = None

    def set_device(self, device: DeviceLike):
        """Where ``fit`` / ``transform`` run: ``None`` (the default) is
        the CUDA card, ``"cpu"`` the plain PyTorch path. Not a param, so
        it stays out of the saved param map; ``copy`` keeps it and a
        fitted model inherits it."""
        self._device = device
        return self

    def resolved_device(self):
        """The ``torch.device`` this stage runs on; raises
        ``DeviceUnavailable`` where that is the card and there is none."""
        return resolve_device(self._device)

    _mesh = None
    _scorer = None

    def set_mesh(self, mesh):
        """Fit (or score) over ``mesh`` (``parallel.mesh.create_mesh``):
        every rank of the mesh makes the same calls. A fitted model
        inherits the estimator's mesh. Not a param: ``copy`` keeps it,
        the saved param map does not."""
        from mmlspark_tpu_torch.parallel.mesh import Mesh
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(f"set_mesh takes a parallel.mesh.Mesh "
                            f"(create_mesh) or None, got "
                            f"{type(mesh).__name__}")
        self._mesh = mesh
        self._scorer = None
        return self


class _LightGBMBase(Estimator, _LightGBMParams):
    """Shared fit orchestration (LightGBMBase.train analog,
    lightgbm/.../LightGBMBase.scala:36-65)."""

    def fit_incremental(self, df: DataFrame, base_model=None,
                        num_new_trees: Optional[int] = None,
                        checkpoint_dir: Optional[str] = None,
                        checkpoint_interval: Optional[int] = None):
        """Warm-start refit: continue ``base_model`` with new trees fit
        on ``df`` (the reference's modelString warm start,
        LightGBMBase.scala:45-60, as a method). ``base_model=None`` fits
        from scratch, still honoring the checkpoint args.
        ``num_new_trees`` overrides ``numIterations`` for the added
        trees. ``checkpoint_dir`` + ``checkpoint_interval`` (default 1)
        thread through the estimator's checkpointed fit: a refit killed
        mid-flight and re-run resumes from the latest
        ``checkpoint_N.txt`` segment bitwise. The estimator itself is not
        mutated — overrides ride a :meth:`copy`."""
        overrides: Dict[str, Any] = {}
        if base_model is not None:
            if base_model.booster is None:
                raise ValueError("fit_incremental: base_model has no "
                                 "fitted booster")
            overrides["modelString"] = base_model.get_model_string()
        if num_new_trees is not None:
            overrides["numIterations"] = num_new_trees
        if checkpoint_dir is not None:
            overrides["checkpointDir"] = checkpoint_dir
            overrides["checkpointInterval"] = (checkpoint_interval
                                               or 1)
        return self.copy(**overrides).fit(df)

    def _extract(self, df: DataFrame):
        x = np.asarray(df.col(self.get("featuresCol")), dtype=np.float64)
        if x.ndim != 2:
            raise ValueError(f"featuresCol {self.get('featuresCol')!r} must "
                             f"be a vector column")
        y = np.asarray(df.col(self.get("labelCol")), dtype=np.float64)
        w = None
        if self.is_set("weightCol"):
            w = np.asarray(df.col(self.get("weightCol")), dtype=np.float64)
        return x, y, w

    def _split_validation(self, df: DataFrame):
        if self.is_set("validationIndicatorCol"):
            mask = np.asarray(df.col(self.get("validationIndicatorCol")), dtype=bool)
            return df.filter(~mask), df.filter(mask)
        return df, None

    def _categorical_indexes(self, df: DataFrame) -> List[int]:
        """Resolve categorical feature slots: explicit indexes, then
        names via slot metadata, then the features column's
        Categoricals metadata (getCategoricalIndexes analog)."""
        out = set(self.get("categoricalSlotIndexes") or [])
        meta = df.metadata(self.get("featuresCol"))
        if self.is_set("categoricalSlotNames"):
            slots = meta.get("slots")
            if slots is None:
                raise ValueError(
                    "categoricalSlotNames needs slot metadata on the "
                    "features column (assemble with VectorAssembler)")
            by_name = {n: i for i, n in enumerate(slots)}
            for name in self.get("categoricalSlotNames"):
                if name not in by_name:
                    raise ValueError(f"no feature slot named {name!r}; "
                                     f"have {slots}")
                out.add(by_name[name])
        out.update(meta.get("categorical_slots") or [])
        return sorted(out)

    def _fit_booster(self, df: DataFrame, objective: str,
                     extra_cfg: Optional[Dict[str, Any]] = None,
                     num_class: int = 1, group_col: Optional[str] = None):
        """Bin, then train on the stage's device: returns (TrainResult,
        BinMapper, InstrumentationMeasures with the phases extract,
        binning, and train's dataPreparation / training / validation).
        ``num_class``: K of a multiclass objective; ``group_col``: the
        query-id column, encoded per set after the validation split
        (dense ids in sorted order), as the JAX package encodes it."""
        device = resolve_device(self._device)
        measures = InstrumentationMeasures()
        cat = self._categorical_indexes(df)
        cfg = self._train_config(objective, categorical_features=cat,
                                 num_class=num_class, **(extra_cfg or {}))
        # pass-through overrides land BEFORE binning, so binning-coupled
        # keys (max_bin, min_data_in_bin) take effect everywhere
        cfg = _apply_pass_through(cfg, self.get("passThroughArgs")
                                  if self.is_set("passThroughArgs") else None)
        check_supported(cfg)      # before any work on the rows
        with measures.phase("extract"):
            train_df, valid_df = self._split_validation(df)
            x, y, w = self._extract(train_df)
            group_ids = vgroup_ids = None
            if group_col is not None:
                # encoded on the rows after the split, so they stay
                # aligned with each set's bins and labels
                group_ids = _encode_groups(train_df, group_col)
                if valid_df is not None and valid_df.num_rows:
                    vgroup_ids = _encode_groups(valid_df, group_col)
            if cfg.zero_as_missing:
                # LightGBM zero_as_missing: zeros enter the missing bin;
                # the trees' decision bits (6) route them at scoring
                x = np.where(x == 0.0, np.nan, x)
        with measures.phase("binning"):
            mapper = BinMapper.fit(
                _sample_rows(x, self.get("seed"),
                             max_sample=self.get("binSampleCount")),
                max_bin=cfg.max_bin,
                categorical_features=cat,
                min_data_in_bin=cfg.min_data_in_bin,
                max_bin_by_feature=(self.get("maxBinByFeature")
                                    if self.is_set("maxBinByFeature")
                                    else None))
            # the narrowest bin ids, written so by the C++ binning
            ids = binned_ingest_dtype(mapper.max_num_bins)
            binned = mapper.transform(x, ids)
        valid_sets = vx_raw = None
        if valid_df is not None and valid_df.num_rows:
            with measures.phase("extract"):
                vx_raw, vy, vw = self._extract(valid_df)
                if cfg.zero_as_missing:
                    vx_raw = np.where(vx_raw == 0.0, np.nan, vx_raw)
            with measures.phase("binning"):
                valid_sets = [(mapper.transform(vx_raw, ids), vy, vw,
                               vgroup_ids)]
        init_model = None
        if self.is_set("modelString"):
            init_model = BoosterArrays.load_model_string(self.get("modelString"))

        init0 = vinit0 = None
        if self.is_set("initScoreCol"):
            # per-row training offset (LightGBM init_score via
            # HasInitScoreCol, LightGBMBase.scala:153); must align with
            # the post-validation-split training rows
            init0 = np.asarray(train_df.col(self.get("initScoreCol")),
                               dtype=np.float64)
            k_out = cfg.num_trees_per_iteration
            if k_out > 1 and (init0.ndim != 2 or init0.shape[1] != k_out):
                raise ValueError(
                    f"initScoreCol {self.get('initScoreCol')!r} must hold "
                    f"(N, {k_out}) per-class scores for a {k_out}-class "
                    f"objective; got shape {init0.shape}")
            if valid_sets is not None:
                vinit0 = np.asarray(valid_df.col(self.get("initScoreCol")),
                                    dtype=np.float64)

        def init_scores(model, xs, offset):
            return warm_start_scores(model, xs, offset, device=device)

        def valid_init_raws(model):
            if vx_raw is None or (model is None and vinit0 is None):
                return None
            return [init_scores(model, vx_raw, vinit0)]

        bin_upper = mapper.bin_upper_values(cfg.max_bin)
        fobj = _cust(self)
        num_batches = self.get("numBatches")
        ckpt_every = self.get("checkpointInterval")
        if ckpt_every and num_batches and num_batches > 1:
            raise ValueError(
                "checkpointInterval does not compose with numBatches "
                "(sequential data batches already warm-start); use one "
                "or the other")
        if num_batches and num_batches > 1:
            # sequential warm-started batches (LightGBMBase.scala:45-60)
            parts = np.array_split(np.arange(len(binned)), num_batches)
            result = None
            for part in parts:
                result = train(
                    binned[part], y[part], cfg,
                    weights=None if w is None else w[part],
                    group_ids=None if group_ids is None else group_ids[part],
                    bin_upper=bin_upper, valid_sets=valid_sets,
                    init_model=init_model,
                    init_raw=init_scores(
                        init_model, x[part],
                        None if init0 is None else init0[part]),
                    valid_init_raws=valid_init_raws(init_model),
                    measures=measures, device=device,
                    custom_objective=fobj, mesh=self._mesh)
                init_model = result.booster
        elif ckpt_every:
            result = self._fit_checkpointed(
                cfg, binned, y, w, bin_upper, init0, init_model,
                lambda model, done, seg_cfg: train(
                    binned, y, seg_cfg, weights=w, group_ids=group_ids,
                    bin_upper=bin_upper,
                    valid_sets=valid_sets, init_model=model,
                    init_raw=init_scores(model, x, init0),
                    valid_init_raws=valid_init_raws(model),
                    measures=measures, device=device,
                    custom_objective=fobj, iteration_offset=done,
                    mesh=self._mesh),
                group_ids)
        else:
            result = train(
                binned, y, cfg, weights=w, group_ids=group_ids,
                bin_upper=bin_upper,
                valid_sets=valid_sets, init_model=init_model,
                init_raw=init_scores(init_model, x, init0),
                valid_init_raws=valid_init_raws(init_model),
                measures=measures, device=device, custom_objective=fobj,
                mesh=self._mesh)
        return result, mapper, measures

    def _fit_checkpointed(self, cfg, binned, y, w, bin_upper, init0,
                          init_model, train_segment, group_ids=None):
        """Mid-training checkpoints and elastic restart (the JAX
        estimator's checkpointed fit): train in warm-started segments of
        ``checkpointInterval`` trees, ``train_segment(model, done,
        seg_cfg)``, persisting the model string after each; a restarted
        fit resumes from the newest verified checkpoint. A segment's warm
        start scores the raw rows (``warm_start_scores``), so a
        checkpointed fit can differ from a monolithic one on rows whose
        value is a float32-rounded bin edge (ROADMAP C3); a killed and
        resumed fit equals the uninterrupted one with the same interval
        bitwise. A ranker's fingerprint also covers its group ids (the
        JAX package's leaves them out, so a ranker's directory does not
        cross between the packages; every other fit's does)."""
        import json
        import os
        import zlib

        from mmlspark_tpu_torch.core.serialize import atomic_write

        if self._mesh is not None:
            # every rank would write and resume the same directory on its
            # own: ranks could resume at other iterations and their
            # collectives would no longer match
            from mmlspark_tpu_torch.models.gbdt.parallel_modes import A8B
            raise NotImplementedError(
                f"checkpointInterval under a mesh is not in the port yet "
                f"({A8B})")
        if not self.is_set("checkpointDir"):
            raise ValueError("checkpointInterval requires checkpointDir")
        if self.get("earlyStoppingRound"):
            raise ValueError(
                "checkpointing does not compose with early stopping: "
                "the no-improve counter cannot span warm-started "
                "segments — drop earlyStoppingRound or "
                "checkpointInterval")
        if self.get("boostingType") == "dart":
            raise ValueError(
                "checkpointing does not compose with DART: trees "
                "frozen into a checkpoint can no longer be dropped "
                "or renormalized — drop boostingType='dart' or "
                "checkpointInterval")
        ckpt_every = self.get("checkpointInterval")
        ckpt_dir = self.get("checkpointDir")
        os.makedirs(ckpt_dir, exist_ok=True)
        done = 0
        latest = self._latest_checkpoint(ckpt_dir)
        total = cfg.num_iterations
        # A checkpoint is only resumable into the run that produced it:
        # stamp a config/data digest and refuse a mismatched warm start.
        fprint = self._checkpoint_fingerprint(
            replace(cfg, tree_learner=_JAX_TREE_LEARNER[
                self.get("parallelism")]),
            binned, y, w, bin_upper, init0, init_model, group_ids)
        meta_path = os.path.join(ckpt_dir, "checkpoint_meta.json")
        if latest is not None and os.path.exists(meta_path):
            with open(meta_path) as fh:
                stored = json.load(fh).get("fingerprint")
            if stored != fprint:
                raise ValueError(
                    f"checkpoints in {ckpt_dir} were produced by a "
                    "different config or dataset (fingerprint "
                    f"{stored!r} != {fprint!r}); clear the "
                    "directory to train fresh")
        else:
            # fresh dir, or a pre-fingerprint checkpoint dir: absence is
            # not evidence of mismatch — backfill
            try:
                atomic_write(meta_path, json.dumps({"fingerprint": fprint}))
            except OSError as e:
                # a broken store never kills the fit
                warn_once(
                    "gbdt.checkpoint_skip",
                    "checkpoint fingerprint write failed (%s: %s); "
                    "continuing WITHOUT checkpoints this run",
                    type(e).__name__, e)
        if latest is not None:
            done, path = latest
            if done > total:
                raise ValueError(
                    f"checkpoint at iteration {done} in {ckpt_dir} "
                    f"exceeds numIterations={total}; clear the "
                    f"directory or raise numIterations")
            with open(path) as fh:
                init_model = BoosterArrays.load_model_string(fh.read())
        result = None
        while done < total or result is None:
            seg = min(ckpt_every, total - done)
            result = train_segment(init_model,
                                   done, replace(cfg, num_iterations=seg))
            init_model = result.booster
            done += seg
            try:
                model_str = result.booster.save_model_string()
                atomic_write(
                    os.path.join(ckpt_dir, f"checkpoint_{done}.txt"),
                    model_str)
                # digest sidecar AFTER the payload: a crash in between
                # leaves a checkpoint without a digest, which resume
                # accepts unverified rather than discarding progress
                atomic_write(
                    os.path.join(ckpt_dir, f"checkpoint_{done}.txt.crc32"),
                    f"{zlib.crc32(model_str.encode()) & 0xFFFFFFFF:08x}")
            except OSError as e:
                # a failing store (full disk, flaky mount) must not kill
                # a healthy fit: restart depth just shrinks
                warn_once(
                    "gbdt.checkpoint_skip",
                    "checkpoint write at iteration %s failed "
                    "(%s: %s); continuing WITHOUT this checkpoint "
                    "— a crash now restarts from the previous one",
                    done, type(e).__name__, e)
        return result

    @staticmethod
    def _checkpoint_fingerprint(cfg, binned, y, w, bin_upper, init0=None,
                                init_model=None, group_ids=None):
        """Digest of everything a warm start must agree on — the JAX
        estimator's, byte for byte, so either package resumes the other's
        checkpoint directory.

        ``num_iterations`` is deliberately excluded: resuming with a
        raised iteration budget is the supported elastic-restart path
        (guarded separately by the done>total check). ``init_model``
        (the modelString warm-start base, fit_incremental) IS included.
        The bin ids are hashed as int32, the width of the JAX package's
        ``BinMapper.transform``, whatever width they were binned to.
        """
        import hashlib
        from dataclasses import asdict

        cfg_items = {k: v for k, v in sorted(asdict(cfg).items())
                     if k != "num_iterations"}
        h = hashlib.sha256(repr(cfg_items).encode())
        if init_model is not None:
            h.update(init_model.save_model_string().encode())
        h.update(repr(binned.shape).encode())
        # cheap data digest: corner slices + moments, not a full pass
        h.update(np.ascontiguousarray(binned[:64], np.int32).tobytes())
        h.update(np.ascontiguousarray(binned[-64:], np.int32).tobytes())
        # binned codes are scale-invariant (quantile bins move with the
        # data); the bin boundaries anchor the digest to the raw values
        h.update(np.ascontiguousarray(bin_upper, np.float64).tobytes())
        h.update(np.asarray(
            [float(np.sum(y)), float(len(y)),
             0.0 if w is None else float(np.sum(w)),
             0.0 if init0 is None else float(np.sum(init0))]).tobytes())
        if group_ids is not None:
            h.update(np.ascontiguousarray(group_ids, np.int32).tobytes())
        return h.hexdigest()[:16]

    @staticmethod
    def _latest_checkpoint(ckpt_dir):
        """Newest segment checkpoint whose crc32 sidecar verifies, as
        ``(iterations, path)``, or None.

        A checkpoint failing its digest (silent bit-rot) is skipped
        with an attributed warn-once and the scan falls back one
        generation. Sidecar-less checkpoints (a crash between payload
        and sidecar) are accepted unverified;
        ``MMLSPARK_TORCH_SPILL_VERIFY=off`` skips the check entirely."""
        import os
        import re
        import zlib

        cands = []
        if os.path.isdir(ckpt_dir):
            for name in os.listdir(ckpt_dir):
                m = re.fullmatch(r"checkpoint_(\d+)\.txt", name)
                if m:
                    cands.append((int(m.group(1)),
                                  os.path.join(ckpt_dir, name)))
        verify = resolve_spill_verify() != "off"
        for done, path in sorted(cands, reverse=True):
            if not verify:
                return (done, path)
            try:
                with open(path + ".crc32") as fh:
                    stored = fh.read().strip()
            except OSError:
                return (done, path)
            try:
                with open(path, "rb") as fh:
                    actual = f"{zlib.crc32(fh.read()) & 0xFFFFFFFF:08x}"
            except OSError as e:
                warn_once(f"gbdt.checkpoint_bitrot.{path}",
                          "checkpoint %s unreadable (%s: %s); resuming "
                          "from the previous one", path,
                          type(e).__name__, e)
                continue
            if actual != stored:
                warn_once(f"gbdt.checkpoint_bitrot.{path}",
                          "checkpoint %s fails its crc32 digest "
                          "(sidecar %s, on disk %s) — silent bit-rot; "
                          "resuming from the previous checkpoint", path,
                          stored, actual)
                continue
            return (done, path)
        return None

    def _finish_model(self, model_cls, result, mapper, measures):
        model = model_cls(**{k: v for k, v in self._paramMap.items()
                             if model_cls.has_param(k)})
        model.booster = result.booster
        model.bin_mapper = mapper
        model._device = self._device
        model._mesh = self._mesh
        model.train_measures = measures
        model.evals_result = result.evals
        model.best_iteration = result.best_iteration
        return model


class BinnedServingUnsupported(RuntimeError):
    """The model cannot take the binned serving data plane; the message
    is the downgrade reason the server records in ``/healthz``."""


@dataclass
class ServingBinnedPlan:
    """Everything the serving data plane needs to score pre-binned rows
    as ``transform`` does (``_LightGBMModelBase.serving_binned_plan``).
    ``bin_rows`` runs on request threads (the C++ binning, thread-safe);
    ``score`` is the binned scorer (``booster.TreeScorer``: one thread,
    padded bucket shapes; it returns a tensor on the model's device, or
    scores a staged batch in place); ``finish`` turns float32
    margins into the ordered reply columns ``transform`` would have
    appended."""

    bin_rows: Callable[[np.ndarray], np.ndarray]
    score: TreeScorer
    finish: Callable[[np.ndarray], Dict[str, np.ndarray]]
    ingest_dtype: Any
    num_features: int
    features_col: str
    # the MMLSPARK_TORCH_INFER_AUTOCAST policy the scorer was built under
    autocast: str = "off"


class _LightGBMModelBase(Model, _LightGBMParams):
    """Shared transform/scoring (LightGBMModelMethods analog)."""

    startIteration = Param(
        "startIteration", "score with trees from this boosting "
        "iteration on (LightGBM predict start_iteration)", to_int,
        ge(0), default=0)
    numIteration = Param(
        "numIteration", "score with at most this many iterations from "
        "startIteration (<0 = all; LightGBM predict num_iteration)",
        to_int, default=-1)

    binnedScoring = Param(
        "binnedScoring", "route transform through the binned-compare "
        "scorer (bin with the training BinMapper, then compare uint8, "
        "uint16 or int32 bin ids instead of float thresholds). Binned "
        "scoring "
        "routes by the float64 bin edge, raw scoring by its float32 "
        "rounding (ROADMAP C8), so the two can differ on rows holding such "
        "a value", to_bool, default=False)

    booster: Optional[BoosterArrays] = None
    bin_mapper: Optional[BinMapper] = None   # training BinMapper, persisted
    train_measures: Optional[InstrumentationMeasures] = None
    evals_result: Optional[List[Dict[str, float]]] = None
    best_iteration: int = -1
    _sliced_cache = None

    @property
    def scoring_booster(self) -> BoosterArrays:
        """The booster restricted to [startIteration,
        startIteration+numIteration) — the full ensemble when the
        params are at their defaults."""
        s = self.get("startIteration")
        m = self.get("numIteration")
        if s == 0 and m <= 0:
            # LightGBM predict semantics: num_iteration <= 0 means all
            return self.booster
        key = (s, m)
        if (self._sliced_cache is None or self._sliced_cache[0] != key
                or self._sliced_cache[1] is not self.booster):
            self._sliced_cache = (
                key, self.booster, self.booster.slice_iterations(s, m))
        return self._sliced_cache[2]

    def _raw_scores(self, x: np.ndarray) -> np.ndarray:
        """Margin scores (float32) on the model's device, in row batches:
        the binned-compare path when ``binnedScoring`` is on and the
        model carries its training BinMapper (bin ids route as raw
        thresholds do, NaN included, except on values at a float32-rounded
        edge: ROADMAP C8), else the float-threshold traversal."""
        device = resolve_device(self._device)
        b = self.scoring_booster
        zmode = b.zero_premap_mode
        binned = (self.get("binnedScoring") and self.bin_mapper is not None
                  and b.supports_binned and zmode != "unsupported")

        def score(xs):
            if binned:
                if zmode == "all_left":
                    # a zero-as-missing fit binned 0.0 as NaN: so does
                    # scoring
                    xs = np.where(xs == 0.0, np.nan, xs)
                return b.predict_binned(
                    self.bin_mapper.transform(xs, binned_ingest_dtype(
                        self.bin_mapper.max_num_bins)), device=device)
            return b.predict(xs, device=device)

        if self._mesh is None:
            return np.concatenate([
                score(x[s:s + _SCORE_BATCH_ROWS]).cpu().numpy()
                for s in range(0, max(len(x), 1), _SCORE_BATCH_ROWS)])
        from mmlspark_tpu_torch.parallel.shard_rules import ShardedScorer
        self._scorer = ShardedScorer(score, self._mesh,
                                     max_batch=_SCORE_BATCH_ROWS)
        return self._scorer(x)

    def shard_metadata(self) -> Dict[str, Any]:
        """How ``transform`` places its rows (the reference's
        ``shard_metadata``): the last scorer's mode ("rules" under a
        mesh, else "serial"), reason, family, dp and the rungs used."""
        from mmlspark_tpu_torch.parallel.shard_rules import ShardedScorer
        return (self._scorer or ShardedScorer(
            None, self._mesh, max_batch=_SCORE_BATCH_ROWS)).metadata()

    def _init_empty(self):
        self.booster = None

    def _get_state(self) -> Dict[str, Any]:
        state = self.booster.state_dict()
        state["best_iteration"] = self.best_iteration
        if self.bin_mapper is not None:
            state["bin_mapper"] = self.bin_mapper.to_dict()
        return state

    def _set_state(self, state: Dict[str, Any]) -> None:
        self.booster = BoosterArrays.from_state_dict(state)
        self.best_iteration = state.get("best_iteration", -1)
        bm = state.get("bin_mapper")
        self.bin_mapper = None if bm is None else BinMapper.from_dict(bm)

    # -- reference model methods -------------------------------------------
    def get_feature_importances(self, importance_type: str = "split") -> np.ndarray:
        return self.booster.feature_importances(importance_type)

    def get_all_instrumentation(self) -> Dict[str, float]:
        """Per-phase training wall-clock seconds (getAllBatchMeasures
        analog, LightGBMPerformance.scala:11-66)."""
        if self.train_measures is None:
            return {}
        return self.train_measures.as_dict()

    def save_native_model(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.booster.save_model_string())

    def get_model_string(self) -> str:
        return self.booster.save_model_string()

    @classmethod
    def load_native_model_from_file(cls, path: str, **params: Any):
        with open(path) as f:
            return cls.load_native_model_from_string(f.read(), **params)

    @classmethod
    def load_native_model_from_string(cls, text: str, **params: Any):
        model = cls(**params)
        model.booster = BoosterArrays.load_model_string(text)
        return model

    def serving_binned_plan(self) -> ServingBinnedPlan:
        """The serving data plane for this model, or
        :class:`BinnedServingUnsupported` with the reason.

        Trained models (``bin_mapper`` persisted) bin through the
        training BinMapper with the booster's ``zero_premap_mode``
        applied; imported model strings (raw thresholds only) recover a
        binning from their own splits (``derive_binning``). Rows move at
        the narrowest ingest dtype and route as the JAX plan's do. The
        scorer runs on the model's device (the card unless
        ``set_device("cpu")``); a missing card raises
        ``DeviceUnavailable``, which is not a reason to downgrade.
        ``MMLSPARK_TORCH_INFER_AUTOCAST=bf16`` keeps the leaf table in
        bfloat16 (``BoosterArrays.predict_binned_scorer``)."""
        if self.booster is None:
            raise BinnedServingUnsupported("model has no fitted booster")
        if self.is_set("leafPredictionCol") or self.is_set("featuresShapCol"):
            raise BinnedServingUnsupported(
                "leafPredictionCol/featuresShapCol require raw features")
        device = self.resolved_device()
        b = self.scoring_booster
        autocast = resolve_infer_autocast()
        features_col = self.get("featuresCol")
        expected_f = self.booster.num_features
        check_shape = not self.get("predictDisableShapeCheck")

        def _check(x: np.ndarray) -> np.ndarray:
            x = np.asarray(x, dtype=np.float64)
            if check_shape and x.shape[1] != expected_f:
                raise ValueError(
                    f"feature count mismatch: model has {expected_f},"
                    f" data has {x.shape[1]}")
            return x

        if self.bin_mapper is not None:
            if not b.supports_binned:
                raise BinnedServingUnsupported(
                    "booster does not support binned routing "
                    "(categorical splits or missing bin thresholds)")
            zmode = b.zero_premap_mode
            if zmode == "unsupported":
                raise BinnedServingUnsupported(
                    "mixed per-node zero-as-missing semantics cannot be "
                    "expressed as per-feature bin ids")
            mapper = self.bin_mapper
            dtype = binned_ingest_dtype(mapper.max_num_bins)

            def bin_rows(x: np.ndarray) -> np.ndarray:
                x = _check(x)
                if zmode == "all_left":
                    # a zero-as-missing fit mapped 0.0 -> NaN before
                    # binning; scoring bins through the same premap
                    x = np.where(x == 0.0, np.nan, x)
                return mapper.transform(x, dtype)

            score = b.predict_binned_scorer(autocast, device)
        else:
            try:
                binning, derived = b.derive_binning()
            except Exception as e:
                raise BinnedServingUnsupported(
                    f"derive_binning failed: {e}") from e
            dtype = binning.dtype

            def bin_rows(x: np.ndarray) -> np.ndarray:
                return binning.transform(_check(x))

            score = derived.predict_binned_scorer(autocast, device)

        return ServingBinnedPlan(
            bin_rows=bin_rows, score=score,
            finish=self._reply_columns_from_raw,
            ingest_dtype=dtype, num_features=expected_f,
            features_col=features_col, autocast=autocast)

    def _features(self, df: DataFrame) -> np.ndarray:
        x = np.asarray(df.col(self.get("featuresCol")), dtype=np.float64)
        if (not self.get("predictDisableShapeCheck")
                and x.shape[1] != self.booster.num_features):
            raise ValueError(
                f"feature count mismatch: model has {self.booster.num_features},"
                f" data has {x.shape[1]}")
        return x

    def _reply_columns_from_raw(self, raw: np.ndarray) -> Dict[str, Any]:
        """Ordered output columns derived from margin scores."""
        raise NotImplementedError

    def _batched(self, fn, x: np.ndarray) -> np.ndarray:
        """``fn(rows, device)`` over row batches of ``x`` on the model's
        device, as float64."""
        device = resolve_device(self._device)
        return np.concatenate([
            fn(x[s:s + _SCORE_BATCH_ROWS], device=device).cpu().numpy()
            for s in range(0, max(len(x), 1), _SCORE_BATCH_ROWS)]
        ).astype(np.float64)

    def _maybe_extra_cols(self, df: DataFrame, x: np.ndarray) -> DataFrame:
        """The leaf-slot and TreeSHAP columns where asked (the JAX
        package's ``_maybe_extra_cols``), both float64."""
        b = self.scoring_booster
        if self.is_set("leafPredictionCol"):
            df = df.with_column(self.get("leafPredictionCol"),
                                self._batched(b.leaf_index, x))
        if self.is_set("featuresShapCol"):
            df = df.with_column(self.get("featuresShapCol"),
                                self._batched(b.contrib, x))
        return df

    def _transform(self, df: DataFrame) -> DataFrame:
        x = self._features(df)
        out = df
        for name, vals in self._reply_columns_from_raw(
                self._raw_scores(x)).items():
            out = out.with_column(name, vals)
        return self._maybe_extra_cols(out, x)


# ---------------------------------------------------------------------------
# Classifier
# ---------------------------------------------------------------------------

class LightGBMClassifier(_LightGBMBase):
    """GBDT classifier (LightGBMClassifier.scala:32 parity): binary, or
    multiclass (softmax, K trees per iteration) where the label has more
    than two values; labels are re-encoded to 0..K-1 and decoded back in
    ``transform``."""

    rawPredictionCol = Param("rawPredictionCol", "raw margin column", to_str,
                             default="rawPrediction")
    probabilityCol = Param("probabilityCol", "probability column", to_str,
                           default="probability")
    thresholds = Param("thresholds", "per-class prediction thresholds",
                       to_list(to_float))
    isUnbalance = Param("isUnbalance", "auto-weight unbalanced binary labels",
                        to_bool, default=False)
    maxNumClasses = Param("maxNumClasses", "cap on discovered label "
                          "cardinality", to_int, gt(0), default=100)
    scalePosWeight = Param(
        "scalePosWeight", "weight of positive-class rows in the binary "
        "objective (LightGBM scale_pos_weight; the reference reaches it "
        "via passThroughArgs)", to_float, gt(0), default=1.0)

    def _fit(self, df: DataFrame) -> "LightGBMClassificationModel":
        y_raw = np.asarray(df.col(self.get("labelCol")), dtype=np.float64)
        classes = np.unique(y_raw[~np.isnan(y_raw)])
        num_class = len(classes)
        if num_class > self.get("maxNumClasses"):
            raise ValueError(
                f"{num_class} distinct labels exceeds maxNumClasses="
                f"{self.get('maxNumClasses')} (guards runaway label "
                "cardinality, LightGBMClassifier.scala maxNumClasses)")
        objective = self.get("objective") or (
            "binary" if num_class <= 2 else "multiclass")
        if objective == "binary" and num_class > 2:
            raise ValueError(f"binary objective with {num_class} classes")
        # re-encode labels to 0..K-1 (objectives one-hot by index)
        encoded = np.searchsorted(classes, y_raw).astype(np.float64)
        df = df.with_column(self.get("labelCol"), encoded)
        spw = self.get("scalePosWeight")
        if ((self.get("isUnbalance") or spw != 1.0)
                and objective == "binary"):
            if self.get("isUnbalance") and spw != 1.0:
                raise ValueError(
                    "isUnbalance and scalePosWeight are mutually "
                    "exclusive (LightGBM: set only one)")
            # scale positive-class rows by neg/pos (LightGBM
            # is_unbalance) or by the explicit scale_pos_weight —
            # weighting grad+hess equals row weighting
            if self.get("isUnbalance"):
                pos = max(float((encoded == 1).sum()), 1.0)
                neg = float((encoded == 0).sum())
                spw = neg / pos
            w = np.where(encoded == 1, spw, 1.0)
            if self.is_set("weightCol"):
                w = w * np.asarray(df.col(self.get("weightCol")), np.float64)
                df = df.with_column(self.get("weightCol"), w)
            else:
                df = df.with_column("_unbalance_weight", w)
                self = self.copy(weightCol="_unbalance_weight")
        result, mapper, measures = self._fit_booster(
            df, objective,
            num_class=num_class if objective != "binary" else 1)
        model = self._finish_model(LightGBMClassificationModel, result,
                                   mapper, measures)
        model.num_classes = num_class
        model.classes_ = classes
        return model


class LightGBMClassificationModel(_LightGBMModelBase):
    rawPredictionCol = Param("rawPredictionCol", "raw margin column", to_str,
                             default="rawPrediction")
    probabilityCol = Param("probabilityCol", "probability column", to_str,
                           default="probability")
    thresholds = Param("thresholds", "per-class prediction thresholds",
                       to_list(to_float))
    num_classes: int = 2
    classes_: Optional[np.ndarray] = None  # original label values, sorted

    def _get_state(self):
        state = super()._get_state()
        state["num_classes"] = self.num_classes
        if self.classes_ is not None:
            state["classes_"] = self.classes_
        return state

    def _set_state(self, state):
        super()._set_state(state)
        self.num_classes = state.get("num_classes", 2)
        c = state.get("classes_")
        self.classes_ = None if c is None else np.asarray(c)

    def _reply_columns_from_raw(self, raw: np.ndarray) -> Dict[str, Any]:
        if raw.ndim == 1:  # binary: margins for [neg, pos]
            raw2 = np.stack([-raw, raw], axis=1)
            prob = 1.0 / (1.0 + np.exp(-raw))
            probs = np.stack([1 - prob, prob], axis=1)
        else:
            raw2 = raw
            probs = np.exp(raw - raw.max(axis=1, keepdims=True))
            probs = probs / probs.sum(axis=1, keepdims=True)
        if self.is_set("thresholds"):
            t = np.asarray(self.get("thresholds"), dtype=np.float64)
            pred_idx = np.argmax(probs / t[None, :], axis=1)
        else:
            pred_idx = np.argmax(probs, axis=1)
        if self.classes_ is not None:  # decode back to original label values
            pred = self.classes_[pred_idx].astype(np.float64)
        else:
            pred = pred_idx.astype(np.float64)
        return {self.get("rawPredictionCol"): raw2,
                self.get("probabilityCol"): probs,
                self.get("predictionCol"): pred}


# ---------------------------------------------------------------------------
# Regressor
# ---------------------------------------------------------------------------

class LightGBMRegressor(_LightGBMBase):
    """GBDT regressor (LightGBMRegressor.scala:1 parity): the objectives
    regression (L2, the default), regression_l1, huber, fair, poisson,
    quantile, mape, gamma and tweedie and their aliases; ``alpha`` is
    huber's and quantile's, ``tweedieVariancePower`` tweedie's."""

    alpha = Param("alpha", "huber/quantile alpha", to_float, gt(0), default=0.9)
    tweedieVariancePower = Param("tweedieVariancePower",
                                 "tweedie variance power in (1,2)", to_float,
                                 in_range(1, 2), default=1.5)

    def _fit(self, df: DataFrame) -> "LightGBMRegressionModel":
        objective = self.get("objective") or "regression"
        extra = {"alpha": self.get("alpha"),
                 "tweedie_variance_power": self.get("tweedieVariancePower")}
        result, mapper, measures = self._fit_booster(df, objective,
                                                     extra_cfg=extra)
        return self._finish_model(LightGBMRegressionModel, result, mapper,
                                  measures)


class LightGBMRegressionModel(_LightGBMModelBase):
    def _reply_columns_from_raw(self, raw: np.ndarray) -> Dict[str, Any]:
        if self.booster.objective in ("poisson", "gamma", "tweedie"):
            raw = np.exp(raw)
        return {self.get("predictionCol"): raw.astype(np.float64)}


# ---------------------------------------------------------------------------
# Ranker
# ---------------------------------------------------------------------------

def _encode_groups(frame: DataFrame, group_col: str) -> np.ndarray:
    """A frame's query ids as dense int32 indices in sorted-id order."""
    _, inv = np.unique(np.asarray(frame.col(group_col)),
                       return_inverse=True)
    return inv.reshape(-1).astype(np.int32)


class LightGBMRanker(_LightGBMBase):
    """Lambdarank ranker (LightGBMRanker.scala:1 parity). ``groupCol``
    holds the query ids; pairs are taken within a query, NDCG is
    evaluated at each ``evalAt`` position under ``labelGain`` (default
    2^label - 1), and only pairs touching the top ``maxPosition``
    predicted positions carry gradient."""

    groupCol = Param("groupCol", "query/group id column", to_str,
                     default="group")
    evalAt = Param("evalAt", "NDCG@k eval positions", to_list(to_int),
                   default=[1, 3, 5])
    labelGain = Param("labelGain", "per-relevance-level NDCG gains "
                      "(default 2^label - 1)", to_list(to_float))
    maxPosition = Param("maxPosition", "NDCG truncation level "
                        "(lambdarank_truncation_level)", to_int, gt(0),
                        default=30)

    def _fit(self, df: DataFrame) -> "LightGBMRankerModel":
        eval_at = self.get("evalAt") or [5]
        extra = {"eval_at": tuple(int(p) for p in eval_at),
                 "lambdarank_truncation_level": self.get("maxPosition")}
        if self.is_set("labelGain"):
            extra["label_gain"] = tuple(self.get("labelGain"))
        result, mapper, measures = self._fit_booster(
            df, "lambdarank", extra_cfg=extra,
            group_col=self.get("groupCol"))
        return self._finish_model(LightGBMRankerModel, result, mapper,
                                  measures)


class LightGBMRankerModel(_LightGBMModelBase):
    """A fitted ranker: ``transform`` appends the raw scores (float64)
    as ``predictionCol``; rank within a query by them."""

    def _reply_columns_from_raw(self, raw: np.ndarray) -> Dict[str, Any]:
        return {self.get("predictionCol"): raw.astype(np.float64)}


def _sample_rows(x: np.ndarray, seed: int, max_sample: int = 200_000) -> np.ndarray:
    """Bin-boundary sample (the analog of LightGBMBase.getSampledRows,
    LightGBMBase.scala:724-749 — sample count bounded, deterministic)."""
    if len(x) <= max_sample:
        return x
    rng = np.random.default_rng(seed)
    return x[rng.choice(len(x), size=max_sample, replace=False)]
