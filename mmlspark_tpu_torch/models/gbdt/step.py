"""The boosting step: one iteration of gbdt, goss or rf as one function
on static buffers, replayed on the card as one captured CUDA graph.

It is the port of the JAX package's fused step (``_make_step_fn``,
``mmlspark_tpu/models/gbdt/trainer.py:2081``), in the same order:

  1. the sampling masks (``sampling``): the bag, the tree's features,
     drawn once per iteration;
  2. grad/hess from the objective (rf's from the base score alone), (N,)
     or (N, K) for K classes; lambdarank over the fit's group layout;
  3. GOSS's multipliers (rows ranked by the sum over classes of |g|),
     folded into grad/hess and the row mask;
  4. per class c: ``trainer.build_tree`` on the column ``g[:, c]`` under
     the row and feature masks (its per-level draws keyed by class c's
     tree stream, ``sampling.tree_keys``; its histograms on the EFB
     plan's bundled matrix where the fit has one), shrinkage (``node_value *
     learning_rate``; rf keeps its values), and the training and
     validation raw scores' column c updated in place;
  5. the metric row.

The step writes its K trees and metric row into one packed float32 row
(:func:`unpack`): per tree ``split_feature`` and ``threshold_bin`` as
the bits of their int32 values, then ``node_value``, ``count``, for a
fit with categorical features each split's decision bits and its
(slots, B) left-bin mask (:func:`unpack_masks`; the reference keeps them
only for such fits too); then the metrics. Unpacked, the trees come in
the booster's order, interleaved by class.

On the CPU, and for a custom objective, the step runs directly, once per
iteration (:class:`Step`). On the card a named objective's step is
captured once as a ``torch.cuda.CUDAGraph`` and replayed each iteration:
the host writes the iteration into a device scalar, replays, and copies
the packed row out. The first iteration of a new capture runs uncaptured
as the warm-up: it builds the kernels and runs their first-use set-up
(``cudaFuncSetAttribute``, occupancy queries, the quantization
threshold table) before capture, and advances the fit once, as a
replay would. Captures are cached by what the graph bakes in (the
shapes, the group layouts' shapes, the loop-relevant config (monotone
constraints, ``extra_trees`` and ``feature_fraction_by_node``
included), the histogram plane, subtraction, the EFB plan's
``cache_key``, the draw function and the device) like the reference's
``_get_step_fn``; each fit copies its data, its group layouts and its
bundled matrix and unbundling maps included, into the cached
buffers. Capture is
thread-local, so serving threads of the same process keep launching.
A capture or replay that fails raises; nothing falls back to the
uncaptured step. A cached step holds its buffers and graph, never a
model, so a swap or a booster's ``clear_jit_cache`` frees what a model
holds whatever the cache keeps; :func:`clear_step_cache` frees every
cached graph and its memory pool.

A graph replays kernels, not Python: a fault armed at a point inside
the step (``gbdt.level_hist``) would fire once at capture and then be
baked into every replay, so such fits run the step uncaptured. The
launch counters of ``hist_cuda`` count the kernels of every replay
(``hist_cuda.captured_launches`` / ``count_replay``).
"""

from __future__ import annotations

import gc
import threading
import time
from collections import OrderedDict
from dataclasses import replace
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core import faults
from mmlspark_tpu_torch.models.gbdt import hist_cuda
from mmlspark_tpu_torch.models.gbdt import objectives as obj_mod
from mmlspark_tpu_torch.models.gbdt import sampling

# fault points hit inside the step (see the module note)
IN_STEP_POINTS = ("gbdt.level_hist",)
STEP_CACHE_LIMIT = 4     # captured steps kept (LRU)

_cache: "OrderedDict[tuple, Step]" = OrderedDict()
_cache_lock = threading.Lock()


def num_slots(cfg) -> int:
    return 2 ** (cfg.effective_depth + 1) - 1


def mask_bins(cfg) -> int:
    """Bins of the per-split left masks a packed row carries: B for a fit
    with categorical features, else none."""
    return cfg.max_bin if cfg.has_categorical else 0


def tree_cols(slots: int, bins: int = 0) -> int:
    """Columns of a packed row before its metrics."""
    return 4 * slots + (slots * (1 + bins) if bins else 0)


def _trees(rows: np.ndarray, slots: int, bins: int, k: int) -> np.ndarray:
    """The (T * K, tree_cols) tree blocks of (T, K * tree_cols + m)
    packed rows, interleaved by class (row t's block c is tree
    t * K + c)."""
    cols = tree_cols(slots, bins)
    return rows[:, :k * cols].reshape(len(rows) * k, cols)


def unpack(rows: np.ndarray, slots: int, bins: int = 0, k: int = 1):
    """(split_feature int32, threshold_bin int32, node_value float32,
    count float32), each (T * K, slots), and the metrics float32 (T, m)
    of (T, K * tree_cols + m) packed rows."""
    rows = np.ascontiguousarray(rows, dtype=np.float32)
    trees = _trees(rows, slots, bins, k)
    return (trees[:, :slots].copy().view(np.int32),
            trees[:, slots:2 * slots].copy().view(np.int32),
            trees[:, 2 * slots:3 * slots], trees[:, 3 * slots:4 * slots],
            rows[:, k * tree_cols(slots, bins):])


def unpack_masks(rows: np.ndarray, slots: int, bins: int, k: int = 1):
    """(decision_type int8 (T * K, slots), bin_go_left bool (T * K,
    slots, bins)) of the packed rows of a fit with categorical
    features."""
    trees = _trees(np.ascontiguousarray(rows, dtype=np.float32), slots,
                   bins, k)
    at = 4 * slots
    return (trees[:, at:at + slots].astype(np.int8),
            trees[:, at + slots:at + slots * (1 + bins)]
            .reshape(len(trees), slots, bins) > 0)


def _loop_only(cfg):
    """The config with the fields the step never reads zeroed, so fits
    that differ only there share a capture (the reference's
    ``_loop_only_normalized``; the learning rate rides in a buffer)."""
    return replace(cfg, num_iterations=0, early_stopping_round=0,
                   learning_rate=0.0, improvement_tolerance=0.0)


class Step:
    """One fit's boosting step over its buffers: the binned rows,
    labels, weights and raw scores, each validation set's, the group
    layouts (``layout``, and each validation set's ``"layout"``: tuples
    of (rows, mask) buckets, or None), and three device scalars (the
    iteration, the learning rate, the base score).

    ``grad_fn(score_in) -> (grad, hess)`` is the objective (the named
    one by default). :meth:`run` runs one iteration: uncaptured, or the
    replay of its graph once :meth:`capture` made one."""

    def __init__(self, cfg, binned, labels, weights, raw, valids, layout,
                 hist_quant: str, subtract: bool,
                 grad_fn: Optional[Callable] = None, efb=None, learner=None):
        from mmlspark_tpu_torch.models.gbdt import trainer as T

        self.cfg = cfg
        self.k = cfg.num_trees_per_iteration
        self.dev = binned.device
        self.binned, self.labels, self.weights, self.raw = (
            binned, labels, weights, raw)
        self.layout = layout
        # the EFB plan's bundled matrix and index maps
        # (``trainer.plan_efb``), or None
        self.efb = efb
        # [{"binned", "labels", "weights", "raw", "layout"}] per
        # validation set
        self.valids = valids
        self.hist_quant, self.subtract = hist_quant, subtract
        self.n, self.num_f = binned.shape
        # a multi-device fit's ``parallel_modes.Learner``. Its step holds
        # this rank's bin ids (its rows, or its columns) and raw scores,
        # and every row's labels and weights: the sampling masks, the
        # objective and the metrics are evaluated on every row, from the
        # scores gathered once per iteration, as the serial step
        # evaluates them (so with its bits on the CPU too, where torch's
        # vectorized elementwise ops round a tensor's tail apart); the
        # trees' histograms, routing and score updates run on this
        # rank's share
        self.learner = learner
        self.raw_full: Optional[torch.Tensor] = None
        if learner is not None:
            self.n, self.num_f = learner.n_total, learner.num_features
        self.it = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.lr = torch.zeros((), dtype=torch.float32, device=self.dev)
        self.base = torch.zeros((), dtype=torch.float32, device=self.dev)
        # the named objective, or a custom one's ``grad_fn``; neither
        # refers back to the step, so a dropped step (and its graph) is
        # freed at once, never by a garbage-collector pass that could
        # fall inside another step's capture
        self.objective_fn = obj_mod.get_objective(cfg.objective)
        self.obj_kwargs = T._objective_kwargs(cfg)
        # the gain table goes to the device here, never inside a capture,
        # for the lambdas and ndcg alike
        gains = (torch.tensor(cfg.label_gain, dtype=torch.float32,
                              device=self.dev) if cfg.label_gain else None)
        if cfg.objective == "lambdarank":
            self.obj_kwargs["group_layout"] = layout
            if gains is not None:
                self.obj_kwargs["label_gain"] = gains
        self.grad_fn = grad_fn
        metric_name, self.metric_list, _, metric_kwargs = \
            T._resolve_metrics(cfg, label_gain=gains)
        # (raw, labels, weights) and the metric's settings of the training
        # set and each validation set; ndcg's with the set's layout
        ndcg = metric_name == "ndcg"
        self.metric_sets = [
            ((vs["raw"], vs["labels"], vs["weights"]),
             {**metric_kwargs, "group_layout": vs.get("layout")} if ndcg
             else metric_kwargs)
            for vs in [{"raw": raw, "labels": labels, "weights": weights,
                        "layout": layout}, *valids]]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.tally: Dict[str, int] = {}
        self.capture_s: Optional[float] = None
        self.key: Optional[tuple] = None
        self.captured = False           # a cached, captured step
        self.lock = threading.Lock()

    # -- one iteration -----------------------------------------------------
    def body(self) -> torch.Tensor:
        """One boosting iteration at ``self.it`` on the buffers: returns
        the packed row. Makes no host sync."""
        cfg, n, dev = self.cfg, self.n, self.dev
        mask = None
        if sampling.bag_active(cfg):
            mask = sampling.bag_mask(
                sampling.draw(sampling.bag_keys(cfg, self.it), n, dev),
                self.labels, cfg)
        feat_mask = None
        if cfg.feature_fraction < 1.0:
            feat_mask = sampling.feature_mask(
                sampling.draw(sampling.feature_keys(cfg, self.it),
                              self.num_f, dev), self.num_f,
                sampling.feature_keep(self.num_f, cfg.feature_fraction))
        g, h, mask = self.grad_hess(self.scores(), mask, self.it)
        return self.add_trees(self.grow(g, h, mask, feat_mask, self.it))

    def scores(self) -> torch.Tensor:
        """Every row's raw scores: ``raw``, or a row-sharded learner's,
        gathered (once per iteration: the metric row gathers the next
        iteration's)."""
        if self.learner is None or not self.learner.rows_sharded:
            return self.raw
        if self.raw_full is None:
            self.raw_full = self.learner.gather_rows(self.raw)
        return self.raw_full

    # the parts of an iteration the host loop (``host_loop.py``) shares
    def grad_hess(self, raw, mask, it):
        """(grad, hess, row mask) at the raw scores ``raw`` (rf's at the
        base score alone): the objective's, GOSS's multipliers folded into
        them and into the row mask ``mask`` (None: every row)."""
        cfg, k = self.cfg, self.k
        score_in = (self.base.expand(raw.shape).clone()
                    if cfg.boosting_type == "rf" else raw)
        if self.grad_fn is not None:
            g, h = self.grad_fn(score_in)
        else:
            g, h = self.objective_fn(score_in, self.labels, self.weights,
                                     **self.obj_kwargs)
        if cfg.boosting_type == "goss":
            mult = sampling.goss_mult(
                g, sampling.draw(sampling.goss_keys(cfg, it), self.n,
                                 self.dev), None, cfg)
            keep = (mult > 0).to(torch.float32)
            mask = keep if mask is None else mask * keep
            gm = mult if k == 1 else mult[:, None]
            g, h = g * gm, h * gm
        return g, h, mask

    def grow(self, g, h, mask, feat_mask, it,
             build: Optional[Callable] = None) -> list:
        """The iteration's K trees, one per class from its own contiguous
        grad/hess column under the shared masks, each with its shrunk
        node values: [(tree, node_value)]. ``build(g, h)`` grows a tree in
        place of ``trainer.build_tree`` (the leaf-wise builder)."""
        from mmlspark_tpu_torch.models.gbdt import trainer as T

        cfg, k = self.cfg, self.k
        nl = cfg.num_leaves if cfg.num_leaves > 0 else 2 ** cfg.effective_depth
        trees = []
        for c in range(k):
            gc, hc = ((g, h) if k == 1 else
                      (g[:, c].contiguous(), h[:, c].contiguous()))
            valid, root = mask, None
            learner = self.learner
            if learner is not None and learner.rows_sharded:
                # the root's sums over every row; then this rank's rows
                root = T._root_sums(gc, hc, mask)
                gc, hc, valid = (None if t is None else learner.rows(t)
                                 for t in (gc, hc, mask))
            if build is not None:
                tree = build(gc, hc)
            else:
                tree = T.build_tree(
                    self.binned, gc, hc, nl, cfg, cfg.max_bin,
                    self.hist_quant, self.subtract, valid=valid,
                    feat_mask=feat_mask,
                    key=(sampling.tree_keys(cfg, c, it)
                         if cfg.draws_per_node else None), efb=self.efb,
                    learner=learner, root=root)
            nv = tree[2] if cfg.boosting_type == "rf" else tree[2] * self.lr
            trees.append((tree, nv))
        return trees

    def add_trees(self, trees, weight: Optional[float] = None,
                  kept: Optional[list] = None) -> torch.Tensor:
        """Each class's tree into the training and validation raw scores'
        column (its prediction times ``weight`` where one is given; the
        training prediction appended to ``kept`` where that is given),
        then the packed row: the trees' blocks and the metric row."""
        from mmlspark_tpu_torch.models.gbdt import trainer as T

        cfg, k, depth = self.cfg, self.k, self.cfg.effective_depth
        blocks = []
        for c, (tree, nv) in enumerate(trees):
            sf, tb, _, cnt = tree[:4]
            bgl = tree[5] if cfg.has_categorical else None
            for j, vs in enumerate([{"raw": self.raw, "binned": self.binned},
                                    *self.valids]):
                if j == 0 and self.learner is not None \
                        and self.learner.mode == "feature":
                    # this rank's columns cannot score its rows: their
                    # final slots came back with the tree
                    pred = nv[tree[4]]
                else:
                    pred = T._predict_tree(sf, tb, nv, vs["binned"], depth,
                                           bgl)
                if kept is not None and j == 0:
                    kept.append(pred)
                if weight is not None:
                    pred = pred * weight
                (vs["raw"] if k == 1 else vs["raw"][:, c]).add_(pred)
            masks = [] if bgl is None else [tree[4].float(),
                                            bgl.float().reshape(-1)]
            blocks += [sf.view(torch.float32), tb.view(torch.float32), nv,
                       cnt, *masks]
        return torch.cat([*blocks, self.metric_row()])

    def metric_row(self) -> torch.Tensor:
        """The metrics of the current raw scores: per metric, the
        training set's, then each validation set's (float32)."""
        sets = self.metric_sets
        if self.learner is not None and self.learner.rows_sharded:
            # every row's scores (gathered, and kept for the next
            # iteration's objective), labels and weights
            self.raw_full = self.learner.gather_rows(self.raw)
            train = (self.raw_full, *sets[0][0][1:])
            sets = [(train, sets[0][1]), *sets[1:]]
        return torch.stack([fn(*args, **kw) for _, fn in self.metric_list
                            for args, kw in sets]).float()

    def run(self, it: int) -> torch.Tensor:
        """Iteration ``it`` (global, ``iteration_offset`` included): the
        packed row, a tensor of its own."""
        self.it.fill_(it)
        if self.graph is None:
            return self.body()
        self.graph.replay()
        hist_cuda.count_replay(self.tally)
        return self.out.clone()

    def capture(self) -> None:
        """Capture :meth:`body` as one CUDA graph on a side stream,
        thread-local, counting the histogram launches it holds. Nothing
        runs: the buffers are as they were."""
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        # no garbage-collector pass inside the capture: one that freed a
        # graph would destroy it mid-capture, which invalidates this one
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with hist_cuda.captured_launches() as tally:
                with torch.cuda.graph(graph,
                                      stream=torch.cuda.Stream(self.dev),
                                      capture_error_mode="thread_local"):
                    out = self.body()
        finally:
            if gc_on:
                gc.enable()
        self.capture_s = time.perf_counter() - t0
        self.graph, self.out, self.tally = graph, out, dict(tally)

    # -- the buffers of a cached step ---------------------------------------
    @classmethod
    def owning(cls, cfg, binned, labels, weights, raw, valids, layout,
               hist_quant, subtract, efb=None) -> "Step":
        """A step over buffers of its own, shaped as the given tensors,
        for capture and reuse by later fits (:meth:`load`)."""
        own = [{k: _like(v) for k, v in vs.items()} for vs in valids]
        return cls(cfg, torch.empty_like(binned), torch.empty_like(labels),
                   _like(weights), torch.empty_like(raw), own,
                   _like(layout), hist_quant, subtract,
                   efb=None if efb is None else
                   {k: torch.empty_like(v) for k, v in efb.items()})

    def load(self, binned, labels, weights, raw, valids, layout,
             efb=None) -> None:
        """Copy one fit's tensors, its group layouts and its EFB
        matrix and maps included, into the buffers."""
        pairs = [(self.binned, binned), (self.labels, labels),
                 (self.weights, weights), (self.raw, raw),
                 (self.layout, layout)]
        for mine, theirs in zip(self.valids, valids):
            pairs += [(mine[k], theirs[k]) for k in mine]
        if self.efb is not None:
            pairs += [(self.efb[k], efb[k]) for k in self.efb]
        for dst, src in pairs:
            if isinstance(dst, tuple):
                pairs += list(zip(dst, src))
            elif dst is not None:
                _copy(dst, src)


def _copy(dst, src) -> None:
    """``dst.copy_(src)``; uint16 bin ids through int16's bits (torch
    implements few ops on uint16), uint8 and int32 ids as they are."""
    if dst.dtype == torch.uint16:
        dst, src = dst.view(torch.int16), src.view(torch.int16)
    dst.copy_(src)


def _like(v):
    """Empty buffers shaped as ``v``: a tensor, None, or a group layout
    (a tuple of (rows, mask) pairs)."""
    if isinstance(v, tuple):
        return tuple(_like(x) for x in v)
    return None if v is None else torch.empty_like(v)


def _shapes(v):
    """The shapes of a group layout (None where there is none)."""
    if isinstance(v, tuple):
        return tuple(_shapes(x) for x in v)
    return None if v is None else tuple(v.shape)


def _cache_key(cfg, binned, weights, valids, hist_quant, subtract,
               layout=None, efb_key=None):
    return (binned.device, tuple(binned.shape), binned.dtype,
            weights is None,
            tuple((vs["binned"].shape[0], vs["weights"] is None,
                   _shapes(vs.get("layout"))) for vs in valids),
            _loop_only(cfg), hist_quant, subtract, sampling.draw,
            _shapes(layout), efb_key)


def open_step(cfg, binned, labels, weights, raw, valids, *,
              layout=None, lr: float,
              base: float, hist_quant: str, subtract: bool,
              custom_objective: Optional[Callable] = None,
              capture: bool = True, efb=None,
              efb_key: Optional[str] = None, learner=None) -> Step:
    """The step of one fit over the given device tensors (``raw`` and
    each validation set's ``"raw"`` are its starting scores; ``layout``
    and each set's ``"layout"`` its group layouts, or None; ``efb`` the
    EFB plan's bundled matrix and maps, ``efb_key`` the plan's
    ``cache_key``; ``learner`` a multi-device fit's
    ``parallel_modes.Learner``, whose step holds every row's ``labels``
    and ``weights`` and this rank's ``binned`` and ``raw``: such a step
    is never captured).

    On the card, a named objective with ``capture`` on gets a captured
    step: the cached one for this shape and config (its buffers loaded
    with these tensors), or a new one, captured after its first
    iteration. Otherwise the step runs directly on the given tensors.
    Call :func:`close_step` when the fit is done."""
    from mmlspark_tpu_torch.models.gbdt import trainer as T

    captured = (capture and binned.device.type == "cuda"
                and custom_objective is None and learner is None
                and not any(faults.is_armed(p) for p in IN_STEP_POINTS))
    if not captured:
        grad_fn = None
        if custom_objective is not None:
            grad_fn = (lambda score: T._custom_grad_hess(
                custom_objective, score, labels, weights))
        # the raw scores are updated in place: copies, never the
        # caller's arrays (a tensor from numpy shares its memory)
        st = Step(cfg, binned, labels, weights, raw.clone(),
                  [{**vs, "raw": vs["raw"].clone()} for vs in valids],
                  layout, hist_quant, subtract, grad_fn, efb=efb,
                  learner=learner)
    else:
        key = _cache_key(cfg, binned, weights, valids, hist_quant, subtract,
                         layout, efb_key)
        with _cache_lock:
            st = _cache.get(key)
            if st is not None and st.lock.acquire(blocking=False):
                _cache.move_to_end(key)
            else:
                st = None   # none, or in use by a fit on another thread
        if st is None:
            st = Step.owning(cfg, binned, labels, weights, raw, valids,
                             layout, hist_quant, subtract, efb)
            st.key = key
            st.lock.acquire()
        st.captured = True
    try:
        if captured:
            st.load(binned, labels, weights, raw, valids, layout, efb)
        st.lr.fill_(lr)
        st.base.fill_(base)
    except BaseException:
        close_step(st)
        raise
    return st


def run_step(st: Step, it: int) -> torch.Tensor:
    """Iteration ``it`` of the fit: on a captured step whose graph is not
    made yet, the uncaptured warm-up, then the capture (cached)."""
    out = st.run(it)
    if st.captured and st.graph is None:
        st.capture()
        with _cache_lock:
            if st.key not in _cache:
                _cache[st.key] = st
                while len(_cache) > STEP_CACHE_LIMIT:
                    _cache.popitem(last=False)
    return out


def close_step(st: Step) -> None:
    """The fit is done with ``st``: a cached step is free for the next."""
    if st.captured and st.lock.locked():
        st.lock.release()


def clear_step_cache() -> None:
    """Drop every cached captured step, and with its graph the graph's
    memory pool (returned to the card by ``torch.cuda.empty_cache``)."""
    with _cache_lock:
        _cache.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def cached_steps() -> List[Step]:
    with _cache_lock:
        return list(_cache.values())
