"""The eager host loop: DART and leaf-wise fits, one iteration at a time
with the host in the loop. The port of the JAX package's ``_train_loop``
(``mmlspark_tpu/models/gbdt/trainer.py:3053-3317``), which ``train``
takes for the same fits (``:2708-2718``).

Why these fits leave the captured step (``step.py``): DART drops a
subset of the earlier trees, drawn on the host, and rescales their
weights every iteration; leaf-wise growth (``leafwise.py``) reads every
split's gain on the host to pick the next leaf. Every other fit stays on
the captured step.

One iteration (:meth:`HostLoop.run`), in the reference's order:

  1. the sampling masks from numpy Generators seeded as the reference's
     (``seed * 1000003 + bagging_seed + iteration_offset``, the same with
     ``feature_fraction_seed``): bagging and pos/neg bagging redrawn every
     ``bagging_freq`` iterations of the segment (rf's bag once),
     ``feature_fraction`` by ``choice`` every iteration. So the masks are
     the reference's bits, where the captured step draws the counter
     hash (ROADMAP C22). GOSS keeps the port's counter hash (C13);
  2. DART's drops from their own stream (``drop_seed``, else ``seed +
     4``, plus the offset): none while ``skip_drop`` says skip, else each
     earlier tree at ``drop_rate`` (``uniform_drop``) or in proportion to
     its weight, at most ``max_drop`` of them (a ``choice`` among the
     drawn, sorted); tree i is class i % K. The gradients are taken at
     ``raw_for_grad``, the raw scores less each dropped tree's kept
     prediction times its weight;
  3. grad/hess (the named objective, or the custom one), GOSS's
     multipliers (``Step.grad_hess``), then per class the tree and its
     shrinkage (``Step.grow``: ``trainer.build_tree`` depthwise, on the
     fit's histogram plane, EFB plan and subtraction; or the leaf-wise
     builder);
  4. DART's weights, Python floats: each dropped tree's times ``norm =
     len / (len + 1)`` and its kept prediction's change added to the raw
     scores; the new trees weigh ``1 / (len + 1)`` (1 without drops);
  5. each new tree's prediction times its weight into the raw scores and
     each validation set's (DART's validation scores are never rescaled
     for dropped trees, as in the reference: ROADMAP C21), then the
     metric row (``Step.add_trees``, which packs the row).

Under a mesh (``parallel_modes.Learner``) every rank runs the loop: the
draws come from the same numpy streams on every rank, so every rank
drops the same trees; the dropped trees' predictions come out of this
rank's rows of the raw scores (every row's under the feature learner),
which are then gathered for the objective, as the step gathers its
scores; the rescaling and the new trees' predictions update this rank's
rows.

The iteration returns the packed row of ``step.py``'s layout (trees,
then metrics), so ``train`` unpacks and assembles both loops' rows the
same way; the tree weights are :attr:`HostLoop.tree_weights`. Nothing
here is captured into a CUDA graph: a DART tree's depthwise build
launches as the uncaptured step does, and the leaf-wise builder syncs
once per histogrammed node by design.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.models.gbdt import sampling
from mmlspark_tpu_torch.models.gbdt.leafwise import make_build_tree_leafwise


class HostLoop:
    """The host loop of one fit over an uncaptured ``step.Step``'s
    buffers (its binned rows, labels, weights, raw scores, validation
    sets, objective and metrics). ``labels``: the training labels on the
    host (pos/neg bagging compares them there, as the reference does)."""

    def __init__(self, st, labels: np.ndarray, *, leafwise: bool,
                 iteration_offset: int = 0):
        cfg = st.cfg
        self.st, self.cfg = st, cfg
        self.offset = iteration_offset
        self.labels = np.asarray(labels)
        self.is_dart = cfg.boosting_type == "dart"
        self.grow = (make_build_tree_leafwise(st.num_f, cfg.max_bin, cfg)
                     if leafwise else None)
        base = cfg.seed * 1000003 + iteration_offset
        self.bag_rng = np.random.default_rng(base + cfg.bagging_seed)
        self.ff_rng = np.random.default_rng(base + cfg.feature_fraction_seed)
        self.drop_rng = np.random.default_rng(
            (cfg.seed + 4 if cfg.drop_seed is None else cfg.drop_seed)
            + iteration_offset)
        self.bag: Optional[torch.Tensor] = None   # every row until drawn
        self.tree_weights: List[float] = []
        # DART: each tree's prediction on the rows the step's ``raw``
        # holds (a multi-device fit: this rank's rows, or every row under
        # the feature learner, which takes it from the build's final
        # slots: ``Step.add_trees``), kept on the device to take it out
        # of the gradients' scores and rescale it
        self.preds: List[torch.Tensor] = []

    # -- the draws ---------------------------------------------------------
    def _masks(self, it: int):
        """(row mask or None, feature mask (numpy, F) or None) of local
        iteration ``it``."""
        cfg, n, num_f = self.cfg, self.st.n, self.st.num_f
        is_rf = cfg.boosting_type == "rf"
        pos_neg = (cfg.pos_bagging_fraction < 1.0
                   or cfg.neg_bagging_fraction < 1.0)
        if (cfg.bagging_freq > 0 and (cfg.bagging_fraction < 1.0 or pos_neg)
                and it % cfg.bagging_freq == 0) or (is_rf and it == 0):
            if pos_neg and not is_rf:
                thr = np.where(self.labels > 0, cfg.pos_bagging_fraction,
                               cfg.neg_bagging_fraction)
                bag = (self.bag_rng.random(n) < thr).astype(np.float32)
            else:
                frac = (cfg.bagging_fraction if cfg.bagging_fraction < 1.0
                        else 0.632)
                bag = (self.bag_rng.random(n) < frac).astype(np.float32)
            self.bag = torch.from_numpy(bag).to(self.st.dev)
        feat_mask = None
        if cfg.feature_fraction < 1.0:
            keep = sampling.feature_keep(num_f, cfg.feature_fraction)
            chosen = self.ff_rng.choice(num_f, size=keep, replace=False)
            feat_mask = np.zeros(num_f, dtype=np.float32)
            feat_mask[chosen] = 1.0
        return self.bag, feat_mask

    def _drops(self) -> List[int]:
        """DART's dropped trees of this iteration, in increasing order."""
        cfg, w = self.cfg, self.tree_weights
        if not (self.is_dart and w
                and self.drop_rng.random() >= cfg.skip_drop):
            return []
        if cfg.uniform_drop:
            probs = np.full(len(w), cfg.drop_rate)
        else:
            # LightGBM dart.hpp: drop probability proportional to tree
            # weight, normalized to mean drop_rate
            wts = np.asarray(w, dtype=np.float64)
            mean_w = max(float(wts.mean()), 1e-12)
            probs = np.clip(cfg.drop_rate * wts / mean_w, 0.0, 1.0)
        dropped = list(np.nonzero(self.drop_rng.random(len(w)) < probs)[0])
        if cfg.max_drop > 0 and len(dropped) > cfg.max_drop:
            dropped = sorted(self.drop_rng.choice(
                dropped, size=cfg.max_drop, replace=False))
        return [int(i) for i in dropped]

    # -- one iteration -----------------------------------------------------
    def run(self, it: int) -> torch.Tensor:
        """Local iteration ``it`` of the segment: the packed row."""
        st, cfg, k = self.st, self.cfg, self.st.k
        it_global = it + self.offset
        mask, feat_mask = self._masks(it)

        def col(raw, c):
            return raw if k == 1 else raw[:, c]

        dropped = self._drops()
        raw_for_grad = st.scores()
        if dropped:
            # on the rows ``raw`` holds, then every row's
            raw_for_grad = st.raw.clone()
            for i in dropped:
                col(raw_for_grad, i % k).sub_(self.preds[i]
                                              * self.tree_weights[i])
            raw_for_grad = st.every_row(raw_for_grad)
        g, h, mask = st.grad_hess(raw_for_grad, mask, it_global)

        build = None
        if self.grow is not None:
            nl = (cfg.num_leaves if cfg.num_leaves > 0
                  else 2 ** cfg.effective_depth)

            def build(gc, hc):
                return tuple(torch.from_numpy(a).to(st.dev) for a in
                             self.grow(st.binned, gc, hc, mask, feat_mask,
                                       nl)[:4])
        fm_dev = (None if feat_mask is None or build is not None
                  else torch.from_numpy(feat_mask).to(st.dev))
        trees = st.grow(g, h, mask, fm_dev, it_global, build)

        w_new = 1.0
        if dropped:
            norm = len(dropped) / (len(dropped) + 1.0)
            # scale the dropped trees toward the new ensemble
            for i in dropped:
                old_w = self.tree_weights[i]
                self.tree_weights[i] = old_w * norm
                col(st.raw, i % k).add_(
                    self.preds[i] * (self.tree_weights[i] - old_w))
            w_new = 1.0 / (len(dropped) + 1.0)
        self.tree_weights += [w_new] * k
        return st.add_trees(trees, w_new,
                            self.preds if self.is_dart else None)

    def stats(self) -> dict:
        """What the loop ran: the leaf-wise builder's counts and host
        seconds (``LeafwiseBuilder.timing``), where it grew the trees."""
        return {} if self.grow is None else dict(self.grow.timing)
