"""Multi-device GBDT tree learners over ``torch.distributed`` — the port
of ``mmlspark_tpu/models/gbdt/parallel_modes.py`` and of the data-parallel
fit that GSPMD makes of the reference's serial ``make_build_tree`` under a
mesh.

Parity: LightGBM's distributed tree learners, selected by ``parallelism``
(``tree_learner``); ``trainer.resolve_mode`` picks one per fit:

- ``data`` — rows sharded over ``dp``; each level's histogram sums are
  all-reduced whole, and every rank runs the serial split finding on
  them (the reference's full-``psum`` path);
- ``data_sharded`` — rows sharded over ``dp``; the sums are
  reduce-scattered by contiguous feature slices (features padded to a
  multiple of ``dp``), each rank rounds and scans its slice, the
  per-slice bests are all-gathered and the first maximum over the
  flattened (feature, bin) wins, as in the serial scan; the winner's
  rank shares its feature, bin and child stats by a masked all-reduce
  (``MMLSPARK_TORCH_HIST_SHARD``);
- ``voting`` — rows sharded over ``dp``; each rank votes for its
  ``top_k`` best features per node on its own rows, the votes are
  all-reduced, and only the sums of the ``2 * top_k`` most voted
  features (ties to the lower id, then in feature order) are
  all-reduced and scanned;
- ``feature`` — rows replicated, the columns sharded over ``fp`` in
  contiguous slices of ``F / fp``; each rank histograms and scans its
  own columns, the winners combine as in ``data_sharded``, and the
  owner of each node's winning feature routes that node's rows, shared
  by an all-reduce of one byte a row.

The port is multi-controller: each rank is a process, and every rank
calls ``trainer.train(..., mesh=mesh)`` (or ``.set_mesh(mesh).fit``) with
the same full arrays; :class:`Learner` holds this rank's share and runs
its side of every collective. The reference is single-controller: one
process calls ``train(..., mesh=mesh)`` and ``shard_map`` lays out the
ranks.

Every learner keeps the serial fit's bits. The float32 histogram is
fixed point (``hist_cuda``): each rank's int64 sums under exponents taken
from the maxima over every rank's rows (``all_reduce`` max) and the
fit's row count are summed exactly (``all_reduce`` / ``reduce_scatter``
of int64) and rounded once, so the reduced histogram is the serial one
bit for bit, whatever the split of the rows; float values travel only
as bits (a masked integer all-reduce) or by gathering. The split scans
are the serial ones (``trainer._numeric_gains``, ``_best_splits``'
first maximum and leaf budget, ``_child_values``). The per-row parts of
the step (the sampling masks, the objective, the root's sums, the
metrics) run on every row, from the raw scores gathered once per
iteration (``step.Step.scores``), as the serial step runs them. So
every objective runs under every learner as it runs serially: GOSS's
multipliers from the draws over every row and the quantile of every
row's |g|, lambdarank and the NDCG metric over the layout of every
query group, a custom objective called with every row's scores, the
labels and the weights as passed; the rows' share of each (this rank's
rows, the padding at weight 0) goes to the histograms. DART's host loop
keeps each tree's prediction on the rows the step's raw scores hold
(``host_loop.py``). So ``data`` and ``data_sharded`` fits, ``feature``
fits, and ``voting`` fits with ``top_k >= F`` give the serial fit's
trees and scores bit for bit (the reference holds its modes to
reduction-order tolerances).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from mmlspark_tpu_torch.models.gbdt import hist_cuda
from mmlspark_tpu_torch.parallel import mesh as mesh_mod
from mmlspark_tpu_torch.parallel.mesh import DATA_AXIS, FEATURE_AXIS

MODES = ("data", "data_sharded", "voting", "feature")


def check_supported(cfg, mode: str, num_features: int, mesh) -> None:
    """Raise for a config a learner cannot honor: the reference's
    ``NotImplementedError`` for voting / feature with categorical
    features, monotone constraints or ``extra_trees``, its
    ``ValueError`` for feature-parallel with features that ``fp`` does
    not divide, and ``NotImplementedError`` for voting / feature with
    ``feature_fraction_by_node`` (the reference fails there with a
    ``TypeError``: its voting and feature builders take no per-node
    draw key)."""
    if mode in ("voting", "feature") and cfg.categorical_features:
        raise NotImplementedError(
            "categorical splits are implemented for the serial/data "
            "tree learners; voting/feature parallel modes treat all "
            "features as numerical — drop categorical_features or use "
            "tree_learner='data'")
    if mode in ("voting", "feature") and any(cfg.monotone_constraints or ()):
        raise NotImplementedError(
            "monotone constraints are implemented for the serial/data "
            "tree learners; voting/feature parallel modes would silently "
            "violate them — use tree_learner='data'")
    if mode in ("voting", "feature") and cfg.extra_trees:
        raise NotImplementedError(
            "extra_trees is implemented for the serial/data tree "
            "learners — use tree_learner='data'")
    if mode in ("voting", "feature") and cfg.feature_fraction_by_node < 1.0:
        raise NotImplementedError(
            "feature_fraction_by_node is implemented for the serial/data "
            "tree learners — use tree_learner='data'")
    fp = mesh_mod.axis_size(mesh, FEATURE_AXIS)
    if mode == "feature" and num_features % fp:
        raise ValueError(f"feature_parallel needs features ({num_features}) "
                         f"divisible by fp ({fp})")


def hist_reduction_bytes(num_features: int, total_bins: int, depth: int,
                         dp: int, sharded: bool, cell_bytes: int = 4) -> int:
    """Per-rank histogram-reduction payload of ONE tree (the reference's
    ``hist_reduction_bytes``, the same numbers at its ``cell_bytes`` 4,
    the float32 stats of its reduction): the bytes of reduced histogram
    each rank receives over the levels, ``cell_bytes`` per (node,
    feature, bin, channel) cell, plus in the sharded mode the winner
    combine (the gathered per-slice gains, the masked all-reduce of the
    winning feature and bin, and of the left and total child stats).
    The port reduces int64 sums: ``cell_bytes`` 8 is its payload, the
    bytes its collectives tagged ``"hist"`` move (``Mesh.bytes``)."""
    f_pad = ((num_features + dp - 1) // dp) * dp
    total = 0
    for d in range(depth):
        width = 2 ** d
        full = width * num_features * total_bins * 3 * cell_bytes
        if not sharded:
            total += full
            continue
        slice_bytes = width * f_pad * total_bins * 3 * cell_bytes // dp
        combine = (dp * width * 4          # all_gather of per-shard gains
                   + 2 * width * 4         # best_feat/best_bin psums
                   + 2 * width * 3 * 4)    # left/total child-stat psums
        total += slice_bytes + combine
    return total


class Learner:
    """This rank's share of a fit under ``mode`` on ``mesh``: ``n_total``
    rows of ``num_features`` features in all; rows ``[row_lo, row_lo +
    n_local)`` of the rows padded to a multiple of ``dp`` (the data
    modes; ``row_valid`` (n_local,) float32 zeroes the padding, None
    where this rank has none), or every row and the columns ``[f_lo,
    f_hi)`` (feature mode)."""

    def __init__(self, mode: str, mesh, cfg, n_total: int,
                 num_features: int):
        if mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
        self.mode, self.mesh, self.cfg = mode, mesh, cfg
        self.n_total, self.num_features = n_total, num_features
        self.rows_sharded = mode != "feature"
        dp = mesh_mod.axis_size(mesh, DATA_AXIS)
        fp = mesh_mod.axis_size(mesh, FEATURE_AXIS)
        if self.rows_sharded:
            self.axis = DATA_AXIS
            self.n_pad = -(-n_total // dp) * dp
            self.n_local = self.n_pad // dp
            self.row_lo = mesh_mod.axis_index(mesh, DATA_AXIS) * self.n_local
            self.f_lo, self.f_hi = 0, num_features
        else:
            self.axis = FEATURE_AXIS
            self.n_pad = self.n_local = n_total
            self.row_lo = 0
            f_loc = num_features // fp
            self.f_lo = mesh_mod.axis_index(mesh, FEATURE_AXIS) * f_loc
            self.f_hi = self.f_lo + f_loc
        self.real_local = max(0, min(self.n_local, n_total - self.row_lo))
        self.row_valid: Optional[torch.Tensor] = None

    # -- this rank's share of the inputs ---------------------------------
    def rows(self, a, fill=0):
        """This rank's rows of the (N, ...) array ``a`` (numpy or a
        tensor), padded where the fit's rows end with ``fill`` (the last
        row where ``fill`` is None, as the reference pads the bin
        ids)."""
        if a is None or not self.rows_sharded:
            return a
        part = a[self.row_lo:self.row_lo + self.real_local]
        pad = self.n_local - self.real_local
        if not pad:
            return part
        if isinstance(a, torch.Tensor):
            tail = (a[-1:].expand(pad, *a.shape[1:]) if fill is None
                    else torch.full((pad, *a.shape[1:]), fill,
                                    dtype=a.dtype, device=a.device))
            return torch.cat([part, tail])
        tail = (np.repeat(a[-1:], pad, axis=0) if fill is None
                else np.full((pad, *a.shape[1:]), fill, dtype=a.dtype))
        return np.concatenate([part, tail])

    def columns(self, binned):
        """This rank's columns of the (N, F) bin ids (feature mode), or
        its rows (the data modes)."""
        if self.rows_sharded:
            return self.rows(binned, fill=None)
        return binned[:, self.f_lo:self.f_hi]

    def set_device(self, dev: torch.device) -> None:
        """Make ``row_valid`` on ``dev``: 1 on this rank's rows of the
        fit, 0 on its padding (None where it has none)."""
        if self.real_local < self.n_local:
            rv = torch.zeros(self.n_local, dtype=torch.float32, device=dev)
            rv[:self.real_local] = 1.0
            self.row_valid = rv

    # -- rows ---------------------------------------------------------------
    def gather_rows(self, t: torch.Tensor) -> torch.Tensor:
        """The (N, ...) tensor of every rank's rows of ``t`` (the data
        modes: gathered over ``dp``, the padding cut), or ``t`` (feature
        mode: every rank holds every row)."""
        if not self.rows_sharded:
            return t
        full = mesh_mod.all_gather(self.mesh, t.contiguous(), DATA_AXIS,
                                   tag="rows")
        return full[:self.n_total]

    def live_rows(self, live: torch.Tensor) -> torch.Tensor:
        return live if self.row_valid is None else live * self.row_valid

    # -- histograms ---------------------------------------------------------
    def _exps(self, grad, hess, live):
        """The fixed-point exponents of the level: the channel maxima over
        every rank's rows (a max all-reduce over ``dp``; feature mode's
        ranks hold every row) and the fit's row count."""
        amax = hist_cuda.level_histogram_amax(grad, hess, live)
        if self.rows_sharded:
            amax = mesh_mod.all_reduce(self.mesh, amax, DATA_AXIS, "max",
                                       tag="amax")
        return hist_cuda.fixed_point_exponents(amax, self.n_total)

    def _sums(self, binned, grad, hess, live, local, width, b, exps):
        f = binned.shape[1]
        acc = torch.zeros((width, f, b, 3), dtype=torch.int64,
                          device=binned.device)
        return hist_cuda.level_histogram_sums(binned, grad, hess, live,
                                              local, width, f, b, exps, acc)

    def histogram(self, binned, grad, hess, live, local, width: int,
                  b: int) -> torch.Tensor:
        """``data``: the level's (width, F, B, 3) histogram of every
        rank's rows, the serial one bit for bit: int64 sums all-reduced
        over ``dp`` and rounded once."""
        exps = self._exps(grad, hess, live)
        acc = self._sums(binned, grad, hess, live, local, width, b, exps)
        acc = mesh_mod.all_reduce(self.mesh, acc, DATA_AXIS, tag="hist")
        return hist_cuda.fixed_point_round(acc, exps)

    # -- split finding (data_sharded, voting, feature) --------------------
    def find_splits(self, binned, grad, hess, live, local, width: int,
                    fmask, remaining, parent_value, kw):
        """The level's splits as ``trainer._find_numeric_splits`` returns
        them, found by this mode's protocol."""
        b = kw["b"]
        exps = self._exps(grad, hess, live)
        acc = self._sums(binned, grad, hess, live, local, width, b, exps)
        if self.mode == "voting":
            return self._voting(acc, exps, fmask, remaining, parent_value,
                                kw)
        f = self.num_features
        if self.mode == "feature":
            hist_loc = hist_cuda.fixed_point_round(acc, exps)
            own = None if fmask is None else fmask[:, self.f_lo:self.f_hi]
            return self._owner_select(hist_loc, own, self.f_lo,
                                      FEATURE_AXIS, remaining, parent_value,
                                      kw)
        # data_sharded: reduce-scatter contiguous feature slices
        dp = mesh_mod.axis_size(self.mesh, DATA_AXIS)
        f_loc = -(-f // dp)
        if f_loc * dp != f:
            acc = torch.nn.functional.pad(acc, (0, 0, 0, 0, 0, f_loc * dp - f))
        blocks = acc.reshape(width, dp, f_loc, b, 3).transpose(0, 1)
        mine = mesh_mod.reduce_scatter(
            self.mesh, blocks.reshape(dp * width, f_loc, b, 3), DATA_AXIS,
            tag="hist")
        hist_loc = hist_cuda.fixed_point_round(mine.contiguous(), exps)
        f_lo = mesh_mod.axis_index(self.mesh, DATA_AXIS) * f_loc
        ids = torch.arange(f_lo, f_lo + f_loc, device=acc.device)
        own = (ids < f)[None, :]
        if fmask is not None:
            own = own & fmask[:, ids.clamp(max=f - 1)]
        return self._owner_select(hist_loc, own, f_lo, DATA_AXIS, remaining,
                                  parent_value, kw)

    def _owner_select(self, hist_loc, own, f_lo: int, axis: str, remaining,
                      parent_value, kw):
        """The serial first-maximum scan over features split in
        contiguous slices: each rank's best of its slice, all-gathered;
        the first maximum over the ranks (ascending slices, so the serial
        flat order) wins, and its rank shares the feature, the bin and
        the child stats (a masked all-reduce of their bits)."""
        from mmlspark_tpu_torch.models.gbdt import trainer as T

        b = kw["b"]
        width = hist_loc.shape[0]
        dev = hist_loc.device
        gain, _ = T._numeric_gains(
            hist_loc, own, b=b, lam1=kw["lam1"], lam2=kw["lam2"],
            min_child=kw["min_child"], min_hess=kw["min_hess"],
            min_gain=kw["min_gain"])
        flat = gain.reshape(width, -1)
        loc_fb = torch.argmax(flat, dim=1)
        loc_gain = torch.gather(flat, 1, loc_fb[:, None])[:, 0]
        size = mesh_mod.axis_size(self.mesh, axis)
        gains = mesh_mod.all_gather(self.mesh, loc_gain, axis,
                                    tag="hist").reshape(size, width)
        # torch.argmax returns the first maximum: the lowest slice
        winner = torch.argmax(gains, dim=0)
        best_gain = torch.gather(gains, 0, winner[None, :])[0]
        mine = winner == mesh_mod.axis_index(self.mesh, axis)
        loc_f = loc_fb // b
        loc_bin = loc_fb % b
        fb = torch.stack([loc_f + f_lo, loc_bin]).to(torch.int32)
        fb = mesh_mod.all_reduce(self.mesh, torch.where(mine, fb, 0), axis,
                                 tag="hist").long()
        best_feat, best_bin = fb[0], fb[1]
        hist_best = hist_loc[torch.arange(width, device=dev), loc_f]
        left_mask = torch.arange(b, device=dev)[None, :] <= loc_bin[:, None]
        left = torch.sum(hist_best * left_mask[..., None], dim=1)
        tot = torch.sum(hist_best, dim=1)
        bits = torch.stack([left, tot]).view(torch.int32)
        bits = mesh_mod.all_reduce(self.mesh,
                                   torch.where(mine[None, :, None], bits, 0),
                                   axis, tag="hist")
        left, tot = bits.view(torch.float32)
        right = tot - left
        do_split, remaining = T._leaf_budget(best_gain, remaining)
        lval, rval, smaller = T._child_values(
            left, right, parent_value, lam1=kw["lam1"], lam2=kw["lam2"],
            path_smooth=kw["path_smooth"],
            max_delta_step=kw["max_delta_step"])
        return (do_split, best_feat, best_bin, lval, rval, left, right,
                remaining, smaller)

    def _voting(self, acc, exps, fmask, remaining, parent_value, kw):
        """Voting: the local scan's ``top_k`` features per node voted,
        the votes all-reduced, and the sums of the most voted ``min(2 *
        top_k, F)`` features (ties to the lower id; then in feature
        order, so at ``top_k >= F`` the serial scan) all-reduced and
        scanned."""
        from mmlspark_tpu_torch.models.gbdt import trainer as T

        b = kw["b"]
        width, f = acc.shape[:2]
        dev = acc.device
        gain_kw = dict(b=b, lam1=kw["lam1"], lam2=kw["lam2"],
                       min_child=kw["min_child"], min_hess=kw["min_hess"],
                       min_gain=kw["min_gain"])
        local_hist = hist_cuda.fixed_point_round(acc, exps)
        local_gain, _ = T._numeric_gains(local_hist, fmask, **gain_kw)
        per_feat = local_gain.amax(dim=2)                      # (width, F)
        top_k = min(max(int(self.cfg.top_k), 1), f)
        top = torch.argsort(-per_feat, dim=1, stable=True)[:, :top_k]
        votes = torch.zeros((width, f), dtype=torch.int32, device=dev)
        votes.scatter_(1, top, 1)
        votes = mesh_mod.all_reduce(self.mesh, votes, DATA_AXIS, tag="vote")
        cand = min(2 * top_k, f)
        cands = torch.sort(torch.argsort(-votes, dim=1, stable=True)[:, :cand],
                           dim=1).values                        # (width, C)
        cand_acc = torch.take_along_dim(acc, cands[:, :, None, None], dim=1)
        cand_acc = mesh_mod.all_reduce(self.mesh, cand_acc.contiguous(),
                                       DATA_AXIS, tag="hist")
        hist_c = hist_cuda.fixed_point_round(cand_acc, exps)
        cmask = (None if fmask is None else
                 torch.take_along_dim(fmask.expand(width, f), cands, dim=1))
        gain, _ = T._numeric_gains(hist_c, cmask, **gain_kw)
        do_split, best_c, best_bin, remaining = T._best_splits(gain,
                                                               remaining, b)
        best_feat = torch.gather(cands, 1, best_c[:, None])[:, 0]
        left_mask = torch.arange(b, device=dev)[None, :] <= best_bin[:, None]
        lval, rval, left, right, smaller = T._children(
            hist_c, best_c, left_mask, parent_value, lam1=kw["lam1"],
            lam2=kw["lam2"], path_smooth=kw["path_smooth"],
            max_delta_step=kw["max_delta_step"])
        return (do_split, best_feat, best_bin, lval, rval, left, right,
                remaining, smaller)

    # -- routing (feature mode) ----------------------------------------------
    def route(self, node, d: int, local, binned, best_feat, best_bin,
              do_split):
        """Each row's slot after level ``d`` (feature mode): the owner of
        a node's winning feature decides its rows' sides, shared by a sum
        all-reduce of one byte a row over ``fp``; the serial rule
        (``trainer._route_rows``) otherwise."""
        from mmlspark_tpu_torch.models.gbdt import trainer as T

        f_loc = self.f_hi - self.f_lo
        moving = (node >= 2 ** d - 1) & do_split[local]
        feat = best_feat[local] - self.f_lo
        mine = moving & (feat >= 0) & (feat < f_loc)
        nbin = T._bins_at(binned, feat.clamp(0, f_loc - 1))
        vote = (mine & (nbin.long() <= best_bin[local])).to(torch.uint8)
        go_left = mesh_mod.all_reduce(self.mesh, vote, FEATURE_AXIS,
                                      tag="route") > 0
        child = torch.where(go_left, 2 * node + 1, 2 * node + 2)
        return torch.where(moving, child, node)
