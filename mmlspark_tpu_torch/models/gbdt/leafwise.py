"""Leaf-wise (best-first) tree growth: the port of the JAX package's
``mmlspark_tpu/models/gbdt/leafwise.py``.

LightGBM's native growth policy (arXiv:1706.08359 §2): instead of
splitting every node of a level, repeatedly split the one open leaf with
the highest gain, capped by ``num_leaves``. Fits select it with
``MMLSPARK_TORCH_GROW_POLICY=leafwise`` (``trainer.resolve_grow_policy``)
and run through the eager host loop (``host_loop.py``), as the reference
routes them through ``_train_loop``: the frontier is a heap whose shape
changes every split, which no fixed-shape step holds.

Per histogrammed node, one ``hist_cuda.level_histogram`` call with
``width=1`` and the node's membership as ``live``: ``csrc/level_hist.cu``
on the card (its uint8, uint16 or int32 instance, by the ids' dtype), its
plain version on the CPU. The kernel skips rows whose ``live`` is 0, so the
mask is the compaction. Only the smaller child of a split is
histogrammed; its sibling is ``parent - smaller`` in float64, with hess
and count clamped at 0.

What stays on the device and what crosses: the rows' node ids
(``node_of_row``) and the membership masks stay on the device, so no
N-sized array crosses to the host. Each histogram comes back as one
(F, B, 3) copy, and the split scan (``best_split``) runs on it in numpy
float64, the reference's own arithmetic (a ``torch.cumsum`` on the card
sums in another order and could flip an argmax tie). The root's grad and
hess sums are exact-rounded sums (:func:`exact_sum`), the same bits on
the CPU and the card; the reference sums them in numpy's pairwise order,
so a root value may differ from its by the last bits of those float64
sums (bitwise wherever the sums are exact in float64).

Determinism: the heap is keyed (-gain, slot), so equal gains split the
lower slot first, and ``np.argmax`` takes the first of tied (feature,
bin) candidates; the histograms are order-free fixed-point sums, so
repeated fits are the same bits.

Trees come out in the full-layout 6-tuple of the reference's builders
(children of slot s at 2s+1 / 2s+2; leaves at uneven depths), so the
booster, the scorer and the model string need nothing new. Categorical
features, monotone constraints, ``extra_trees`` and
``feature_fraction_by_node`` grow depthwise instead (``trainer.train``
warns once), as in the reference.
"""

from __future__ import annotations

import heapq
import time
from typing import Dict

import numpy as np
import torch

from mmlspark_tpu_torch.models.gbdt.hist_cuda import (
    bin_ids,
    fixed_point_exponents,
    level_histogram,
    pow2,
)

LO_BITS = 31     # exact_sum's second limb: bits below the first's unit


def exact_sum(x: torch.Tensor) -> float:
    """The sum of a 1-d float32 tensor as a Python float, independent of
    the order of the terms and the device: each term, scaled by the
    fixed-point exponent of ``hist_cuda.fixed_point_exponents``, splits
    into an integer part and ``LO_BITS`` bits of fraction, both summed
    exactly in int64 and combined once. Terms below ``2^-(e + 31)`` of the
    largest lose their lowest bits; the result is within a float64 ulp
    or two of the exact sum."""
    n = x.numel()
    if n == 0:
        return 0.0
    e = fixed_point_exponents(x.abs().amax().reshape(1), n)
    s = x.double() * pow2(e)                      # exact
    hi = torch.round(s)
    lo = torch.round((s - hi) * 2.0 ** LO_BITS)   # s - hi is exact
    hi_sum, lo_sum = hi.long().sum(), lo.long().sum()
    carry = lo_sum >> LO_BITS                     # floor: rem >= 0
    rem = lo_sum - (carry << LO_BITS)
    total = ((hi_sum + carry).double() + rem.double() * 2.0 ** -LO_BITS) \
        * pow2(-e)
    return float(total.item())


class LeafwiseBuilder:
    """Best-first builder with the reference's signature (less its unused
    ``key``): ``(binned, grad, hess, valid, feat_mask, remaining_leaves)``
    -> (split_feature int32, threshold_bin int32, node_value float32,
    count float32, decision_type int8, bin_go_left bool (slots, B)) numpy
    arrays in the full heap layout of ``effective_depth`` levels.

    ``binned``: (N, F) uint8, uint16 or int32 ids on the fit's device;
    ``grad``, ``hess``: (N,) float32 there; ``valid``: (N,) float32 0/1
    row mask or None (every row); ``feat_mask``: (F,) 0/1 array-like or
    None (every feature). ``timing`` accumulates over calls: histogram
    calls, the host's seconds enqueueing them, reading them back (which
    waits for the card) and scanning them, and host reads."""

    def __init__(self, num_features: int, total_bins: int, cfg):
        self.cfg = cfg
        self.f, self.b = num_features, total_bins
        self.depth_cap = cfg.effective_depth
        self.num_slots = 2 ** (self.depth_cap + 1) - 1
        self.lam1, self.lam2 = float(cfg.lambda_l1), float(cfg.lambda_l2)
        self.min_child = float(cfg.min_data_in_leaf)
        self.min_hess = float(cfg.min_sum_hessian_in_leaf)
        self.min_gain = float(cfg.min_gain_to_split)
        self.num_bits = 6 if cfg.zero_as_missing else 10
        self.timing: Dict[str, float] = {
            "hist_calls": 0, "host_reads": 0, "hist_s": 0.0, "read_s": 0.0,
            "search_s": 0.0}

    def leaf_obj(self, g, h):
        g_adj = np.sign(g) * np.maximum(np.abs(g) - self.lam1, 0.0)
        denom = h + self.lam2 + 1e-30
        return -g_adj / denom, g_adj * g_adj / denom

    def best_split(self, hist, fmask):
        """hist (F, B, 3) float64 -> (gain, feat, bin, lstats, rstats) or
        None: the depthwise numeric scan (ordered cumsum, the
        min_child / min_hess / min_gain guards, the last bin excluded),
        first maximum."""
        t0 = time.perf_counter()
        b = self.b
        cum = hist.cumsum(axis=1)
        tot = cum[:, -1:, :]
        gl, hl, cl = cum[..., 0], cum[..., 1], cum[..., 2]
        gt, ht, ct = tot[..., 0], tot[..., 1], tot[..., 2]
        gr, hr, cr = gt - gl, ht - hl, ct - cl
        _, score_l = self.leaf_obj(gl, hl)
        _, score_r = self.leaf_obj(gr, hr)
        _, score_p = self.leaf_obj(gt, ht)
        gain = 0.5 * (score_l + score_r - score_p)
        ok = ((cl >= self.min_child) & (cr >= self.min_child)
              & (hl >= self.min_hess) & (hr >= self.min_hess)
              & (gain > self.min_gain) & (fmask[:, None] > 0))
        ok[:, -1] = False
        gain = np.where(ok, gain, -np.inf)
        fb = int(np.argmax(gain))        # first max: deterministic ties
        bg = gain.reshape(-1)[fb]
        self.timing["search_s"] += time.perf_counter() - t0
        if not np.isfinite(bg):
            return None
        feat, tbin = divmod(fb, b)
        lstats = hist[feat, :tbin + 1, :].sum(axis=0)
        rstats = hist[feat].sum(axis=0) - lstats
        return float(bg), int(feat), int(tbin), lstats, rstats

    def node_hist(self, binned, grad, hess, member, local):
        """One node's (F, B, 3) float64 histogram: a width-1 level
        histogram over every row with the node's membership as ``live``,
        read back to the host."""
        t0 = time.perf_counter()
        h = level_histogram(binned, grad, hess, member, local, 1, self.f,
                            self.b)[0]
        t1 = time.perf_counter()
        out = h.cpu().numpy().astype(np.float64)
        t = self.timing
        t["hist_s"] += t1 - t0
        t["read_s"] += time.perf_counter() - t1
        t["hist_calls"] += 1
        t["host_reads"] += 1
        return out

    def __call__(self, binned, grad, hess, valid, feat_mask,
                 remaining_leaves):
        cfg, b = self.cfg, self.b
        dev = binned.device
        n = int(binned.shape[0])
        fmask = (np.ones(self.f, np.float32) if feat_mask is None
                 else np.asarray(feat_mask, np.float32))
        max_leaves = int(remaining_leaves)
        num_slots = self.num_slots

        split_feature = np.full(num_slots, -1, np.int32)
        threshold_bin = np.zeros(num_slots, np.int32)
        node_value = np.zeros(num_slots, np.float32)
        node_count = np.zeros(num_slots, np.float32)

        live = (torch.ones(n, dtype=torch.bool, device=dev) if valid is None
                else valid > 0)
        live_f = live.to(torch.float32)
        node_of_row = torch.zeros(n, dtype=torch.int32, device=dev)
        local = torch.zeros(n, dtype=torch.int32, device=dev)

        # root: the reference's float64 sums over the valid rows (terms
        # grad * valid, exact in float32 for a 0/1 mask)
        root_g = exact_sum(grad * live_f)
        root_h = exact_sum(hess * live_f)
        self.timing["host_reads"] += 3
        rv, _ = self.leaf_obj(np.float64(root_g), np.float64(root_h))
        if cfg.max_delta_step > 0:
            rv = np.clip(rv, -cfg.max_delta_step, cfg.max_delta_step)
        node_value[0] = rv
        node_count[0] = np.float32(int(live.sum()))

        root_hist = self.node_hist(binned, grad, hess, live_f, local)
        heap = []       # (-gain, slot): slot ids break gain ties
        info = {}       # slot -> (hist, depth, feat, bin, ls, rs)
        cand = self.best_split(root_hist, fmask)
        if cand is not None:
            gain, feat, tbin, ls, rs = cand
            heapq.heappush(heap, (-gain, 0))
            info[0] = (root_hist, 0, feat, tbin, ls, rs)

        leaves = 1
        while heap and leaves < max_leaves:
            _, s = heapq.heappop(heap)
            hist, d, feat, tbin, ls, rs = info.pop(s)
            split_feature[s] = feat
            threshold_bin[s] = tbin
            lslot, rslot = 2 * s + 1, 2 * s + 2

            # route the node's rows on the device
            members = live & (node_of_row == s)
            go_left = bin_ids(binned[:, feat]) <= tbin
            node_of_row = torch.where(
                members, torch.where(go_left, lslot, rslot).to(torch.int32),
                node_of_row)

            lval, _ = self.leaf_obj(ls[0], ls[1])
            rval, _ = self.leaf_obj(rs[0], rs[1])
            if cfg.path_smooth > 0:
                pv = node_value[s]
                wl = ls[2] / (ls[2] + cfg.path_smooth)
                wr = rs[2] / (rs[2] + cfg.path_smooth)
                lval = lval * wl + pv * (1.0 - wl)
                rval = rval * wr + pv * (1.0 - wr)
            if cfg.max_delta_step > 0:
                lval = np.clip(lval, -cfg.max_delta_step,
                               cfg.max_delta_step)
                rval = np.clip(rval, -cfg.max_delta_step,
                               cfg.max_delta_step)
            node_value[lslot], node_value[rslot] = lval, rval
            node_count[lslot], node_count[rslot] = ls[2], rs[2]
            leaves += 1

            if d + 1 < self.depth_cap:
                # histogram the smaller child; its sibling by subtraction
                small_left = ls[2] <= rs[2]
                small = lslot if small_left else rslot
                hist_small = self.node_hist(
                    binned, grad, hess,
                    (members & (go_left == small_left)).to(torch.float32),
                    local)
                hist_big = hist - hist_small
                # float cancellation: clamp derived hess/count for the
                # guards, as the depthwise builder does
                hist_big[..., 1] = np.maximum(hist_big[..., 1], 0.0)
                hist_big[..., 2] = np.maximum(hist_big[..., 2], 0.0)
                pair = ((lslot, hist_small if small == lslot else hist_big),
                        (rslot, hist_small if small == rslot else hist_big))
                for cslot, chist in pair:
                    c = self.best_split(chist, fmask)
                    if c is not None:
                        cgain, cfeat, cbin, cls_, crs = c
                        heapq.heappush(heap, (-cgain, cslot))
                        info[cslot] = (chist, d + 1, cfeat, cbin, cls_,
                                       crs)

        split = split_feature >= 0
        decision_type = np.where(split, self.num_bits, 0).astype(np.int8)
        bin_go_left = split[:, None] & (
            np.arange(b)[None, :] <= threshold_bin[:, None])
        return (split_feature, threshold_bin, node_value, node_count,
                decision_type, bin_go_left)


def make_build_tree_leafwise(num_features: int, total_bins: int,
                             cfg) -> LeafwiseBuilder:
    """The best-first builder of one fit (the reference's
    ``make_build_tree_leafwise``)."""
    return LeafwiseBuilder(num_features, total_bins, cfg)

