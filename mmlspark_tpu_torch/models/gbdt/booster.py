"""Tree-ensemble representation and batch scoring on PyTorch.

Port of the JAX package's ``BoosterArrays``. Every tree is stored in a
fixed full-binary layout (node i's children are 2i+1 / 2i+2); scoring
walks every row down every tree and adds the trees one by one in order,
each add rounded as the fused multiply-add XLA makes of it, so the
accumulation is the JAX ``scan``'s.

Routing is the JAX package's ``_go_left_fn``: a booster without
``decision_type`` sends NaN left (as the missing bin 0 goes in training)
and compares the rest with the threshold; one with it follows LightGBM's
decision bits per node (default-left, missing type, and at categorical
nodes the category bitset ``cat_bitset``; ``score_cuda.decision_left``).

``predict``, ``predict_binned``, ``leaf_index`` and the serving scorer
``predict_binned_scorer`` all score through a ``TreeScorer``: the
booster's tables on one device once (cached per booster, kind, autocast
and device; ``clear_jit_cache`` drops them), and per call one
``score_cuda.tree_score`` — the kernel ``csrc/tree_score.cu`` on the
card, one launch per batch, its plain version on the CPU. Leaf indices
are a second output of the same walk. ``contrib`` (exact path-dependent
TreeSHAP) and ``contrib_saabas`` are plain torch ops on whatever device
they run. ``derive_binning`` recovers a binning from an imported model
string's own thresholds so such a model can be served binned too.

Also carries the host-side model methods of the JAX package's booster:
feature importances, LightGBM's native model-string format (written and
read exactly as the JAX package does, so strings cross between the
packages), iteration slices, warm-start concatenation and the state
dict a saved model persists.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import DeviceLike, resolve_device
from mmlspark_tpu_torch.models.gbdt.score_cuda import (BIN_CODES, StagedBatch,
                                                       decision_left,
                                                       make_tables,
                                                       pack_decision_nodes,
                                                       pack_nodes, tree_score,
                                                       tree_score_staged)
from mmlspark_tpu_torch.ops.ingest import binned_ingest_dtype
from mmlspark_tpu_torch.parallel.shard_rules import placement_cast


@dataclass
class BoosterArrays:
    """SoA ensemble. All (T, M) with M = 2^(D+1)-1 full-tree slots.

    ``split_feature < 0`` marks a leaf slot; ``node_value`` holds the
    (already shrunk) output value for leaves and the would-be output for
    internal nodes. Arrays are host numpy; scoring moves them to the
    device it runs on.
    """

    split_feature: np.ndarray      # (T, M) int32, -1 for leaf
    threshold_bin: np.ndarray      # (T, M) int32  (bins <= t go left)
    threshold_value: np.ndarray    # (T, M) float64 raw-value upper edge
    node_value: np.ndarray         # (T, M) float32
    count: np.ndarray              # (T, M) float32 train rows per node
    tree_weights: np.ndarray       # (T,) float32
    max_depth: int
    num_features: int
    num_class: int = 1             # trees are interleaved per class
    objective: str = "regression"
    init_score: float = 0.0
    feature_names: Optional[List[str]] = None
    decision_type: Optional[np.ndarray] = None   # (T, M) int8
    cat_bitset: Optional[np.ndarray] = None      # (T, M, W) uint32

    @property
    def num_trees(self) -> int:
        return self.split_feature.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.split_feature.shape[1]

    @property
    def has_categorical(self) -> bool:
        return (self.decision_type is not None and self.cat_bitset is not None
                and bool((self.decision_type & 1).any()))

    @property
    def supports_binned(self) -> bool:
        """Binned-scoring eligibility, as the JAX package decides it:
        numerical-only routing and valid bin thresholds. Memoised: the
        arrays are immutable after construction (derive modified
        boosters with ``dataclasses.replace``)."""
        cached = self.__dict__.get("_supports_binned")
        if cached is None:
            cached = (not self.has_categorical
                      and not bool((self.threshold_bin[
                          self.split_feature >= 0] < 0).any()))
            self.__dict__["_supports_binned"] = cached
        return cached

    @property
    def zero_premap_mode(self) -> str:
        """How exact-0.0 inputs must be handled before binned scoring:
        ``"none"`` (no zero-as-missing nodes, or no ``decision_type``),
        ``"all_left"`` (every zero-as-missing node routes missing left:
        map 0.0 -> NaN before binning, as a zero-as-missing fit did) or
        ``"unsupported"`` (mixed per-node zero semantics a per-feature
        bin id cannot express). Memoised like ``supports_binned``."""
        cached = self.__dict__.get("_zero_premap_mode")
        if cached is None:
            if self.decision_type is None:
                cached = "none"
            else:
                internal = self.split_feature >= 0
                dt = self.decision_type[internal]
                num_dt = dt[(dt & 1) == 0]   # numerical internal nodes
                mt1 = ((num_dt >> 2) & 3) == 1
                if not bool(mt1.any()):
                    cached = "none"
                elif bool((mt1 & ((num_dt & 2) != 0)).all()):
                    cached = "all_left"
                else:
                    cached = "unsupported"
            self.__dict__["_zero_premap_mode"] = cached
        return cached

    def clear_jit_cache(self) -> None:
        """Drop the cached scorers (the serving warm/cold LRU's eviction
        hook): their device tables are released and a scorer is built
        again on its next use. The memoised verdicts
        (``supports_binned`` / ``zero_premap_mode``) stay."""
        self.__dict__.pop("_scorers", None)

    def _scorer(self, raw: bool, autocast: str, device: DeviceLike,
                decision: bool = False) -> "TreeScorer":
        dev = resolve_device(device)
        cache = self.__dict__.setdefault("_scorers", {})
        key = (raw, autocast, str(dev), decision)
        if key not in cache:
            cache[key] = TreeScorer(self, dev, raw=raw, autocast=autocast,
                                    decision=decision)
        return cache[key]

    def predict_binned_scorer(self, autocast: str = "off",
                              device: DeviceLike = None) -> "TreeScorer":
        """The serving scorer, the counterpart of the JAX package's
        ``predict_binned_jit(autocast)``: BINNED features (N, F) ->
        raw scores, (N,) or (N, K), on ``device`` (the card unless
        ``"cpu"``). Built once per (autocast, device) and cached on the
        booster. ``autocast="bf16"`` keeps the leaf table in bfloat16
        (``placement_cast``); each leaf value is promoted to float32
        against the float32 tree weight, so accumulation stays float32
        and only the stored leaf values are rounded."""
        if autocast not in ("off", "bf16"):
            raise ValueError(f"predict_binned_scorer: autocast={autocast!r} "
                             "not in ('off', 'bf16')")
        if not self.supports_binned:
            if self.has_categorical:
                raise NotImplementedError(
                    "binned scoring routes by threshold_bin; categorical "
                    "splits route by raw-value bitset — use predict")
            raise ValueError(
                "this booster has no binned thresholds (imported from a "
                "LightGBM model string, which carries raw-value "
                "thresholds only) — use predict on raw features, or "
                "derive_binning() to recover a binning from the model's "
                "own splits and score binned")
        return self._scorer(False, autocast, device)

    def predict_binned(self, binned, device: DeviceLike = None) -> torch.Tensor:
        """BINNED features (N, F) small-int bin ids (the
        ``BinMapper.transform`` output the model was trained on, best as
        uint8) -> raw scores, (N,) or (N, K): routes by
        ``bin <= threshold_bin`` (the missing bin 0 goes left), as the
        JAX package's ``predict_binned_fn`` does whatever the decision
        bits. Categorical boosters are refused."""
        if not self.supports_binned:
            if self.has_categorical:
                raise NotImplementedError(
                    "binned scoring routes by threshold_bin; categorical "
                    "splits route by raw-value bitset — use predict")
            raise ValueError(
                "this booster has no binned thresholds (imported from a "
                "model string); score raw features with predict")
        return self._scorer(False, "off", device)(binned)

    def predict(self, x, device: DeviceLike = None) -> torch.Tensor:
        """Raw features (N, F) -> raw scores, (N,) or (N, K), routed as
        the JAX package's ``predict_fn`` routes them (``_go_left_fn``):
        without ``decision_type`` NaN goes left, matching training where
        the missing bin (0) satisfies bin <= threshold; with it, by the
        decision bits (``score_cuda.decision_left``). Features and
        thresholds compare in float32."""
        return self._scorer(True, "off", device,
                            decision=self.decision_type is not None)(x)

    def leaf_index(self, x, device: DeviceLike = None) -> torch.Tensor:
        """Raw features (N, F) -> (N, T) int32: the slot of the leaf each
        row reaches in each tree, the JAX package's ``leaf_index_fn``
        (LightGBM's predLeaf in the full layout). One walk of the decision
        route gives the leaf slots and the scores together (a booster
        without ``decision_type`` routes as default-left with NaN missing,
        bits 10, which is how it routes anyway)."""
        return self._scorer(True, "off", device, decision=True)(
            x, leaves=True)[1]

    # -- contributions ------------------------------------------------------
    def _router(self, dev: torch.device):
        """``(tree, nodes, fx) -> bool``: where values ``fx`` go left at
        the slots ``nodes`` of tree ``tree`` (broadcast against ``fx``),
        the JAX package's ``_go_left_fn`` on ``dev``."""
        tv = torch.as_tensor(self.threshold_value, dtype=torch.float32,
                             device=dev)
        if self.decision_type is None:
            return lambda t, node, fx: torch.isnan(fx) | (fx <= tv[t][node])
        dt = torch.as_tensor(self.decision_type.astype(np.int64), device=dev)
        if not self.has_categorical:
            return lambda t, node, fx: decision_left(fx, dt[t][node],
                                                     tv[t][node])
        bits = torch.as_tensor(self.cat_bitset.astype(np.int64), device=dev)
        words = bits.shape[2]

        def go_left(t, node, fx):
            held = bits[t][node].expand(*fx.shape, words)
            return decision_left(
                fx, dt[t][node], tv[t][node],
                lambda w: torch.gather(held, -1, w[..., None])[..., 0],
                words * 32)
        return go_left

    def _rows(self, x, dev: torch.device) -> torch.Tensor:
        return torch.as_tensor(x).to(torch.float32).to(dev)

    def _ancestor_tables(self):
        """Per-slot root-to-slot path tables of the full layout, the JAX
        package's: (anc_node, anc_child, anc_valid, is_left), each
        (M, D). Slot s's entry j is the split at ``anc_node[s, j]`` whose
        on-path child is ``anc_child[s, j]``; unused entries padded."""
        m, d = self.num_nodes, self.max_depth
        anc_node = np.zeros((m, d), np.int64)
        anc_child = np.zeros((m, d), np.int64)
        anc_valid = np.zeros((m, d), bool)
        for slot in range(m):
            chain = []
            cur = slot
            while cur > 0:
                par = (cur - 1) // 2
                chain.append((par, cur))
                cur = par
            for j, (par, ch) in enumerate(reversed(chain)):
                anc_node[slot, j], anc_child[slot, j] = par, ch
                anc_valid[slot, j] = True
        return anc_node, anc_child, anc_valid, anc_child == 2 * anc_node + 1

    def contrib(self, x, device: DeviceLike = None) -> torch.Tensor:
        """Exact path-dependent TreeSHAP contributions, the JAX package's
        ``contrib_fn``: raw features (N, F) -> (N, F + 1) float32, the
        last column the expected value; per-class blocks (N, K * (F + 1))
        for K > 1 (tree t adds to class t % K). For every reachable leaf
        the root-to-leaf path adds ``v * (o_i - z_i) * PSI_i`` to each
        path feature i (o the row's routing indicator, z the cover
        ratio, PSI_i the permutation-weighted leave-one-out path
        polynomial, built by positive multiply-adds as the reference
        builds it); duplicate path features merge into their first
        occurrence. Plain torch ops on ``device`` (the card unless
        ``"cpu"``), in blocks of rows whose (rows, M) working tensors
        stay small."""
        dev = resolve_device(device)
        xt = self._rows(x, dev)
        n, num_f, depth, m = (xt.shape[0], self.num_features, self.max_depth,
                              self.num_nodes)
        k = max(self.num_class, 1)
        route = self._router(dev)
        anc_node, anc_child, anc_valid, is_left = (
            torch.as_tensor(a, device=dev) for a in self._ancestor_tables())
        wgt = [math.factorial(lv) * math.factorial(depth - 1 - lv)
               / math.factorial(depth) for lv in range(depth)]
        wgt = np.asarray(wgt, np.float32).tolist()
        sf_all = torch.as_tensor(self.split_feature.astype(np.int64),
                                 device=dev)
        ct_all = torch.as_tensor(self.count, dtype=torch.float32, device=dev)
        nv_all = torch.as_tensor(self.node_value, dtype=torch.float32,
                                 device=dev)
        tw = torch.as_tensor(self.tree_weights, dtype=torch.float32,
                             device=dev)
        all_nodes = torch.arange(m, device=dev)
        acc = torch.zeros((n, k, num_f + 1), dtype=torch.float32, device=dev)
        acc[:, :, num_f] += torch.tensor(self.init_score, dtype=torch.float32)
        block = max(1, CONTRIB_CELLS // max(m, 1))
        for t in range(self.num_trees):
            sf_t, ct_t = sf_all[t], ct_all[t]
            v_t = nv_all[t] * tw[t]
            u = [torch.where(anc_valid[:, j], sf_t[anc_node[:, j]], -1)
                 for j in range(depth)]
            z = [torch.where(anc_valid[:, j], ct_t[anc_child[:, j]]
                             / torch.clamp_min(ct_t[anc_node[:, j]], 1.0),
                             1.0) for j in range(depth)]
            reach = torch.ones(m, dtype=torch.bool, device=dev)
            for j in range(depth):
                reach &= torch.where(anc_valid[:, j],
                                     sf_t[anc_node[:, j]] >= 0, True)
            leaf_mask = (reach & (sf_t < 0)).to(torch.float32)
            vmask = v_t * leaf_mask
            for s in range(0, n, block):
                xs = xt[s:s + block]
                gl = route(t, all_nodes, xs[:, sf_t.clamp_min(0)])
                o = [torch.where(anc_valid[None, :, j],
                                 torch.where(is_left[None, :, j],
                                             gl[:, anc_node[:, j]],
                                             ~gl[:, anc_node[:, j]]),
                                 True).to(torch.float32)
                     for j in range(depth)]
                zs = list(z)
                _merge_duplicates(u, zs, o, m, dev)
                if s == 0:
                    zprod = leaf_mask
                    for j in range(depth):
                        zprod = zprod * zs[j]
                    base = torch.sum(v_t * zprod)
                phi = torch.zeros((xs.shape[0], num_f), dtype=torch.float32,
                                  device=dev)
                for i in range(depth):
                    coeffs = [torch.ones_like(o[0])]
                    for j in range(depth):
                        if j == i:
                            continue
                        coeffs = [
                            (coeffs[lv] * zs[j] if lv < len(coeffs) else 0)
                            + (coeffs[lv - 1] * o[j] if lv else 0)
                            for lv in range(len(coeffs) + 1)]
                    psi = coeffs[0] * wgt[0]
                    for lv in range(1, depth):
                        # rounded once, as XLA's fused multiply-add
                        psi = (psi.double() + coeffs[lv].double() * wgt[lv]
                               ).float()
                    amount = vmask * (o[i] - zs[i]) * psi
                    amount = amount * (u[i] >= 0)
                    phi.index_add_(1, u[i].clamp_min(0), amount)
                cls = t % k
                acc[s:s + block, cls, :num_f] += phi
                acc[s:s + block, cls, num_f] += base
        return acc[:, 0] if k == 1 else acc.reshape(n, k * (num_f + 1))

    def contrib_saabas(self, x, device: DeviceLike = None) -> torch.Tensor:
        """Saabas path attributions, the JAX package's
        ``contrib_saabas_fn``: each split on a row's path credits
        ``value(child) - value(node)`` (times the tree weight) to its
        feature; the last column of each block is the expected value.
        (N, F + 1), or (N, K * (F + 1)) for K > 1. Plain torch ops on
        ``device``."""
        dev = resolve_device(device)
        xt = self._rows(x, dev)
        n, num_f, depth = xt.shape[0], self.num_features, self.max_depth
        k = max(self.num_class, 1)
        route = self._router(dev)
        sf_all = torch.as_tensor(self.split_feature.astype(np.int64),
                                 device=dev)
        nv_all = torch.as_tensor(self.node_value, dtype=torch.float32,
                                 device=dev)
        tw = torch.as_tensor(self.tree_weights, dtype=torch.float32,
                             device=dev)
        rows = torch.arange(n, device=dev)
        acc = torch.zeros((n, k, num_f + 1), dtype=torch.float32, device=dev)
        acc[:, :, num_f] += torch.tensor(self.init_score, dtype=torch.float32)
        for t in range(self.num_trees):
            sf_t, nv_t = sf_all[t], nv_all[t]
            node = torch.zeros(n, dtype=torch.int64, device=dev)
            c = torch.zeros((n, num_f), dtype=torch.float32, device=dev)
            for _ in range(depth):
                feat = sf_t[node]
                is_leaf = feat < 0
                fx = torch.gather(xt, 1, feat.clamp_min(0)[:, None])[:, 0]
                child = torch.where(route(t, node, fx), 2 * node + 1,
                                    2 * node + 2)
                child = torch.where(is_leaf, node, child)
                delta = (nv_t[child] - nv_t[node]) * tw[t]
                c.index_put_((rows, feat.clamp_min(0)),
                             torch.where(is_leaf, 0.0, delta),
                             accumulate=True)
                node = child
            cls = t % k
            acc[:, cls, :num_f] += c
            acc[:, cls, num_f] += nv_t[0] * tw[t]
        return acc[:, 0] if k == 1 else acc.reshape(n, k * (num_f + 1))

    def derive_binning(self) -> "tuple[DerivedBinning, BoosterArrays]":
        """Recover a binning from the model's own split thresholds so an
        IMPORTED model string (raw-value thresholds only, threshold_bin
        stamped -1) can be scored binned, as the JAX package does.

        The per-feature sorted unique thresholds T define bins
        ``bin(x) = 1 + #{T_i < x}`` (bin 0 is the always-left missing
        sentinel, as in trained models); a node splitting at T[j] gets
        ``threshold_bin = 1 + j``, so ``bin(x) <= 1 + j  <=>  x <= T[j]``
        in float64. Returns ``(binning, booster)``, the booster a copy
        with ``threshold_bin`` filled. NaN (and, at zero-as-missing
        nodes, exact 0.0) land where every node on the feature agrees
        they go; ``DerivedBinning.transform`` raises where the model
        mixes directions for a feature whose column holds such values.
        Categorical models are refused."""
        if self.has_categorical:
            raise NotImplementedError(
                "binned scoring routes by threshold_bin; categorical "
                "splits route by raw-value bitset — use predict")
        thresholds: List[np.ndarray] = []
        nodes_per_feature: List[List[tuple]] = [
            [] for _ in range(self.num_features)]
        internal = self.split_feature >= 0
        for t, m in zip(*np.nonzero(internal)):
            d = int(self.decision_type[t, m]) \
                if self.decision_type is not None else None
            nodes_per_feature[int(self.split_feature[t, m])].append(
                (float(self.threshold_value[t, m]), d))
        nan_bin = np.zeros(self.num_features, dtype=np.int64)
        zero_bin = np.full(self.num_features, -1, dtype=np.int64)
        for f in range(self.num_features):
            tf = np.unique(np.asarray(
                [thr for thr, _ in nodes_per_feature[f]], dtype=np.float64))
            thresholds.append(tf)
            k = len(tf)
            # where a NaN in this column has to land: only missing type
            # 2 treats NaN as missing; types 0 and 3 compare it as 0.0,
            # type 1 treats NaN (and 0.0) as missing
            pol = set()
            for _, d in nodes_per_feature[f]:
                if d is None:
                    pol.add("left")     # trained no-cat: NaN routes left
                else:
                    mt = (d >> 2) & 3
                    dl = (d & 2) != 0
                    pol.add("zero" if mt in (0, 3)
                            else ("left" if dl else "right"))
            if not pol or pol == {"left"}:
                nan_bin[f] = 0
            elif pol == {"right"}:
                nan_bin[f] = k + 1
            elif pol == {"zero"}:
                nan_bin[f] = 1 + int(np.searchsorted(tf, 0.0, side="left"))
            else:
                nan_bin[f] = -1     # mixed: refused if NaN appears
            # zero-as-missing (missing type 1): exact 0.0 routes by the
            # node's default direction
            zpol = set()
            for _, d in nodes_per_feature[f]:
                if d is not None and ((d >> 2) & 3) == 1:
                    zpol.add("left" if (d & 2) != 0 else "right")
                else:
                    zpol.add("compare")
            if zpol and zpol != {"compare"}:
                if zpol == {"left"}:
                    zero_bin[f] = 0
                elif zpol == {"right"}:
                    zero_bin[f] = k + 1
                else:
                    zero_bin[f] = -2    # mixed: refused if 0.0 appears
        max_bin_id = max((len(t) + 1 for t in thresholds), default=1)
        binning = DerivedBinning(thresholds=thresholds, nan_bin=nan_bin,
                                 zero_bin=zero_bin, num_bins=max_bin_id + 1)
        tb = np.array(self.threshold_bin, copy=True)
        for t, m in zip(*np.nonzero(internal)):
            f = int(self.split_feature[t, m])
            tb[t, m] = 1 + int(np.searchsorted(
                thresholds[f], float(self.threshold_value[t, m]),
                side="left"))
        return binning, dataclasses.replace(self, threshold_bin=tb)

    # -- importances --------------------------------------------------------
    def feature_importances(self, importance_type: str = "split") -> np.ndarray:
        """'split' = #splits per feature; 'gain' approximated by squared
        value-delta weighted by node count (getFeatureImportances analog,
        LightGBMModelMethods.scala:13)."""
        out = np.zeros(self.num_features, dtype=np.float64)
        sf = self.split_feature
        internal = sf >= 0
        if importance_type == "split":
            np.add.at(out, sf[internal], 1.0)
            return out
        for t in range(self.num_trees):
            for m in np.nonzero(internal[t])[0]:
                left, right = 2 * m + 1, 2 * m + 2
                if right >= self.num_nodes:
                    continue
                # variance-reduction proxy for split gain
                gain = (self.count[t, left] * self.node_value[t, left] ** 2
                        + self.count[t, right] * self.node_value[t, right] ** 2
                        - self.count[t, m] * self.node_value[t, m] ** 2)
                out[sf[t, m]] += max(gain, 0.0)
        return out

    # -- LightGBM model-string interop --------------------------------------
    def save_model_string(self) -> str:
        """Serialize to LightGBM native text format (compacting the full
        binary layout into LightGBM's explicit child-pointer arrays), line
        for line as the JAX package writes it: every split's decision
        bits, and categorical splits as ``cat_boundaries`` /
        ``cat_threshold`` words."""
        lines = [
            "tree",
            "version=v4",
            f"num_class={self.num_class}",
            f"num_tree_per_iteration={self.num_class}",
            "label_index=0",
            f"max_feature_idx={self.num_features - 1}",
            f"objective={self.objective}",
            "feature_names=" + " ".join(
                self.feature_names or
                [f"Column_{i}" for i in range(self.num_features)]),
            "feature_infos=" + " ".join("none" for _ in range(self.num_features)),
            "",
        ]
        for t in range(self.num_trees):
            lines.extend(self._tree_to_text(t))
            lines.append("")
        lines.append("end of trees")
        lines.append("")
        # non-standard but harmless trailer keys for lossless reload
        lines.append(f"init_score={self.init_score!r}")
        lines.append(f"max_depth_layout={self.max_depth}")
        lines.append("tree_weights=" + " ".join(repr(float(w)) for w in self.tree_weights))
        return "\n".join(lines)

    def _tree_to_text(self, t: int) -> List[str]:
        sf, tv, nv, cnt = (self.split_feature[t], self.threshold_value[t],
                           self.node_value[t], self.count[t])
        dt_known = self.decision_type is not None
        dt = (self.decision_type[t] if dt_known
              else np.zeros_like(sf, dtype=np.int8))
        # map full-layout slots to LightGBM internal/leaf numbering (BFS)
        internal_ids: Dict[int, int] = {}
        leaf_ids: Dict[int, int] = {}
        order: List[int] = []
        stack = [0]
        while stack:
            m = stack.pop(0)
            if sf[m] >= 0:
                internal_ids[m] = len(internal_ids)
                order.append(m)
                stack.extend([2 * m + 1, 2 * m + 2])
            else:
                leaf_ids[m] = len(leaf_ids)
        n_int = len(internal_ids)

        def child_code(m: int) -> int:
            return internal_ids[m] if sf[m] >= 0 else ~leaf_ids[m]

        split_feature, threshold, left, right = [], [], [], []
        internal_value, internal_count, decision = [], [], []
        cat_boundaries: List[int] = [0]
        cat_words: List[int] = []
        for m in order:
            split_feature.append(int(sf[m]))
            if dt[m] & 1:
                # categorical: the threshold indexes cat_boundaries /
                # cat_threshold (LightGBM's layout)
                threshold.append(float(len(cat_boundaries) - 1))
                cat_words.extend(int(w) for w in self.cat_bitset[t, m])
                cat_boundaries.append(len(cat_words))
                decision.append(1)
            else:
                threshold.append(float(tv[m]))
                # a booster without bits routes as default-left with NaN
                # missing: 10
                decision.append(int(dt[m]) if dt_known else _NAN_LEFT)
            left.append(child_code(2 * m + 1))
            right.append(child_code(2 * m + 2))
            internal_value.append(float(nv[m]))
            internal_count.append(int(cnt[m]))
        leaves = sorted(leaf_ids, key=lambda m: leaf_ids[m])
        leaf_value = [float(nv[m] * self.tree_weights[t]) for m in leaves]
        leaf_count = [int(cnt[m]) for m in leaves]
        num_cat = len(cat_boundaries) - 1
        out = [
            f"Tree={t}",
            f"num_leaves={max(len(leaves), 1)}",
            f"num_cat={num_cat}",
            "split_feature=" + " ".join(map(str, split_feature)),
            "split_gain=" + " ".join("0" for _ in range(n_int)),
            "threshold=" + " ".join(repr(v) for v in threshold),
            "decision_type=" + " ".join(map(str, decision)),
            "left_child=" + " ".join(map(str, left)),
            "right_child=" + " ".join(map(str, right)),
            "leaf_value=" + " ".join(repr(v) for v in leaf_value),
            "leaf_weight=" + " ".join("0" for _ in range(len(leaves))),
            "leaf_count=" + " ".join(map(str, leaf_count)),
            "internal_value=" + " ".join(repr(v) for v in internal_value),
            "internal_weight=" + " ".join("0" for _ in range(n_int)),
            "internal_count=" + " ".join(map(str, internal_count)),
            "is_linear=0",
            "shrinkage=1",
        ]
        if num_cat:
            at = out.index("is_linear=0")
            out[at:at] = [
                "cat_boundaries=" + " ".join(map(str, cat_boundaries)),
                "cat_threshold=" + " ".join(map(str, cat_words))]
        return out

    @staticmethod
    def load_model_string(text: str) -> "BoosterArrays":
        """Parse LightGBM native text into the full layout, as the JAX
        package does: every split's ``decision_type`` (2 where the string
        has none, as LightGBM writes), categorical splits' ``cat_threshold``
        words into ``cat_bitset`` (T, M, W), W the widest set. A string
        whose every split is numeric and default-left with NaN missing
        (10) loads without bits, as ``from_state_dict`` does: a booster
        without bits routes exactly so."""
        header: Dict[str, str] = {}
        tree_blocks: List[Dict[str, str]] = []
        current: Optional[Dict[str, str]] = None
        for line in text.splitlines():
            line = line.strip()
            if not line or line == "tree":
                continue
            if line == "end of trees":
                current = None  # trailer keys belong to the header
                continue
            if line.startswith("Tree="):
                current = {}
                tree_blocks.append(current)
                continue
            if "=" in line:
                k, v = line.split("=", 1)
                (current if current is not None else header)[k] = v
        num_features = int(header["max_feature_idx"]) + 1
        num_class = int(header.get("num_class", "1"))

        # depth needed for the full layout
        def tree_depth(blk: Dict[str, str]) -> int:
            if "left_child" not in blk or not blk["left_child"].strip():
                return 1
            left = list(map(int, blk["left_child"].split()))
            right = list(map(int, blk["right_child"].split()))

            def rec(code: int) -> int:
                if code < 0:
                    return 0
                return 1 + max(rec(left[code]), rec(right[code]))

            return max(rec(0), 1)

        depth = max((tree_depth(b) for b in tree_blocks), default=1)
        if "max_depth_layout" in header:
            depth = max(depth, int(header["max_depth_layout"]))
        m_slots = 2 ** (depth + 1) - 1
        n_trees = len(tree_blocks)
        sf = np.full((n_trees, m_slots), -1, dtype=np.int32)
        # model strings carry raw-value thresholds only: stamp the bin
        # thresholds invalid so predict_binned refuses
        tb = np.full((n_trees, m_slots), -1, dtype=np.int32)
        tv = np.full((n_trees, m_slots), np.inf, dtype=np.float64)
        nv = np.zeros((n_trees, m_slots), dtype=np.float32)
        cnt = np.zeros((n_trees, m_slots), dtype=np.float32)
        weights = np.ones(n_trees, dtype=np.float32)
        if "tree_weights" in header:
            weights = np.asarray(list(map(float, header["tree_weights"].split())),
                                 dtype=np.float32)
        # the bitsets' width: the widest categorical split of any tree
        max_words = 0
        for blk in tree_blocks:
            if int(blk.get("num_cat", "0")) > 0:
                bounds = list(map(int, blk["cat_boundaries"].split()))
                max_words = max(max_words, max(
                    bounds[i + 1] - bounds[i] for i in range(len(bounds) - 1)))
        dt = np.zeros((n_trees, m_slots), np.int8)
        bitset = (np.zeros((n_trees, m_slots, max_words), np.uint32)
                  if max_words else None)
        for t, blk in enumerate(tree_blocks):
            n_leaves = int(blk.get("num_leaves", "1"))
            leaf_value = list(map(float, blk["leaf_value"].split()))
            leaf_count = list(map(float, blk.get(
                "leaf_count", " ".join("0" * 1 for _ in range(n_leaves))).split())) \
                if blk.get("leaf_count") else [0.0] * n_leaves
            if n_leaves == 1 or "split_feature" not in blk or not blk["split_feature"].strip():
                nv[t, 0] = leaf_value[0] / max(weights[t], 1e-30)
                cnt[t, 0] = leaf_count[0] if leaf_count else 0
                continue
            split_feature = list(map(int, blk["split_feature"].split()))
            threshold = list(map(float, blk["threshold"].split()))
            left = list(map(int, blk["left_child"].split()))
            right = list(map(int, blk["right_child"].split()))
            internal_value = list(map(float, blk["internal_value"].split()))
            internal_count = list(map(float, blk["internal_count"].split()))
            decision = (list(map(int, blk["decision_type"].split()))
                        if blk.get("decision_type") else [2] * len(split_feature))
            cat_bounds = (list(map(int, blk["cat_boundaries"].split()))
                          if int(blk.get("num_cat", "0")) > 0 else [])
            cat_words = (list(map(int, blk["cat_threshold"].split()))
                         if cat_bounds else [])

            def place(code: int, slot: int, t=t, split_feature=split_feature,
                      threshold=threshold, left=left, right=right,
                      internal_value=internal_value,
                      internal_count=internal_count,
                      leaf_value=leaf_value, leaf_count=leaf_count,
                      decision=decision, cat_bounds=cat_bounds,
                      cat_words=cat_words):
                if code < 0:
                    leaf = ~code
                    nv[t, slot] = leaf_value[leaf] / max(weights[t], 1e-30)
                    cnt[t, slot] = leaf_count[leaf] if leaf < len(leaf_count) else 0
                    return
                sf[t, slot] = split_feature[code]
                dt[t, slot] = np.int8(decision[code])
                if decision[code] & 1:
                    lo, hi = (cat_bounds[int(threshold[code])],
                              cat_bounds[int(threshold[code]) + 1])
                    tv[t, slot] = np.nan
                    bitset[t, slot, :hi - lo] = np.asarray(
                        cat_words[lo:hi], dtype=np.int64).astype(np.uint32)
                else:
                    tv[t, slot] = threshold[code]
                nv[t, slot] = internal_value[code]
                cnt[t, slot] = internal_count[code]
                place(left[code], 2 * slot + 1)
                place(right[code], 2 * slot + 2)

            place(0, 0)
        if bitset is None and np.all(dt[sf >= 0] == _NAN_LEFT):
            dt = None
        return BoosterArrays(
            split_feature=sf, threshold_bin=tb, threshold_value=tv,
            node_value=nv, count=cnt, tree_weights=weights,
            max_depth=depth, num_features=num_features, num_class=num_class,
            objective=header.get("objective", "regression"),
            init_score=float(header.get("init_score", "0.0")),
            feature_names=header.get("feature_names", "").split() or None,
            decision_type=dt, cat_bitset=bitset,
        )

    def slice_iterations(self, start_iteration: int = 0,
                         num_iteration: int = -1) -> "BoosterArrays":
        """Sub-ensemble over boosting iterations [start, start+num)
        (LightGBM predict's start_iteration/num_iteration; trees are
        interleaved per class, so iteration i owns trees
        [i*K, (i+1)*K)). ``init_score`` stays included — it is a
        separate additive constant here, not part of any iteration.
        ``num_iteration <= 0`` means to the end (LightGBM predict semantics)."""
        k = max(self.num_class, 1)
        total = self.num_trees // k
        if not 0 <= start_iteration <= total:
            raise ValueError(
                f"start_iteration {start_iteration} outside [0, {total}]")
        stop = (total if num_iteration <= 0
                else min(total, start_iteration + num_iteration))
        sl = slice(start_iteration * k, stop * k)
        return BoosterArrays(
            split_feature=self.split_feature[sl],
            threshold_bin=self.threshold_bin[sl],
            threshold_value=self.threshold_value[sl],
            node_value=self.node_value[sl],
            count=self.count[sl],
            tree_weights=self.tree_weights[sl],
            max_depth=self.max_depth,
            num_features=self.num_features,
            num_class=self.num_class,
            objective=self.objective,
            init_score=self.init_score,
            feature_names=self.feature_names,
            decision_type=(None if self.decision_type is None
                           else self.decision_type[sl]),
            cat_bitset=(None if self.cat_bitset is None
                        else self.cat_bitset[sl]),
        )

    @staticmethod
    def concat(a: "BoosterArrays", b: "BoosterArrays") -> "BoosterArrays":
        """Concatenate ensembles (warm-start continuation): pad both to
        the deeper full-tree layout, keep ``a``'s base/init metadata. Where
        one side carries decision bits the other's splits take 10
        (default-left, NaN missing: how a booster without bits routes),
        and the bitsets widen to the wider side's."""
        if a.num_class != b.num_class:
            raise ValueError("cannot concat boosters with different num_class")
        if a.num_features != b.num_features:
            raise ValueError("cannot concat boosters with different feature counts")
        depth = max(a.max_depth, b.max_depth)
        slots = 2 ** (depth + 1) - 1

        def pad(x: np.ndarray, fill) -> np.ndarray:
            if x.shape[1] == slots:
                return x
            out = np.full((x.shape[0], slots), fill, dtype=x.dtype)
            out[:, :x.shape[1]] = x
            return out

        dt = bitset = None
        if a.decision_type is not None or b.decision_type is not None:
            def bits_of(x):
                return (x.decision_type if x.decision_type is not None else
                        np.where(x.split_feature >= 0, _NAN_LEFT, 0)
                        .astype(np.int8))

            dt = np.concatenate([pad(bits_of(a), 0), pad(bits_of(b), 0)])
            w_a = a.cat_bitset.shape[2] if a.cat_bitset is not None else 1
            w_b = b.cat_bitset.shape[2] if b.cat_bitset is not None else 1
            bitset = np.zeros((dt.shape[0], slots, max(w_a, w_b)), np.uint32)
            if a.cat_bitset is not None:
                bitset[:a.num_trees, :a.num_nodes, :w_a] = a.cat_bitset
            if b.cat_bitset is not None:
                bitset[a.num_trees:, :b.num_nodes, :w_b] = b.cat_bitset

        return BoosterArrays(
            split_feature=np.concatenate([pad(a.split_feature, -1),
                                          pad(b.split_feature, -1)]),
            threshold_bin=np.concatenate([pad(a.threshold_bin, 0),
                                          pad(b.threshold_bin, 0)]),
            threshold_value=np.concatenate([pad(a.threshold_value, np.inf),
                                            pad(b.threshold_value, np.inf)]),
            node_value=np.concatenate([pad(a.node_value, 0.0),
                                       pad(b.node_value, 0.0)]),
            count=np.concatenate([pad(a.count, 0.0), pad(b.count, 0.0)]),
            tree_weights=np.concatenate([a.tree_weights, b.tree_weights]),
            max_depth=depth,
            num_features=a.num_features,
            num_class=a.num_class,
            objective=b.objective,
            init_score=a.init_score,
            feature_names=a.feature_names or b.feature_names,
            decision_type=dt, cat_bitset=bitset,
        )

    # -- generic state dict (for Model persistence) -------------------------
    def state_dict(self) -> Dict[str, Any]:
        """The JAX package's ``state_dict`` layout."""
        return {
            "split_feature": self.split_feature,
            "threshold_bin": self.threshold_bin,
            "threshold_value": self.threshold_value,
            "node_value": self.node_value,
            "node_count": self.count,
            "tree_weights": self.tree_weights,
            "booster_meta": {
                "max_depth": self.max_depth,
                "num_features": self.num_features,
                "num_class": self.num_class,
                "objective": self.objective,
                "init_score": self.init_score,
                "feature_names": self.feature_names,
            },
            **({"decision_type": self.decision_type,
                "cat_bitset": self.cat_bitset}
               if self.decision_type is not None else {}),
        }

    @staticmethod
    def from_state_dict(state: Dict[str, Any]) -> "BoosterArrays":
        """The inverse of ``state_dict``: also reads the state of a JAX
        ``BoosterArrays`` (arrays as numpy), cast to this layout's
        dtypes. A JAX booster warm-started from a model string keeps
        ``decision_type`` on every node; where each split is numeric
        and default-left with NaN missing (``decision_type=10``, how
        this layout routes a booster without bits) the bits are dropped,
        as ``load_model_string`` drops them."""
        meta = state["booster_meta"]
        split_feature = np.asarray(state["split_feature"], np.int32)
        dt, bitset = state.get("decision_type"), state.get("cat_bitset")
        if (dt is not None and (bitset is None or not np.any(bitset))
                and np.all(np.asarray(dt)[split_feature >= 0] == _NAN_LEFT)):
            dt = bitset = None
        return BoosterArrays(
            split_feature=split_feature,
            threshold_bin=np.asarray(state["threshold_bin"], np.int32),
            threshold_value=np.asarray(state["threshold_value"], np.float64),
            node_value=np.asarray(state["node_value"], np.float32),
            count=np.asarray(state["node_count"], np.float32),
            tree_weights=np.asarray(state["tree_weights"], np.float32),
            max_depth=int(meta["max_depth"]),
            num_features=int(meta["num_features"]),
            num_class=int(meta["num_class"]),
            objective=meta["objective"],
            init_score=float(meta["init_score"]),
            feature_names=meta.get("feature_names"),
            decision_type=(None if dt is None else np.asarray(dt, np.int8)),
            cat_bitset=(None if bitset is None
                        else np.asarray(bitset, np.uint32)),
        )


# LightGBM decision_type of a numeric split that sends NaN left and
# compares everything else (default-left bit 2 | missing type NaN 8)
_NAN_LEFT = 10
# (rows x slots) cells of a block of rows in ``contrib``'s working tensors
CONTRIB_CELLS = 1 << 24


def _merge_duplicates(u, z, o, m: int, dev) -> None:
    """In place on a tree's path entries (``contrib``): a feature met
    again down a path merges into its first occurrence (z and o
    multiplied), the later entry becomes neutral (z = o = 1), as the JAX
    package's ``contrib_fn`` merges them."""
    depth = len(u)
    merged = [torch.zeros(m, dtype=torch.bool, device=dev)
              for _ in range(depth)]
    for j in range(1, depth):
        taken = torch.zeros(m, dtype=torch.bool, device=dev)
        for k in range(j):
            hit = ((u[k] == u[j]) & (u[j] >= 0) & ~merged[k] & ~merged[j]
                   & ~taken)
            z[k] = torch.where(hit, z[k] * z[j], z[k])
            o[k] = torch.where(hit, o[k] * o[j], o[k])
            taken = taken | hit
        z[j] = torch.where(taken, 1.0, z[j])
        o[j] = torch.where(taken, 1.0, o[j])
        merged[j] = merged[j] | taken


class TreeScorer:
    """A booster's scorer on one device, the counterpart of a jitted JAX
    scorer: the tables packed and copied there once
    (``score_cuda.pack_nodes`` / ``make_tables``: a 32-bit word per node
    for bin ids, or the wide node {int32 feature, int32 threshold} where
    a threshold passes 65,534 or a split feature 32,767, or the feature
    and the float32 rounding of the raw threshold for ``raw``, every leaf
    pushed to the last level; the leaf table in float32, or bfloat16
    under ``autocast="bf16"`` through ``placement_cast``; each slot's
    float64 leaf * weight), and per call one ``score_cuda.tree_score``.
    Packing refuses a negative bin threshold. ``decision``: raw rows
    routed by the booster's decision bits and category bitsets
    (``score_cuda.pack_decision_nodes``; 10 at every split of a booster
    without bits), whose walk also gives leaf slots."""

    def __init__(self, booster: BoosterArrays, device: torch.device,
                 raw: bool = False, autocast: str = "off",
                 decision: bool = False):
        sf = booster.split_feature
        if sf.size and int(sf.max()) >= booster.num_features:
            raise ValueError(f"a split feature ({int(sf.max())}) is not "
                             f"below num_features ({booster.num_features})")
        extra = {}
        if decision:
            dt = booster.decision_type
            if dt is None:
                dt = np.where(sf >= 0, _NAN_LEFT, 0)
            nodes, leaf, bits, words, slots = pack_decision_nodes(
                sf, booster.threshold_value, booster.node_value,
                booster.max_depth, dt,
                booster.cat_bitset if booster.has_categorical else None)
            extra = dict(bits=torch.as_tensor(bits, device=device),
                         bit_words=words,
                         leaf_slot=torch.as_tensor(slots, device=device))
        else:
            nodes, leaf, wide = pack_nodes(
                sf, booster.threshold_value if raw else booster.threshold_bin,
                booster.node_value, booster.max_depth, raw)
            extra = dict(wide=wide)
        self.device = device
        self.autocast = autocast
        self.tables = make_tables(
            nodes=torch.as_tensor(nodes, device=device),
            leaf=placement_cast(
                torch.as_tensor(leaf, device=device),
                torch.bfloat16 if autocast == "bf16" else None),
            tree_weight=torch.as_tensor(booster.tree_weights,
                                        dtype=torch.float32, device=device),
            num_nodes=sf.shape[1], max_depth=booster.max_depth,
            num_class=booster.num_class, num_features=booster.num_features,
            init_score=booster.init_score, **extra)

    def __call__(self, x, leaves: bool = False):
        """(N, F) bin ids, or raw features for a raw scorer (numpy or a
        tensor) -> raw scores on this scorer's device, (N,) or (N, K);
        with ``leaves`` (a decision scorer) also the (N, T) int32 leaf
        slots. Raw features are scored as float32; bin ids other than
        uint8, uint16 and int32 as int32. Both casts happen where ``x``
        lies, before the one copy to the device."""
        xt = torch.as_tensor(x)
        if self.tables.raw:
            want = torch.float32
        else:
            want = xt.dtype if xt.dtype in BIN_CODES else torch.int32
        xt = xt.to(want).to(self.device).contiguous()
        return tree_score(xt, self.tables, leaves)

    def staged_batch(self, rows: int, features: int, dtype) -> StagedBatch:
        """The buffers of one padded batch shape of bin ids of the numpy
        ``dtype`` (``score_cuda.StagedBatch``), for ``score_staged``."""
        return StagedBatch(self.tables, rows, features,
                           torch.from_numpy(np.empty(0, dtype)).dtype)

    def score_staged(self, batch: StagedBatch) -> None:
        """Score ``batch.x`` into ``batch.out``: on the card one call for
        the copy in, the kernel and the copy out."""
        tree_score_staged(batch, self.tables)


@dataclass
class DerivedBinning:
    """Per-feature threshold tables recovered from an imported model's
    splits (``BoosterArrays.derive_binning``). ``transform`` bins raw
    features for the binned scorer: ``bin(x) = 1 + #{T_i < x}`` in
    float64, with NaN / zero-as-missing values mapped per the model's
    (uniform) per-feature policy and refused where it mixes
    directions. Past 65,536 bins (a model of more than 65,534 distinct
    thresholds on a feature) the ids are int32 and the booster's
    thresholds pass what a 32-bit bin node holds: its scorer packs wide
    nodes (``score_cuda.pack_nodes``)."""

    thresholds: List[np.ndarray]    # per feature, sorted unique float64
    nan_bin: np.ndarray             # (F,) where NaN lands; -1 = refuse
    zero_bin: np.ndarray            # (F,) where exact 0.0 lands;
                                    # -1 = compares normally, -2 = refuse
    num_bins: int                   # max bin id + 1 (dtype sizing)

    @property
    def dtype(self):
        return binned_ingest_dtype(self.num_bins)

    def transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x)
        n, f = x.shape
        if f != len(self.thresholds):
            raise ValueError(f"expected {len(self.thresholds)} features, "
                             f"got {f}")
        out = np.empty((n, f), dtype=self.dtype)
        for j, tf in enumerate(self.thresholds):
            col = np.asarray(x[:, j], dtype=np.float64)
            bins = 1 + np.searchsorted(tf, col, side="left")
            nan_mask = np.isnan(col)
            if nan_mask.any():
                if self.nan_bin[j] < 0:
                    raise ValueError(
                        f"feature {j}: this model mixes NaN default "
                        "directions across nodes, which a per-feature "
                        "bin id cannot express — use predict for rows "
                        "with NaN in this column")
                bins[nan_mask] = self.nan_bin[j]
            if self.zero_bin[j] != -1:
                zmask = col == 0.0
                if zmask.any():
                    if self.zero_bin[j] == -2:
                        raise ValueError(
                            f"feature {j}: this model mixes "
                            "zero-as-missing directions across nodes — "
                            "use predict for rows with 0.0 in this "
                            "column")
                    bins[zmask] = self.zero_bin[j]
            out[:, j] = bins
        return out
