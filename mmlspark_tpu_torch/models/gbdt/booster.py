"""Tree-ensemble representation and batch scoring on PyTorch.

Port of the JAX package's ``BoosterArrays`` for numeric boosters. Every
tree is stored in a fixed full-binary layout (node i's children are
2i+1 / 2i+2); scoring walks all rows ``max_depth`` gather steps per
tree and adds the trees one by one in order, so the per-tree
accumulation order is the JAX ``scan``'s.

This slice scores numeric boosters trained without ``decision_type``
bits (NaN routes left, as the missing bin 0 does in training).
Categorical / zero-as-missing routing, leaf indices and contributions
are later work (ROADMAP A5).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import DeviceLike, resolve_device


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

    def _require_numeric(self):
        if self.decision_type is not None or self.cat_bitset is not None:
            raise NotImplementedError(
                "scoring boosters with decision_type bits (categorical or "
                "zero-as-missing splits) is not in the port yet (ROADMAP A5)")

    def _score(self, x: torch.Tensor, tv, go_left) -> torch.Tensor:
        """Sum over trees of ``node_value * tree_weight`` at each row's
        leaf, starting from ``init_score``; ``go_left(fx, thr)`` routes."""
        dev = x.device
        sf = torch.as_tensor(self.split_feature, device=dev).long()
        nv = torch.as_tensor(self.node_value, dtype=torch.float32, device=dev)
        tw = torch.as_tensor(self.tree_weights, dtype=torch.float32,
                             device=dev)
        n, k = x.shape[0], self.num_class
        acc = torch.full((n, k), self.init_score, dtype=torch.float32,
                         device=dev)
        for t in range(self.num_trees):
            node = torch.zeros(n, dtype=torch.int64, device=dev)
            for _ in range(self.max_depth):
                feat = sf[t][node]
                is_leaf = feat < 0
                fx = torch.gather(x, 1, torch.clamp_min(feat, 0)[:, None])[:, 0]
                child = torch.where(go_left(fx, tv[t][node]), 2 * node + 1,
                                    2 * node + 2)
                node = torch.where(is_leaf, node, child)
            acc[:, t % k] += nv[t][node] * tw[t]
        return acc[:, 0] if k == 1 else acc

    def predict_binned(self, binned, device: DeviceLike = None) -> torch.Tensor:
        """BINNED features (N, F) small-int bin ids (the
        ``BinMapper.transform`` output the model was trained on, best as
        uint8) -> raw scores, (N,) or (N, K): routes by
        ``bin <= threshold_bin``."""
        self._require_numeric()
        if (self.threshold_bin[self.split_feature >= 0] < 0).any():
            raise ValueError(
                "this booster has no binned thresholds (imported from a "
                "model string); score raw features with predict")
        dev = resolve_device(device)
        bd = torch.as_tensor(binned, device=dev)
        tb = torch.as_tensor(self.threshold_bin, device=dev).long()
        return self._score(bd, tb, lambda fb, thr: fb.long() <= thr)

    def predict(self, x, device: DeviceLike = None) -> torch.Tensor:
        """Raw features (N, F) -> raw scores, (N,) or (N, K). NaN routes
        left, matching training where the missing bin (0) satisfies
        bin <= threshold. Features and thresholds compare in float32, as
        the JAX package's ``predict_fn`` does."""
        self._require_numeric()
        dev = resolve_device(device)
        xd = torch.as_tensor(np.asarray(x, dtype=np.float32)
                             if isinstance(x, np.ndarray) else x,
                             device=dev).float()
        tv = torch.as_tensor(np.asarray(self.threshold_value, np.float32),
                             device=dev)
        return self._score(xd, tv,
                           lambda fx, thr: torch.isnan(fx) | (fx <= thr))
