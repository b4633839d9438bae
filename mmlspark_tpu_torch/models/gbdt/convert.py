"""Weight carry-over from the JAX package: a booster fitted there,
passed as the arrays of its ``BoosterArrays.state_dict()``, becomes the
port's ``BoosterArrays``. Only numpy arrays and plain values cross;
nothing of JAX is imported."""

from __future__ import annotations

from typing import Any, Dict

import numpy as np

from mmlspark_tpu_torch.models.gbdt.booster import BoosterArrays


def booster_from_jax_state(state: Dict[str, Any]) -> BoosterArrays:
    """``state``: the dict of a JAX ``BoosterArrays.state_dict()`` (arrays
    as numpy). The returned booster keeps host arrays; its ``predict`` /
    ``predict_binned`` take the device to score on (the card unless
    ``device="cpu"``)."""
    meta = state["booster_meta"]
    return BoosterArrays(
        split_feature=np.asarray(state["split_feature"], dtype=np.int32),
        threshold_bin=np.asarray(state["threshold_bin"], dtype=np.int32),
        threshold_value=np.asarray(state["threshold_value"],
                                   dtype=np.float64),
        node_value=np.asarray(state["node_value"], dtype=np.float32),
        count=np.asarray(state["node_count"], dtype=np.float32),
        tree_weights=np.asarray(state["tree_weights"], dtype=np.float32),
        max_depth=int(meta["max_depth"]),
        num_features=int(meta["num_features"]),
        num_class=int(meta["num_class"]),
        objective=meta["objective"],
        init_score=float(meta["init_score"]),
        feature_names=meta.get("feature_names"),
        decision_type=(None if state.get("decision_type") is None
                       else np.asarray(state["decision_type"], np.int8)),
        cat_bitset=(None if state.get("cat_bitset") is None
                    else np.asarray(state["cat_bitset"], np.uint32)),
    )
