"""Inference placement — the port's copy of ``resolve_infer_autocast``,
``placement_cast`` and ``ShardedScorer`` from the JAX package's
``parallel/shard_rules.py``. The port's models are tree tables, which
every rank holds whole (the reference's GBDT rule table replicates
every leaf), so the rule tables themselves have no counterpart."""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core import env, sanitizer


def resolve_infer_autocast() -> str:
    """``MMLSPARK_TORCH_INFER_AUTOCAST``: off (default, the bitwise arm)
    or bf16. Unknown values warn once and fall back to off."""
    mode = (env.env_str(env.INFER_AUTOCAST, "off") or "off").strip().lower()
    mode = mode or "off"
    if mode not in ("off", "bf16"):
        env.warn_once(env.INFER_AUTOCAST,
                      f"{env.INFER_AUTOCAST}={mode!r} not in off|bf16; "
                      "using off")
        mode = "off"
    return mode


def placement_cast(x: torch.Tensor,
                   dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The one low-precision placement seam: cast a floating ``x`` to
    ``dtype`` (round to nearest even); ``None`` or a non-float ``x``
    passes through unchanged."""
    if dtype is not None and x.is_floating_point():
        return x.to(dtype)
    return x


class ShardedScorer:
    """The scoring engine of a model under a mesh (the reference's
    ``ShardedScorer``, GBDT family): the rows of a call are split over
    the mesh's ``dp`` ranks in contiguous shards; each rank scores its
    shard through ``fn`` (numpy rows -> a (rows, ...) tensor, e.g. a
    booster's ``tree_score``) in batches of one rung of
    ``inference.bucket_ladder(max_batch)``, chosen by the shard's rows
    and padded with zero rows (rows score independently); the shards'
    scores are all-gathered over ``dp`` (``parallel.mesh.all_gather``)
    and cut to the call's rows. Every rank of the mesh makes the call
    with the same rows and gets every row's scores. Without a mesh it
    calls ``fn`` on the rows in ``max_batch`` batches. A rung's first
    call is a build for the sanitizer's recompile budget
    (``sanitizer.count_recompile``), as the reference's first compile of
    a rung is."""

    def __init__(self, fn: Callable, mesh=None, *, max_batch: int = 65536):
        from mmlspark_tpu_torch.parallel.inference import bucket_ladder

        self.fn, self.mesh = fn, mesh
        self.max_batch = max(int(max_batch), 1)
        self._ladder = bucket_ladder(self.max_batch)
        if mesh is None:
            self.mode, self.reason, self.dp = ("serial", "no mesh attached",
                                               1)
        else:
            from mmlspark_tpu_torch.parallel.mesh import DATA_AXIS, axis_size
            self.dp = axis_size(mesh, DATA_AXIS)
            self.mode = "rules"
            self.reason = (f"rows over the {self.dp}-rank dp axis of a "
                           f"{mesh.size}-rank mesh")
        self.rungs_used: set = set()

    def _score(self, x: np.ndarray, rung: int) -> torch.Tensor:
        """``fn`` over ``x`` in batches of ``rung`` rows, the last padded
        with zero rows, the padding cut."""
        out = []
        for s in range(0, max(len(x), 1), rung):
            xs = x[s:s + rung]
            if len(xs) < rung:
                xs = np.concatenate(
                    [xs, np.zeros((rung - len(xs), *x.shape[1:]), x.dtype)])
            out.append(self.fn(xs))
        return torch.cat(out)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        from mmlspark_tpu_torch.parallel.inference import bucket_for

        n = len(x)
        if self.mesh is None:
            return torch.cat([self.fn(x[s:s + self.max_batch]) for s in
                              range(0, max(n, 1), self.max_batch)]
                             ).cpu().numpy()[:n]
        from mmlspark_tpu_torch.parallel.mesh import (DATA_AXIS, all_gather,
                                                      axis_index)
        shard = -(-max(n, 1) // self.dp)
        rung = bucket_for(shard, self._ladder)
        if rung not in self.rungs_used:
            self.rungs_used.add(rung)
            sanitizer.count_recompile(
                f"shard_rules gbdt rung {rung} (global {self.dp * rung})")
        lo = axis_index(self.mesh, DATA_AXIS) * shard
        scores = self._score(x[lo:lo + shard], rung)[:shard]
        if len(scores) < shard:
            # the last shard holds fewer rows: pad to the shards' length
            scores = torch.cat([scores, scores.new_zeros(
                (shard - len(scores), *scores.shape[1:]))])
        full = all_gather(self.mesh, scores.contiguous(), DATA_AXIS,
                          tag="scores")
        return full.cpu().numpy()[:n]

    def metadata(self) -> Dict[str, Any]:
        return {"shard_rules": self.mode, "shard_rules_reason": self.reason,
                "shard_rules_family": "gbdt",
                "infer_autocast": resolve_infer_autocast(),
                "shard_rules_dp": self.dp,
                "shard_rules_rungs": sorted(self.rungs_used)}
